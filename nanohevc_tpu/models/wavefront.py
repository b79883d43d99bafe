"""Closed-loop (wavefront) all-intra encode and the matching decoder.

True HEVC intra prediction reads *reconstructed* neighbors, which
serializes blocks along the raster diagonal.  The reference sidesteps
this entirely (it predicts from source pixels, __main__.py:162-163;
its own docs acknowledge the real encoder must use reconstructed
pixels, docs/frames_and_panes.md:342-346).  This module implements the
real thing as one batched program:

- blocks on the same anti-diagonal (by + bx == d) have no mutual
  dependency, so the frame is processed as a lax.scan over diagonals,
  each step batch-encoding up to min(nby, nbx) blocks in parallel
  (the classic wavefront);
- prediction needs only two 1-pixel-wide reconstruction boundaries,
  so the scan carries compact *boundary buffers* instead of the whole
  frame: the bottom pixel row of every block-row and the right pixel
  column of every block-col.  Reconstructed blocks leave the loop as
  stacked scan outputs and are scattered into the plane once at the
  end, so the per-step state is O(m*N), not O(H*W);
- the buffers are stored in *skewed (systolic) coordinates* - the
  bottom-row buffer shifts block-row by's columns right by by*N, the
  right-column buffer shifts block-col bx's rows down by bx*N.  Under
  that skew, every slot of diagonal d reads its whole reference at the
  SAME offset (column d*N, after a global +N+1 shift) and writes at
  d*N+N+1, so each scan step is two contiguous dynamic slices + two
  dynamic-update-slices plus rolls/flips along the slot axis - no
  gather or scatter HLOs anywhere in the loop;
- frame-edge clamp semantics (replicate the last reconstructed pixel)
  become a conditional write of a replicated N-wide tail, applied only
  when the plane is block-aligned on that axis (otherwise the clamped
  region of a full recon plane is unwritten zeros, and so are the
  buffer tails);
- per-step block coordinates are compile-time tables; the slot axis is
  the block-row index, so each diagonal has at most one block per
  slot; invalid slots blend back the old buffer contents and their
  outputs are dropped by the final scatter;
- total padded work is (nby + nbx - 1) * min(nby, nbx) block slots,
  about 1.5x the true block count at 16:9 aspect - the price of the
  dependency, still fully batched;
- frames are independent, so `jax.vmap` over a frame batch encodes k
  frames' same-index diagonals in one step (multi-frame diagonal
  interleaving): k times the parallel work at the same 374-step
  dependency depth.

Because prediction is causal, `decode_plane` reconstructs the frame
pixel-exactly from (modes, levels) alone - the encoder/decoder pair
closes the loop the reference never could.
"""

from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

from nanohevc_tpu import ops


@lru_cache(maxsize=None)
def _skew_tables(nby: int, nbx: int) -> tuple[np.ndarray, np.ndarray]:
    """Static skewed-wavefront tables over the (diagonal, block-row) grid.

    Slot axis = block-row by (each anti-diagonal holds at most one
    block per block-row).  Returns (bx (ndiag, nby), valid mask) as
    numpy arrays.
    """
    ndiag = nby + nbx - 1
    by = np.arange(nby, dtype=np.int32)
    d = np.arange(ndiag, dtype=np.int32)
    bx = d[:, None] - by[None, :]
    ok = (bx >= 0) & (bx < nbx)
    return bx, ok


def _skew_blocks(raster: jnp.ndarray, nby: int, nbx: int) -> jnp.ndarray:
    """Raster blocks (B, nby*nbx, ...) -> skewed (B, ndiag, nby, ...).

    skewed[d, by] = raster[by, d - by].  Because d - by is a shear, the
    whole permutation is one pad + reshape: flattening the padded
    (nby, ndiag+1) layout gives flat[by*(ndiag+1) + bx] =
    flat2[by*ndiag + (by + bx)], i.e. exactly the (by, d) grid.  No
    gather HLO anywhere.
    Invalid (d, by) slots hold neighboring rows' data - callers must
    treat them as garbage (the wavefront drops them on deskew).
    """
    b, nb = raster.shape[:2]
    rest = raster.shape[2:]
    ndiag = nby + nbx - 1
    x = raster.reshape(b, nby, nbx, *rest)
    pad = [(0, 0), (0, 0), (0, ndiag + 1 - nbx)] + [(0, 0)] * len(rest)
    x = jnp.pad(x, pad).reshape(b, nby * (ndiag + 1), *rest)
    x = x[:, : nby * ndiag].reshape(b, nby, ndiag, *rest)
    axes = (0, 2, 1) + tuple(range(3, 3 + len(rest)))
    return x.transpose(axes)


def _deskew_blocks(skewed: jnp.ndarray, nby: int, nbx: int) -> jnp.ndarray:
    """Skewed (B, ndiag, nby, ...) -> raster (B, nby*nbx, ...).

    Inverse shear of _skew_blocks, again one pad + reshape:
    raster[by, bx] = skewed[by + bx, by].  Garbage in invalid slots is
    never read.
    """
    b, ndiag, nby_ = skewed.shape[:3]
    rest = skewed.shape[3:]
    axes = (0, 2, 1) + tuple(range(3, 3 + len(rest)))
    x = skewed.transpose(axes).reshape(b, nby * ndiag, *rest)
    pad = [(0, 0), (0, nby)] + [(0, 0)] * len(rest)
    x = jnp.pad(x, pad).reshape(b, nby, ndiag + 1, *rest)
    return x[:, :, :nbx].reshape(b, nby * nbx, *rest)


def _skew_buffers(nby: int, nbx: int, n: int):
    """Zero-initialised skewed boundary buffers (bottom-rows, right-cols).

    Skew algebra (derived in the module docstring): bottom-row buffer
    row by holds recon row (by+1)*N-1 at skewed column real+by*N+N+1;
    right-col buffer row bx+nby holds recon column (bx+1)*N-1 at
    skewed row real+bx*N+N+1.  With that shift, diagonal d's reads all
    start at offset d*N and its writes at d*N+N+1, independent of slot.
    """
    ndiag = nby + nbx - 1
    width = (ndiag + 2) * n + 2
    s_bot = jnp.zeros((nby, width), jnp.int32)
    r_sp = jnp.zeros((ndiag + nby, width), jnp.int32)
    return s_bot, r_sp


def _read_refs_skewed(s_bot, r_sp, d, n, nby, boundary, bx):
    """(nby, 4N+2) reference array for diagonal d from skewed buffers.

    Same layout/semantics as ops.tiling.extract_refs_at on the full
    recon plane: top[0] is the corner, frame-edge positions masked to
    `boundary`, beyond-edge extensions are replicated pixels (aligned
    planes) or zeros (unwritten recon), both already in the buffers.
    """
    top_rows = jax.lax.dynamic_slice(s_bot, (0, d * n), (nby, 2 * n + 1))
    brow = jnp.full((1, 2 * n + 1), boundary, jnp.int32)
    top = jnp.concatenate([brow, top_rows[:-1]], axis=0)  # slot by -> row by-1
    left = jax.lax.dynamic_slice(r_sp, (d, d * n), (nby, 2 * n + 1))[::-1]
    left = jnp.where((bx == 0)[:, None], boundary, left)
    by = jnp.arange(nby, dtype=jnp.int32)
    corner_edge = (by == 0) | (bx == 0)
    top = top.at[:, 0].set(jnp.where(corner_edge, boundary, top[:, 0]))
    left = left.at[:, 0].set(jnp.where(corner_edge, boundary, left[:, 0]))
    return jnp.concatenate([top, left], axis=-1)


def _write_bufs_skewed(s_bot, r_sp, rec, d, ok, bx, n, nby, nbx, rep_w, rep_h):
    """Blend diagonal d's bottom rows / right columns into the buffers.

    Valid slots write their block's bottom row / right column at skewed
    offset d*N+N+1; the N-wide tail carries the replicated last pixel
    for frame-edge clamp parity (only when that axis is block-aligned).
    Invalid slots keep the old contents.
    """
    c0 = d * n + n + 1
    okc = ok[:, None]
    last_pix = rec[:, n - 1, n - 1 : n]                    # (nby, 1)

    old_b = jax.lax.dynamic_slice(s_bot, (0, c0), (nby, 2 * n))
    head = jnp.where(okc, rec[:, n - 1, :], old_b[:, :n])
    if rep_w:
        at_last_col = okc & (bx == nbx - 1)[:, None]
        tail = jnp.where(at_last_col, last_pix, old_b[:, n:])
    else:
        tail = old_b[:, n:]
    s_bot = jax.lax.dynamic_update_slice(
        s_bot, jnp.concatenate([head, tail], axis=1), (0, c0)
    )

    old_slot = jax.lax.dynamic_slice(r_sp, (d + 1, c0), (nby, 2 * n))[::-1]
    head_r = jnp.where(okc, rec[:, :, n - 1], old_slot[:, :n])
    if rep_h:
        by = jnp.arange(nby, dtype=jnp.int32)
        at_last_row = okc & (by == nby - 1)[:, None]
        tail_r = jnp.where(at_last_row, last_pix, old_slot[:, n:])
    else:
        tail_r = old_slot[:, n:]
    new_r = jnp.concatenate([head_r, tail_r], axis=1)[::-1]
    r_sp = jax.lax.dynamic_update_slice(r_sp, new_r, (d + 1, c0))
    return s_bot, r_sp


def _code_residual(blocks_slot, pred, qp, n, use_dst, bit_depth,
                   dequant_rescale, rdoq=False, scan="diag", modes=None,
                   rd_lambda_scale=1.0):
    res = blocks_slot - pred
    coeff = ops.forward_transform(res, use_dst)
    levels = ops.quantize(coeff, qp, n, True)
    if rdoq:
        # RD-optimal level adjustment (ops/rdoq.py) INSIDE the loop:
        # the adjusted levels feed the dequant/reconstruct below, so
        # the wavefront's neighbor references — and therefore the
        # decoder — see exactly the levels the stream carries.  Same
        # two-stage pass as the open-loop path (all_intra.py), applied
        # per diagonal slot; the rate model prices the stream's actual
        # scan (mode-dependent included).
        from nanohevc_tpu.ops.rdoq import rd_lambda_calibrated

        lam = rd_lambda_calibrated(
            qp, n, use_dst, dequant_rescale, rd_lambda_scale
        )
        gain = jnp.broadcast_to(ops.rdoq_gain(n, use_dst), coeff.shape)
        packed = ops.rdoq_levels(
            ops.scan_pack(coeff, scan, modes=modes),
            ops.scan_pack(levels, scan, modes=modes),
            ops.scan_pack(gain, scan, modes=modes),
            qp, n, lam, dequant_rescale=dequant_rescale,
        )
        levels = ops.scan_unpack(packed, scan, modes=modes)
    deq = ops.dequantize(levels, qp, n, rescale=dequant_rescale)
    rec = ops.inverse_transform(deq, use_dst)
    recon = jnp.clip(pred + rec, 0, (1 << bit_depth) - 1)
    return levels, recon


def encode_planes_closed_loop(
    planes: jnp.ndarray,
    qp,
    *,
    n: int,
    mode_set: str = "dc_planar",
    decision: str = "energy",
    use_dst: bool = False,
    bit_depth: int = 8,
    scan: str = "diag",
    dequant_rescale: bool = False,
    intra_smoothing: bool = False,
    deblock: bool = False,
    deblock_chroma: bool = False,
    sao: bool = False,
    sao_ctb: bool = False,
    sao_tile: int = 64,
    rdoq: bool = False,
    rd_lambda_scale: float = 1.0,
):
    """Batched wavefront encode: (B, H, W) planes, reconstruction-fed.

    Returns {"recon" (B, H, W), "levels" (B, nb, N*N) scan-packed
    raster order, "modes" (B, nb)}.  Frames are independent, so the
    batch axis is a `vmap` over the diagonal scan - multi-frame
    diagonal interleaving: B frames' same-index diagonals per
    sequential step.  The scan is pinned bit-exactly to the sequential
    per-block oracle (nanohevc_tpu.ref.encode.encode_plane_closed_loop).
    """
    b, h, w = planes.shape
    src = planes.astype(jnp.int32)
    # Pad non-block-aligned planes to block multiples by edge
    # replication (the conformance-window pattern: every pixel is
    # coded, the decoder crops back to the SPS dimensions) so
    # decode(encode(x)) is pixel-exact at ANY geometry — previously
    # ragged edges kept source pixels the decoder could only zero.
    hp, wp = -(-h // n) * n, -(-w // n) * n
    if (hp, wp) != (h, w):
        src = jnp.concatenate(
            [src, jnp.broadcast_to(src[:, h - 1 : h, :], (b, hp - h, w))],
            axis=1,
        ) if hp != h else src
        src = jnp.concatenate(
            [src, jnp.broadcast_to(src[:, :, w - 1 : w], (b, hp, wp - w))],
            axis=2,
        ) if wp != w else src
    nby, nbx = hp // n, wp // n
    ndiag = nby + nbx - 1
    blocks = jax.vmap(lambda p: ops.tile_plane(p, n))(src)   # (B, nb, N, N)
    bx_t, ok_t = _skew_tables(nby, nbx)
    boundary = 1 << (bit_depth - 1)
    rep_w, rep_h = True, True   # padded planes are always block-aligned
    from nanohevc_tpu.models.all_intra import decide_modes

    bx_j, ok_j = jnp.asarray(bx_t), jnp.asarray(ok_t)
    d_j = jnp.arange(ndiag, dtype=jnp.int32)
    rd = decision == "rd"

    def step(carry, xs):
        if rd:
            s_bot, r_sp, prev_modes = carry
        else:
            s_bot, r_sp = carry
        d, bx, ok, blocks_slot = xs
        refs = _read_refs_skewed(s_bot, r_sp, d, n, nby, boundary, bx)
        mb = None
        if rd:
            # EXACT per-candidate MPM signalling cost: in skewed
            # coordinates, slot by's left neighbor (by, bx-1) was
            # decided at step d-1 in the SAME slot and its above
            # neighbor (by-1, bx) in slot by-1 — both live in the
            # previous step's decided-modes vector.  Unavailable
            # neighbors (bx == 0 <=> by == d; by == 0) read as DC,
            # the mode coder's exact conditioning
            # (runtime/entropy.py encode_modes), so the rate term
            # prices the shipped syntax with no approximation.
            from nanohevc_tpu.ops.mode_rate import mpm_mode_bits

            slot_i = jnp.arange(nby, dtype=jnp.int32)
            a_n = jnp.where(slot_i == d, 1, prev_modes)
            b_n = jnp.concatenate(
                [jnp.ones((1,), jnp.int32), prev_modes[:-1]]
            )
            mb = mpm_mode_bits(a_n, b_n)
        pred, modes = decide_modes(
            blocks_slot, refs, n, mode_set, decision,
            smoothing=intra_smoothing, bit_depth=bit_depth,
            qp=qp, use_dst=use_dst, dequant_rescale=dequant_rescale,
            mode_bits=mb,
        )
        levels, rec_blocks = _code_residual(
            blocks_slot, pred, qp, n, use_dst, bit_depth,
            dequant_rescale, rdoq=rdoq, scan=scan, modes=modes,
            rd_lambda_scale=rd_lambda_scale,
        )
        s_bot, r_sp = _write_bufs_skewed(
            s_bot, r_sp, rec_blocks, d, ok, bx, n, nby, nbx, rep_w, rep_h
        )
        new_carry = (s_bot, r_sp, modes) if rd else (s_bot, r_sp)
        return new_carry, (rec_blocks, levels, modes)

    def one_frame(frame_sk):
        init = _skew_buffers(nby, nbx, n)
        if rd:
            init = init + (jnp.ones((nby,), jnp.int32),)
        _, outs = jax.lax.scan(step, init, (d_j, bx_j, ok_j, frame_sk))
        return outs

    blocks_sk = _skew_blocks(blocks, nby, nbx)
    rec_all, levels_all, modes_all = jax.vmap(one_frame)(blocks_sk)

    # Deskew back to raster block order (pure pad+reshape, no
    # scatter), then untile/pack over the whole batch at once.
    rec_raster = _deskew_blocks(rec_all, nby, nbx)        # (B, nb, N, N)
    lev_raster = _deskew_blocks(levels_all, nby, nbx)
    modes = _deskew_blocks(modes_all, nby, nbx)           # (B, nb)
    recon = jax.vmap(lambda rc: ops.untile_plane(rc, hp, wp))(rec_raster)
    if deblock:
        # In-loop deblocking (spec 8.7.2) on the padded recon before
        # the conformance crop — an output filter only: intra
        # prediction reads the unfiltered wavefront buffers, exactly
        # the spec's intra semantics, so levels/modes are unchanged
        # and the decoder applies the identical filter for pixel-exact
        # round trips.
        recon = ops.deblock_plane(
            recon, qp, bit_depth=bit_depth, is_chroma=deblock_chroma
        )
    levels = ops.scan_pack(
        lev_raster.reshape(b * nby * nbx, n, n), scan,
        modes=modes.reshape(b * nby * nbx),
    ).reshape(b, nby * nbx, n * n)
    out = {"levels": levels, "modes": modes}
    if sao:
        # SAO (spec 8.7.3) after deblocking, estimated per frame
        # against the padded source, applied to the padded recon, and
        # signalled in a per-frame SAO NAL ((B,) type, (B,) band_pos,
        # (B, 4) offsets) so the decoder re-applies it identically.
        from nanohevc_tpu.ops.sao import apply_sao, estimate_sao

        t, pos, offs = jax.vmap(
            lambda s, r: estimate_sao(s, r, bit_depth)
        )(src, recon)
        recon = jax.vmap(
            lambda r, a, p_, o: apply_sao(r, a, p_, o, bit_depth)
        )(recon, t, pos, offs)
        out["sao"] = (t, pos, offs)
    if sao_ctb:
        # CTB-granular SAO (spec 8.7.3 grain): per-tile RD-selected
        # parameters with merge candidates, signalled per frame in a
        # bit-packed CTB-SAO NAL ((B, nty, ntx) maps).
        if sao:
            raise ValueError("sao and sao_ctb are mutually exclusive")
        from nanohevc_tpu.ops.sao_ctb import apply_sao_ctb, estimate_sao_ctb

        tm, bm, om = jax.vmap(
            lambda s, r: estimate_sao_ctb(s, r, sao_tile, qp, bit_depth)
        )(src, recon)
        recon = jax.vmap(
            lambda r, a, p_, o: apply_sao_ctb(r, a, p_, o, sao_tile,
                                              bit_depth)
        )(recon, tm, bm, om)
        out["sao_ctb"] = (tm, bm, om)
    # crop the conformance-window pad; levels/modes keep the padded
    # block geometry (the decoder re-derives it from the SPS dims)
    out["recon"] = recon[:, :h, :w]
    return out


def encode_plane_closed_loop(plane: jnp.ndarray, qp, **kwargs):
    """Single-plane wavefront encode; see encode_planes_closed_loop.

    Returns {"recon" (H, W), "levels" (nb, N*N) scan-packed raster
    order, "modes" (nb,)} - the (modes, levels) pair is sufficient for
    pixel-exact decode_plane reconstruction.
    """
    out = encode_planes_closed_loop(plane[None], qp, **kwargs)
    return {
        k: tuple(x[0] for x in v) if isinstance(v, tuple) else v[0]
        for k, v in out.items()
    }


def encode_frame_closed_loop(frame, config) -> tuple:
    """Closed-loop encode of a Frame -> (recon Frame, bitstream bytes).

    The bitstream is fully decodable to pixels by decode_frame (unlike
    the open-loop path, whose prediction a decoder cannot reproduce).
    """
    import numpy as np

    from nanohevc_tpu.frame import Frame
    from nanohevc_tpu.runtime.bitstream import assemble_bitstream

    recon = Frame.zeros(frame.height, frame.width, dtype=np.int16)
    plane_levels = {}
    plane_modes = {}
    sao_params = {}
    sao_ctb_params = {}
    for name, src, dst in (
        ("Y", frame.y, recon.y),
        ("U", frame.u, recon.u),
        ("V", frame.v, recon.v),
    ):
        is_luma = name == "Y"
        bs = config.block_size if is_luma else config.chroma_block_size()
        out = encode_plane_closed_loop(
            jnp.asarray(src.data.astype(np.int32)),
            jnp.int32(config.qp),
            n=bs,
            mode_set=config.mode_set if is_luma else config.chroma_modes(),
            decision=config.decision,
            use_dst=config.use_dst(bs, is_luma),
            bit_depth=config.bit_depth,
            scan=config.scan,
            dequant_rescale=config.dequant_rescale,
            intra_smoothing=config.intra_smoothing and is_luma,
            deblock=config.deblock,
            deblock_chroma=not is_luma,
            sao=config.sao,
            sao_ctb=config.sao_ctb,
            sao_tile=config.sao_tile,
            rdoq=config.rdoq,
        )
        dst.data[...] = np.asarray(out["recon"]).astype(np.int16)
        plane_levels[name] = (np.asarray(out["levels"]), bs)
        plane_modes[name] = np.asarray(out["modes"])
        if config.sao:
            t, pos, offs = out["sao"]
            sao_params[name] = (int(t), int(pos), np.asarray(offs))
        if config.sao_ctb:
            tm, bm, om = out["sao_ctb"]
            sao_ctb_params[name] = (
                config.sao_tile, np.asarray(tm), np.asarray(bm),
                np.asarray(om),
            )
    bitstream = assemble_bitstream(
        frame.width, frame.height, config.qp, plane_levels, plane_modes,
        bit_depth=config.bit_depth, scan=config.scan,
        dequant_rescale=config.dequant_rescale,
        intra_smoothing=config.intra_smoothing,
        entropy_coder=config.entropy_coder,
        deblock=config.deblock,
        sao=sao_params if config.sao else None,
        sao_ctb=sao_ctb_params if config.sao_ctb else None,
    )
    return recon, bitstream


def decode_frame(bitstream: bytes):
    """Pixel-exact decode of a closed-loop frame bitstream -> Frame.

    Self-contained: geometry, QP, bit depth, scan order and the
    dequant-rescale flag all come from the SPS/PPS in the stream.  The
    per-plane block size is carried by each slice header.  Non-block-
    aligned dimensions are fully coded via the encoder's edge-replicated
    padding and cropped here (conformance window), so the decode is
    pixel-exact at any geometry.
    """
    import numpy as np

    from nanohevc_tpu.frame import Frame
    from nanohevc_tpu.runtime.bitstream import _SCAN_NAME, parse_bitstream

    parsed = parse_bitstream(bitstream)
    params = parsed.get("params", {})
    if not {"width", "height", "qp"} <= params.keys():
        from nanohevc_tpu.runtime.entropy import CorruptBitstreamError

        raise CorruptBitstreamError(
            "no usable SPS/PPS in stream (not a nanohevc bitstream, or "
            "parameter sets corrupted)"
        )
    width, height, qp = params["width"], params["height"], params["qp"]
    bit_depth = 8 + params.get("bit_depth_luma_minus8", 0)
    scan = _SCAN_NAME[params.get("scan_idx", 0)]
    rescale = params.get("dequant_rescale", False)
    smoothing = params.get("intra_smoothing", False)
    deblock = params.get("deblock", False)
    sao_all = params.get("sao") or {}
    sao_ctb_all = params.get("sao_ctb") or {}
    if params.get("sao_enabled") and not (sao_all or sao_ctb_all):
        # The PPS promised per-frame SAO parameters; a stream that lost
        # its SAO NAL must fail loudly, not decode silently unfiltered.
        from nanohevc_tpu.runtime.entropy import CorruptBitstreamError

        raise CorruptBitstreamError(
            "PPS signals SAO but the frame's SAO NAL is missing "
            "(truncated or corrupted stream)"
        )
    missing = {"Y", "U", "V"} - parsed.keys()
    if missing:
        from nanohevc_tpu.runtime.entropy import CorruptBitstreamError

        raise CorruptBitstreamError(
            f"stream is missing plane slices: {sorted(missing)} "
            "(truncated, or slice NALs corrupted)"
        )
    recon = Frame.zeros(height, width, dtype=np.int16)
    for name, dst, (h, w) in (
        ("Y", recon.y, (height, width)),
        ("U", recon.u, (height // 2, width // 2)),
        ("V", recon.v, (height // 2, width // 2)),
    ):
        sl = parsed[name]
        bs = sl["block_size"]
        use_dst = name == "Y" and bs == 4
        plane = decode_plane(
            jnp.asarray(sl["levels"]),
            jnp.asarray(sl["modes"]),
            jnp.int32(sl.get("qp", qp)),   # slice qp overrides PPS
            n=bs,
            height=h,
            width=w,
            use_dst=use_dst,
            bit_depth=bit_depth,
            scan=scan,
            dequant_rescale=rescale,
            intra_smoothing=smoothing and name == "Y",  # spec: luma only
            deblock=deblock,
            is_chroma=name != "Y",
            sao=sao_all.get(name),
            sao_ctb=sao_ctb_all.get(name),
        )
        dst.data[...] = np.asarray(plane).astype(np.int16)
    return recon


@lru_cache(maxsize=None)
def _decode_planes_jit(n: int, height: int, width: int, use_dst: bool,
                       bit_depth: int, scan: str, dequant_rescale: bool,
                       intra_smoothing: bool, deblock: bool = False,
                       is_chroma: bool = False, with_sao: bool = False,
                       sao_ctb_tile: int = 0):
    """Compiled batched decoder: (B, nb, N*N), (B, nb), (B,) -> (B, H, W).

    Frames are independent, so the batch axis vmaps straight over the
    per-frame diagonal scan (per-frame qp included — rate-controlled
    sequences carry a different slice QP per frame).  One compile per
    (geometry, options, batch) serves the whole sequence decode.
    sao_ctb_tile > 0 decodes with per-frame CTB-SAO maps riding the
    batch axis (the tile size is static per stream).
    """
    import jax

    def one(levels, modes, qp, sao=None, sao_maps=None):
        return decode_plane(
            levels, modes, qp, n=n, height=height, width=width,
            use_dst=use_dst, bit_depth=bit_depth, scan=scan,
            dequant_rescale=dequant_rescale,
            intra_smoothing=intra_smoothing,
            deblock=deblock, is_chroma=is_chroma, sao=sao,
            sao_ctb=None if sao_maps is None
            else (sao_ctb_tile,) + tuple(sao_maps),
        )

    if with_sao:
        return jax.jit(jax.vmap(lambda lv, md, qp, sao: one(lv, md, qp, sao)))
    if sao_ctb_tile:
        return jax.jit(jax.vmap(
            lambda lv, md, qp, maps: one(lv, md, qp, None, maps)
        ))
    return jax.jit(jax.vmap(lambda levels, modes, qp: one(levels, modes, qp)))


def decode_planes(
    levels: jnp.ndarray,
    modes: jnp.ndarray,
    qps: jnp.ndarray,
    *,
    n: int,
    height: int,
    width: int,
    use_dst: bool = False,
    bit_depth: int = 8,
    scan: str = "diag",
    dequant_rescale: bool = False,
    intra_smoothing: bool = False,
    deblock: bool = False,
    is_chroma: bool = False,
    sao=None,
    sao_ctb=None,
) -> jnp.ndarray:
    """Batched decode_plane: (B, nb, N*N) levels + (B, nb) modes +
    (B,) per-frame QPs -> (B, H, W) reconstructions, one dispatch.

    sao, when present, is a per-frame ((B,) type, (B,) band_pos,
    (B, 4) offsets) triple riding the batch axis.  sao_ctb is
    (tile, (B, nty, ntx) type, (B, nty, ntx) band, (B, nty, ntx, 4)
    offsets) — CTB-granular maps per frame."""
    if sao is not None and sao_ctb is not None:
        raise ValueError("pass per-frame sao OR sao_ctb, not both")
    fn = _decode_planes_jit(n, height, width, use_dst, bit_depth, scan,
                            dequant_rescale, intra_smoothing,
                            deblock, is_chroma, sao is not None,
                            sao_ctb[0] if sao_ctb is not None else 0)
    if sao is not None:
        return fn(levels, modes, qps, tuple(jnp.asarray(a) for a in sao))
    if sao_ctb is not None:
        return fn(levels, modes, qps,
                  tuple(jnp.asarray(a) for a in sao_ctb[1:]))
    return fn(levels, modes, qps)


def decode_plane(
    levels: jnp.ndarray,
    modes: jnp.ndarray,
    qp,
    *,
    n: int,
    height: int,
    width: int,
    use_dst: bool = False,
    bit_depth: int = 8,
    scan: str = "diag",
    dequant_rescale: bool = False,
    intra_smoothing: bool = False,
    deblock: bool = False,
    is_chroma: bool = False,
    sao=None,
    sao_ctb=None,
) -> jnp.ndarray:
    """Pixel-exact decoder for closed-loop streams.

    (nb, N*N) scan-packed levels + (nb,) modes -> (H, W) recon, by the
    same wavefront in reverse: dequantize/inverse-transform the
    residual, predict each diagonal from the already-reconstructed
    neighbors, add, clip.  Non-block-aligned dimensions decode the
    encoder's edge-replicated padded geometry and crop back (the
    conformance window), so decode == encoder recon at any H x W.
    """
    hp, wp = -(-height // n) * n, -(-width // n) * n
    nby, nbx = hp // n, wp // n
    ndiag = nby + nbx - 1
    res_blocks = ops.inverse_transform(
        ops.dequantize(
            ops.scan_unpack(levels, scan, modes=modes), qp, n,
            rescale=dequant_rescale,
        ),
        use_dst,
    )                                                     # (nb, N, N)
    bx_t, ok_t = _skew_tables(nby, nbx)
    boundary = 1 << (bit_depth - 1)
    rep_w, rep_h = True, True   # padded geometry is block-aligned
    from nanohevc_tpu.ops.intra import predict_by_mode_mm

    res_sk = _skew_blocks(res_blocks[None], nby, nbx)[0]
    modes_sk = _skew_blocks(modes[None], nby, nbx)[0]
    bx_j, ok_j = jnp.asarray(bx_t), jnp.asarray(ok_t)
    d_j = jnp.arange(ndiag, dtype=jnp.int32)

    def step(carry, xs):
        s_bot, r_sp = carry
        d, bx, ok, res_slot, modes_slot = xs
        refs = _read_refs_skewed(s_bot, r_sp, d, n, nby, boundary, bx)
        pred = predict_by_mode_mm(
            refs, n, modes_slot, smoothing=intra_smoothing,
            bit_depth=bit_depth,
        )
        rec = jnp.clip(pred + res_slot, 0, (1 << bit_depth) - 1)
        s_bot, r_sp = _write_bufs_skewed(
            s_bot, r_sp, rec, d, ok, bx, n, nby, nbx, rep_w, rep_h
        )
        return (s_bot, r_sp), rec

    _, rec_all = jax.lax.scan(
        step, _skew_buffers(nby, nbx, n), (d_j, bx_j, ok_j, res_sk, modes_sk)
    )
    rec_raster = _deskew_blocks(rec_all[None], nby, nbx)[0]
    plane = ops.untile_plane(rec_raster, hp, wp)
    if deblock:
        # mirror of the encoder's padded-recon filtering (8.7.2): the
        # wavefront above predicted from unfiltered samples, so this
        # reproduces the encoder's output plane exactly
        plane = ops.deblock_plane(
            plane, qp, bit_depth=bit_depth, is_chroma=is_chroma
        )
    if sao is not None:
        # sao = (type_idx, band_pos, offsets[4]) from the frame's SAO
        # NAL, applied after deblocking (spec 8.7.3 stage order)
        from nanohevc_tpu.ops.sao import apply_sao

        plane = apply_sao(plane, sao[0], sao[1], sao[2], bit_depth)
    if sao_ctb is not None:
        # sao_ctb = (tile, type_map, band_map, off_map) from the
        # CTB-SAO NAL; the encoder applied the same padded-domain
        # filter, so round trips stay pixel-exact
        from nanohevc_tpu.ops.sao_ctb import apply_sao_ctb

        tile, tm, bm, om = sao_ctb
        plane = apply_sao_ctb(
            plane, jnp.asarray(tm), jnp.asarray(bm), jnp.asarray(om),
            tile, bit_depth,
        )
    return plane[:height, :width]
