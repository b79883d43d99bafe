"""All-intra encoder pipelines over the blocked frame tensor.

Two pipelines, both jitted whole-plane graphs (no per-block loops):

- `encode_plane_parity`: the reference CLI's predict-only encode —
  DC vs planar decided by residual energy, best prediction written to
  the reconstruction (parity: /root/reference/nano_hevc/__main__.py:
  142-189, including neighbors-from-source and clip-before-write).

- `encode_plane_full`: the complete front-half — mode search (DC+planar
  or all 35 modes), predict -> residual -> forward transform -> quantize
  -> scan-pack (for the host entropy stage) -> dequantize -> inverse
  transform -> reconstruct -> clip.  This is the chain the reference
  only exercises in tests/README (SURVEY §3.3), here as one fused
  device graph.

Mode numbering: 0 planar, 1 DC, 2..34 angular.
"""

from __future__ import annotations

from functools import lru_cache, partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from nanohevc_tpu.config import EncoderConfig
from nanohevc_tpu.frame import Frame, Plane
from nanohevc_tpu import ops
from nanohevc_tpu.ops.intra import DC_MODE, PLANAR_MODE


# ---------------------------------------------------------------------------
# Mode decision
# ---------------------------------------------------------------------------

def _cost(blocks: jnp.ndarray, pred: jnp.ndarray, decision: str) -> jnp.ndarray:
    if decision == "energy":
        return ops.residual_energy_blocks(blocks - pred)
    if decision == "satd":
        return ops.satd_blocks(blocks, pred)
    return ops.sad_blocks(blocks, pred)


def _rd_lambda(qp, rd_lambda_scale: float) -> jnp.ndarray:
    """HEVC-style lambda(QP) = 0.57 * 2^((QP-12)/3), scaled.

    One definition shared by the mode decision, the cbf decision and
    the mode-rate term so every RD mechanism prices bits identically.
    """
    return rd_lambda_scale * 0.57 * jnp.exp2(
        (jnp.asarray(qp, jnp.float32) - 12.0) / 3.0
    )


def _rd_costs(
    blocks: jnp.ndarray,
    preds: jnp.ndarray,
    n: int,
    qp,
    use_dst: bool,
    bit_depth: int,
    dequant_rescale: bool,
    rd_lambda_scale: float,
) -> jnp.ndarray:
    """True rate-distortion cost per (block, candidate mode).

    blocks (nb, N, N); preds (nb, M, N, N) -> (nb, M) float32 costs
    SSE + lambda(QP) * bits, where each candidate's residual is pushed
    through the real transform/quant/recon chain and its rate comes
    from the calibrated device rate model (ops/rate.py, tracks the
    shipped range coder).  lambda is the HEVC-style
    0.57 * 2^((QP-12)/3) scaled by rd_lambda_scale — the same
    operating point the rdo_cbf decision uses, so the two RD
    mechanisms compose consistently.
    """
    nb, m = preds.shape[:2]
    flat_pred = preds.reshape(nb * m, n, n)
    res = (blocks[:, None] - preds).reshape(nb * m, n, n)
    levels = ops.quantize(ops.forward_transform(res, use_dst), qp, n, True)
    rec_res = ops.inverse_transform(
        ops.dequantize(levels, qp, n, rescale=dequant_rescale), use_dst
    )
    recon = jnp.clip(flat_pred + rec_res, 0, (1 << bit_depth) - 1)
    blk = jnp.broadcast_to(blocks[:, None], preds.shape).reshape(nb * m, n, n)
    diff = (blk - recon).astype(jnp.float32)
    sse = (diff * diff).sum(axis=(1, 2))
    bits = ops.rate_model_bits_adaptive(ops.scan_pack(levels, "diag"))
    lam = _rd_lambda(qp, rd_lambda_scale)
    return (sse + lam * bits).reshape(nb, m)


def decide_modes(
    blocks: jnp.ndarray,
    refs: jnp.ndarray,
    n: int,
    mode_set: str,
    decision: str,
    smoothing: bool = False,
    bit_depth: int = 8,
    qp=None,
    use_dst: bool = False,
    dequant_rescale: bool = False,
    rd_lambda_scale: float = 1.0,
    grid: Tuple[int, int] | None = None,
    mode_bits: jnp.ndarray | None = None,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Pick the best intra mode per block.

    Returns (pred (nb,N,N), mode_idx (nb,)).  For "dc_planar", ties go
    to DC (parity: __main__.py:173-179).  For "all", ties go to the
    lowest mode index (argmin).  The 35-mode search runs as a running
    minimum over per-mode predictions, so peak memory stays O(nb*N^2)
    instead of O(nb*35*N^2).

    smoothing applies the spec's [1 2 1] reference-sample filter
    (8.4.4.2.3) to the modes its filter-flag rule selects (DC never,
    nothing at 4x4); the reference implementation has no smoothing at
    all, so this is opt-in and off by default for parity.

    decision="rd" replaces the prediction-error proxy with the true RD
    cost SSE + lambda(QP) * bits per candidate (each mode's residual
    through the real transform/quant/recon chain, rate from the
    calibrated coder model) — requires qp; use_dst/dequant_rescale
    must match the pipeline so the measured distortion is the real
    one.  Costlier than SATD (full chain x 35) but fully batched.

    grid=(nby, nbx) (the raster block-grid shape) additionally charges
    each candidate its MPM signalling cost lambda * mode_bits
    (ops/mode_rate.py: 2/3/6 static bins per spec 8.4.2.2 — the term
    the bitstream's mode coder actually spends, runtime/entropy.py
    encode_modes).  Two passes: pass 1 decides on SSE + lambda *
    level_bits alone, pass 2 derives each block's MPM list from its
    pass-1 left/above neighbors and re-decides with the mode-rate
    term included — the standard one-step RDO approximation for an
    all-at-once open-loop decision.  decision="rd" only.

    mode_bits=(nb, 35) float32 charges an EXACT per-candidate mode-rate
    term lambda * mode_bits instead (mutually exclusive with grid):
    the closed-loop wavefront passes it, computed from the true
    already-decided neighbor modes its sequential scan carries — no
    two-pass approximation needed there.
    """
    from nanohevc_tpu.ops.intra import mode_filter_flags

    if decision == "rd" and qp is None:
        raise ValueError("decision='rd' needs qp at decide_modes()")
    flags = mode_filter_flags(n) if smoothing else None
    refs_f = (
        ops.smooth_refs(refs, n, bit_depth) if smoothing and n > 4 else refs
    )
    dc = ops.dc_predict(refs, n)                 # DC always unfiltered
    pl = ops.planar_predict(
        refs_f if (flags is not None and flags[PLANAR_MODE]) else refs, n
    )

    if mode_set in ("dc", "planar"):
        # Fixed single mode — no search, no cost evaluation.  The 4:2:0
        # standard-stream export uses this for chroma: the spec codes
        # ONE intra_chroma_pred_mode per CU covering both components,
        # and DC/planar are always representable (in the 8.4.3
        # candidate list, or via DM when the luma mode equals them).
        nb = blocks.shape[0]
        if mode_set == "dc":
            return dc, jnp.full((nb,), DC_MODE, jnp.int32)
        return pl, jnp.full((nb,), PLANAR_MODE, jnp.int32)

    def rd(preds):
        return _rd_costs(
            blocks, preds, n, qp, use_dst, bit_depth, dequant_rescale,
            rd_lambda_scale,
        )

    if decision == "rd":
        both = rd(jnp.stack([dc, pl], axis=1))
        cost_dc, cost_pl = both[:, 0], both[:, 1]
    else:
        cost_dc = _cost(blocks, dc, decision)
        cost_pl = _cost(blocks, pl, decision)

    if mode_set == "dc_planar":
        if decision == "rd" and (grid is not None or mode_bits is not None):
            lam = _rd_lambda(qp, rd_lambda_scale)
            if mode_bits is None:
                from nanohevc_tpu.ops.mode_rate import mode_bits_for_grid

                p1 = jnp.where(cost_dc <= cost_pl, DC_MODE, PLANAR_MODE)
                mode_bits = mode_bits_for_grid(
                    p1.astype(jnp.int32).reshape(grid)
                )
            cost_dc = cost_dc + lam * mode_bits[:, DC_MODE]
            cost_pl = cost_pl + lam * mode_bits[:, PLANAR_MODE]
        dc_wins = cost_dc <= cost_pl
        pred = jnp.where(dc_wins[:, None, None], dc, pl)
        mode = jnp.where(dc_wins, DC_MODE, PLANAR_MODE).astype(jnp.int32)
        return pred, mode

    # 35-mode search, fully batched: all 33 angular predictions come
    # from ONE einsum against the stacked per-mode weight matrices,
    # costs are evaluated with a mode axis, and the winner is applied
    # by a one-hot matmul — no gathers anywhere.
    from nanohevc_tpu.ops.angular_tables import angular_weight_matrices
    from nanohevc_tpu.ops.intra import cat_weight_matrices

    nb = refs.shape[0]
    if smoothing and n > 4:
        # each mode's weights live in the raw or the filtered half of
        # the doubled refs vector per its static filter flag
        refs_in = jnp.concatenate([refs, refs_f], axis=1)
        w_host = cat_weight_matrices(n)                  # (33, 2R, N*N)
    else:
        refs_in = refs
        w_host = angular_weight_matrices(n)              # (33, R, N*N)
    w_all = jnp.asarray(
        w_host.transpose(1, 0, 2).reshape(w_host.shape[1], -1)
    )                                                    # (R', 33*N*N)
    preds_flat = (
        (
            jnp.einsum("br,rq->bq", refs_in, w_all,
                       preferred_element_type=jnp.int32)
            + 16
        )
        >> 5
    ).astype(jnp.int16)   # predictions fit int16; halves the HBM tensor
    preds = preds_flat.reshape(nb, 33, n, n)
    if decision == "rd":
        costs_ang = rd(preds.astype(jnp.int32))
    else:
        costs_ang = _cost(blocks[:, None], preds.astype(jnp.int32), decision)

    costs = jnp.concatenate(
        [cost_pl[:, None], cost_dc[:, None], costs_ang], axis=1
    )                                                    # (nb, 35); idx = mode
    if decision == "rd" and (grid is not None or mode_bits is not None):
        lam = _rd_lambda(qp, rd_lambda_scale)
        if mode_bits is None:
            from nanohevc_tpu.ops.mode_rate import mode_bits_for_grid

            p1 = jnp.argmin(costs, axis=1).astype(jnp.int32)
            mode_bits = mode_bits_for_grid(p1.reshape(grid))
        costs = costs + lam * mode_bits
    best_mode = jnp.argmin(costs, axis=1).astype(jnp.int32)  # ties -> lowest
    onehot = jax.nn.one_hot(best_mode - 2, 33, dtype=jnp.int32)
    best_ang = jnp.einsum(
        "bm,bmq->bq", onehot, preds.reshape(nb, 33, n * n),
        preferred_element_type=jnp.int32,
    ).reshape(nb, n, n)
    sel = best_mode[:, None, None]
    best_pred = jnp.where(
        sel == PLANAR_MODE, pl, jnp.where(sel == DC_MODE, dc, best_ang)
    )
    return best_pred, best_mode


# ---------------------------------------------------------------------------
# Plane pipelines (pure jnp graphs; jitted via the cached wrappers below)
# ---------------------------------------------------------------------------

def _clip(x: jnp.ndarray, bit_depth: int) -> jnp.ndarray:
    return jnp.clip(x, 0, (1 << bit_depth) - 1)


def encode_plane_parity(
    plane: jnp.ndarray, n: int, bit_depth: int = 8
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Predict-only encode of one plane (reference CLI semantics).

    (H, W) int -> (recon (H, W) int32 with zero-filled dropped edges,
    dc_wins (nb,) bool).
    """
    h, w = plane.shape
    blocks = ops.tile_plane(plane.astype(jnp.int32), n)
    refs = ops.extract_refs(plane, n)
    pred, mode = decide_modes(blocks, refs, n, "dc_planar", "energy")
    recon = ops.untile_plane(_clip(pred, bit_depth), h, w)
    return recon, mode == DC_MODE


def encode_plane_full(
    plane: jnp.ndarray,
    qp,
    *,
    n: int,
    mode_set: str = "dc_planar",
    decision: str = "energy",
    use_dst: bool = False,
    is_intra: bool = True,
    bit_depth: int = 8,
    scan: str = "diag",
    rdo_cbf: bool = False,
    rdoq: bool = False,
    dequant_rescale: bool = False,
    rate_mode: str = "coder",
    rd_lambda_scale: float = 1.0,
    intra_smoothing: bool = False,
):
    """Full front-half encode of one plane.

    rdoq enables rate-distortion optimized quantization (ops/rdoq.py):
    levels are re-decided under D + lambda * R before reconstruction.
    Encoder-only — streams stay decodable by the unchanged decoder.
    The reference has no RDOQ (plain deadzone, its quant.py:41-79).

    rdo_cbf enables a rate-distortion coded-block decision: a block's
    residual is dropped (all levels zeroed, recon = clipped prediction)
    when coding it is not worth its rate, i.e. when
    SSE(skip) <= SSE(coded) + lambda(QP) * rate_bits with the
    HEVC-style lambda = 0.57 * 2^((QP-12)/3).  Off by default
    (reference parity).  rate_mode picks the rate source:
    "coder" (default) uses the device rate model calibrated against
    the shipped range coder (ops/rate.py, tracks nhr_block_bits);
    "heuristic" keeps the reference-style sum(log2(|l|+1)) + 2*nnz
    estimate (its quant.py:153-168) for A/B comparison.
    rd_lambda_scale multiplies lambda — the rate-control knob: 1.0
    optimizes fidelity-weighted cost; larger values trade PSNR for
    bitrate (at 1.0 this codec's distortion scale puts the cbf
    boundary far from the rate term, so scales >> 1 are where rate
    accuracy decides).

    Returns dict of device arrays:
      recon  (H, W)   reconstructed plane (dropped edges copy the source,
                      so frame metrics reflect coded area only)
      levels (nb, N*N) scan-ordered quantized levels (host entropy input)
      modes  (nb,)    chosen intra mode per block
      nnz    (nb,)    non-zero level count per block
    """
    h, w = plane.shape
    src = plane.astype(jnp.int32)
    blocks = ops.tile_plane(src, n)
    # HEVC boundary fill is 1 << (bit_depth - 1); 128 at 8-bit (parity)
    refs = ops.extract_refs(src, n, boundary=1 << (bit_depth - 1))
    pred, modes = decide_modes(
        blocks, refs, n, mode_set, decision, smoothing=intra_smoothing,
        bit_depth=bit_depth, qp=qp, use_dst=use_dst,
        dequant_rescale=dequant_rescale, rd_lambda_scale=rd_lambda_scale,
        grid=(h // n, w // n),
    )
    res = blocks - pred
    coeff = ops.forward_transform(res, use_dst)
    levels = ops.quantize(coeff, qp, n, is_intra)
    if rdoq:
        # RD-optimal level adjustment in scan domain (encoder-only:
        # the decoder dequantizes whatever levels arrive).  Lambda is
        # calibrated to the codec's true quantization step — the
        # nominal HEVC formula barely binds at this coefficient scale.
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
    rec_res = ops.inverse_transform(deq, use_dst)
    recon_blocks = _clip(pred + rec_res, bit_depth)

    if not rdoq:
        packed = ops.scan_pack(levels, scan, modes=modes)
    if rdo_cbf:
        pred_clip = _clip(pred, bit_depth)
        d_coded = ops.residual_energy_blocks(blocks - recon_blocks)
        d_skip = ops.residual_energy_blocks(blocks - pred_clip)
        # rates follow the coder's scan-positional contexts -> feed the
        # scan-packed levels, not the raster layout
        if rate_mode == "coder":
            rate = ops.rate_model_bits_adaptive(packed)
        else:
            rate = ops.estimate_bits_blocks(levels)
        lam = _rd_lambda(qp, rd_lambda_scale)
        skip = d_skip.astype(jnp.float32) <= d_coded.astype(jnp.float32) + lam * rate
        levels = jnp.where(skip[:, None, None], 0, levels)
        packed = jnp.where(skip[:, None], 0, packed)
        recon_blocks = jnp.where(skip[:, None, None], pred_clip, recon_blocks)

    recon = ops.untile_plane(recon_blocks, h, w)
    nby, nbx = h // n, w // n
    if nby * n != h or nbx * n != w:
        # keep uncoded edge pixels = source so PSNR measures coded loss
        mask = jnp.zeros((h, w), dtype=bool).at[: nby * n, : nbx * n].set(True)
        recon = jnp.where(mask, recon, src)
    return {
        "recon": recon,
        "levels": packed,
        "modes": modes,
        "nnz": (packed != 0).sum(axis=1),
    }


@lru_cache(maxsize=None)
def _jit_parity(n: int, bit_depth: int):
    return jax.jit(partial(encode_plane_parity, n=n, bit_depth=bit_depth))


@lru_cache(maxsize=None)
def _jit_full(n: int, mode_set: str, decision: str, use_dst: bool,
              is_intra: bool, bit_depth: int, scan: str,
              rdo_cbf: bool = False, dequant_rescale: bool = False,
              intra_smoothing: bool = False, rdoq: bool = False):
    return jax.jit(
        partial(
            encode_plane_full,
            n=n,
            mode_set=mode_set,
            decision=decision,
            use_dst=use_dst,
            is_intra=is_intra,
            bit_depth=bit_depth,
            scan=scan,
            rdo_cbf=rdo_cbf,
            rdoq=rdoq,
            dequant_rescale=dequant_rescale,
            intra_smoothing=intra_smoothing,
        )
    )


# ---------------------------------------------------------------------------
# Frame-level host wrappers
# ---------------------------------------------------------------------------

def encode_frame_intra(
    frame: Frame, block_size: int, output_path: str | None = None
) -> Tuple[Frame, dict]:
    """Predict-only frame encode, reference-CLI compatible.

    Y uses block_size; U/V use block_size//2 floored at 4
    (parity: __main__.py:151-158).  Returns (recon Frame, stats dict
    with "dc"/"planar"/"blocks" counts summed over all planes).
    """
    recon = Frame.zeros(frame.height, frame.width, dtype=np.int16)
    stats = {"dc": 0, "planar": 0, "blocks": 0}
    chroma_bs = max(4, block_size // 2)
    for name, src, dst in (
        ("Y", frame.y, recon.y),
        ("U", frame.u, recon.u),
        ("V", frame.v, recon.v),
    ):
        bs = block_size if name == "Y" else chroma_bs
        rec, dc_wins = _jit_parity(bs, 8)(jnp.asarray(src.data))
        dst.data[...] = np.asarray(rec).astype(np.int16)
        dc = int(np.asarray(dc_wins).sum())
        nb = int(dc_wins.shape[0])
        stats["dc"] += dc
        stats["planar"] += nb - dc
        stats["blocks"] += nb
    if output_path:
        with open(output_path, "wb") as f:
            f.write(recon.to_yuv420p())
    return recon, stats


def encode_frame_full(frame: Frame, config: EncoderConfig) -> Tuple[Frame, dict]:
    """Full front-half frame encode under an EncoderConfig.

    Returns (recon Frame, info dict with per-plane levels/modes plus
    summary stats: psnr_y, nnz, estimated bits).
    """
    recon = Frame.zeros(frame.height, frame.width, dtype=np.int16)
    info = {"planes": {}, "blocks": 0}
    for name, src, dst in (
        ("Y", frame.y, recon.y),
        ("U", frame.u, recon.u),
        ("V", frame.v, recon.v),
    ):
        is_luma = name == "Y"
        bs = config.block_size if is_luma else config.chroma_block_size()
        fn = _jit_full(
            bs,
            config.mode_set if is_luma else config.chroma_modes(),
            config.decision,
            config.use_dst(bs, is_luma),
            config.is_intra,
            config.bit_depth,
            config.scan,
            config.rdo_cbf,
            config.dequant_rescale,
            config.intra_smoothing and is_luma,  # spec: luma only
            config.rdoq,
        )
        out = fn(jnp.asarray(src.data), jnp.int32(config.qp))
        dst.data[...] = np.asarray(out["recon"]).astype(np.int16)
        info["planes"][name] = {
            "levels": np.asarray(out["levels"]),
            "modes": np.asarray(out["modes"]),
            "nnz": int(np.asarray(out["nnz"]).sum()),
            "block_size": bs,
        }
        info["blocks"] += int(out["modes"].shape[0])
    from nanohevc_tpu.ref.metrics import psnr as psnr_host
    from nanohevc_tpu.ref.metrics import ssim as ssim_host

    orig_y = frame.y.data.astype(np.uint8)
    rec_y = recon.y.data.astype(np.uint8)
    info["psnr_y"] = psnr_host(orig_y, rec_y)
    info["ssim_y"] = ssim_host(orig_y, rec_y)
    return recon, info


# ---------------------------------------------------------------------------
# Demo utilities
# ---------------------------------------------------------------------------

def create_test_frame(height: int, width: int) -> Frame:
    """Synthetic 4-quadrant test frame (parity: __main__.py:26-53).

    Quadrants: horizontal gradient / vertical gradient / flat 128 /
    diagonal ramp min(255, 50+i+j).  Vectorized numpy.
    """
    h2, w2 = height // 2, width // 2
    y = np.empty((height, width), dtype=np.uint8)
    y[:h2, :w2] = np.tile(np.linspace(50, 200, w2, dtype=np.uint8), (h2, 1))
    y[:h2, w2:] = np.tile(
        np.linspace(50, 200, h2, dtype=np.uint8).reshape(-1, 1), (1, width - w2)
    )
    y[h2:, :w2] = 128
    i = np.arange(height - h2).reshape(-1, 1)
    j = np.arange(width - w2).reshape(1, -1)
    y[h2:, w2:] = np.minimum(255, 50 + i + j).astype(np.uint8)
    u = np.full((h2, w2), 128, dtype=np.uint8)
    v = np.full((h2, w2), 128, dtype=np.uint8)
    return Frame(
        Plane(y.astype(np.int16)), Plane(u.astype(np.int16)), Plane(v.astype(np.int16))
    )
