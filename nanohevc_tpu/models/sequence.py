"""Multi-frame sequence encoder with checkpoint/resume.

BASELINE config 5's shape: a YUV420p sequence is encoded in device
batches (vmapped/sharded over frames), levels stream to the host
entropy stage, and the bitstream grows one access unit per frame:

  [VPS][SPS][PPS]  then per frame:  [AUD(frame_idx)][slice Y][U][V]

Checkpoint/resume (SURVEY §5): frames are embarrassingly restartable,
so resume state is just (frames_done, bytes_written) in a JSON sidecar
next to the bitstream; restart truncates any partial tail and
continues from the next frame.  The reference has no persistence
beyond raw YUV I/O (frame.py:88-115).
"""

from __future__ import annotations

import functools
import json
import os
import struct
import time
from dataclasses import dataclass
from typing import Dict, Iterator, List

import numpy as np

from nanohevc_tpu.config import EncoderConfig
from nanohevc_tpu.utils.tracing import Stopwatch, throughput_stats

NAL_AUD = 35


@functools.lru_cache(maxsize=1)
def _transfer_jits():
    """Shared device-side transfer helpers (compact header, int8 modes,
    uint8->int32 widen), jitted once per process."""
    import jax
    import jax.numpy as jnp

    from nanohevc_tpu.ops.sparse import compact_levels

    return (
        jax.jit(compact_levels),
        jax.jit(lambda m: m.astype(jnp.int8)),
        jax.jit(lambda p: p.astype(jnp.int32)),
    )


def _read_frames(path: str, width: int, height: int, start: int, count: int
                 ) -> Iterator[tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Yield (Y, U, V) uint8 planes for frames [start, start+count)."""
    fs = width * height * 3 // 2
    ys = width * height
    us = (width // 2) * (height // 2)
    with open(path, "rb") as f:
        f.seek(start * fs)
        for _ in range(count):
            buf = f.read(fs)
            if len(buf) < fs:
                return
            y = np.frombuffer(buf, np.uint8, ys).reshape(height, width)
            u = np.frombuffer(buf, np.uint8, us, ys).reshape(height // 2, width // 2)
            v = np.frombuffer(buf, np.uint8, us, ys + us).reshape(height // 2, width // 2)
            yield y, u, v


def _load_progress(
    progress_path: str, bitstream_path: str
) -> tuple[int, int, int | None]:
    """(frames_done, valid_bytes, qp) from the sidecar; (0, 0, None) if
    invalid.  qp is the rate-control state at checkpoint time (None for
    fixed-QP runs or older sidecars)."""
    try:
        with open(progress_path) as f:
            p = json.load(f)
        size = os.path.getsize(bitstream_path)
        if p["bytes_written"] <= size:
            saved_qp = p.get("qp")
            return (
                int(p["frames_done"]),
                int(p["bytes_written"]),
                int(saved_qp) if saved_qp is not None else None,
            )
    except (OSError, KeyError, ValueError):
        pass
    return 0, 0, None


@dataclass
class SequenceResult:
    frames: int
    resumed_from: int
    bytes_written: int
    mean_psnr_y: float
    stats: dict


def encode_sequence(
    input_path: str,
    width: int,
    height: int,
    num_frames: int,
    config: EncoderConfig,
    bitstream_path: str,
    *,
    batch: int = 8,
    resume: bool = True,
    mesh=None,
    report_every: int = 0,
    closed_loop: bool = False,
    target_bpp: float | None = None,
    entropy_tiles: int = 1,
) -> SequenceResult:
    """Encode `num_frames` frames of a YUV420p file to a bitstream.

    closed_loop=True uses the reconstruction-fed wavefront encoder, so
    the resulting stream is pixel-exactly decodable (decode_sequence);
    open loop (default) matches reference semantics and is much faster.

    target_bpp enables one-pass rate control: a RateController
    (models/rate_control.py) adjusts QP between batches to average
    `target_bpp` bits per luma pixel; per-slice qp fields carry the
    schedule to the decoder.  config.qp seeds the controller.  Rate
    control keeps the dispatch/drain software pipeline with one batch
    of lag (batch i's coded size sets batch i+2's QP — i+1 is already
    in flight when i drains); QP is a traced argument, so every QP
    shares one compiled program.
    """
    import jax
    import jax.numpy as jnp

    from nanohevc_tpu.ops.sparse import fetch_levels
    from nanohevc_tpu.parallel.sharding import make_batch_encoder
    from nanohevc_tpu.runtime import entropy
    from nanohevc_tpu.runtime.bitstream import assemble_bitstream

    if (config.deblock or config.sao or config.sao_ctb) and not closed_loop:
        # the signalled filters would make the decoder transform a
        # reconstruction the open-loop encoder never produced — refuse
        raise ValueError("config.deblock/config.sao/config.sao_ctb "
                         "require closed_loop=True (in-loop filters on "
                         "the decodable recon)")

    if closed_loop:
        if mesh is not None and batch % mesh.shape["frame"]:
            # Sharded closed loop: frames spread over the mesh's
            # 'frame' axis (zero communication — the wavefront
            # recurrence is intra-frame); the luma batch and the
            # 2*batch chroma stack must divide that axis.
            raise ValueError(
                f"closed-loop sequence batch {batch} must be a "
                f"multiple of the mesh 'frame' axis ({mesh.shape['frame']})"
            )
        from nanohevc_tpu.parallel.sharding import make_closed_loop_encoder

        luma_fn = make_closed_loop_encoder(config, mesh, is_luma=True)
        chroma_fn = make_closed_loop_encoder(config, mesh, is_luma=False)
    else:
        luma_fn = make_batch_encoder(config, mesh, is_luma=True)
        chroma_fn = make_batch_encoder(config, mesh, is_luma=False)

    progress_path = bitstream_path + ".progress"
    start, valid_bytes, saved_qp = (0, 0, None)
    if resume:
        start, valid_bytes, saved_qp = _load_progress(
            progress_path, bitstream_path
        )
    start = min(start, num_frames)

    controller = None
    cur_qp = config.qp
    if target_bpp is not None:
        from nanohevc_tpu.models.rate_control import RateController

        if start > 0 and saved_qp is not None:
            cur_qp = saved_qp           # resume the controller state
        controller = RateController(
            target_bits=target_bpp * width * height * batch,
            qp=cur_qp,
        )

    from nanohevc_tpu.runtime.bitstream import _SCAN_IDX

    def _params(which: int) -> bytes:
        from nanohevc_tpu.runtime.bitstream import _ENTROPY_IDX

        return entropy.write_params(
            width, height, config.block_size, config.qp, which,
            bit_depth=config.bit_depth, scan_idx=_SCAN_IDX[config.scan],
            rescale_flag=int(config.dequant_rescale),
            smoothing_flag=int(config.intra_smoothing),
            entropy_idx=_ENTROPY_IDX[config.entropy_coder],
            deblock_flag=int(config.deblock),
            mode_mpm_flag=1,  # per-frame slices code modes with MPM
            # every frame must then carry its SAO NAL or fail decode
            sao_flag=int(config.sao or config.sao_ctb),
        )

    sw = Stopwatch()
    psnrs: List[float] = []
    mode_flags = "r+b" if (start > 0 and os.path.exists(bitstream_path)) else "wb"
    t_run = time.perf_counter()
    with open(bitstream_path, mode_flags) as out:
        if start > 0:
            out.truncate(valid_bytes)
            out.seek(valid_bytes)
        else:
            header = (
                entropy.wrap_nal(entropy.NAL_VPS, _params(0))
                + entropy.wrap_nal(entropy.NAL_SPS, _params(1))
                + entropy.wrap_nal(entropy.NAL_PPS, _params(2))
            )
            out.write(header)

        # Device->host bytes are kept small: only the occupied SCAN
        # PREFIX of the level tensor is fetched, as int16 (ops/sparse.py;
        # an 8-byte device header names the prefix); modes shrink to
        # int8 (0-34).  Uploads ride as uint8 and widen on device for
        # the same reason.
        _compact, _to_i8, _widen = _transfer_jits()

        def dispatch(first: int):
            """Load + enqueue one device batch; returns pending handle."""
            take = min(batch, num_frames - first)
            with sw.time("load"):
                planes = list(_read_frames(input_path, width, height, first, take))
            if not planes:
                return None
            take = len(planes)
            # pad ragged tail batches to the full batch size so every
            # device call shares one compiled program
            padded = planes + [planes[-1]] * (batch - take)
            ys = np.stack([p[0] for p in padded])          # uint8
            uvs = np.stack(
                [p[1] for p in padded] + [p[2] for p in padded]
            )
            qp_dev = jnp.int32(cur_qp)
            with sw.time("dispatch"):
                y_out = dict(luma_fn(_widen(jnp.asarray(ys)), qp_dev))
                c_out = dict(chroma_fn(_widen(jnp.asarray(uvs)), qp_dev))
                for o in (y_out, c_out):     # async enqueue, like the encode
                    o["levels_sparse"] = _compact(o["levels"])
                    o["modes8"] = _to_i8(o["modes"])
            return first, take, cur_qp, y_out, c_out

        def drain(pending) -> int:
            """Fetch a finished batch, entropy-code it, append, checkpoint."""
            nonlocal cur_qp
            first, take, batch_qp, y_out, c_out = pending
            with sw.time("fetch"):
                y_levels = fetch_levels(
                    y_out["levels_sparse"], y_out["levels"].shape,
                    dense=y_out["levels"],
                )[:take]
                y_modes = np.asarray(y_out["modes8"], np.int32)[:take]
                c_levels = fetch_levels(
                    c_out["levels_sparse"], c_out["levels"].shape,
                    dense=c_out["levels"],
                )
                c_modes = np.asarray(c_out["modes8"], np.int32)
                psnrs.extend(float(v) for v in np.asarray(y_out["psnr"])[:take])
                y_sao = c_sao = y_ctb = c_ctb = None
                if config.sao:
                    y_sao = tuple(np.asarray(a) for a in y_out["sao"])
                    c_sao = tuple(np.asarray(a) for a in c_out["sao"])
                if config.sao_ctb:
                    y_ctb = tuple(np.asarray(a) for a in y_out["sao_ctb"])
                    c_ctb = tuple(np.asarray(a) for a in c_out["sao_ctb"])
            batch_bytes = 0
            with sw.time("entropy"):
                cb = config.chroma_block_size()
                for i in range(take):
                    aud = entropy.wrap_nal(NAL_AUD, struct.pack("<I", first + i))
                    sao_i = sao_ctb_i = None
                    if config.sao:
                        sao_i = {
                            "Y": tuple(a[i] for a in y_sao),
                            "U": tuple(a[i] for a in c_sao),
                            "V": tuple(a[batch + i] for a in c_sao),
                        }
                    if config.sao_ctb:
                        t_ = config.sao_tile
                        sao_ctb_i = {
                            "Y": (t_,) + tuple(a[i] for a in y_ctb),
                            "U": (t_,) + tuple(a[i] for a in c_ctb),
                            "V": (t_,) + tuple(a[batch + i] for a in c_ctb),
                        }
                    frame_bs = assemble_bitstream(
                        width,
                        height,
                        batch_qp,
                        {
                            "Y": (y_levels[i], config.block_size),
                            "U": (c_levels[i], cb),
                            "V": (c_levels[batch + i], cb),
                        },
                        {
                            "Y": y_modes[i],
                            "U": c_modes[i],
                            "V": c_modes[batch + i],
                        },
                        scan=config.scan,
                        entropy_tiles=entropy_tiles,
                        entropy_coder=config.entropy_coder,
                        sao=sao_i,
                        sao_ctb=sao_ctb_i,
                    )
                    # assemble_bitstream repeats parameter sets per call;
                    # strip them here (sequence carries one global set)
                    frame_bs = _strip_param_sets(frame_bs)
                    out.write(aud + frame_bs)
                    batch_bytes += len(aud) + len(frame_bs)
            if controller is not None and take == batch:
                cur_qp = controller.update(batch_bytes * 8)
            out.flush()
            with open(progress_path, "w") as pf:
                json.dump(
                    {"frames_done": first + take, "bytes_written": out.tell(),
                     "qp": cur_qp}, pf
                )
            if report_every and (first + take - start) % report_every == 0:
                print(f"  frame {first + take}/{num_frames}", flush=True)
            return first + take

        done = start
        # Software pipeline: batch i+1 is enqueued on device before
        # batch i's results are fetched and entropy-coded on the
        # host, so the sequential entropy stage overlaps device
        # compute.  Rate control rides the SAME pipeline with one
        # batch of lag: batch i's coded size (known at drain time)
        # sets the QP of batch i+2 — batch i+1 was already in flight
        # with the previous QP when i drained.  Feedback is delayed by
        # one batch; the device never idles (round-4 verdict item 10;
        # accuracy cost measured in tests/test_rate_control.py).
        pending = dispatch(done) if done < num_frames else None
        if controller is not None and pending is not None:
            # Prime the feedback loop: drain the first batch before
            # enqueueing the second, so a badly-seeded QP is corrected
            # after ONE batch; only the steady state carries the
            # one-batch lag (the device idles exactly once, at start).
            done = drain(pending)
            pending = dispatch(done) if done < num_frames else None
        while pending is not None:
            nxt_first = pending[0] + pending[1]
            nxt = dispatch(nxt_first) if nxt_first < num_frames else None
            done = drain(pending)
            pending = nxt

        bytes_written = out.tell()

    wall = time.perf_counter() - t_run
    stats = sw.report()
    stats["throughput"] = throughput_stats(
        (done - start) * width * height * 3 // 2, wall
    )
    if controller is not None and done > start:
        stats["rate_control"] = {
            "target_bpp": target_bpp,
            "achieved_bpp": (bytes_written - valid_bytes) * 8
            / ((done - start) * width * height),
            "qp_start": config.qp if start == 0 or saved_qp is None else saved_qp,
            "qp_final": cur_qp,
        }
    return SequenceResult(
        frames=done,
        resumed_from=start,
        bytes_written=bytes_written,
        mean_psnr_y=float(np.mean(psnrs)) if psnrs else float("nan"),
        stats=stats,
    )


def _strip_param_sets(frame_bs: bytes) -> bytes:
    """Drop VPS/SPS/PPS NALs from a single-frame bitstream blob."""
    from nanohevc_tpu.runtime.bitstream import _split_nals
    from nanohevc_tpu.runtime import entropy

    out = []
    # re-wrap surviving NALs (payloads round-trip through unescape/escape)
    for nal_type, payload in _split_nals(frame_bs):
        if nal_type in (32, 33, 34):
            continue
        out.append(entropy.wrap_nal(nal_type, payload))
    return b"".join(out)


def decode_sequence(bitstream_path: str, output_path: str) -> int:
    """Pixel-exact decode of a closed-loop sequence bitstream to YUV420p.

    Geometry and QP come from the stream's parameter sets.  Returns the
    number of frames written.  (Streams produced with closed_loop=False
    parse but do not decode to the encoder's pixels — open-loop
    prediction reads source neighbors a decoder does not have.)
    """
    import jax.numpy as jnp
    import numpy as np

    from nanohevc_tpu.models.wavefront import decode_plane, decode_planes
    from nanohevc_tpu.runtime.bitstream import _split_nals, parse_params
    from nanohevc_tpu.runtime import entropy as E

    with open(bitstream_path, "rb") as f:
        data = f.read()
    params: dict = {}
    for nal_type, payload in _split_nals(data):
        if nal_type in (E.NAL_SPS, E.NAL_PPS):
            try:
                params.update(parse_params(payload))
            except ValueError:
                continue            # skip corrupted parameter sets
    if not {"width", "height", "qp"} <= params.keys():
        from nanohevc_tpu.runtime.entropy import CorruptBitstreamError

        raise CorruptBitstreamError(
            "no usable SPS/PPS in sequence stream (not a nanohevc "
            "bitstream, or parameter sets corrupted)"
        )
    width, height, qp = params["width"], params["height"], params["qp"]
    from nanohevc_tpu.runtime.bitstream import _SCAN_NAME

    bit_depth = 8 + params.get("bit_depth_luma_minus8", 0)
    scan = _SCAN_NAME[params.get("scan_idx", 0)]
    rescale = params.get("dequant_rescale", False)
    smoothing = params.get("intra_smoothing", False)
    deblock = params.get("deblock", False)

    frames = decode_sequence_levels(bitstream_path)
    n_written = 0
    dt = np.uint8 if bit_depth <= 8 else np.dtype("<u2")
    batch = 8
    with open(output_path, "wb") as out:
        for b0 in range(0, len(frames), batch):
            chunk = frames[b0 : b0 + batch]
            for fi, fr in enumerate(chunk):
                p = fr.get("params", {})
                if p.get("sao_enabled") and not (
                    p.get("sao") or p.get("sao_ctb")
                ):
                    # the global PPS promised per-frame SAO; a frame
                    # whose SAO NAL was dropped must fail loudly
                    from nanohevc_tpu.runtime.entropy import (
                        CorruptBitstreamError,
                    )

                    raise CorruptBitstreamError(
                        f"PPS signals SAO but frame {b0 + fi} has no "
                        "SAO NAL (truncated or corrupted stream)"
                    )
            # One vmapped dispatch per plane kind per chunk (frames are
            # independent; per-frame slice QP rides the batch) — the
            # frame-by-frame eager decode re-dispatched 3 * n_frames
            # unjitted diagonal scans.
            planes_out = {}
            for name, (h, w) in (
                ("Y", (height, width)),
                ("U", (height // 2, width // 2)),
                ("V", (height // 2, width // 2)),
            ):
                sls = [fr[name] for fr in chunk]
                # per-frame SAO params from each access unit's SAO NAL;
                # frames without one get type 0 (identity) so the batch
                # still decodes in one dispatch
                saos = [
                    fr.get("params", {}).get("sao", {}).get(name)
                    for fr in chunk
                ]
                sao_b = None
                if any(s is not None for s in saos):
                    off = (0, 0, np.zeros(4, np.int32))
                    filled = [s if s is not None else off for s in saos]
                    sao_b = (
                        np.array([s[0] for s in filled], np.int32),
                        np.array([s[1] for s in filled], np.int32),
                        np.stack([np.asarray(s[2], np.int32)
                                  for s in filled]),
                    )
                # CTB-granular SAO maps per frame (tile from the NAL;
                # all-off maps fill frames without one, e.g. when only
                # some planes carry CTB params)
                ctbs = [
                    fr.get("params", {}).get("sao_ctb", {}).get(name)
                    for fr in chunk
                ]
                sao_ctb_b = None
                if any(c is not None for c in ctbs):
                    tile_c = next(c[0] for c in ctbs if c is not None)
                    shape = next(
                        np.asarray(c[1]).shape for c in ctbs
                        if c is not None
                    )
                    zero = (tile_c, np.zeros(shape, np.int32),
                            np.zeros(shape, np.int32),
                            np.zeros(shape + (4,), np.int32))
                    fc = [c if c is not None else zero for c in ctbs]
                    sao_ctb_b = (
                        tile_c,
                        np.stack([np.asarray(c[1], np.int32) for c in fc]),
                        np.stack([np.asarray(c[2], np.int32) for c in fc]),
                        np.stack([np.asarray(c[3], np.int32) for c in fc]),
                    )
                bs = sls[0]["block_size"]
                if any(s["block_size"] != bs for s in sls):
                    # mixed per-slice block sizes: decode singly
                    planes_out[name] = [
                        np.asarray(decode_plane(
                            jnp.asarray(s["levels"]), jnp.asarray(s["modes"]),
                            jnp.int32(s.get("qp", qp)), n=s["block_size"],
                            height=h, width=w,
                            use_dst=(name == "Y" and s["block_size"] == 4),
                            bit_depth=bit_depth, scan=scan,
                            dequant_rescale=rescale,
                            intra_smoothing=smoothing and name == "Y",
                            deblock=deblock, is_chroma=name != "Y",
                            sao=None if sao_b is None else tuple(
                                jnp.asarray(a[j]) for a in sao_b
                            ),
                            sao_ctb=None if sao_ctb_b is None else (
                                sao_ctb_b[0],
                            ) + tuple(a[j] for a in sao_ctb_b[1:]),
                        )) for j, s in enumerate(sls)
                    ]
                    continue
                recon = decode_planes(
                    jnp.asarray(np.stack([s["levels"] for s in sls])),
                    jnp.asarray(np.stack([s["modes"] for s in sls])),
                    jnp.asarray([s.get("qp", qp) for s in sls], jnp.int32),
                    n=bs, height=h, width=w,
                    use_dst=(name == "Y" and bs == 4),
                    bit_depth=bit_depth, scan=scan,
                    dequant_rescale=rescale,
                    intra_smoothing=smoothing and name == "Y",
                    deblock=deblock, is_chroma=name != "Y",
                    sao=sao_b,
                    sao_ctb=sao_ctb_b,
                )
                planes_out[name] = list(np.asarray(recon).astype(dt))
            for i in range(len(chunk)):
                for name in ("Y", "U", "V"):
                    out.write(np.asarray(planes_out[name][i], dtype=dt).tobytes())
                n_written += 1
    return n_written


def decode_sequence_levels(bitstream_path: str) -> List[Dict[str, dict]]:
    """Parse a sequence bitstream back to per-frame plane level dicts."""
    from nanohevc_tpu.runtime.bitstream import _split_nals, parse_bitstream
    from nanohevc_tpu.runtime import entropy as E

    with open(bitstream_path, "rb") as f:
        data = f.read()

    # split into access units on AUD NALs; the sequence's single global
    # parameter-set group is replayed in front of every frame so each
    # parse sees the SPS geometry bound and the PPS entropy/scan flags
    frames: List[Dict[str, dict]] = []
    current: List[bytes] = []
    param_nals: List[bytes] = []
    for nal_type, payload in _split_nals(data):
        if nal_type == NAL_AUD:
            if current:
                frames.append(
                    parse_bitstream(b"".join(param_nals + current))
                )
            current = []
        elif nal_type in (E.NAL_VPS, E.NAL_SPS, E.NAL_PPS):
            param_nals.append(E.wrap_nal(nal_type, payload))
        elif nal_type in (E.NAL_SLICE, E.NAL_SAO):
            # SAO parameters are per-frame: they ride each access unit
            current.append(E.wrap_nal(nal_type, payload))
    if current:
        frames.append(parse_bitstream(b"".join(param_nals + current)))
    return frames
