"""Benchmark: all-intra encode throughput on one GPU, multi-config.

Rows, each timed separately and gated on bit-exactness:
  flagship      1080p luma, 8x8 dc_planar/energy open-loop full pipeline
                (BASELINE.json north star); gate: 256 sampled blocks
                against the per-block numpy oracle.
  mode8         1080p luma, 35-mode SATD search, 8x8; same gate.
  mode4         1080p luma, 35-mode SATD search at 4x4 with DST-VII (the
                HEVC 4x4 luma intra rule); same gate.
  closed_loop_35  1080p closed-loop (reconstruction-fed) 35-mode SATD
                search, 8x8, batch 8; gate: pixel-exact decode_plane
                round trip.
  closed_loop_35_16  the same at 16x16.
  wavefront     1080p closed-loop dc_planar, 8x8, batch 32; same gate.
  sequence      24-frame 1080p closed-loop sequence to a real bitstream
                (device + host entropy + NAL write), decode-verified,
                plus two A/Bs: loop-filters+spec-CABAC on/off cost, and
                entropy tiles 4 vs 1.
  yuv           1080p 4:2:0 frame (Y 8x8 + U/V 4x4 chroma).
  uhd_4k        2160x3840 luma, 8x8 dc_planar.

Every row runs the XLA path on the GPU; the script refuses to run on
any other backend.  Each timed loop ends in block_until_ready, and
each row reports its first-batch (compile) seconds apart.

Output: one JSON line after every row (the newest line is complete);
the top-level metric/value is the flagship row and the full row set
rides in "rows":
  {"metric": ..., "value": Mpix/s, "unit": "Mpix/s", "vs_baseline": x,
   "device": {...}, "rows": [{"metric": ..., "value": ...,
   "unit": "Mpix/s", "bit_exact": true, "compile_s": ...}, ...]}

vs_baseline is the speedup over the reference's measured full-pipeline
rate of ~0.10 Mpix/s on one CPU core (BASELINE.md).
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time

import numpy as np

BASELINE_MPIX_S = 0.10  # reference full per-block pipeline, BASELINE.md
H, W, QP = 1080, 1920, 22
UHD_H, UHD_W = 2160, 3840
SEQ_FRAMES = 24
FLAGSHIP_METRIC = (
    "1080p all-intra luma full pipeline (predict+DCT+Q+IQ+recon), 1 GPU"
)


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def cumulative_json(rows: list, device: dict) -> str:
    flag = next((r for r in rows if r["label"] == "flagship"), None)
    out_rows = [{k: v for k, v in r.items() if k != "label"} for r in rows]
    if not all(r.get("bit_exact", True) for r in rows):
        return json.dumps({
            "metric": "BIT-EXACTNESS FAILURE", "value": 0.0,
            "unit": "Mpix/s", "vs_baseline": 0.0, "device": device,
            "rows": out_rows,
        })
    v = float(flag["value"]) if flag else 0.0
    return json.dumps({
        "metric": FLAGSHIP_METRIC,
        "value": round(v, 1),
        "unit": "Mpix/s",
        "vs_baseline": round(v / BASELINE_MPIX_S, 1),
        "device": device,
        "rows": out_rows,
    })


# --------------------------------------------------------------------------
# Shared measurement helpers
# --------------------------------------------------------------------------

def time_batch(batch_fn, frames, pixels_per_iter, target_s, label):
    """Repeat `batch_fn(frames)` for ~target_s -> (Mpix/s, compile_s)."""
    import jax

    t0 = time.perf_counter()
    jax.block_until_ready(batch_fn(frames))
    compile_s = time.perf_counter() - t0
    log(f"[{label}] compile+first batch: {compile_s:.1f}s")

    iters = 2
    while True:
        t0 = time.perf_counter()
        for _ in range(iters):
            out = batch_fn(frames)
        jax.block_until_ready(out)
        dt = time.perf_counter() - t0
        log(f"[{label}] {iters} batches: {dt:.3f}s wall")
        if dt > target_s or iters >= 4096:
            break
        iters = min(iters * 4,
                    max(iters + 1, int(iters * target_s * 1.1 / max(dt, 1e-3))))
    mpix_s = pixels_per_iter * iters / dt / 1e6
    log(f"[{label}] -> {mpix_s:.1f} Mpix/s")
    return mpix_s, compile_s


def oracle_gate(plane, host_plane, n, height, width, **kw) -> float:
    """% of 256 sampled blocks matching the per-block numpy oracle
    (nanohevc_tpu.ref.encode.open_loop_block) bit-for-bit."""
    import jax
    import jax.numpy as jnp

    from nanohevc_tpu import ops
    from nanohevc_tpu.models.all_intra import encode_plane_full
    from nanohevc_tpu.ref.encode import open_loop_block

    rng = np.random.default_rng(0)
    nbx = width // n
    sample = rng.choice((height // n) * nbx, size=256, replace=False)
    idx = jnp.asarray(sample)
    decision = "energy" if kw.get("mode_set", "dc_planar") == "dc_planar" else "satd"

    @jax.jit
    def run_and_gather(p):
        out = encode_plane_full(p, jnp.int32(QP), n=n, decision=decision, **kw)
        levels = ops.scan_unpack(out["levels"], modes=out["modes"])
        return levels[idx], ops.tile_plane(out["recon"], n)[idx], out["modes"][idx]

    levels_s, recon_s, modes_s = (np.asarray(a) for a in run_and_gather(plane))
    bad = 0
    for k, b in enumerate(sample):
        by, bx = divmod(int(b), nbx)
        rec, lvl, mode = open_loop_block(host_plane, n, QP, by, bx, **kw)
        if not (np.array_equal(lvl, levels_s[k]) and np.array_equal(rec, recon_s[k])
                and mode == modes_s[k]):
            bad += 1
    return 100.0 * (len(sample) - bad) / len(sample)


def decode_gate(out, n) -> bool:
    """Frame 0 of a closed-loop batch decodes pixel-exactly."""
    import jax
    import jax.numpy as jnp

    from nanohevc_tpu.models.wavefront import decode_plane

    dec = jax.jit(lambda lv, md: decode_plane(
        lv, md, jnp.int32(QP), n=n, height=H, width=W
    ))(out["levels"][0], out["modes"][0])
    return bool(jnp.array_equal(dec, out["recon"][0]))


class Ctx:
    """Lazy shared inputs so rows only build what they use."""

    def __init__(self):
        self._cache = {}

    def _get(self, key, builder):
        if key not in self._cache:
            self._cache[key] = builder()
        return self._cache[key]

    @property
    def host_plane(self):
        return self._get("host_plane", lambda: np.random.default_rng(0)
                         .integers(0, 256, (H, W)).astype(np.int32))

    @property
    def plane(self):
        import jax.numpy as jnp

        return self._get("plane", lambda: jnp.asarray(self.host_plane))

    def frames(self, k):
        import jax.numpy as jnp

        return self._get(("frames", k), lambda: jnp.stack([self.plane] * k))


# --------------------------------------------------------------------------
# Rows. Each returns {"metric", "value", "unit", "bit_exact", "compile_s"}.
# --------------------------------------------------------------------------

def open_loop_row(metric, label, n, k, **kw):
    def run(ctx):
        import jax
        import jax.numpy as jnp

        from nanohevc_tpu.models.all_intra import encode_plane_full

        decision = "energy" if kw.get("mode_set", "dc_planar") == "dc_planar" else "satd"
        fn = jax.jit(jax.vmap(lambda p: encode_plane_full(
            p, jnp.int32(QP), n=n, decision=decision, **kw)))
        v, c = time_batch(fn, ctx.frames(k), H * W * k, 3.0, label)
        pct = oracle_gate(ctx.plane, ctx.host_plane, n, H, W, **kw)
        log(f"[{label}] oracle gate: {pct:.1f}% of 256 blocks")
        return {"metric": metric, "value": round(v, 1), "unit": "Mpix/s",
                "bit_exact": pct == 100.0, "compile_s": round(c, 1)}

    return run


def closed_loop_row(metric, label, n, k, **kw):
    def run(ctx):
        import jax
        import jax.numpy as jnp

        from nanohevc_tpu.models.wavefront import encode_planes_closed_loop

        fn = jax.jit(lambda ps: encode_planes_closed_loop(
            ps, jnp.int32(QP), n=n, **kw))
        v, c = time_batch(fn, ctx.frames(k), H * W * k, 3.0, label)
        ok = decode_gate(fn(ctx.frames(k)), n)
        return {"metric": metric, "value": round(v, 1), "unit": "Mpix/s",
                "bit_exact": ok, "compile_s": round(c, 1)}

    return run


def row_sequence(ctx):
    """BASELINE config 5: 24-frame 1080p sequence, device encode + host
    entropy + bitstream write, END-TO-END Mpix/s (wall clock from raw
    YUV file to finished bitstream, everything included).

    Closed-loop so the stream is pixel-exactly decodable; the gate
    decodes 2 sampled frames against an independent re-encode.  Two
    8-frame A/Bs ride along: (a) loop filters + spec CABAC on vs off;
    (b) entropy tiles 4 vs 1 (host entropy parallelism)."""
    import jax.numpy as jnp

    from nanohevc_tpu.config import EncoderConfig
    from nanohevc_tpu.frame import Frame
    from nanohevc_tpu.models.sequence import (
        decode_sequence_levels,
        encode_sequence,
    )
    from nanohevc_tpu.models.wavefront import (
        decode_plane,
        encode_frame_closed_loop,
    )

    num_frames = SEQ_FRAMES
    rng = np.random.default_rng(7)
    yy, xx = np.mgrid[0:H, 0:W]
    frame_bytes = H * W * 3 // 2
    with tempfile.TemporaryDirectory(prefix="nhseq_") as tmp:
        src_path = os.path.join(tmp, "in.yuv")
        bs_path = os.path.join(tmp, "out.bin")
        log("[sequence] generating source...")
        with open(src_path, "wb") as f:
            for i in range(num_frames):
                y = (128 + 80 * np.sin(xx / 19 + i * 0.3) * np.cos(yy / 23)
                     + rng.normal(0, 6, (H, W)))
                u = np.full((H // 2, W // 2), 128, np.uint8)
                f.write(np.clip(y, 0, 255).astype(np.uint8).tobytes())
                f.write(u.tobytes())
                f.write(u.tobytes())
        config = EncoderConfig(block_size=8, qp=30)

        # Warm the jitted encode/compact programs on one batch first, so
        # the end-to-end wall measures the encoder, not the compile.
        log("[sequence] warmup batch (compile)...")
        t0 = time.perf_counter()
        encode_sequence(
            src_path, W, H, min(8, num_frames), config,
            os.path.join(tmp, "warm.bin"), batch=8, resume=False,
            closed_loop=True,
        )
        compile_s = time.perf_counter() - t0
        log(f"[sequence] warmup done in {compile_s:.1f}s")

        log("[sequence] encoding...")
        t0 = time.perf_counter()
        res = encode_sequence(
            src_path, W, H, num_frames, config, bs_path,
            batch=8, resume=False, closed_loop=True,
        )
        dt = time.perf_counter() - t0
        mpix = num_frames * H * W * 1.5 / dt / 1e6
        stage_s = {
            k: round(v["total_s"], 3)
            for k, v in res.stats.items()
            if isinstance(v, dict) and "total_s" in v
        }
        log(f"[sequence] {num_frames} frames in {dt:.2f}s end-to-end "
            f"-> {mpix:.1f} Mpix/s (YUV pixels, host entropy included); "
            f"stages {stage_s}")

        # decode-verify gate: 2 sampled frames decode == independent
        # closed-loop re-encode of the same source frames
        frames_lv = decode_sequence_levels(bs_path)
        ok = len(frames_lv) == num_frames
        for fi in (0, num_frames - 1):
            if not ok:
                break
            with open(src_path, "rb") as f:
                f.seek(fi * frame_bytes)
                fr = Frame.from_yuv420p(f.read(frame_bytes), H, W)
            recon, _ = encode_frame_closed_loop(fr, config)
            sl = frames_lv[fi]["Y"]
            got = decode_plane(
                jnp.asarray(sl["levels"]), jnp.asarray(sl["modes"]),
                jnp.int32(sl.get("qp", config.qp)),
                n=config.block_size, height=H, width=W, scan=config.scan,
            )
            ok = np.array_equal(np.asarray(got), recon.y.data.astype(np.int32))
            if not ok:
                log(f"[sequence] decode-verify FAILED at frame {fi}")

        # A/B 1: deblock+SAO+spec-CABAC on vs off, 8-frame re-encodes
        ab_n = min(8, num_frames)
        feats = {}
        for name, cfg in (
            ("off", config),
            ("on", EncoderConfig(block_size=8, qp=30, deblock=True, sao=True,
                                 entropy_coder="cabac")),
        ):
            # warm THIS config's jits untimed (the encoder jit cache makes
            # repeat configs free; "off" reuses the main run's programs)
            encode_sequence(src_path, W, H, ab_n, cfg,
                            os.path.join(tmp, f"feat_{name}_warm.bin"),
                            batch=8, resume=False, closed_loop=True)
            t0 = time.perf_counter()
            r = encode_sequence(src_path, W, H, ab_n, cfg,
                                os.path.join(tmp, f"feat_{name}.bin"),
                                batch=8, resume=False, closed_loop=True)
            feats[name] = (time.perf_counter() - t0, int(r.bytes_written))
        feat_speed = feats["off"][0] / max(feats["on"][0], 1e-9)
        feat_bpp = feats["on"][1] / max(feats["off"][1], 1e-9)
        log(f"[sequence] features A/B ({ab_n} frames): on runs at "
            f"{feat_speed:.2f}x of off's speed, {feat_bpp:.2f}x bytes")

        # A/B 2: entropy tiles (host entropy parallelism)
        ab = {}
        for tiles in (1, 4):
            t0 = time.perf_counter()
            encode_sequence(
                src_path, W, H, ab_n, config,
                os.path.join(tmp, f"ab{tiles}.bin"),
                batch=8, resume=False, closed_loop=True, entropy_tiles=tiles,
            )
            ab[tiles] = time.perf_counter() - t0
        ratio = ab[1] / max(ab[4], 1e-9)
        log(f"[sequence] entropy-tiles A/B ({ab_n} frames): speedup {ratio:.2f}x")
    return {
        "metric": f"{num_frames}-frame {H}p sequence end-to-end "
                  "(device + host entropy + bitstream, closed loop)",
        "value": round(mpix, 1),
        "unit": "Mpix/s",
        "bit_exact": bool(ok),
        "compile_s": round(compile_s, 1),
        "coded_bytes": int(res.bytes_written),
        "stage_seconds": stage_s,
        "features_on_speed_ratio": round(feat_speed, 2),
        "features_on_bytes_ratio": round(feat_bpp, 2),
        "entropy_tiles4_speedup": round(ratio, 2),
    }


def row_yuv(ctx):
    import jax
    import jax.numpy as jnp

    from nanohevc_tpu.models.all_intra import encode_plane_full

    rng = np.random.default_rng(1)
    u = jnp.asarray(rng.integers(0, 256, (H // 2, W // 2)).astype(np.int32))
    v = jnp.asarray(rng.integers(0, 256, (H // 2, W // 2)).astype(np.int32))

    def yuv_one(y, u, v):
        return tuple(encode_plane_full(p, jnp.int32(QP), n=n)["recon"]
                     for p, n in ((y, 8), (u, 4), (v, 4)))

    yuv_fn = jax.jit(jax.vmap(yuv_one))
    yuv_frames = (ctx.frames(16), jnp.stack([u] * 16), jnp.stack([v] * 16))
    val, c = time_batch(lambda t: yuv_fn(*t), yuv_frames,
                        int(H * W * 1.5) * 16, 3.0, "yuv")
    pct = oracle_gate(ctx.plane, ctx.host_plane, 8, H, W)
    return {
        "metric": "1080p 4:2:0 YUV frame (Y 8x8 + UV 4x4)",
        "value": round(val, 1), "unit": "Mpix/s", "bit_exact": pct == 100.0,
        "compile_s": round(c, 1),
    }


def row_4k(ctx):
    import jax
    import jax.numpy as jnp

    from nanohevc_tpu.models.all_intra import encode_plane_full

    host_4k = np.random.default_rng(0).integers(
        0, 256, (UHD_H, UHD_W)
    ).astype(np.int32)
    p4k = jnp.asarray(host_4k)
    fn = jax.jit(jax.vmap(lambda p: encode_plane_full(p, jnp.int32(QP), n=8)))
    v, c = time_batch(fn, jnp.stack([p4k] * 8), UHD_H * UHD_W * 8, 3.0, "4k")
    pct = oracle_gate(p4k, host_4k, 8, UHD_H, UHD_W)
    log(f"[4k] oracle gate: {pct:.1f}% of 256 blocks")
    return {
        "metric": "4K (2160x3840) luma 8x8 dc_planar full pipeline",
        "value": round(v, 1), "unit": "Mpix/s", "bit_exact": pct == 100.0,
        "compile_s": round(c, 1),
    }


ROWS = [
    ("flagship", open_loop_row(
        "1080p luma 8x8 dc_planar full pipeline", "flagship", 8, 32)),
    ("mode8", open_loop_row(
        "1080p luma 35-mode SATD search, 8x8", "mode8", 8, 8,
        mode_set="all")),
    ("mode4", open_loop_row(
        "1080p luma 35-mode SATD search, 4x4 DST-VII", "mode4", 4, 4,
        mode_set="all", use_dst=True)),
    ("closed_loop_35", closed_loop_row(
        "1080p closed-loop 35-mode SATD search, 8x8, batch 8",
        "closed_loop_35", 8, 8, mode_set="all", decision="satd")),
    ("wavefront", closed_loop_row(
        "1080p closed-loop wavefront (reconstruction-fed), 8x8, batch 32",
        "wavefront", 8, 32)),
    ("sequence", row_sequence),
    ("closed_loop_35_16", closed_loop_row(
        "1080p closed-loop 35-mode SATD search, 16x16, batch 8",
        "closed_loop_35_16", 16, 8, mode_set="all", decision="satd")),
    ("yuv", row_yuv),
    ("uhd_4k", row_4k),
]


def main() -> None:
    import jax

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from nanohevc_tpu.utils.compile_cache import enable_compile_cache

    if jax.default_backend() != "gpu":
        raise SystemExit(f"bench.py measures the GPU; JAX found "
                         f"{jax.default_backend()!r}")
    enable_compile_cache()
    dev = jax.devices()[0]
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices())}
    log(f"backend: {jax.devices()}")
    ctx = Ctx()
    rows = []
    for label, fn in ROWS:
        t0 = time.perf_counter()
        row = fn(ctx)
        row["label"] = label
        row["seconds"] = round(time.perf_counter() - t0, 1)
        log(f"[{label}] done in {row['seconds']}s, "
            f"bit_exact={row.get('bit_exact')}")
        rows.append(row)
        print(cumulative_json(rows, device), flush=True)
    if not all(r.get("bit_exact", True) for r in rows):
        sys.exit(3)  # distinct from a crash (1): gate failure


if __name__ == "__main__":
    main()
