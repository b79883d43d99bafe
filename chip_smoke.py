"""Smoke test: the encoder's main path, run natively on a GPU.

    python chip_smoke.py [--seed N]     # one GPU: phases 1-4
    python chip_smoke.py --multi        # four GPUs: the sharded paths only

Run it from the root of a checkout.  Everything runs in this one
process, which is the only one to use the card; the CLI is called
in-process.  A phase that fails raises, and the script exits non-zero
without printing a result.

1. Device: JAX's default backend must be a GPU.
2. Main path at 1080p through the CLI: a 16-frame 8-bit 4:2:0 sequence
   made from the seed goes through `encode-seq --closed-loop
   --mode-search` twice (with the standard-stream export; with
   deblocking, CTB SAO and CABAC), and each container stream is decoded
   and checked pixel-exact against the encoder's own reconstruction.
   One frame also goes through `encode --pipeline full --mode-search`
   and `encode --pipeline closed-loop`.
3. Parity on the card: (a) the closed- and open-loop programs on the
   GPU against the same programs on the host CPU backend, (b) the
   closed loop against the sequential numpy oracle, (c) the open-loop
   pipeline against the per-block oracle on 256 sampled 1080p blocks.
   Integer outputs must be bit-equal.
4. A timing line: frames/s and Mpix/s of each phase-2 encode.
5. With --multi, only: the closed-loop sequence sharded over four
   cards must give the one-card bitstream byte for byte, and the
   open-loop batch encoder with rows split over two cards must equal
   the unsharded one.

The last line of stdout is one JSON object,
{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

W, H, FRAMES, BATCH, QP = 1920, 1080, 16, 8, 27
SEQ = ["--width", str(W), "--height", str(H)]
# The main path: closed loop, 35-mode SATD search, 8x8 luma / 4x4 chroma.
MAIN = SEQ + ["--frames", str(FRAMES), "--closed-loop", "--mode-search",
              "--batch", str(BATCH), "--qp", str(QP), "--no-resume"]
# PSNR is a float32 mean over ~2M squared errors; the GPU sums in
# another order than the CPU, so the two may differ in the last bits.
PSNR_TOL_DB = 1e-3


def log(*args) -> None:
    print(*args, flush=True)


def device_phase():
    """Phase 1: require a GPU; print the devices and the card's limits."""
    import jax

    backend = jax.default_backend()
    if backend != "gpu":
        raise SystemExit(f"chip_smoke: needs a GPU, JAX found {backend!r}")
    log(f"devices: {jax.devices()}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    for line in smi.splitlines():
        log(f"card: {line}")
    return smi.splitlines()[0]


def make_sequence(path: str, seed: int) -> None:
    """16 frames of smooth gradients and sinusoids with mild texture."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    cy, cx = yy[::2, ::2], xx[::2, ::2]
    with open(path, "wb") as f:
        for i in range(FRAMES):
            ph = rng.uniform(0, 2 * np.pi, 4)
            y = (60 + 0.05 * xx + 0.04 * yy
                 + 45 * np.sin(xx / 53 + ph[0] + 0.2 * i) * np.cos(yy / 71 + ph[1])
                 + rng.normal(0, 3, (H, W)))
            u = 128 + 24 * np.sin(cx / 97 + ph[2]) + rng.normal(0, 1.5, cx.shape)
            v = 128 + 24 * np.cos(cy / 83 + ph[3]) + rng.normal(0, 1.5, cy.shape)
            for p in (y, u, v):
                f.write(np.clip(np.rint(p), 0, 255).astype(np.uint8).tobytes())


def read_frames(path: str, count: int):
    """(Y (F, H, W), U (F, H/2, W/2), V) uint8 arrays of a YUV420p file."""
    ys, cs = H * W, (H // 2) * (W // 2)
    raw = np.fromfile(path, np.uint8, count * (ys + 2 * cs))
    raw = raw.reshape(count, ys + 2 * cs)
    return (raw[:, :ys].reshape(count, H, W),
            raw[:, ys:ys + cs].reshape(count, H // 2, W // 2),
            raw[:, ys + cs:].reshape(count, H // 2, W // 2))


def timed_cli(argv) -> float:
    from nanohevc_tpu.cli import main as cli_main

    t0 = time.perf_counter()
    cli_main(list(argv))
    return time.perf_counter() - t0


def encoder_recon(src: str, config):
    """The closed-loop encoder's own reconstruction of every frame, from
    the jitted programs encode_sequence runs (cached on the config)."""
    import jax.numpy as jnp

    from nanohevc_tpu.parallel import make_closed_loop_encoder

    y, u, v = read_frames(src, FRAMES)
    luma = make_closed_loop_encoder(config, is_luma=True)
    chroma = make_closed_loop_encoder(config, is_luma=False)
    out = []
    for b0 in range(0, FRAMES, BATCH):
        sl = slice(b0, b0 + BATCH)
        ry = luma(jnp.asarray(y[sl], jnp.int32), jnp.int32(QP))["recon"]
        rc = chroma(jnp.asarray(np.concatenate([u[sl], v[sl]]), jnp.int32),
                    jnp.int32(QP))["recon"]
        out.append((np.asarray(ry), np.asarray(rc[:BATCH]),
                    np.asarray(rc[BATCH:])))
    return tuple(np.concatenate([o[k] for o in out]) for k in range(3))


def check_decode(bitstream: str, decoded: str, recon) -> None:
    timed_cli(["decode", bitstream, "-o", decoded])
    got = read_frames(decoded, FRAMES)
    for name, g, r in zip("YUV", got, recon):
        if not np.array_equal(g.astype(np.int32), r):
            bad = int((g.astype(np.int32) != r).any(axis=(1, 2)).sum())
            raise AssertionError(
                f"{bitstream}: decoded {name} differs from the encoder's "
                f"recon in {bad} of {FRAMES} frames"
            )
    log(f"decode {os.path.basename(bitstream)}: {FRAMES} frames pixel-exact")


def main_path_phase(tmp: str, src: str):
    """Phase 2: the CLI at 1080p; returns the timing of each encode."""
    from nanohevc_tpu.config import EncoderConfig

    runs = {
        "export": (["--hevc-export", os.path.join(tmp, "a.hevc")],
                   EncoderConfig(block_size=8, qp=QP, mode_set="all",
                                 decision="satd", chroma_mode_set="dc")),
        "filters_cabac": (["--deblock", "--sao-ctb", "--entropy", "cabac"],
                          EncoderConfig(block_size=8, qp=QP, mode_set="all",
                                        decision="satd", deblock=True,
                                        sao_ctb=True, entropy_coder="cabac")),
    }
    timing = {}
    for name, (extra, config) in runs.items():
        bs = os.path.join(tmp, f"{name}.bin")
        argv = ["encode-seq", src, *MAIN, *extra, "--bitstream", bs]
        cold = timed_cli(argv)              # compiles, then encodes
        warm = timed_cli(argv)              # the same programs, cached
        timing[name] = {
            "frames_per_s": FRAMES / warm,
            "mpix_per_s": FRAMES * W * H / warm / 1e6,
            "encode_s": warm,
            "compile_s": max(cold - warm, 0.0),
            "bytes": os.path.getsize(bs),
        }
        check_decode(bs, os.path.join(tmp, f"{name}.yuv"),
                     encoder_recon(src, config))
    with open(os.path.join(tmp, "a.hevc"), "rb") as f:
        if f.read(4) != b"\x00\x00\x00\x01":
            raise AssertionError("HEVC export does not start with an "
                                 "Annex B start code")

    # One frame through the former single-frame routes.
    full_rec = os.path.join(tmp, "full_rec.yuv")
    timed_cli(["encode", src, *SEQ, "--pipeline", "full", "--mode-search",
               "--qp", str(QP), "-o", full_rec])
    cl_rec, cl_bs = os.path.join(tmp, "cl_rec.yuv"), os.path.join(tmp, "cl.bin")
    cl_dec = os.path.join(tmp, "cl_dec.yuv")
    timed_cli(["encode", src, *SEQ, "--pipeline", "closed-loop",
               "--qp", str(QP), "-o", cl_rec, "--bitstream", cl_bs])
    timed_cli(["decode", cl_bs, "-o", cl_dec])
    with open(cl_rec, "rb") as a, open(cl_dec, "rb") as b:
        if a.read() != b.read():
            raise AssertionError("encode --pipeline closed-loop: decode "
                                 "differs from the encoder's recon")
    log("encode --pipeline closed-loop: 1 frame decodes pixel-exact")
    return timing, full_rec


def parity_phase(src: str, full_rec: str) -> None:
    """Phase 3: the GPU against the CPU backend and the numpy oracles."""
    import jax
    import jax.numpy as jnp

    from nanohevc_tpu import ops
    from nanohevc_tpu.models.all_intra import encode_plane_full
    from nanohevc_tpu.models.wavefront import encode_planes_closed_loop
    from nanohevc_tpu.ops.sao_ctb import estimate_sao_ctb
    from nanohevc_tpu.ref.encode import encode_plane_closed_loop, open_loop_block

    gpu, cpu = jax.devices()[0], jax.devices("cpu")[0]
    y, u, v = (p[0].astype(np.int32) for p in read_frames(src, 1))
    search = dict(mode_set="all", decision="satd")
    closed = {n: jax.jit(lambda p, q, n=n: encode_planes_closed_loop(
        p[None], q, n=n, **search)) for n in (4, 8)}
    opened = {n: jax.jit(lambda p, q, n=n: encode_plane_full(
        p, q, n=n, **search)) for n in (4, 8)}

    # (a) the same programs on the GPU and on the host CPU backend
    gpu_open = {}
    for name, plane, n in (("Y", y, 8), ("U", u, 4), ("V", v, 4)):
        for kind, fns in (("closed", closed), ("open", opened)):
            outs = {}
            for role, dev in (("gpu", gpu), ("cpu", cpu)):
                o = fns[n](jax.device_put(plane, dev),
                           jax.device_put(jnp.int32(QP), dev))
                outs[role] = {k: np.asarray(o[k]).reshape(-1)
                              for k in ("recon", "levels", "modes")}
                outs[role]["psnr"] = float(ops.psnr(
                    jax.device_put(plane, dev),
                    jnp.reshape(o["recon"], plane.shape)))
            g, c = outs["gpu"], outs["cpu"]
            for k in ("recon", "levels", "modes"):
                if not np.array_equal(g[k], c[k]):
                    raise AssertionError(f"(a) {kind} {name} {k}: GPU != CPU")
            if abs(g["psnr"] - c["psnr"]) > PSNR_TOL_DB:
                raise AssertionError(f"(a) {kind} {name} PSNR {g['psnr']} "
                                     f"vs {c['psnr']}")
            log(f"(a) {kind}-loop {name}: recon/levels/modes bit-equal, "
                f"PSNR {g['psnr']:.4f} vs {c['psnr']:.4f} dB")
            if kind == "open":
                gpu_open[name] = g
            if kind == "closed" and name == "Y":
                rec_y = g["recon"].reshape(H, W)

    # The CLI's open-loop frame is the same program's output.
    rec = read_frames(full_rec, 1)
    for name, r in zip("YUV", rec):
        if not np.array_equal(r[0].reshape(-1).astype(np.int32),
                              gpu_open[name]["recon"]):
            raise AssertionError(f"encode --pipeline full {name} differs "
                                 "from the open-loop program")
    log("encode --pipeline full --mode-search: recon equals the program's")

    # CTB SAO is chosen by float32 RD scores: report how many choices
    # the two backends share (fused multiply-adds may round differently).
    sao_fn = jax.jit(lambda s, r: estimate_sao_ctb(s, r, 64, QP))
    sao = {role: [np.asarray(a) for a in sao_fn(
        jax.device_put(y, dev), jax.device_put(rec_y, dev))]
        for role, dev in (("gpu", gpu), ("cpu", cpu))}
    same = np.ones(sao["gpu"][0].shape, bool)      # (tile rows, tile cols)
    for g_map, c_map in zip(sao["gpu"], sao["cpu"]):   # type, band, offsets
        same &= (g_map == c_map).reshape(same.shape + (-1,)).all(-1)
    agree = same.mean()
    log(f"(a) CTB SAO choices, 1080p luma: {100 * agree:.2f}% of CTBs "
        "identical on GPU and CPU (float32 RD scores)")

    # (b) the closed loop against the sequential numpy oracle, on a
    # 64x128 crop from the middle of the frame
    crop = y[H // 2 - 32:H // 2 + 32, W // 2 - 64:W // 2 + 64]
    for n, dst in ((4, True), (8, False), (16, False)):
        out = jax.jit(lambda p, n=n, dst=dst: encode_planes_closed_loop(
            p[None], jnp.int32(QP), n=n, use_dst=dst, **search))(crop)
        want_rec, want_lv, want_modes = encode_plane_closed_loop(
            crop, n, QP, mode_set="all", use_dst=dst)
        got_lv = ops.scan_unpack(out["levels"][0], modes=out["modes"][0])
        for k, g, w in (("recon", out["recon"][0], want_rec),
                        ("levels", got_lv, want_lv),
                        ("modes", out["modes"][0], want_modes)):
            if not np.array_equal(np.asarray(g), w):
                raise AssertionError(f"(b) n={n} {k}: GPU != oracle")
        log(f"(b) closed loop n={n}{' DST' if dst else ''} 64x128: "
            "bit-equal to the sequential oracle")

    # (c) the open-loop pipeline against the per-block oracle
    rng = np.random.default_rng(0)
    nby, nbx = H // 8, W // 8
    sample = rng.choice(nby * nbx, size=256, replace=False)
    flag = jax.jit(lambda p: encode_plane_full(p, jnp.int32(QP), n=8))(
        jax.device_put(y, gpu))
    for mode_set, out in (("dc_planar", {k: np.asarray(flag[k]).reshape(-1)
                                         for k in ("recon", "levels", "modes")}),
                          ("all", gpu_open["Y"])):
        recon = out["recon"].reshape(H, W)
        levels = out["levels"].reshape(nby * nbx, 64)
        for b in sample:
            by, bx = divmod(int(b), nbx)
            want_rec, want_lv, want_mode = open_loop_block(
                y, 8, QP, by, bx, mode_set=mode_set)
            lv = ops.scan_unpack(levels[b][None], modes=out["modes"][b][None])
            if not (np.array_equal(recon[by * 8:by * 8 + 8, bx * 8:bx * 8 + 8],
                                   want_rec)
                    and np.array_equal(np.asarray(lv)[0], want_lv)
                    and out["modes"][b] == want_mode):
                raise AssertionError(f"(c) {mode_set} block {b}: GPU != oracle")
        log(f"(c) open loop {mode_set}: 256 sampled 1080p blocks bit-equal")


def multi_phase(tmp: str, src: str) -> None:
    """--multi: the sharded paths on four cards against one card."""
    import jax
    import jax.numpy as jnp

    from nanohevc_tpu.config import EncoderConfig
    from nanohevc_tpu.models.sequence import encode_sequence
    from nanohevc_tpu.parallel import encode_batch_sharded, make_batch_encoder, make_mesh

    devs = jax.devices()
    if len(devs) < 4:
        raise SystemExit(f"--multi needs 4 GPUs, found {len(devs)}")
    config = EncoderConfig(block_size=8, qp=QP, mode_set="all",
                           decision="satd", chroma_mode_set="dc")
    streams = {}
    for name, mesh in (("1 card", None), ("4 cards", make_mesh(devs[:4]))):
        path = os.path.join(tmp, f"multi_{name[0]}.bin")
        t0 = time.perf_counter()
        encode_sequence(src, W, H, FRAMES, config, path, batch=BATCH,
                        resume=False, closed_loop=True, mesh=mesh)
        cold = time.perf_counter() - t0
        t0 = time.perf_counter()
        encode_sequence(src, W, H, FRAMES, config, path, batch=BATCH,
                        resume=False, closed_loop=True, mesh=mesh)
        warm = time.perf_counter() - t0
        with open(path, "rb") as f:
            streams[name] = f.read()
        log(f"closed-loop sequence, {name}: {FRAMES / warm:.3f} frames/s "
            f"warm, first run {cold:.1f} s")
    if streams["1 card"] != streams["4 cards"]:
        raise AssertionError("4-card closed-loop stream differs from 1-card")
    log(f"4-card stream byte-identical to 1-card ({len(streams['1 card'])} B)")

    y = read_frames(src, 4)[0].astype(np.int32)       # (4, 1080, 1920)
    mesh = make_mesh(devs[:4], space=2)                # 1080 % (2 * 8) != 0
    got = encode_batch_sharded(y, QP, config, mesh)
    want = make_batch_encoder(config)(jnp.asarray(y), jnp.int32(QP))
    for k in ("recon", "levels", "modes"):
        if not np.array_equal(np.asarray(got[k]), np.asarray(want[k])):
            raise AssertionError(f"space=2 batch encoder {k} != unsharded")
    log(f"open-loop batch encoder, rows over 2 cards ({H} rows, 8x8 "
        "blocks): bit-equal to unsharded")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--multi", action="store_true",
                        help="run only the four-card sharded paths")
    args = parser.parse_args(argv)

    card = device_phase()
    import jax

    from nanohevc_tpu.utils.compile_cache import enable_compile_cache

    log(f"compile cache: {enable_compile_cache()}")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        src = os.path.join(tmp, "src.yuv")
        make_sequence(src, args.seed)
        if args.multi:
            multi_phase(tmp, src)
        else:
            timing, full_rec = main_path_phase(tmp, src)
            parity_phase(src, full_rec)
            log("timing: " + json.dumps({
                "card": card, "frames": FRAMES, "size": f"{W}x{H}",
                "mpix": "luma pixels", **timing}))
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
