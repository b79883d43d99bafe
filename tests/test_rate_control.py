"""Rate control: QP-for-budget search and the sequence ABR controller.

The reference has no rate control of any kind (QP is a free parameter,
reference quant.py:41); these tests cover the framework's addition:
bits are measured by the real range coder, QP schedules ride per-slice
qp fields, and streams stay pixel-exactly decodable.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from nanohevc_tpu.config import EncoderConfig
from nanohevc_tpu.models.rate_control import (
    RateController,
    find_frame_qp,
    frame_coded_bytes,
)


def _textured_frame(h, w, seed=0):
    from nanohevc_tpu.frame import Frame

    rng = np.random.default_rng(seed)
    frame = Frame.zeros(h, w, dtype=np.int16)
    yy, xx = np.mgrid[0:h, 0:w]
    frame.y.data[...] = np.clip(
        64 + xx // 4 + yy // 6 + rng.integers(-20, 20, (h, w)), 0, 255
    )
    frame.u.data[...] = rng.integers(100, 156, (h // 2, w // 2))
    frame.v.data[...] = rng.integers(100, 156, (h // 2, w // 2))
    return frame


class TestFrameQP:
    def test_bits_monotone_in_qp(self):
        frame = _textured_frame(32, 32)
        sizes = [
            frame_coded_bytes(frame, EncoderConfig(block_size=8, qp=q))
            for q in (10, 22, 34, 46)
        ]
        assert sizes == sorted(sizes, reverse=True), sizes
        assert sizes[0] > sizes[-1]

    def test_find_frame_qp_meets_budget(self):
        frame = _textured_frame(32, 32, seed=1)
        config = EncoderConfig(block_size=8, qp=22)
        hi = frame_coded_bytes(frame, EncoderConfig(block_size=8, qp=10))
        lo = frame_coded_bytes(frame, EncoderConfig(block_size=8, qp=46))
        target = (hi + lo) // 2
        qp, size = find_frame_qp(frame, config, target)
        assert size <= target
        if qp > 0:
            # best quality: one step finer must overshoot
            over = frame_coded_bytes(
                frame, EncoderConfig(block_size=8, qp=qp - 1)
            )
            assert over > target

    def test_impossible_budget_returns_max_qp(self):
        frame = _textured_frame(32, 32, seed=2)
        qp, size = find_frame_qp(frame, EncoderConfig(block_size=8), 1)
        assert qp == 51
        assert size > 1


class TestController:
    def test_converges_on_static_source(self):
        """A plant with the codec's rate-QP slope: the controller must
        settle at the QP whose rate matches target."""
        target = 10_000.0
        ctl = RateController(target_bits=target, qp=40)

        def plant(qp):  # ~half the bits every +6 QP, anchored off target
            return target * 2.0 ** ((26 - qp) / 6)

        qp = ctl.qp
        for _ in range(30):
            qp = ctl.update(plant(qp))
        assert abs(plant(qp) - target) / target < 0.3, (qp, plant(qp))

    def test_clamps_to_qp_range(self):
        ctl = RateController(target_bits=1e9, qp=50)
        assert ctl.update(1.0) >= 0
        ctl2 = RateController(target_bits=1.0, qp=2)
        for _ in range(5):
            q = ctl2.update(1e9)
        assert q == 51


class TestSequenceRateControl:
    def _write_seq(self, path, w, h, n_frames, seed):
        rng = np.random.default_rng(seed)
        with open(path, "wb") as f:
            for i in range(n_frames):
                y = np.clip(
                    rng.integers(-30, 30, (h, w))
                    + np.linspace(0, 200, w)[None, :].astype(int),
                    0, 255,
                ).astype(np.uint8)
                u = rng.integers(100, 156, (h // 2, w // 2)).astype(np.uint8)
                v = rng.integers(100, 156, (h // 2, w // 2)).astype(np.uint8)
                f.write(y.tobytes() + u.tobytes() + v.tobytes())

    def test_target_bpp_steers_qp_and_decodes(self, tmp_path):
        from nanohevc_tpu.models.sequence import (
            decode_sequence,
            encode_sequence,
        )

        w, h, n = 64, 32, 12
        src = tmp_path / "seq.yuv"
        self._write_seq(src, w, h, n, seed=3)
        bs = tmp_path / "seq.bin"
        # seed QP far too fine for a tight budget: controller must coarsen
        config = EncoderConfig(block_size=8, qp=8)
        res = encode_sequence(
            str(src), w, h, n, config, str(bs),
            batch=2, closed_loop=True, target_bpp=0.28,
        )
        rc = res.stats["rate_control"]
        assert rc["qp_final"] > 8, rc
        assert rc["achieved_bpp"] < 2.0  # far below the QP-8 rate
        # the variable-QP stream must still decode pixel-exactly
        out = tmp_path / "dec.yuv"
        assert decode_sequence(str(bs), str(out)) == n

    def test_open_loop_rate_control_honors_runtime_qp(self, tmp_path):
        """The controller's QP changes must reach the open-loop device
        encode (QP is a traced argument of the compiled program)."""
        from nanohevc_tpu.models.sequence import encode_sequence

        w, h, n = 64, 32, 8
        src = tmp_path / "seq.yuv"
        self._write_seq(src, w, h, n, seed=5)
        bs = tmp_path / "seq.bin"
        res = encode_sequence(
            str(src), w, h, n, EncoderConfig(block_size=8, qp=6),
            str(bs), batch=2, target_bpp=0.2,
        )
        rc = res.stats["rate_control"]
        assert rc["qp_final"] > 6, rc

    def test_fixed_qp_unaffected(self, tmp_path):
        """No target_bpp -> byte-identical to the pre-rate-control path."""
        from nanohevc_tpu.models.sequence import encode_sequence

        w, h, n = 32, 32, 4
        src = tmp_path / "seq.yuv"
        self._write_seq(src, w, h, n, seed=4)
        b1, b2 = tmp_path / "a.bin", tmp_path / "b.bin"
        config = EncoderConfig(block_size=8, qp=24)
        encode_sequence(str(src), w, h, n, config, str(b1), batch=2,
                        closed_loop=True, resume=False)
        encode_sequence(str(src), w, h, n, config, str(b2), batch=2,
                        closed_loop=True, resume=False)
        assert b1.read_bytes() == b2.read_bytes()


class TestTargetBytesCLI:
    def test_encode_target_bytes(self, tmp_path, capsys):
        from nanohevc_tpu.cli import main

        rng = np.random.default_rng(6)
        w, h = 32, 32
        src = tmp_path / "in.yuv"
        src.write_bytes(
            rng.integers(0, 256, w * h * 3 // 2, dtype=np.uint8)
            .astype(np.uint8).tobytes()
        )
        bs = tmp_path / "out.bin"
        main(["encode", str(src), "--width", str(w), "--height", str(h),
              "--pipeline", "closed-loop", "--target-bytes", "700",
              "--bitstream", str(bs)])
        text = capsys.readouterr().out
        assert "Rate search: QP" in text
        assert bs.stat().st_size <= 700


class TestSliceQP:
    def test_slice_qp_overrides_pps(self):
        """A frame coded at QP 30 inside a stream whose PPS says 22
        still decodes with 30 (the slice field wins)."""
        from nanohevc_tpu.models.wavefront import (
            decode_plane,
            encode_plane_closed_loop,
        )
        from nanohevc_tpu.runtime.bitstream import (
            assemble_bitstream,
            parse_bitstream,
        )

        rng = np.random.default_rng(5)
        plane = jnp.asarray(rng.integers(0, 256, (32, 32)).astype(np.int32))
        enc = encode_plane_closed_loop(plane, jnp.int32(30), n=8)
        bs = assemble_bitstream(
            32, 32, 30, {"Y": (np.asarray(enc["levels"]), 8)},
            {"Y": np.asarray(enc["modes"])},
        )
        parsed = parse_bitstream(bs)
        assert parsed["Y"]["qp"] == 30
        dec = decode_plane(
            jnp.asarray(parsed["Y"]["levels"]),
            jnp.asarray(parsed["Y"]["modes"]),
            jnp.int32(parsed["Y"]["qp"]),
            n=8, height=32, width=32,
        )
        assert np.array_equal(np.asarray(dec), np.asarray(enc["recon"]))
