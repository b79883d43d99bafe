"""Closed-loop wavefront encoder/decoder tests.

The key property the reference cannot offer: encode -> (modes, levels)
-> decode reproduces the encoder's reconstruction pixel-exactly,
because prediction is causal over reconstructed neighbors.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from nanohevc_tpu.models.wavefront import (
    decode_plane,
    encode_plane_closed_loop,
    encode_planes_closed_loop,
)
from nanohevc_tpu.ops import scan_unpack
from nanohevc_tpu.ref.encode import encode_plane_closed_loop as closed_loop_oracle


class TestClosedLoopEncode:
    @pytest.mark.parametrize("n", [4, 8])
    def test_matches_sequential_oracle(self, n):
        """Wavefront-parallel == sequential per-block, bit-for-bit."""
        rng = np.random.default_rng(0)
        plane = rng.integers(0, 256, (4 * n, 6 * n)).astype(np.int32)
        out = encode_plane_closed_loop(jnp.asarray(plane), jnp.int32(20), n=n)
        want_recon, want_levels, want_modes = closed_loop_oracle(plane, n, 20)
        assert np.array_equal(np.asarray(out["recon"]), want_recon)
        assert np.array_equal(np.asarray(out["modes"]), want_modes)
        got_levels = np.asarray(scan_unpack(out["levels"]))
        assert np.array_equal(got_levels, want_levels)

    def test_differs_from_open_loop(self):
        """Closed-loop recon must differ from source-fed prediction
        (proves neighbors actually come from the reconstruction)."""
        from nanohevc_tpu.models.all_intra import encode_plane_full

        rng = np.random.default_rng(1)
        plane = jnp.asarray(rng.integers(0, 256, (32, 32)).astype(np.int32))
        closed = encode_plane_closed_loop(plane, jnp.int32(35), n=4)
        open_ = encode_plane_full(plane, jnp.int32(35), n=4)
        assert not np.array_equal(
            np.asarray(closed["recon"]), np.asarray(open_["recon"])
        )


# (n, h, w, qp, mode_set, options) — block sizes 4-32, the 4x4 DST-VII
# luma rule, 10-bit, the dequant rescale, QP extremes and geometries
# whose block grid is tall, one block thick or not aligned at all.
ORACLE_CASES = [
    pytest.param(4, 16, 24, 24, "dc_planar", {"use_dst": True}, id="n4-dst"),
    pytest.param(4, 16, 20, 30, "dc_planar", {}, id="n4-dct"),
    pytest.param(8, 24, 32, 24, "dc_planar", {}, id="n8"),
    pytest.param(16, 48, 64, 24, "dc_planar", {}, id="n16"),
    pytest.param(32, 96, 128, 24, "dc_planar", {}, id="n32"),
    pytest.param(8, 24, 32, 0, "dc_planar", {}, id="n8-qp0"),
    pytest.param(8, 24, 32, 51, "dc_planar", {}, id="n8-qp51"),
    pytest.param(8, 24, 32, 26, "dc_planar", {"bit_depth": 10}, id="n8-10bit"),
    pytest.param(4, 16, 24, 30, "dc_planar",
                 {"bit_depth": 10, "use_dst": True}, id="n4-dst-10bit"),
    pytest.param(8, 24, 32, 28, "dc_planar", {"dequant_rescale": True},
                 id="n8-rescale"),
    pytest.param(16, 32, 48, 28, "dc_planar", {"dequant_rescale": True},
                 id="n16-rescale"),
    pytest.param(8, 37, 45, 28, "dc_planar", {}, id="n8-nonaligned"),
    pytest.param(8, 64, 16, 35, "dc_planar", {}, id="n8-tall"),
    pytest.param(8, 8, 64, 22, "dc_planar", {}, id="n8-one-row"),
    pytest.param(4, 16, 24, 24, "all", {"use_dst": True}, id="all-n4-dst"),
    pytest.param(8, 24, 40, 24, "all", {}, id="all-n8"),
    pytest.param(16, 48, 64, 27, "all", {}, id="all-n16"),
    pytest.param(32, 64, 96, 30, "all", {}, id="all-n32"),
    pytest.param(4, 24, 24, 30, "all",
                 {"bit_depth": 10, "dequant_rescale": True}, id="all-n4-10bit-rescale"),
    pytest.param(8, 61, 70, 28, "all", {}, id="all-n8-nonaligned"),
]


def _oracle_plane(seed, h, w, bit_depth=8):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1 << bit_depth, (h, w)).astype(np.int32)


def _assert_matches_oracle(out, plane, n, qp, mode_set, kw):
    want_recon, want_levels, want_modes = closed_loop_oracle(
        plane, n, qp, mode_set=mode_set, **kw
    )
    assert np.array_equal(np.asarray(out["recon"]), want_recon)
    assert np.array_equal(np.asarray(out["modes"]), want_modes)
    got_levels = np.asarray(scan_unpack(out["levels"], modes=out["modes"]))
    assert np.array_equal(got_levels, want_levels)


class TestXlaScanVsOracle:
    """The closed-loop XLA scan == the sequential per-block oracle
    (nanohevc_tpu.ref.encode), bit-for-bit, over the configurations the
    encoder serves."""

    @pytest.mark.parametrize("n,h,w,qp,mode_set,kw", ORACLE_CASES)
    def test_single_frame(self, n, h, w, qp, mode_set, kw):
        plane = _oracle_plane(n * h + w, h, w, kw.get("bit_depth", 8))
        out = encode_plane_closed_loop(
            jnp.asarray(plane), jnp.int32(qp), n=n, mode_set=mode_set,
            decision="energy" if mode_set == "dc_planar" else "satd", **kw
        )
        _assert_matches_oracle(out, plane, n, qp, mode_set, kw)

    @pytest.mark.parametrize("mode_set", ["dc_planar", "all"])
    def test_batch(self, mode_set):
        """Frames of a batch interleave their diagonals in one scan and
        stay independent: each equals its own sequential encode."""
        planes = np.stack([_oracle_plane(60 + i, 24, 40) for i in range(3)])
        out = encode_planes_closed_loop(
            jnp.asarray(planes), jnp.int32(22), n=8, mode_set=mode_set,
            decision="energy" if mode_set == "dc_planar" else "satd",
        )
        for i in range(3):
            _assert_matches_oracle(
                {k: out[k][i] for k in ("recon", "levels", "modes")},
                planes[i], 8, 22, mode_set, {},
            )

    def test_mode_search_decode_round_trip(self):
        """decode_plane reproduces the 35-mode encode's recon from
        (levels, modes) alone — the defining closed-loop property, over
        the full mode range."""
        h, w = 48, 64
        plane = jnp.asarray(_oracle_plane(77, h, w))
        enc = encode_plane_closed_loop(
            plane, jnp.int32(26), n=8, mode_set="all", decision="satd",
        )
        assert len(np.unique(np.asarray(enc["modes"]))) > 2  # real sweep
        dec = decode_plane(
            enc["levels"], enc["modes"], jnp.int32(26), n=8,
            height=h, width=w,
        )
        assert np.array_equal(np.asarray(dec), np.asarray(enc["recon"]))


class TestDecoder:
    def test_batched_decode_matches_per_frame(self):
        """decode_planes == decode_plane per frame, incl. per-frame QP."""
        from nanohevc_tpu.models.wavefront import decode_planes

        rng = np.random.default_rng(4)
        h, w, n = 24, 40, 8
        qps = [18, 30, 44]
        enc = [
            encode_plane_closed_loop(
                jnp.asarray(rng.integers(0, 256, (h, w)).astype(np.int32)),
                jnp.int32(q), n=n,
            )
            for q in qps
        ]
        batched = decode_planes(
            jnp.stack([e["levels"] for e in enc]),
            jnp.stack([e["modes"] for e in enc]),
            jnp.asarray(qps, jnp.int32),
            n=n, height=h, width=w,
        )
        for i, (e, q) in enumerate(zip(enc, qps)):
            one = decode_plane(
                e["levels"], e["modes"], jnp.int32(q), n=n, height=h, width=w
            )
            assert np.array_equal(np.asarray(batched[i]), np.asarray(one)), i
            assert np.array_equal(np.asarray(one), np.asarray(e["recon"])), i

    @pytest.mark.parametrize("n", [4, 8])
    @pytest.mark.parametrize("qp", [10, 30, 50])
    def test_decode_reproduces_encoder_recon(self, n, qp):
        rng = np.random.default_rng(2)
        h, w = 4 * n, 5 * n
        plane = jnp.asarray(rng.integers(0, 256, (h, w)).astype(np.int32))
        enc = encode_plane_closed_loop(plane, jnp.int32(qp), n=n)
        dec = decode_plane(
            enc["levels"], enc["modes"], jnp.int32(qp), n=n, height=h, width=w
        )
        assert np.array_equal(np.asarray(dec), np.asarray(enc["recon"]))

    def test_decode_through_bitstream(self):
        """encode -> entropy bitstream -> parse -> decode, pixel-exact."""
        from nanohevc_tpu.runtime import assemble_bitstream, parse_bitstream

        rng = np.random.default_rng(3)
        h, w = 32, 48
        plane = jnp.asarray(rng.integers(0, 256, (h, w)).astype(np.int32))
        enc = encode_plane_closed_loop(plane, jnp.int32(22), n=8)
        bs = assemble_bitstream(
            w, h, 22,
            {"Y": (np.asarray(enc["levels"]), 8)},
            {"Y": np.asarray(enc["modes"])},
        )
        parsed = parse_bitstream(bs)["Y"]
        dec = decode_plane(
            jnp.asarray(parsed["levels"]),
            jnp.asarray(parsed["modes"]),
            jnp.int32(22),
            n=8,
            height=h,
            width=w,
        )
        assert np.array_equal(np.asarray(dec), np.asarray(enc["recon"]))

    def test_decode_nondefault_config_through_bitstream(self):
        """The SPS/PPS carry bit depth, scan and the rescale flag, so a
        stream with a non-default config decodes with NO out-of-band
        knowledge (10-bit + horizontal scan + spec-gain dequant)."""
        from nanohevc_tpu.config import EncoderConfig
        from nanohevc_tpu.frame import Frame
        from nanohevc_tpu.models.wavefront import (
            decode_frame,
            encode_frame_closed_loop,
        )

        rng = np.random.default_rng(8)
        h, w = 32, 32
        frame = Frame.zeros(h, w, dtype=np.int16)
        frame.y.data[...] = rng.integers(0, 1024, (h, w))
        frame.u.data[...] = rng.integers(0, 1024, (h // 2, w // 2))
        frame.v.data[...] = rng.integers(0, 1024, (h // 2, w // 2))
        config = EncoderConfig(
            block_size=8, qp=26, bit_depth=10, scan="horizontal",
            dequant_rescale=True,
        )
        recon, bs = encode_frame_closed_loop(frame, config)
        decoded = decode_frame(bs)
        for p in ("y", "u", "v"):
            assert np.array_equal(
                getattr(decoded, p).data, getattr(recon, p).data
            ), p

    @pytest.mark.slow   # ~17 s CLI decode compile; 10-bit codec parity stays fast at block level
    def test_10bit_cli_decode_writes_16le(self, tmp_path, capsys):
        """A 10-bit stream decodes to 16-bit-LE YUV, not truncated u8."""
        from nanohevc_tpu.cli import main
        from nanohevc_tpu.config import EncoderConfig
        from nanohevc_tpu.frame import Frame
        from nanohevc_tpu.models.wavefront import encode_frame_closed_loop

        rng = np.random.default_rng(9)
        frame = Frame.zeros(16, 16, dtype=np.int16)
        frame.y.data[...] = rng.integers(0, 1024, (16, 16))
        frame.u.data[...] = rng.integers(0, 1024, (8, 8))
        frame.v.data[...] = rng.integers(0, 1024, (8, 8))
        recon, bs = encode_frame_closed_loop(
            frame, EncoderConfig(block_size=8, qp=20, bit_depth=10)
        )
        p = tmp_path / "b10.bin"
        p.write_bytes(bs)
        out = tmp_path / "b10.yuv"
        main(["decode", str(p), "-o", str(out)])
        assert "10-bit" in capsys.readouterr().out
        got = np.frombuffer(out.read_bytes(), np.dtype("<u2"))[: 16 * 16]
        assert np.array_equal(
            got.reshape(16, 16), recon.y.data.astype(np.uint16)
        )

    def test_pps_fields_roundtrip(self):
        from nanohevc_tpu.runtime.bitstream import (
            assemble_bitstream,
            parse_bitstream,
        )

        levels = np.zeros((4, 16), np.int32)
        bs = assemble_bitstream(
            16, 16, 30, {"Y": (levels, 4)}, bit_depth=10,
            scan="vertical", dequant_rescale=True,
        )
        params = parse_bitstream(bs)["params"]
        assert params["bit_depth_luma_minus8"] == 2
        assert params["scan_idx"] == 2
        assert params["dequant_rescale"] is True

    @pytest.mark.slow   # ~15 s; closed-loop decode exactness covered by dc_planar roundtrips
    def test_mode_search_closed_loop_roundtrip(self):
        rng = np.random.default_rng(4)
        h, w = 32, 32
        plane = jnp.asarray(rng.integers(0, 256, (h, w)).astype(np.int32))
        enc = encode_plane_closed_loop(
            plane, jnp.int32(18), n=4, mode_set="all", decision="satd"
        )
        dec = decode_plane(
            enc["levels"], enc["modes"], jnp.int32(18), n=4, height=h, width=w
        )
        assert np.array_equal(np.asarray(dec), np.asarray(enc["recon"]))
        assert np.asarray(enc["modes"]).max() >= 2  # some angular chosen


class TestFrameCodec:
    def test_encode_decode_frame_pixel_exact(self):
        from nanohevc_tpu.config import EncoderConfig
        from nanohevc_tpu.models.all_intra import create_test_frame
        from nanohevc_tpu.models.wavefront import decode_frame, encode_frame_closed_loop

        frame = create_test_frame(64, 64)   # block-aligned
        config = EncoderConfig(block_size=8, qp=24)
        recon, bitstream = encode_frame_closed_loop(frame, config)
        decoded = decode_frame(bitstream)
        assert np.array_equal(decoded.y.data, recon.y.data)
        assert np.array_equal(decoded.u.data, recon.u.data)
        assert np.array_equal(decoded.v.data, recon.v.data)

    @pytest.mark.parametrize("h,w", [
        # slow: ~14-16 s per geometry (each compiles its own padded
        # program); the (33, 35) case keeps the any-geometry contract
        # in the fast profile
        pytest.param(52, 61, marks=pytest.mark.slow),
        pytest.param(40, 60, marks=pytest.mark.slow),
        (33, 35),
    ])
    def test_nonaligned_dims_decode_pixel_exact(self, h, w):
        """decode(encode(x)) == encoder recon at ANY geometry: ragged
        edges are coded via edge-replicated padding and cropped back
        (conformance window) — the round-2 decoder zeroed them."""
        from nanohevc_tpu.config import EncoderConfig
        from nanohevc_tpu.frame import Frame
        from nanohevc_tpu.models.wavefront import (
            decode_frame,
            encode_frame_closed_loop,
        )

        rng = np.random.default_rng(13)
        frame = Frame.zeros(h, w, dtype=np.int16)
        frame.y.data[...] = rng.integers(0, 256, (h, w))
        frame.u.data[...] = rng.integers(0, 256, frame.u.data.shape)
        frame.v.data[...] = rng.integers(0, 256, frame.v.data.shape)
        config = EncoderConfig(block_size=8, qp=24)
        recon, bitstream = encode_frame_closed_loop(frame, config)
        decoded = decode_frame(bitstream)
        assert np.array_equal(decoded.y.data, recon.y.data)
        assert np.array_equal(decoded.u.data, recon.u.data)
        assert np.array_equal(decoded.v.data, recon.v.data)
        # the ragged edge is genuinely coded now, not source passthrough
        assert recon.y.data.shape == (h, w)

    def test_cli_encode_decode_roundtrip(self, tmp_path, capsys):
        from nanohevc_tpu.cli import main
        from nanohevc_tpu.models.all_intra import create_test_frame

        frame = create_test_frame(48, 64)
        src = tmp_path / "in.yuv"
        src.write_bytes(frame.to_yuv420p())
        recon_path = tmp_path / "recon.yuv"
        bs_path = tmp_path / "out.bin"
        main(["encode", str(src), "--width", "64", "--height", "48",
              "--pipeline", "closed-loop", "--qp", "20",
              "-o", str(recon_path), "--bitstream", str(bs_path)])
        out_path = tmp_path / "decoded.yuv"
        main(["decode", str(bs_path), "-o", str(out_path)])
        text = capsys.readouterr().out
        assert "decodable" in text and "Decoded:" in text
        assert out_path.read_bytes() == recon_path.read_bytes()
