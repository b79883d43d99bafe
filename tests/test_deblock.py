"""Deblocking filter: oracle golden values + device-path parity.

Oracle (ref/deblock.py) is checked against hand-derived spec 8.7.2
arithmetic; the batched jnp path (ops/deblock.py) is fuzz-checked
bit-exact against the oracle across sizes, QPs, bit depths and both
plane kinds.
"""

import numpy as np
import pytest

from nanohevc_tpu.ref import deblock as refdb
from nanohevc_tpu.ops import deblock as opsdb


def _mixed_plane(rng, h, w, pix_max, block=8):
    """Blocky-then-noisy content that exercises off/weak/strong paths."""
    by, bx = -(-h // block), -(-w // block)
    base = rng.integers(0, pix_max + 1, (by, bx))
    plane = np.repeat(np.repeat(base, block, 0), block, 1)[:h, :w]
    noise = rng.integers(-6, 7, (h, w))
    return np.clip(plane + noise, 0, pix_max).astype(np.int32)


class TestOracleGolden:
    def test_table_shapes(self):
        assert refdb.BETA_TABLE[16] == 6 and refdb.BETA_TABLE[51] == 64
        assert refdb.TC_TABLE[18] == 1 and refdb.TC_TABLE[53] == 24

    def test_filter_params(self):
        # qp=37: beta' = 36, tc index 39 -> tc' = 5 (Table 8-12)
        assert refdb.filter_params(37) == (36, 5)
        # 10-bit scales both by 4
        assert refdb.filter_params(37, bit_depth=10) == (144, 20)
        assert refdb.filter_params(0) == (0, 0)

    def test_strong_filter_step_edge(self):
        """Hand-derived spec 8.7.2.5.7 strong filter at a 100|108 step.

        qp=37 -> beta=36, tc=5.  d=0<36, all strong conditions hold;
        p0'=(100+200+200+216+108+4)>>3=103, p1'=410>>2=102,
        p2'=812>>3=101, q0'=844>>3=105, q1'=426>>2=106, q2'=860>>3=107.
        """
        plane = np.full((8, 16), 100, np.int32)
        plane[:, 8:] = 108
        out = refdb.deblock_plane(plane, qp=37)
        expect = [100, 100, 100, 100, 100, 101, 102, 103,
                  105, 106, 107, 108, 108, 108, 108, 108]
        assert (out == np.array(expect)[None, :]).all()

    def test_chroma_step_edge(self):
        """8.7.2.5.5: delta=((8<<2)+100-108+4)>>3=3 -> 103 | 105."""
        plane = np.full((8, 16), 100, np.int32)
        plane[:, 8:] = 108
        out = refdb.deblock_plane(plane, qp=37, is_chroma=True)
        row = out[0]
        assert row[7] == 103 and row[8] == 105
        assert (row[:7] == 100).all() and (row[9:] == 108).all()

    def test_flat_plane_unchanged(self):
        plane = np.full((32, 32), 77, np.int32)
        for chroma in (False, True):
            out = refdb.deblock_plane(plane, qp=51, is_chroma=chroma)
            assert (out == plane).all()

    def test_low_qp_noop(self):
        rng = np.random.default_rng(0)
        plane = _mixed_plane(rng, 24, 24, 255)
        # beta=0 below qp 16 (luma), tc=0 below qp+2=18 (both)
        assert (refdb.deblock_plane(plane, qp=13) == plane).all()
        assert (refdb.deblock_plane(plane, qp=15, is_chroma=True)
                == plane).all()

    def test_picture_corner_untouched(self):
        # Picture-boundary edges are never filtered, so the 4x4 corner
        # regions (beyond reach of every interior edge) are invariant.
        rng = np.random.default_rng(1)
        plane = _mixed_plane(rng, 32, 32, 255)
        out = refdb.deblock_plane(plane, qp=45)
        for ys in (slice(0, 4), slice(-4, None)):
            for xs in (slice(0, 4), slice(-4, None)):
                assert (out[ys, xs] == plane[ys, xs]).all()


class TestOpsParity:
    @pytest.mark.parametrize("qp", [0, 16, 18, 22, 30, 37, 45, 51])
    @pytest.mark.parametrize("chroma", [False, True])
    def test_fuzz_vs_oracle(self, qp, chroma):
        rng = np.random.default_rng(qp * 2 + chroma)
        for h, w in [(8, 16), (16, 16), (24, 40), (32, 28), (20, 36)]:
            plane = _mixed_plane(rng, h, w, 255)
            want = refdb.deblock_plane(plane, qp, is_chroma=chroma)
            got = np.asarray(opsdb.deblock_plane(plane, qp, is_chroma=chroma))
            assert (got == want).all(), (h, w, qp, chroma)

    @pytest.mark.parametrize("bit_depth", [8, 10])
    def test_bit_depth(self, bit_depth):
        rng = np.random.default_rng(7)
        pix_max = (1 << bit_depth) - 1
        plane = _mixed_plane(rng, 32, 32, pix_max)
        want = refdb.deblock_plane(plane, 40, bit_depth=bit_depth)
        got = np.asarray(opsdb.deblock_plane(plane, 40, bit_depth=bit_depth))
        assert (got == want).all()

    def test_ragged_height_tail_unfiltered(self):
        # H % 4 != 0: trailing partial segment passes through (both impls)
        rng = np.random.default_rng(9)
        plane = _mixed_plane(rng, 22, 32, 255)
        want = refdb.deblock_plane(plane, 45)
        got = np.asarray(opsdb.deblock_plane(plane, 45))
        assert (got == want).all()
        assert (got[20:] == plane[20:]).all()

    def test_batched_matches_single(self):
        import jax.numpy as jnp

        rng = np.random.default_rng(3)
        planes = np.stack([_mixed_plane(rng, 24, 32, 255) for _ in range(3)])
        batched = np.asarray(opsdb.deblock_plane(jnp.asarray(planes), 39))
        singles = np.stack([
            np.asarray(opsdb.deblock_plane(p, 39)) for p in planes
        ])
        assert (batched == singles).all()

    def test_jit_traced_qp(self):
        import jax
        import jax.numpy as jnp

        rng = np.random.default_rng(4)
        plane = _mixed_plane(rng, 16, 24, 255)
        f = jax.jit(lambda x, q: opsdb.deblock_plane(x, q))
        for qp in (17, 33, 51):
            want = refdb.deblock_plane(plane, qp)
            got = np.asarray(f(jnp.asarray(plane), jnp.int32(qp)))
            assert (got == want).all()

    def test_narrow_plane_noop(self):
        plane = np.arange(64, dtype=np.int32).reshape(8, 8)
        assert (np.asarray(opsdb.deblock_plane(plane, 51)) == plane).all()


class TestClosedLoopIntegration:
    def _roundtrip(self, h, w, qp=37, **cfg):
        from nanohevc_tpu.config import EncoderConfig
        from nanohevc_tpu.models.all_intra import create_test_frame
        from nanohevc_tpu.models.wavefront import (
            decode_frame,
            encode_frame_closed_loop,
        )

        frame = create_test_frame(h, w)
        config = EncoderConfig(qp=qp, deblock=True, **cfg)
        recon, bitstream = encode_frame_closed_loop(frame, config)
        decoded = decode_frame(bitstream)
        for p in ("y", "u", "v"):
            assert np.array_equal(
                getattr(decoded, p).data, getattr(recon, p).data
            ), p
        return frame, recon, bitstream

    def test_roundtrip_pixel_exact(self):
        self._roundtrip(64, 64)

    @pytest.mark.slow   # ~16 s closed-loop compile at odd geometry; aligned case stays fast
    def test_roundtrip_nonaligned(self):
        # padded-recon filtering must match on both sides pre-crop
        self._roundtrip(52, 61)

    @pytest.mark.slow   # ~11 s second closed-loop config compile
    def test_pps_flag(self):
        from nanohevc_tpu.runtime.bitstream import parse_bitstream

        _, _, bs = self._roundtrip(32, 32)
        assert parse_bitstream(bs)["params"]["deblock"] is True

    @pytest.mark.slow   # ~11 s second config compile; the pps_flag --slow test covers the flag
    def test_flag_off_stream_not_filtered(self):
        from nanohevc_tpu.config import EncoderConfig
        from nanohevc_tpu.models.all_intra import create_test_frame
        from nanohevc_tpu.models.wavefront import (
            decode_frame,
            encode_frame_closed_loop,
        )

        frame = create_test_frame(32, 32)
        off = EncoderConfig(qp=37)
        on = EncoderConfig(qp=37, deblock=True)
        r_off, bs_off = encode_frame_closed_loop(frame, off)
        r_on, _ = encode_frame_closed_loop(frame, on)
        from nanohevc_tpu.runtime.bitstream import parse_bitstream

        assert parse_bitstream(bs_off)["params"]["deblock"] is False
        assert not np.array_equal(r_off.y.data, r_on.y.data)
        # filtering is output-only: coded levels/modes are identical,
        # so both streams decode (the flag just toggles the filter)
        d_off = decode_frame(bs_off)
        assert np.array_equal(d_off.y.data, r_off.y.data)

    def test_recon_matches_standalone_filter(self):
        """encoder recon == deblock(unfiltered recon) on aligned dims."""
        from nanohevc_tpu.config import EncoderConfig
        from nanohevc_tpu.models.all_intra import create_test_frame
        from nanohevc_tpu.models.wavefront import encode_frame_closed_loop

        frame = create_test_frame(64, 64)
        qp = 40
        r_off, _ = encode_frame_closed_loop(frame, EncoderConfig(qp=qp))
        r_on, _ = encode_frame_closed_loop(
            frame, EncoderConfig(qp=qp, deblock=True)
        )
        want_y = refdb.deblock_plane(r_off.y.data.astype(np.int32), qp)
        assert (r_on.y.data == want_y).all()
        want_u = refdb.deblock_plane(
            r_off.u.data.astype(np.int32), qp, is_chroma=True
        )
        assert (r_on.u.data == want_u).all()

    def test_sequence_open_loop_refuses_deblock(self, tmp_path):
        from nanohevc_tpu.config import EncoderConfig
        from nanohevc_tpu.models.sequence import encode_sequence

        src = tmp_path / "in.yuv"
        src.write_bytes(bytes(16 * 16 * 3 // 2))
        with pytest.raises(ValueError, match="closed_loop"):
            encode_sequence(
                str(src), 16, 16, 1,
                EncoderConfig(qp=30, deblock=True),
                str(tmp_path / "out.nhb"),
            )
