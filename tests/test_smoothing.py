"""Reference-sample smoothing (spec 8.4.4.2.3) — opt-in, beyond the
reference implementation (which has no smoothing at all).

The [1 2 1]/4 filter applies along the boundary path (bottom-left ->
corner -> top-right) for luma modes selected by the filter-flag rule;
4x4 and DC never filter.  Checked against an independent numpy
formulation, the spec's known mode sets, and full encode -> bitstream
-> decode round-trips.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from nanohevc_tpu import ops


def numpy_smooth(refs: np.ndarray, n: int) -> np.ndarray:
    """Independent scalar formulation of the boundary filter."""
    out = refs.copy()
    for b in range(refs.shape[0]):
        top = refs[b, : 2 * n + 1].astype(np.int64)    # corner at 0
        left = refs[b, 2 * n + 1 :].astype(np.int64)
        path = np.concatenate([left[1:][::-1], [top[0]], top[1:]])
        f = path.copy()
        for i in range(1, len(path) - 1):
            f[i] = (path[i - 1] + 2 * path[i] + path[i + 1] + 2) >> 2
        fl = f[: 2 * n][::-1]
        fc = f[2 * n]
        ft = f[2 * n + 1 :]
        out[b, : 2 * n + 1] = np.concatenate([[fc], ft])
        out[b, 2 * n + 1 :] = np.concatenate([[fc], fl])
    return out


class TestFilter:
    @pytest.mark.parametrize("n", [8, 16, 32])
    def test_matches_independent_formulation(self, n):
        rng = np.random.default_rng(0)
        refs = rng.integers(0, 256, (5, 4 * n + 2)).astype(np.int32)
        refs[:, 2 * n + 1] = refs[:, 0]   # both corner copies agree
        got = np.asarray(ops.smooth_refs(jnp.asarray(refs), n))
        assert np.array_equal(got, numpy_smooth(refs, n))

    def test_uniform_refs_unchanged(self):
        refs = jnp.full((2, 4 * 8 + 2), 77, jnp.int32)
        assert (np.asarray(ops.smooth_refs(refs, 8)) == 77).all()


class TestStrongSmoothing:
    """Bilinear strong filter at 32x32 (spec 8.4.4.2.3 second clause)."""

    def _refs(self, top_arm, left_arm, corner):
        n = 32
        refs = np.empty((1, 4 * n + 2), np.int32)
        refs[0, 0] = corner
        refs[0, 1 : 2 * n + 1] = top_arm
        refs[0, 2 * n + 1] = corner
        refs[0, 2 * n + 2 :] = left_arm
        return refs

    def test_linear_arms_take_bilinear_ramp(self):
        n = 32
        # perfectly linear arms: corner 0 -> end 128 over 64 samples
        arm = np.round(np.linspace(2, 128, 2 * n)).astype(np.int32)
        refs = self._refs(arm, arm, 0)
        out = np.asarray(ops.smooth_refs(jnp.asarray(refs), n))
        x = np.arange(2 * n - 1)
        want_ramp = ((2 * n - 1 - x) * 0 + (x + 1) * arm[-1] + n) >> 6
        got_top = out[0, 1 : 2 * n]
        assert np.array_equal(got_top, want_ramp)
        assert out[0, 0] == 0                      # corner raw
        assert out[0, 2 * n] == arm[-1]            # far end raw

    def test_nonflat_arms_keep_121(self):
        n = 32
        rng = np.random.default_rng(4)
        arm = rng.integers(0, 256, 2 * n).astype(np.int32)
        refs = self._refs(arm, arm, 200)           # jagged: fails flatness
        got = np.asarray(ops.smooth_refs(jnp.asarray(refs), n))
        want = numpy_smooth(refs, n)
        assert np.array_equal(got, want)

    def test_threshold_scales_with_bit_depth(self):
        n = 32
        # curvature 16: flat at 10-bit (thresh 32), NOT flat at 8-bit
        # (thresh 8) -> different filters
        arm = np.round(np.linspace(2, 128, 2 * n)).astype(np.int32)
        arm_mid_bumped = arm.copy()
        arm_mid_bumped[n - 1] -= 8   # |end + corner - 2*mid| = 16ish
        refs = self._refs(arm_mid_bumped, arm_mid_bumped, 0)
        out8 = np.asarray(ops.smooth_refs(jnp.asarray(refs), n, bit_depth=8))
        out10 = np.asarray(ops.smooth_refs(jnp.asarray(refs), n, bit_depth=10))
        assert not np.array_equal(out8, out10)

    def test_closed_loop_32_roundtrip(self):
        from nanohevc_tpu.models.wavefront import (
            decode_plane,
            encode_plane_closed_loop,
        )

        rng = np.random.default_rng(5)
        # smooth gradient content: triggers the strong filter
        yy, xx = np.mgrid[0:64, 0:96]
        plane = jnp.asarray((xx + yy).astype(np.int32) % 250)
        enc = encode_plane_closed_loop(
            plane, jnp.int32(24), n=32, intra_smoothing=True
        )
        dec = decode_plane(
            enc["levels"], enc["modes"], jnp.int32(24), n=32,
            height=64, width=96, intra_smoothing=True,
        )
        assert np.array_equal(np.asarray(dec), np.asarray(enc["recon"]))


class TestFilterFlags:
    def test_8x8_filters_exactly_planar_2_18_34(self):
        flags = ops.mode_filter_flags(8)
        assert set(np.nonzero(flags)[0]) == {0, 2, 18, 34}

    def test_16x16_excludes_near_hor_ver(self):
        flags = ops.mode_filter_flags(16)
        off = set(np.nonzero(~flags)[0])
        assert off == {1, 9, 10, 11, 25, 26, 27}

    def test_32x32_excludes_only_dc_10_26(self):
        flags = ops.mode_filter_flags(32)
        assert set(np.nonzero(~flags)[0]) == {1, 10, 26}

    def test_4x4_never(self):
        assert not ops.mode_filter_flags(4).any()


class TestPrediction:
    def test_decide_modes_changes_with_smoothing_at_8(self):
        from nanohevc_tpu.models.all_intra import decide_modes

        rng = np.random.default_rng(1)
        blocks = jnp.asarray(rng.integers(0, 256, (16, 8, 8)).astype(np.int32))
        refs = jnp.asarray(rng.integers(0, 256, (16, 34)).astype(np.int32))
        p0, _ = decide_modes(blocks, refs, 8, "all", "satd")
        p1, _ = decide_modes(blocks, refs, 8, "all", "satd", smoothing=True)
        assert not np.array_equal(np.asarray(p0), np.asarray(p1))

    def test_noop_at_4x4(self):
        from nanohevc_tpu.models.all_intra import decide_modes

        rng = np.random.default_rng(2)
        blocks = jnp.asarray(rng.integers(0, 256, (16, 4, 4)).astype(np.int32))
        refs = jnp.asarray(rng.integers(0, 256, (16, 18)).astype(np.int32))
        p0, m0 = decide_modes(blocks, refs, 4, "all", "satd")
        p1, m1 = decide_modes(blocks, refs, 4, "all", "satd", smoothing=True)
        assert np.array_equal(np.asarray(p0), np.asarray(p1))
        assert np.array_equal(np.asarray(m0), np.asarray(m1))

    def test_predict_by_mode_respects_flags(self):
        """Mode 26 (unfiltered at 8x8) must ignore smoothing; mode 18
        (filtered) must not."""
        from nanohevc_tpu.ops.intra import predict_by_mode_mm

        rng = np.random.default_rng(3)
        refs = jnp.asarray(rng.integers(0, 256, (4, 34)).astype(np.int32))
        m26 = jnp.full((4,), 26, jnp.int32)
        m18 = jnp.full((4,), 18, jnp.int32)
        assert np.array_equal(
            np.asarray(predict_by_mode_mm(refs, 8, m26)),
            np.asarray(predict_by_mode_mm(refs, 8, m26, smoothing=True)),
        )
        assert not np.array_equal(
            np.asarray(predict_by_mode_mm(refs, 8, m18)),
            np.asarray(predict_by_mode_mm(refs, 8, m18, smoothing=True)),
        )


class TestEndToEnd:
    @pytest.mark.slow   # ~15 s; smoothing decode exactness also pinned at block level
    def test_closed_loop_bitstream_roundtrip(self):
        """Smoothing rides the PPS: the decoder reproduces the encoder's
        reconstruction with no out-of-band knowledge."""
        from nanohevc_tpu.config import EncoderConfig
        from nanohevc_tpu.models.all_intra import create_test_frame
        from nanohevc_tpu.models.wavefront import (
            decode_frame,
            encode_frame_closed_loop,
        )

        frame = create_test_frame(32, 32)
        config = EncoderConfig(
            block_size=8, qp=24, mode_set="all", decision="satd",
            intra_smoothing=True,
        )
        recon, bs = encode_frame_closed_loop(frame, config)
        decoded = decode_frame(bs)
        for p in ("y", "u", "v"):
            assert np.array_equal(
                getattr(decoded, p).data, getattr(recon, p).data
            ), p

    @pytest.mark.slow   # ~18 s full encode A/B; filter-rule parity stays fast
    def test_smoothing_changes_the_stream(self):
        from nanohevc_tpu.config import EncoderConfig
        from nanohevc_tpu.models.all_intra import create_test_frame
        from nanohevc_tpu.models.wavefront import encode_frame_closed_loop

        frame = create_test_frame(32, 32)
        base = dict(block_size=8, qp=24, mode_set="all", decision="satd")
        _, b0 = encode_frame_closed_loop(frame, EncoderConfig(**base))
        _, b1 = encode_frame_closed_loop(
            frame, EncoderConfig(**base, intra_smoothing=True)
        )
        assert b0 != b1
