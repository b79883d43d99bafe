"""Device-path vs numpy-oracle bit-exactness sweeps.

This is the core guarantee of the framework: every batched jnp op in
nanohevc_tpu.ops reproduces the oracle (and therefore the reference
implementation) bit-exactly, across block sizes x QPs x all 35 modes.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from nanohevc_tpu import ref as oracle
from nanohevc_tpu import ops

SIZES = [4, 8, 16, 32]


def random_plane(rng, h, w):
    return rng.integers(0, 256, (h, w)).astype(np.int32)


def oracle_refs(plane, n):
    """Build the combined reference vector the slow way, per block."""
    h, w = plane.shape
    out = []
    for by in range(h // n):
        for bx in range(w // n):
            y0, x0 = by * n, bx * n
            top = np.empty(2 * n + 1, np.int32)
            left = np.empty(2 * n + 1, np.int32)
            corner = 128 if (y0 == 0 or x0 == 0) else plane[y0 - 1, x0 - 1]
            top[0] = left[0] = corner
            for i in range(1, 2 * n + 1):
                top[i] = 128 if y0 == 0 else plane[y0 - 1, min(x0 + i - 1, w - 1)]
                left[i] = 128 if x0 == 0 else plane[min(y0 + i - 1, h - 1), x0 - 1]
            out.append(np.concatenate([top, left]))
    return np.stack(out)


class TestTiling:
    @pytest.mark.parametrize("n", SIZES)
    def test_tile_untile_roundtrip(self, n):
        rng = np.random.default_rng(0)
        h, w = 3 * n + n // 2, 4 * n + n - 1   # non-multiple edges
        plane = random_plane(rng, h, w)
        blocks = ops.tile_plane(jnp.asarray(plane), n)
        nby, nbx = h // n, w // n
        assert blocks.shape == (nby * nbx, n, n)
        back = np.asarray(ops.untile_plane(blocks, h, w))
        assert np.array_equal(back[: nby * n, : nbx * n], plane[: nby * n, : nbx * n])
        assert np.all(back[nby * n :, :] == 0) and np.all(back[:, nbx * n :] == 0)

    def test_raster_order(self):
        plane = np.arange(8 * 8).reshape(8, 8).astype(np.int32)
        blocks = np.asarray(ops.tile_plane(jnp.asarray(plane), 4))
        assert blocks[0, 0, 0] == 0 and blocks[1, 0, 0] == 4
        assert blocks[2, 0, 0] == 32 and blocks[3, 3, 3] == 63

    @pytest.mark.parametrize("n", [4, 8])
    def test_extract_refs_matches_per_block(self, n):
        rng = np.random.default_rng(1)
        plane = random_plane(rng, 4 * n, 5 * n)
        got = np.asarray(ops.extract_refs(jnp.asarray(plane), n))
        want = oracle_refs(plane, n)
        assert np.array_equal(got, want)


class TestIntraParity:
    @pytest.mark.parametrize("n", SIZES)
    def test_dc_planar(self, n):
        rng = np.random.default_rng(2)
        plane = random_plane(rng, 2 * n, 4 * n)
        refs = ops.extract_refs(jnp.asarray(plane), n)
        dc = np.asarray(ops.dc_predict(refs, n))
        pl = np.asarray(ops.planar_predict(refs, n))
        nrefs = oracle_refs(plane, n)
        for b in range(nrefs.shape[0]):
            top, left = nrefs[b, : 2 * n + 1], nrefs[b, 2 * n + 1 :]
            want_dc = oracle.intra_dc_predict(top[1 : n + 1], left[1 : n + 1], n)
            assert np.array_equal(dc[b], want_dc), f"DC block {b}"
            # encoder parity: top_right/bottom_left = Nth neighbor sample
            want_pl = oracle.intra_planar_predict(
                top[1 : n + 1], left[1 : n + 1], int(top[n]), int(left[n]), n
            )
            assert np.array_equal(pl[b], want_pl), f"planar block {b}"

    @pytest.mark.parametrize("n", SIZES)
    def test_angular_all_modes(self, n):
        rng = np.random.default_rng(3)
        plane = random_plane(rng, 2 * n, 3 * n)
        refs = ops.extract_refs(jnp.asarray(plane), n)
        preds = np.asarray(ops.angular_predict_all(refs, n))  # (nb, 33, n, n)
        nrefs = oracle_refs(plane, n)
        for b in range(nrefs.shape[0]):
            top, left = nrefs[b, : 2 * n + 1], nrefs[b, 2 * n + 1 :]
            for mi, mode in enumerate(range(2, 35)):
                want = oracle.intra_angular_predict(top, left, int(top[0]), mode, n)
                assert np.array_equal(preds[b, mi], want), f"block {b} mode {mode}"

    def test_predict_by_mode_mixed(self):
        n = 8
        rng = np.random.default_rng(4)
        plane = random_plane(rng, 4 * n, 4 * n)
        refs = ops.extract_refs(jnp.asarray(plane), n)
        nb = refs.shape[0]
        modes = rng.integers(0, 35, nb).astype(np.int32)
        got = np.asarray(ops.predict_by_mode(refs, n, jnp.asarray(modes)))
        nrefs = oracle_refs(plane, n)
        for b in range(nb):
            top, left = nrefs[b, : 2 * n + 1], nrefs[b, 2 * n + 1 :]
            m = int(modes[b])
            if m == 0:
                want = oracle.intra_planar_predict(
                    top[1 : n + 1], left[1 : n + 1], int(top[n]), int(left[n]), n
                )
            elif m == 1:
                want = oracle.intra_dc_predict(top[1 : n + 1], left[1 : n + 1], n)
            else:
                want = oracle.intra_angular_predict(top, left, int(top[0]), m, n)
            assert np.array_equal(got[b], want), f"block {b} mode {m}"


class TestTransformParity:
    @pytest.mark.parametrize("n", SIZES)
    @pytest.mark.parametrize("use_dst", [False, True])
    def test_forward_inverse(self, n, use_dst):
        if use_dst and n != 4:
            pytest.skip("DST only defined at 4x4")
        rng = np.random.default_rng(5)
        res = rng.integers(-1023, 1024, (64, n, n)).astype(np.int32)
        fwd = np.asarray(ops.forward_transform(jnp.asarray(res), use_dst))
        for b in range(res.shape[0]):
            assert np.array_equal(fwd[b], oracle.forward_transform(res[b], use_dst))
        inv = np.asarray(ops.inverse_transform(jnp.asarray(fwd), use_dst))
        for b in range(res.shape[0]):
            assert np.array_equal(inv[b], oracle.inverse_transform(fwd[b], use_dst))


class TestQuantParity:
    @pytest.mark.parametrize("n", SIZES)
    def test_all_qps(self, n):
        rng = np.random.default_rng(6)
        coeff = rng.integers(-30000, 30000, (8, n, n)).astype(np.int32)
        j = jnp.asarray(coeff)
        for qp in range(0, 52, 3):
            for intra in (True, False):
                got = np.asarray(ops.quantize(j, qp, n, intra))
                for b in range(coeff.shape[0]):
                    assert np.array_equal(
                        got[b], oracle.quantize(coeff[b], qp, n, intra)
                    ), f"qp={qp} intra={intra}"
        levels = rng.integers(-3000, 3000, (8, n, n)).astype(np.int32)
        jl = jnp.asarray(levels)
        for qp in range(0, 52, 3):
            got = np.asarray(ops.dequantize(jl, qp, n))
            for b in range(levels.shape[0]):
                assert np.array_equal(got[b], oracle.dequantize(levels[b], qp, n))

    def test_traced_qp_matches_static(self):
        rng = np.random.default_rng(7)
        c = jnp.asarray(rng.integers(-500, 500, (4, 8, 8)).astype(np.int32))
        import jax

        f = jax.jit(lambda x, qp: ops.quantize(x, qp, 8))
        for qp in (0, 17, 51):
            assert np.array_equal(f(c, jnp.int32(qp)), ops.quantize(c, qp, 8))


class TestMetricsParity:
    def test_psnr_mse_sad(self):
        rng = np.random.default_rng(8)
        a = rng.integers(0, 256, (32, 32)).astype(np.int32)
        b = rng.integers(0, 256, (32, 32)).astype(np.int32)
        assert abs(float(ops.psnr(jnp.asarray(a), jnp.asarray(b))) - oracle.psnr(a, b)) < 1e-3
        assert abs(float(ops.mse(jnp.asarray(a), jnp.asarray(b))) - oracle.mse(a, b)) < 1e-3

    def test_satd_blocks_matches_4x4(self):
        rng = np.random.default_rng(9)
        a = rng.integers(0, 256, (16, 4, 4)).astype(np.int32)
        b = rng.integers(0, 256, (16, 4, 4)).astype(np.int32)
        got = np.asarray(ops.satd_blocks(jnp.asarray(a), jnp.asarray(b)))
        for i in range(16):
            assert got[i] == oracle.satd_4x4(a[i], b[i])

    def test_residual_energy(self):
        rng = np.random.default_rng(10)
        r = rng.integers(-255, 256, (8, 8, 8)).astype(np.int32)
        got = np.asarray(ops.residual_energy_blocks(jnp.asarray(r)))
        for i in range(8):
            assert got[i] == oracle.residual_energy(r[i])


class TestScan:
    @pytest.mark.parametrize("n", SIZES)
    @pytest.mark.parametrize("kind", ["diag", "horizontal", "vertical"])
    def test_pack_unpack_roundtrip(self, n, kind):
        rng = np.random.default_rng(11)
        x = jnp.asarray(rng.integers(-100, 100, (6, n, n)).astype(np.int32))
        packed = ops.scan_pack(x, kind)
        assert packed.shape == (6, n * n)
        assert np.array_equal(np.asarray(ops.scan_unpack(packed, kind)), np.asarray(x))

    def test_diag_4x4_dc_first_and_order(self):
        x = jnp.asarray(np.arange(16, dtype=np.int32).reshape(1, 4, 4))
        packed = np.asarray(ops.scan_pack(x, "diag"))[0]
        assert packed[0] == 0                       # DC first
        assert list(packed[:6]) == [0, 4, 1, 8, 5, 2]  # up-right diagonals


class TestSSIM:
    def test_identical_is_one(self):
        rng = np.random.default_rng(12)
        x = rng.integers(0, 256, (64, 64)).astype(np.int32)
        from nanohevc_tpu.ref.metrics import ssim as ssim_ref

        assert abs(ssim_ref(x, x) - 1.0) < 1e-9
        assert abs(float(ops.ssim(jnp.asarray(x), jnp.asarray(x))) - 1.0) < 1e-5

    def test_noise_lowers_ssim_and_matches_oracle(self):
        rng = np.random.default_rng(13)
        x = rng.integers(0, 200, (64, 64)).astype(np.int32)
        y = np.clip(x + rng.integers(-20, 21, x.shape), 0, 255).astype(np.int32)
        from nanohevc_tpu.ref.metrics import ssim as ssim_ref

        want = ssim_ref(x, y)
        got = float(ops.ssim(jnp.asarray(x), jnp.asarray(y)))
        assert want < 0.99
        assert abs(got - want) < 2e-3

    def test_estimate_bits_blocks(self):
        rng = np.random.default_rng(14)
        lv = rng.integers(-10, 11, (4, 8, 8)).astype(np.int32)
        got = np.asarray(ops.estimate_bits_blocks(jnp.asarray(lv)))
        for i in range(4):
            assert abs(got[i] - oracle.estimate_bits(lv[i])) <= 1.0
        nz = np.asarray(ops.count_nonzero_blocks(jnp.asarray(lv)))
        for i in range(4):
            assert nz[i] == oracle.count_nonzero(lv[i])


class TestMatmulAngular:
    @pytest.mark.parametrize("n", SIZES)
    def test_mm_matches_gather_path(self, n):
        """Gather-free matmul formulation is bit-identical to gathers."""
        from nanohevc_tpu.ops.intra import angular_predict_mm

        rng = np.random.default_rng(31)
        plane = random_plane(rng, 2 * n, 3 * n)
        refs = ops.extract_refs(jnp.asarray(plane), n)
        want = np.asarray(ops.angular_predict_all(refs, n))
        for mi, mode in enumerate(range(2, 35)):
            got = np.asarray(angular_predict_mm(refs, n, mode))
            assert np.array_equal(got, want[:, mi]), mode

    def test_predict_by_mode_mm_matches(self):
        from nanohevc_tpu.ops.intra import predict_by_mode_mm

        n = 8
        rng = np.random.default_rng(32)
        plane = random_plane(rng, 4 * n, 4 * n)
        refs = ops.extract_refs(jnp.asarray(plane), n)
        modes = jnp.asarray(rng.integers(0, 35, refs.shape[0]).astype(np.int32))
        want = np.asarray(ops.predict_by_mode(refs, n, modes))
        got = np.asarray(predict_by_mode_mm(refs, n, modes))
        assert np.array_equal(got, want)


# (n, h, w, qp, mode_set, options) for the whole open-loop pipeline:
# every block size, QP extremes, trailing rows/columns outside the block
# grid, the 4x4 DST-VII luma rule, 10-bit and the dequant rescale.
PIPELINE_CASES = [
    pytest.param(4, 14, 24, 26, "dc_planar", {}, id="n4-partial-rows"),
    pytest.param(8, 36, 48, 10, "dc_planar", {}, id="n8-partial-rows"),
    pytest.param(16, 72, 96, 30, "dc_planar", {}, id="n16-partial-rows"),
    pytest.param(32, 144, 192, 30, "dc_planar", {}, id="n32-partial-rows"),
    pytest.param(8, 32, 64, 0, "dc_planar", {}, id="qp0"),
    pytest.param(8, 32, 64, 17, "dc_planar", {}, id="qp17"),
    pytest.param(8, 32, 64, 37, "dc_planar", {}, id="qp37"),
    pytest.param(8, 32, 64, 51, "dc_planar", {}, id="qp51"),
    pytest.param(8, 44, 61, 22, "dc_planar", {}, id="n8-ragged-width"),
    pytest.param(4, 24, 32, 24, "dc_planar", {"use_dst": True}, id="n4-dst"),
    pytest.param(4, 16, 24, 30, "dc_planar",
                 {"use_dst": True, "bit_depth": 10}, id="n4-dst-10bit"),
    pytest.param(8, 32, 48, 30, "dc_planar", {"bit_depth": 10}, id="n8-10bit"),
    pytest.param(8, 32, 64, 28, "dc_planar", {"dequant_rescale": True},
                 id="n8-rescale"),
    pytest.param(16, 32, 64, 28, "dc_planar", {"dequant_rescale": True},
                 id="n16-rescale"),
    pytest.param(4, 20, 24, 26, "all", {"use_dst": True}, id="all-n4-dst"),
    pytest.param(8, 24, 40, 12, "all", {}, id="all-n8"),
    pytest.param(16, 48, 80, 30, "all", {}, id="all-n16"),
    pytest.param(32, 96, 160, 30, "all", {}, id="all-n32"),
    pytest.param(8, 21, 24, 24, "all", {}, id="all-n8-partial-rows"),
    pytest.param(8, 16, 24, 30, "all", {"bit_depth": 10}, id="all-n8-10bit"),
]


class TestPipelineVsOracle:
    """encode_plane_full (the open-loop XLA pipeline) == the per-block
    numpy oracle nanohevc_tpu.ref.encode, bit-for-bit."""

    @pytest.mark.parametrize("n,h,w,qp,mode_set,kw", PIPELINE_CASES)
    def test_plane(self, n, h, w, qp, mode_set, kw):
        from nanohevc_tpu.models.all_intra import encode_plane_full
        from nanohevc_tpu.ref.encode import encode_plane_open_loop

        rng = np.random.default_rng(n * h + w + qp)
        plane = rng.integers(0, 1 << kw.get("bit_depth", 8), (h, w))
        plane = plane.astype(np.int32)
        if mode_set == "all" and h % n:
            # extreme trailing rows: the left extension must read the
            # real rows below the last block-row, not the grid's edge
            plane[(h // n) * n :, :] = (1 << kw.get("bit_depth", 8)) - 1
        out = encode_plane_full(
            jnp.asarray(plane), jnp.int32(qp), n=n, mode_set=mode_set,
            decision="energy" if mode_set == "dc_planar" else "satd", **kw
        )
        want_recon, want_levels, want_modes = encode_plane_open_loop(
            plane, n, qp, mode_set=mode_set, **kw
        )
        assert np.array_equal(np.asarray(out["recon"]), want_recon)
        assert np.array_equal(np.asarray(out["modes"]), want_modes)
        got_levels = np.asarray(ops.scan_unpack(out["levels"], modes=out["modes"]))
        assert np.array_equal(got_levels, want_levels)
        assert np.array_equal(
            np.asarray(out["nnz"]), (want_levels != 0).sum(axis=(1, 2))
        )

    def test_batched_vmap(self):
        """The frame batch of the sequence encoder (a vmap over planes)
        equals each frame's own oracle encode."""
        from nanohevc_tpu.config import EncoderConfig
        from nanohevc_tpu.parallel import make_batch_encoder
        from nanohevc_tpu.ref.encode import encode_plane_open_loop

        rng = np.random.default_rng(40)
        frames = rng.integers(0, 256, (3, 28, 40)).astype(np.int32)
        out = make_batch_encoder(EncoderConfig(block_size=8, qp=27))(
            jnp.asarray(frames), jnp.int32(27)
        )
        for f in range(3):
            want_recon, want_levels, _ = encode_plane_open_loop(frames[f], 8, 27)
            assert np.array_equal(np.asarray(out["recon"][f]), want_recon), f
            assert np.array_equal(
                np.asarray(ops.scan_unpack(out["levels"][f])), want_levels
            ), f
