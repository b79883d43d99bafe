"""Multi-chip sharding tests on the virtual 8-device CPU mesh."""

import sys
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from nanohevc_tpu.config import EncoderConfig
from nanohevc_tpu.models.all_intra import encode_plane_full
from nanohevc_tpu.parallel import encode_batch_sharded, make_batch_encoder, make_mesh


needs_8 = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices"
)


class TestMesh:
    @needs_8
    def test_2d_mesh_shapes(self):
        mesh = make_mesh(space=2)
        assert mesh.devices.shape == (4, 2)
        assert mesh.axis_names == ("frame", "space")

    @needs_8
    def test_invalid_space_raises(self):
        with pytest.raises(ValueError):
            make_mesh(space=3)


class TestShardedEncode:
    @needs_8
    @pytest.mark.parametrize("space", [1, 2])
    def test_sharded_matches_single_device(self, space):
        """Sharded multi-frame encode is bit-identical to per-frame encode."""
        mesh = make_mesh(space=space)
        f_axis = 8 // space
        rng = np.random.default_rng(0)
        frames = rng.integers(0, 256, (f_axis, 32 * space, 64)).astype(np.int32)
        config = EncoderConfig(block_size=8, qp=22)

        out = encode_batch_sharded(frames, 22, config, mesh)
        recon = np.asarray(out["recon"])
        levels = np.asarray(out["levels"])

        for f in range(frames.shape[0]):
            single = encode_plane_full(
                jnp.asarray(frames[f]), jnp.int32(22), n=8
            )
            assert np.array_equal(recon[f], np.asarray(single["recon"])), f
            assert np.array_equal(levels[f], np.asarray(single["levels"])), f

    @needs_8
    def test_mean_psnr_reduction(self):
        mesh = make_mesh(space=1)
        rng = np.random.default_rng(1)
        frames = rng.integers(0, 256, (8, 32, 32)).astype(np.int32)
        out = encode_batch_sharded(frames, 30, EncoderConfig(block_size=4, qp=30), mesh)
        per_frame = np.asarray(out["psnr"])
        assert np.isfinite(per_frame).all()
        assert abs(float(out["mean_psnr"]) - per_frame.mean()) < 1e-3

    @needs_8
    def test_sharded_closed_loop_matches_single_device(self):
        """Frame-sharded wavefront encode == per-frame closed loop."""
        from nanohevc_tpu.models.wavefront import encode_plane_closed_loop
        from nanohevc_tpu.parallel import make_closed_loop_encoder

        mesh = make_mesh(space=1)
        rng = np.random.default_rng(3)
        frames = rng.integers(0, 256, (8, 32, 48)).astype(np.int32)
        config = EncoderConfig(block_size=8, qp=24)
        fn = make_closed_loop_encoder(config, mesh)
        sharding = NamedSharding(mesh, P("frame", None, None))
        planes = jax.device_put(jnp.asarray(frames), sharding)
        out = fn(planes, jnp.int32(24))
        for f in range(8):
            single = encode_plane_closed_loop(
                jnp.asarray(frames[f]), jnp.int32(24), n=8
            )
            for k in ("recon", "levels", "modes"):
                assert np.array_equal(
                    np.asarray(out[k][f]), np.asarray(single[k])
                ), (k, f)

    @needs_8
    def test_sharded_smoothing_matches_single_device(self):
        """Regression: the sharded XLA step once dropped the
        intra_smoothing flag."""
        mesh = make_mesh(space=1)
        rng = np.random.default_rng(7)
        frames = rng.integers(0, 256, (8, 32, 64)).astype(np.int32)
        config = EncoderConfig(
            block_size=8, qp=22, mode_set="all", decision="satd",
            intra_smoothing=True,
        )
        fn = make_batch_encoder(config, mesh)
        sharding = NamedSharding(mesh, P("frame", "space", None))
        planes = jax.device_put(jnp.asarray(frames), sharding)
        out = fn(planes, jnp.int32(22))
        single = encode_plane_full(
            jnp.asarray(frames[0]), jnp.int32(22), n=8, mode_set="all",
            decision="satd", intra_smoothing=True,
        )
        assert np.array_equal(
            np.asarray(out["recon"][0]), np.asarray(single["recon"])
        )
        assert np.array_equal(
            np.asarray(out["modes"][0]), np.asarray(single["modes"])
        )

    def test_unsharded_encoders_cached_on_config(self):
        """One jitted program per frozen config: the sequence encoder,
        the CLI and callers that re-create an encoder share it."""
        from nanohevc_tpu.parallel import make_closed_loop_encoder

        cfg = EncoderConfig(block_size=8, qp=22, mode_set="all", decision="satd")
        same = EncoderConfig(block_size=8, qp=22, mode_set="all", decision="satd")
        assert make_batch_encoder(cfg) is make_batch_encoder(same)
        assert make_closed_loop_encoder(cfg) is make_closed_loop_encoder(same)
        assert make_closed_loop_encoder(cfg) is not make_closed_loop_encoder(
            cfg, is_luma=False
        )

    def test_unsharded_encoder_works(self):
        fn = make_batch_encoder(EncoderConfig(block_size=8, qp=22))
        rng = np.random.default_rng(2)
        frames = jnp.asarray(rng.integers(0, 256, (2, 32, 64)).astype(np.int32))
        out = fn(frames, jnp.int32(22))
        assert out["recon"].shape == (2, 32, 64)
        assert out["levels"].shape == (2, 32, 64)


REPO = str(Path(__file__).resolve().parents[1])


class TestGraftEntry:
    @pytest.mark.slow   # ~90 s: every sharded program compiles once
    def test_dryrun_multichip(self):
        sys.path.insert(0, REPO)
        from __graft_entry__ import dryrun_multichip

        dryrun_multichip(len(jax.devices()))

    def test_dryrun_multichip_needs_the_devices(self):
        """Asked for more devices than the process has, the dry run
        raises instead of substituting a virtual CPU mesh."""
        sys.path.insert(0, REPO)
        from __graft_entry__ import dryrun_multichip

        with pytest.raises(RuntimeError, match="needs"):
            dryrun_multichip(len(jax.devices()) + 1)

    @pytest.mark.slow
    def test_entry_compiles(self):
        sys.path.insert(0, REPO)
        from __graft_entry__ import entry

        fn, (plane, qp) = entry()
        # compile-check on a small slice to keep CPU time down
        small = plane[:64, :128]
        out = jax.jit(fn)(small, qp)
        assert out["recon"].shape == (64, 128)


class TestShardedXlaPath:
    @needs_8
    @pytest.mark.parametrize("space,mode_set", [
        (2, "dc_planar"),
        (4, "dc_planar"),
        (2, "all"),
    ])
    def test_nondivisible_height_matches_unsharded(self, space, mode_set):
        """Rows split over 'space' where space*N does not divide the
        height (the 1080p case: 135 rows of 8 over 2 devices): XLA's
        partitioner inserts the halos, and the result equals the
        unsharded encoder bit-for-bit."""
        mesh = make_mesh(space=space)
        f_axis = 8 // space
        h = 40   # 5 block-rows: not a multiple of space*8
        rng = np.random.default_rng(11 + space)
        frames = rng.integers(0, 256, (f_axis, h, 64)).astype(np.int32)
        cfg = EncoderConfig(
            block_size=8, qp=25, mode_set=mode_set,
            decision="energy" if mode_set == "dc_planar" else "satd",
        )
        out = encode_batch_sharded(frames, 25, cfg, mesh)
        want = make_batch_encoder(cfg)(jnp.asarray(frames), jnp.int32(25))
        assert out["recon"].shape == (f_axis, h, 64)
        for k in ("recon", "levels", "modes", "psnr"):
            assert np.array_equal(np.asarray(out[k]), np.asarray(want[k])), k

    def test_runtime_qp_is_honoured(self):
        """One compiled batch encoder serves every QP: the traced qp
        argument reaches the quantizer (what rate control relies on)."""
        fn = make_batch_encoder(EncoderConfig(block_size=8, qp=22))
        rng = np.random.default_rng(12)
        frames = jnp.asarray(rng.integers(0, 256, (2, 16, 32)).astype(np.int32))
        for qp in (10, 40):
            got = fn(frames, jnp.int32(qp))
            want = encode_plane_full(frames[0], jnp.int32(qp), n=8)
            assert np.array_equal(
                np.asarray(got["levels"][0]), np.asarray(want["levels"])
            ), qp
