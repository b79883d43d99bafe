"""Rate-aware 35-mode decision (decision="rd"): SSE + lambda * bits."""

import numpy as np
import jax.numpy as jnp
import pytest

from nanohevc_tpu.config import EncoderConfig
from nanohevc_tpu.frame import Frame
from nanohevc_tpu.models.all_intra import encode_frame_full
from nanohevc_tpu.ref.metrics import psnr
from nanohevc_tpu.runtime.bitstream import assemble_bitstream


def _edges_frame(h=96, w=96):
    rng = np.random.default_rng(0)
    y, x = np.mgrid[0:h, 0:w]
    img = ((x // 7 + y // 11) % 2) * 180 + 40 + rng.normal(0, 3, (h, w))
    fr = Frame.zeros(h, w, dtype=np.int16)
    fr.y.data[...] = np.clip(img, 0, 255).astype(np.int16)
    fr.u.data[...] = 128
    fr.v.data[...] = 128
    return fr


def _run(fr, decision, qp):
    cfg = EncoderConfig(block_size=8, qp=qp, mode_set="all", decision=decision)
    recon, info = encode_frame_full(fr, cfg)
    planes = {
        nm: (np.asarray(p["levels"]), p["block_size"])
        for nm, p in info["planes"].items()
    }
    modes = {nm: np.asarray(p["modes"]) for nm, p in info["planes"].items()}
    bs = assemble_bitstream(fr.width, fr.height, qp, planes, modes)
    return len(bs), psnr(
        fr.y.data.astype(np.uint8), recon.y.data.astype(np.uint8)
    )


class TestRdDecision:
    @pytest.mark.slow   # ~82 s: 35-mode RD compile; the edge-content RD test keeps the contract fast
    def test_rd_runs_and_changes_modes_vs_satd(self):
        fr = _edges_frame()
        cfg_s = EncoderConfig(block_size=8, qp=30, mode_set="all", decision="satd")
        cfg_r = EncoderConfig(block_size=8, qp=30, mode_set="all", decision="rd")
        _, info_s = encode_frame_full(fr, cfg_s)
        _, info_r = encode_frame_full(fr, cfg_r)
        ms = np.asarray(info_s["planes"]["Y"]["modes"])
        mr = np.asarray(info_r["planes"]["Y"]["modes"])
        assert ms.shape == mr.shape
        assert not np.array_equal(ms, mr)  # the rate term binds

    @pytest.mark.slow   # ~120 s cold: first RD-program compile in the fast profile
    def test_rd_curve_dominates_satd_on_edges(self):
        """At equal (or smaller) size the RD decision must not lose
        PSNR on strongly directional content (docs/quality.md table)."""
        fr = _edges_frame()
        s_bytes, s_psnr = _run(fr, "satd", 30)
        r_bytes, r_psnr = _run(fr, "rd", 38)
        assert r_bytes < s_bytes
        assert r_psnr > s_psnr

    def test_rd_requires_qp(self):
        from nanohevc_tpu.models.all_intra import decide_modes
        from nanohevc_tpu import ops

        plane = jnp.zeros((16, 16), jnp.int32)
        blocks = ops.tile_plane(plane, 8)
        refs = ops.extract_refs(plane, 8)
        with pytest.raises(ValueError, match="rd"):
            decide_modes(blocks, refs, 8, "all", "rd")

    @pytest.mark.slow   # ~20 s closed-loop RD compile; decode exactness covered by test_wavefront
    def test_rd_closed_loop_decodes_pixel_exact(self):
        from nanohevc_tpu.models.wavefront import (
            decode_frame,
            encode_frame_closed_loop,
        )

        fr = _edges_frame(48, 64)
        cfg = EncoderConfig(
            block_size=8, qp=30, mode_set="all", decision="rd"
        )
        recon, bs = encode_frame_closed_loop(fr, cfg)
        dec = decode_frame(bs)
        assert np.array_equal(dec.y.data, recon.y.data)


class TestClosedLoopExactModeRate:
    @pytest.mark.slow   # ~27 s; the static-bound checks in test_modes_mpm stay fast
    def test_exact_mpm_rate_reduces_mode_bytes_and_decodes(self):
        """Closed-loop decision='rd' charges the EXACT MPM signalling
        cost (neighbors from the scan's decided-modes carry, no 2-pass
        approximation): the chosen mode field must code at most as many
        bytes as the SATD field on coherent content, and the stream
        must stay pixel-exact through decode_plane."""
        import numpy as np

        from nanohevc_tpu.models.wavefront import (
            decode_plane,
            encode_plane_closed_loop,
        )
        from nanohevc_tpu.runtime import entropy as E

        rng = np.random.default_rng(0)
        h, w, n, qp = 64, 96, 8, 38
        base = np.linspace(0, 255, w)[None, :] + rng.integers(
            -25, 26, (h, w))
        plane = jnp.asarray(np.clip(base, 0, 255).astype(np.int32))
        satd = encode_plane_closed_loop(
            plane, jnp.int32(qp), n=n, mode_set="all", decision="satd")
        rd = encode_plane_closed_loop(
            plane, jnp.int32(qp), n=n, mode_set="all", decision="rd")
        dec = decode_plane(rd["levels"], rd["modes"], jnp.int32(qp),
                           n=n, height=h, width=w)
        assert np.array_equal(np.asarray(dec), np.asarray(rd["recon"]))
        nby, nbx = h // n, w // n
        b_satd = len(E.encode_modes(np.asarray(satd["modes"]), nby, nbx))
        b_rd = len(E.encode_modes(np.asarray(rd["modes"]), nby, nbx))
        assert b_rd <= b_satd, (b_rd, b_satd)
