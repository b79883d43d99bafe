"""Batched deblocking filter (spec 8.7.2, all-intra bS = 2).

Vectorized twin of ref/deblock.py (the sequential oracle; see its
docstring for the spec mapping and the all-intra specialization).

Batched formulation: filters on the 8-sample deblocking grid touch at most
4 samples each side of an edge, and edges are >= 8 apart, so every
edge in a pass is independent — the whole plane's vertical pass is a
handful of elementwise ops over (H, n_edges) views taken with static
stride-8 slices (no gather HLO anywhere).  The 4-line segment
decisions of 8.7.2.5.3 are a (H//4, 4, n_edges) reshape reading lines
0 and 3.  The horizontal pass is the same function on the transpose
of the vertical pass's output (the spec's pass ordering, 8.7.2.1).

Zero-strength QPs need no special casing: tc == 0 clips every delta
to zero and beta == 0 makes d < beta unsatisfiable, so low-QP planes
pass through unchanged (pinned by tests against the oracle).

All arithmetic is int32; `>>` on negatives is arithmetic in XLA,
matching the numpy oracle.  qp may be a traced scalar (rate-controlled
sequences vary it per frame), so the Table 8-12 lookups are dynamic.
"""

from __future__ import annotations

import jax.numpy as jnp

from nanohevc_tpu.ref.deblock import BETA_TABLE, TC_TABLE

# No module-level jnp constants: this module is imported lazily inside
# jitted pipelines, and an Array created during an active trace leaks
# as a tracer into later traces.  Tables lift per call (XLA folds it).


def _params(qp, bit_depth: int):
    """Traced (beta, tc) for a bS=2 edge (Table 8-12, bit-depth scaled)."""
    qp = jnp.asarray(qp, jnp.int32)
    beta = jnp.asarray(BETA_TABLE)[jnp.clip(qp, 0, 51)] << (bit_depth - 8)
    tc = jnp.asarray(TC_TABLE)[jnp.clip(qp + 2, 0, 53)] << (bit_depth - 8)
    return beta, tc


def _edge_cols(x, n_e: int):
    """The 8 sample columns around every edge: list of (..., H, n_e)."""
    return [x[..., :, 4 + j : 4 + j + 8 * (n_e - 1) + 1 : 8] for j in range(8)]


def _seg_bcast(m, h: int):
    """(..., H//4, n_e) per-segment mask -> (..., H, n_e) per row.

    Tail rows past the last full 4-row segment get False (unfiltered).
    """
    b = jnp.broadcast_to(m[..., :, None, :], (*m.shape[:-1], 4, m.shape[-1]))
    b = b.reshape(*m.shape[:-2], 4 * m.shape[-2], m.shape[-1])
    rem = h - b.shape[-2]
    if rem:
        pad = jnp.zeros((*b.shape[:-2], rem, b.shape[-1]), b.dtype)
        b = jnp.concatenate([b, pad], axis=-2)
    return b


def _vertical_pass(x, qp, bit_depth: int, is_chroma: bool):
    """Filter all interior vertical edges of (..., H, W) planes."""
    h, w = x.shape[-2], x.shape[-1]
    n_e = (w - 4) // 8
    if n_e <= 0:
        return x
    beta, tc = _params(qp, bit_depth)
    pix_max = (1 << bit_depth) - 1
    x = x.astype(jnp.int32)

    if is_chroma:
        # 8.7.2.5.5: p0/q0 only, no on/off decision beyond bS == 2.
        # Columns around edge x=8k: p1/p0/q0/q1 at 8k-2 .. 8k+1.
        p1 = x[..., :, 6 : 6 + 8 * (n_e - 1) + 1 : 8]
        p0 = x[..., :, 7 : 7 + 8 * (n_e - 1) + 1 : 8]
        q0 = x[..., :, 8 : 8 + 8 * (n_e - 1) + 1 : 8]
        q1 = x[..., :, 9 : 9 + 8 * (n_e - 1) + 1 : 8]
        delta = jnp.clip((((q0 - p0) << 2) + p1 - q1 + 4) >> 3, -tc, tc)
        x = x.at[..., :, 7 : 7 + 8 * (n_e - 1) + 1 : 8].set(
            jnp.clip(p0 + delta, 0, pix_max))
        x = x.at[..., :, 8 : 8 + 8 * (n_e - 1) + 1 : 8].set(
            jnp.clip(q0 - delta, 0, pix_max))
        return x

    p3, p2, p1, p0, q0, q1, q2, q3 = _edge_cols(x, n_e)

    # Per-row second derivatives; per-segment decisions from rows 0/3.
    # A trailing partial (< 4-row) segment is left unfiltered, matching
    # the oracle's range(0, h-3, 4); padded planes never have one.
    dp = jnp.abs(p2 - 2 * p1 + p0)
    dq = jnp.abs(q2 - 2 * q1 + q0)
    hs = h // 4
    if hs == 0:
        return x

    def seg(a):  # head rows of (..., H, n_e) -> (..., H//4, 4, n_e)
        a = a[..., : 4 * hs, :]
        return a.reshape(*a.shape[:-2], hs, 4, n_e)

    dp03 = seg(dp)[..., 0, :] + seg(dp)[..., 3, :]
    dq03 = seg(dq)[..., 0, :] + seg(dq)[..., 3, :]
    on = (dp03 + dq03) < beta                        # 8.7.2.5.3 d < beta

    def strong_at(i):
        sw = 2 * (seg(dp)[..., i, :] + seg(dq)[..., i, :]) < (beta >> 2)
        sw &= (jnp.abs(seg(p3)[..., i, :] - seg(p0)[..., i, :])
               + jnp.abs(seg(q0)[..., i, :] - seg(q3)[..., i, :])) < (beta >> 3)
        sw &= jnp.abs(seg(p0)[..., i, :] - seg(q0)[..., i, :]) < (
            (5 * tc + 1) >> 1)
        return sw

    strong = _seg_bcast(on & strong_at(0) & strong_at(3), h)
    weak = _seg_bcast(on, h) & ~strong
    side = (beta + (beta >> 1)) >> 3
    filt_p1 = weak & _seg_bcast(dp03 < side, h)
    filt_q1 = weak & _seg_bcast(dq03 < side, h)

    # Strong filter (8.7.2.5.7), clipped to +-2*tc around the input.
    c2 = 2 * tc
    p0s = jnp.clip((p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3,
                   p0 - c2, p0 + c2)
    p1s = jnp.clip((p2 + p1 + p0 + q0 + 2) >> 2, p1 - c2, p1 + c2)
    p2s = jnp.clip((2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3,
                   p2 - c2, p2 + c2)
    q0s = jnp.clip((p1 + 2 * p0 + 2 * q0 + 2 * q1 + q2 + 4) >> 3,
                   q0 - c2, q0 + c2)
    q1s = jnp.clip((p0 + q0 + q1 + q2 + 2) >> 2, q1 - c2, q1 + c2)
    q2s = jnp.clip((p0 + q0 + q1 + 3 * q2 + 2 * q3 + 4) >> 3,
                   q2 - c2, q2 + c2)

    # Weak filter: per-row delta, dead when |delta| >= 10*tc.
    delta = (9 * (q0 - p0) - 3 * (q1 - p1) + 8) >> 4
    wok = weak & (jnp.abs(delta) < 10 * tc)
    dc = jnp.clip(delta, -tc, tc)
    p0w = jnp.clip(p0 + dc, 0, pix_max)
    q0w = jnp.clip(q0 - dc, 0, pix_max)
    th = tc >> 1
    p1w = jnp.clip(p1 + jnp.clip((((p2 + p0 + 1) >> 1) - p1 + dc) >> 1,
                                 -th, th), 0, pix_max)
    q1w = jnp.clip(q1 + jnp.clip((((q2 + q0 + 1) >> 1) - q1 - dc) >> 1,
                                 -th, th), 0, pix_max)

    new = [
        None,                                                   # p3
        jnp.where(strong, p2s, p2),                             # p2
        jnp.where(strong, p1s, jnp.where(wok & filt_p1, p1w, p1)),
        jnp.where(strong, p0s, jnp.where(wok, p0w, p0)),
        jnp.where(strong, q0s, jnp.where(wok, q0w, q0)),
        jnp.where(strong, q1s, jnp.where(wok & filt_q1, q1w, q1)),
        jnp.where(strong, q2s, q2),                             # q2
        None,                                                   # q3
    ]
    for j in (1, 2, 3, 4, 5, 6):
        x = x.at[..., :, 4 + j : 4 + j + 8 * (n_e - 1) + 1 : 8].set(new[j])
    return x


def deblock_plane(plane, qp, bit_depth: int = 8, is_chroma: bool = False):
    """Deblock (..., H, W) reconstructed planes; jittable, batched.

    Applied to the padded (block-aligned) reconstruction before the
    conformance-window crop, identically in encoder and decoder, so
    closed-loop decode stays pixel-exact.  Bit-exact vs the
    ref/deblock.py oracle (tests/test_deblock.py).
    """
    v = _vertical_pass(jnp.asarray(plane), qp, bit_depth, is_chroma)
    return _vertical_pass(
        v.swapaxes(-1, -2), qp, bit_depth, is_chroma
    ).swapaxes(-1, -2)
