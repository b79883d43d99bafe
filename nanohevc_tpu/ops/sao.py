"""Batched Sample Adaptive Offset (spec 8.7.3).

Vectorized twin of ref/sao.py (see its docstring for the spec mapping
and the per-plane framework adaptation).  Sample classification is
pure elementwise algebra — EO categories come from two rolled copies
of the plane with a static border-validity mask (rolled wrap values
never escape the mask), band indices from one shift — so the whole
filter is a handful of fused VPU ops; no gather HLO on the pixel path
(the final 5/32-entry LUT lookups are tiny constant-indexed takes).

Estimation statistics are exact integer reductions (category counts
and diff sums in int32, order-independent), scored in float32 with
the same operation order as the oracle, so the chosen parameters are
bit-identical to ref/sao.py across impls (tests/test_sao.py).

`type_idx`/`band_pos`/`offsets` are traced values: one compiled
program serves every parameter choice (sequence decode batches frames
with different per-frame SAO).
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from nanohevc_tpu.ref.sao import (
    EDGE_CAT,
    EO_NEIGHBORS,
    SAO_BO,
    SAO_EO0,
    SAO_OFF,
    max_offset,
)

# NOTE: no module-level jnp constants — this module is imported lazily
# inside jitted pipelines, and an Array created during an active trace
# leaks as a tracer into every later trace (UnexpectedTracerError from
# a *different* jit).  EDGE_CAT stays numpy; _eo_cat lifts it per call
# (XLA constant-folds the conversion).


def _valid_mask(h: int, w: int, eo_class: int) -> np.ndarray:
    """Static (h, w) bool: both EO neighbors inside the picture."""
    dy0, dx0, dy1, dx1 = EO_NEIGHBORS[eo_class]
    m = np.ones((h, w), bool)
    for dy, dx in ((dy0, dx0), (dy1, dx1)):
        if dy < 0:
            m[:1] = False
        if dy > 0:
            m[-1:] = False
        if dx < 0:
            m[:, :1] = False
        if dx > 0:
            m[:, -1:] = False
    return m


def _eo_cat(p, eo_class: int):
    """(..., H, W) int32 EO category; border samples category 0."""
    dy0, dx0, dy1, dx1 = EO_NEIGHBORS[eo_class]
    n0 = jnp.roll(p, (-dy0, -dx0), axis=(-2, -1))
    n1 = jnp.roll(p, (-dy1, -dx1), axis=(-2, -1))
    ei = 2 + jnp.sign(p - n0) + jnp.sign(p - n1)
    cat = jnp.asarray(EDGE_CAT)[ei]
    valid = jnp.asarray(_valid_mask(p.shape[-2], p.shape[-1], eo_class))
    return jnp.where(valid, cat, 0)


def _band_idx(p, bit_depth: int):
    return (p >> (bit_depth - 5)).astype(jnp.int32)


def apply_sao(plane, type_idx, band_pos, offsets, bit_depth: int = 8):
    """Apply (type_idx, band_pos, offsets[4]) to (..., H, W) planes.

    All three parameters may be traced; type SAO_OFF yields the input
    unchanged.  Bit-exact vs ref/sao.apply_sao.
    """
    p = jnp.asarray(plane).astype(jnp.int32)
    type_idx = jnp.asarray(type_idx, jnp.int32)
    band_pos = jnp.asarray(band_pos, jnp.int32)
    offsets = jnp.asarray(offsets, jnp.int32)
    pix_max = (1 << bit_depth) - 1

    lut5 = jnp.concatenate([jnp.zeros(1, jnp.int32), offsets])
    delta = jnp.zeros_like(p)
    for c in range(4):
        delta = jnp.where(type_idx == SAO_EO0 + c, lut5[_eo_cat(p, c)], delta)
    lut32 = jnp.zeros(32, jnp.int32).at[(band_pos + jnp.arange(4)) & 31].set(
        offsets)
    delta = jnp.where(type_idx == SAO_BO,
                      lut32[_band_idx(p, bit_depth)], delta)
    return jnp.clip(p + delta, 0, pix_max)


def _offset_from_stats(cnt, ssum, cap: int, lo: int, hi: int):
    """Mirror of ref/sao._offset_from_stats (float32 round, clips)."""
    o = jnp.round(ssum.astype(jnp.float32)
                  / jnp.maximum(cnt, 1).astype(jnp.float32))
    o = jnp.clip(o.astype(jnp.int32), max(lo, -cap), min(hi, cap))
    return jnp.where(cnt > 0, o, 0).astype(jnp.int32)


def _delta_sse(cnt, ssum, o):
    cnt = cnt.astype(jnp.float32)
    ssum = ssum.astype(jnp.float32)
    o = o.astype(jnp.float32)
    return cnt * (o * o) - jnp.float32(2.0) * o * ssum


def estimate_sao(src, rec, bit_depth: int = 8):
    """(H, W) src/rec -> (type_idx, band_pos, offsets[4]) int32 scalars.

    Jittable; vmap over a frame batch for per-frame parameters.
    Candidate order (off, EO 0-3, BO positions 0-28) and float32
    scoring mirror the oracle, so ties resolve identically.
    """
    src = jnp.asarray(src).astype(jnp.int32)
    rec = jnp.asarray(rec).astype(jnp.int32)
    diff = src - rec
    cap = max_offset(bit_depth)

    scores = [jnp.float32(0.0)]                     # candidate 0: off
    all_offs = [jnp.zeros(4, jnp.int32)]
    for c in range(4):
        cat = _eo_cat(rec, c)
        offs = []
        d_total = jnp.float32(0.0)
        for k in range(1, 5):
            m = (cat == k).astype(jnp.int32)
            cnt = m.sum(dtype=jnp.int32)
            ssum = (diff * m).sum(dtype=jnp.int32)
            lo, hi = (0, cap) if k <= 2 else (-cap, 0)
            o = _offset_from_stats(cnt, ssum, cap, lo, hi)
            offs.append(o)
            d_total = d_total + _delta_sse(cnt, ssum, o)
        scores.append(d_total)
        all_offs.append(jnp.stack(offs))

    bands = _band_idx(rec, bit_depth).reshape(-1)
    cnt_b = jnp.zeros(32, jnp.int32).at[bands].add(1)
    sum_b = jnp.zeros(32, jnp.int32).at[bands].add(diff.reshape(-1))
    o_b = _offset_from_stats(cnt_b, sum_b, cap, -cap, cap)
    d_b = _delta_sse(cnt_b, sum_b, o_b)
    # left-to-right 4-band window chain, same order as the oracle
    d_win = ((d_b[0:29] + d_b[1:30]) + d_b[2:31]) + d_b[3:32]
    bo_offs = jnp.stack([o_b[p : p + 29] for p in range(4)], axis=1)

    score_v = jnp.concatenate([jnp.stack(scores), d_win])       # (34,)
    offs_v = jnp.concatenate([jnp.stack(all_offs), bo_offs])    # (34, 4)
    idx = jnp.argmin(score_v).astype(jnp.int32)   # first minimum wins
    type_idx = jnp.where(idx == 0, SAO_OFF,
                         jnp.where(idx <= 4, idx, SAO_BO))
    band_pos = jnp.where(idx >= 5, idx - 5, 0)
    return type_idx, band_pos, offs_v[idx]
