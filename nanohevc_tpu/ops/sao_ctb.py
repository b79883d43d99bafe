"""CTB-granular Sample Adaptive Offset (spec 8.7.3 at CTB grain).

The per-frame SAO stage (ops/sao.py) adapts one parameter set per
plane; the spec signals SAO per CTB with merge-left/up flags, which is
where most of SAO's gain on mixed content lives.  This module does the
CTB-granular version as batched device ops:

* Classification stays FULL-PLANE (the spec filters across CTB
  boundaries; only picture borders mask to category 0), so tile edges
  see their true neighbors.  Per-tile statistics are then plain
  reshape-reductions over the (nty, T, ntx, T) view — no gathers.
* Each tile's (type, band_pos, offsets) is chosen by rate-distortion:
  exact SSE delta per candidate (cnt*o^2 - 2*o*sum from the integer
  stats) plus lambda * signalling bits (2/20/23 bits for
  off / EO / BO under the bit-packed tile syntax in
  runtime/bitstream.py).  A second pass offers each tile its left/up
  neighbors' first-pass parameters at merge price (2 bits), the
  standard one-step approximation of the spec's sao_merge_left/up RDO.
  Merge flags themselves are derived at signalling time by exact
  equality of FINAL parameters, so decode correctness never depends on
  the decision quality.
* apply_sao_ctb upsamples the (nty, ntx) parameter maps to pixel grain
  with jnp.repeat and applies all types with where-masks — the same
  gather-free shape as ops/sao.apply_sao, shared verbatim by encoder
  and decoder for pixel-exact round trips.

Estimation arithmetic mirrors ops/sao.py (int32 stats, float32
scoring, first-minimum ties) so a 1-tile grid reproduces the per-frame
estimator's choice exactly on border-free content and the numpy test
oracle can pin every path.

Reference scope: the reference has no loop filters at all; SAO is a
framework capability beyond it (its README.md:97-100 roadmap stops at
entropy coding).
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from nanohevc_tpu.ref.sao import SAO_BO, SAO_EO0, SAO_OFF, max_offset
from nanohevc_tpu.ops.sao import (
    _band_idx,
    _delta_sse,
    _eo_cat,
    _offset_from_stats,
)

# Signalling cost per tile under the bit-packed syntax (merge bits are
# position-dependent 0-2 and charged separately by the merge pass).
BITS_OFF = 2.0
BITS_EO = 20.0    # 2 type + 2 class + 4 * 4-bit offsets
BITS_BO = 23.0    # 2 type + 5 band_pos + 4 * 4-bit offsets
BITS_MERGE = 2.0


def tile_grid(h: int, w: int, tile: int) -> tuple[int, int]:
    return -(-h // tile), -(-w // tile)


def _pad_to_tiles(x: jnp.ndarray, tile: int) -> jnp.ndarray:
    h, w = x.shape[-2:]
    nty, ntx = tile_grid(h, w, tile)
    pad = [(0, 0)] * (x.ndim - 2) + [(0, nty * tile - h), (0, ntx * tile - w)]
    return jnp.pad(x, pad)


def _tile_sum(x: jnp.ndarray, tile: int) -> jnp.ndarray:
    """(H, W) int32 -> (nty, ntx) int32 per-tile sums (H, W padded)."""
    hp, wp = x.shape[-2:]
    v = x.reshape(hp // tile, tile, wp // tile, tile)
    return v.sum(axis=(1, 3), dtype=jnp.int32)


def sao_tile_stats(src, rec, tile: int, bit_depth: int = 8):
    """Integer SAO statistics per tile.

    src/rec (H, W) -> dict of int32 arrays:
      eo_cnt/eo_sum (4, 4, nty, ntx)  [eo_class, category-1, ty, tx]
      bo_cnt/bo_sum (32, nty, ntx)    [band, ty, tx]
    Classification is full-plane; only picture borders are category 0.
    """
    src = jnp.asarray(src).astype(jnp.int32)
    rec = jnp.asarray(rec).astype(jnp.int32)
    h, w = rec.shape
    diff = src - rec
    valid = jnp.ones((h, w), jnp.int32)
    diff_p = _pad_to_tiles(diff, tile)
    valid_p = _pad_to_tiles(valid, tile)

    eo_cnt, eo_sum = [], []
    for c in range(4):
        cat_p = _pad_to_tiles(_eo_cat(rec, c), tile)
        cnt_c, sum_c = [], []
        for k in range(1, 5):
            m = ((cat_p == k) & (valid_p == 1)).astype(jnp.int32)
            cnt_c.append(_tile_sum(m, tile))
            sum_c.append(_tile_sum(diff_p * m, tile))
        eo_cnt.append(jnp.stack(cnt_c))
        eo_sum.append(jnp.stack(sum_c))

    band_p = _pad_to_tiles(_band_idx(rec, bit_depth), tile)
    bo_cnt, bo_sum = [], []
    for b in range(32):
        m = ((band_p == b) & (valid_p == 1)).astype(jnp.int32)
        bo_cnt.append(_tile_sum(m, tile))
        bo_sum.append(_tile_sum(diff_p * m, tile))
    return {
        "eo_cnt": jnp.stack(eo_cnt),
        "eo_sum": jnp.stack(eo_sum),
        "bo_cnt": jnp.stack(bo_cnt),
        "bo_sum": jnp.stack(bo_sum),
    }


def _delta_for_params(stats, type_idx, band_pos, offsets):
    """Exact SSE delta of applying given params to each tile.

    type_idx/band_pos (nty, ntx) int32, offsets (nty, ntx, 4) int32
    -> (nty, ntx) float32.  Computed from the integer stats, so it
    prices ANY parameter set (the merge pass uses neighbor params).
    """
    d = jnp.zeros(type_idx.shape, jnp.float32)
    for c in range(4):
        dc = jnp.zeros_like(d)
        for k in range(4):
            dc = dc + _delta_sse(
                stats["eo_cnt"][c, k], stats["eo_sum"][c, k],
                offsets[..., k],
            )
        d = jnp.where(type_idx == SAO_EO0 + c, dc, d)
    bo_cnt = jnp.moveaxis(stats["bo_cnt"], 0, -1)       # (nty, ntx, 32)
    bo_sum = jnp.moveaxis(stats["bo_sum"], 0, -1)
    db = jnp.zeros_like(d)
    for k in range(4):
        idx = (band_pos + k) & 31
        cnt_k = jnp.take_along_axis(bo_cnt, idx[..., None], -1)[..., 0]
        sum_k = jnp.take_along_axis(bo_sum, idx[..., None], -1)[..., 0]
        db = db + _delta_sse(cnt_k, sum_k, offsets[..., k])
    return jnp.where(type_idx == SAO_BO, db, d)


def estimate_sao_ctb(src, rec, tile: int, qp, bit_depth: int = 8,
                     rd_lambda_scale: float = 1.0, merge: bool = True):
    """Per-tile RD-selected SAO parameters.

    (H, W) src/rec -> (type_map (nty, ntx), band_map (nty, ntx),
    off_map (nty, ntx, 4)) int32.  Cost = SSE delta + lambda * bits
    with the HEVC-style lambda(QP); the merge pass offers each tile its
    left/up neighbors' pass-1 parameters at merge price.
    """
    stats = sao_tile_stats(src, rec, tile, bit_depth)
    cap = max_offset(bit_depth)
    lam = rd_lambda_scale * 0.57 * jnp.exp2(
        (jnp.asarray(qp, jnp.float32) - 12.0) / 3.0
    )
    nty, ntx = stats["bo_cnt"].shape[1:]

    # Candidate 0: off.
    scores = [jnp.full((nty, ntx), lam * BITS_OFF, jnp.float32)]
    offs_all = [jnp.zeros((nty, ntx, 4), jnp.int32)]
    # Candidates 1-4: the four EO classes.
    for c in range(4):
        offs_c, d_tot = [], jnp.zeros((nty, ntx), jnp.float32)
        for k in range(4):
            cnt = stats["eo_cnt"][c, k]
            ssum = stats["eo_sum"][c, k]
            lo, hi = (0, cap) if k < 2 else (-cap, 0)
            o = _offset_from_stats(cnt, ssum, cap, lo, hi)
            offs_c.append(o)
            d_tot = d_tot + _delta_sse(cnt, ssum, o)
        scores.append(d_tot + lam * BITS_EO)
        offs_all.append(jnp.stack(offs_c, axis=-1))
    # Candidates 5-33: BO windows at positions 0-28.
    o_b = _offset_from_stats(stats["bo_cnt"], stats["bo_sum"], cap,
                             -cap, cap)                  # (32, nty, ntx)
    d_b = _delta_sse(stats["bo_cnt"], stats["bo_sum"], o_b)
    for p in range(29):
        d_win = ((d_b[p] + d_b[p + 1]) + d_b[p + 2]) + d_b[p + 3]
        scores.append(d_win + lam * BITS_BO)
        offs_all.append(jnp.stack([o_b[p + k] for k in range(4)], axis=-1))

    score_v = jnp.stack(scores)                          # (34, nty, ntx)
    offs_v = jnp.stack(offs_all)                         # (34, nty, ntx, 4)
    idx = jnp.argmin(score_v, axis=0).astype(jnp.int32)  # first min wins
    type_map = jnp.where(idx == 0, SAO_OFF,
                         jnp.where(idx <= 4, idx, SAO_BO))
    band_map = jnp.where(idx >= 5, idx - 5, 0)
    onehot = (
        jnp.arange(34, dtype=jnp.int32)[:, None, None] == idx
    ).astype(jnp.int32)
    off_map = (offs_v * onehot[..., None]).sum(axis=0)
    best_cost = (score_v * onehot.astype(jnp.float32)).sum(axis=0)

    if not merge:
        return type_map, band_map, off_map

    # Merge pass: adopt the left/up neighbor's pass-1 params when the
    # exact SSE of those params here plus the merge price beats our
    # own full-signalling cost.  Decode-side merge flags are derived
    # later by equality of FINAL params, so this stays a pure decision.
    def shifted(m, axis, fill):
        pad = [(0, 0)] * m.ndim
        pad[axis] = (1, 0)
        sl = [slice(None)] * m.ndim
        sl[axis] = slice(0, m.shape[axis])
        return jnp.pad(m, pad, constant_values=fill)[tuple(sl)]

    best = (best_cost, type_map, band_map, off_map)
    for axis in (1, 0):                                  # left, then up
        nt, nb_, no_ = (shifted(type_map, axis, SAO_OFF),
                        shifted(band_map, axis, 0),
                        shifted(off_map, axis, 0))
        d_n = _delta_for_params(stats, nt, nb_, no_)
        d_n = jnp.where(nt == SAO_OFF, 0.0, d_n)
        cost_n = d_n + lam * BITS_MERGE
        first = jnp.zeros((nty, ntx), bool).at[
            (slice(None), 0) if axis == 1 else (0, slice(None))
        ].set(True)
        cost_n = jnp.where(first, jnp.inf, cost_n)      # no such neighbor
        take = cost_n < best[0]
        best = (
            jnp.where(take, cost_n, best[0]),
            jnp.where(take, nt, best[1]),
            jnp.where(take, nb_, best[2]),
            jnp.where(take[..., None], no_, best[3]),
        )
    return best[1], best[2], best[3]


def apply_sao_ctb(plane, type_map, band_map, off_map, tile: int,
                  bit_depth: int = 8):
    """Apply per-tile SAO parameters to (H, W) planes.

    Parameter maps may be traced; shared by encoder and decoder so
    round trips are pixel-exact.  Classification is full-plane,
    identical to the estimator's.
    """
    p = jnp.asarray(plane).astype(jnp.int32)
    h, w = p.shape[-2:]
    nty, ntx = tile_grid(h, w, tile)

    def up(m):
        m = jnp.repeat(m, tile, axis=0)[:h]
        return jnp.repeat(m, tile, axis=1)[:, :w]

    type_pix = up(jnp.asarray(type_map, jnp.int32))
    pos_pix = up(jnp.asarray(band_map, jnp.int32))
    off_pix = jnp.stack(
        [up(jnp.asarray(off_map[..., k], jnp.int32)) for k in range(4)],
        axis=-1,
    )
    delta = jnp.zeros_like(p)
    for c in range(4):
        cat = _eo_cat(p, c)
        sel = type_pix == SAO_EO0 + c
        for k in range(1, 5):
            delta = jnp.where(sel & (cat == k), off_pix[..., k - 1], delta)
    wi = (_band_idx(p, bit_depth) - pos_pix) & 31
    for k in range(4):
        delta = jnp.where((type_pix == SAO_BO) & (wi == k),
                          off_pix[..., k], delta)
    return jnp.clip(p + delta, 0, (1 << bit_depth) - 1)
