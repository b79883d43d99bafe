"""Batched intra prediction over the block axis (and the mode axis).

Replaces the reference's per-block, per-pixel Python loops
(/root/reference/nano_hevc/intra.py:37-207) with whole-frame tensor
ops: DC and planar are broadcast arithmetic; angular modes are two
static gathers plus an integer lerp driven by the compile-time tables
in ops.angular_tables.  All functions take the combined reference
vector layout produced by ops.tiling.extract_refs.
"""

from __future__ import annotations

from typing import Sequence

import jax
import jax.numpy as jnp

from nanohevc_tpu.ops.angular_tables import angular_tables, angular_weight_matrices

# Mode numbering follows HEVC: 0 = planar, 1 = DC, 2..34 angular.
PLANAR_MODE = 0
DC_MODE = 1
ALL_ANGULAR = tuple(range(2, 35))

# Reference-sample smoothing (spec 8.4.4.2.3): thresholds on
# min(|mode-26|, |mode-10|) per block size; 4x4 and DC never filter.
_SMOOTH_THRESH = {8: 7, 16: 1, 32: 0}


def mode_filter_flags(n: int):
    """Static (35,) bool: which modes read [1 2 1]-filtered references.

    filterFlag = n > 4 and mode != DC and
    min(|mode-26|, |mode-10|) > thresh[n] (spec 8.4.4.2.3; planar's
    mode index 0 gives minDist 10, so planar filters at every n >= 8).
    """
    import numpy as np

    flags = np.zeros(35, bool)
    if n == 4:
        return flags
    t = _SMOOTH_THRESH[n]
    for m in range(35):
        if m == DC_MODE:
            continue
        dist = 10 if m == PLANAR_MODE else min(abs(m - 26), abs(m - 10))
        flags[m] = dist > t
    return flags


def smooth_refs(
    refs: jnp.ndarray, n: int, bit_depth: int = 8, strong: bool = True
) -> jnp.ndarray:
    """Reference-sample filter (spec 8.4.4.2.3) on the combined
    (nb, 4N+2) layout.

    Normal filter: the boundary path runs bottom-left -> corner ->
    top-right; interior samples take (prev + 2*cur + next + 2) >> 2,
    the corner averages its two path neighbors (top[1], left[1]), and
    the two path endpoints (top[2N], left[2N]) pass unfiltered.

    Strong (bilinear) filter, 32x32 only: when both boundary arms are
    near-linear (|end + corner - 2*mid| < 1 << (bit_depth - 5)), the
    interior is replaced by the bilinear ramp between the corner and
    the arm's far end — the spec's strong_intra_smoothing, decided
    per block on device (`strong=True` mirrors
    sps_strong_intra_smoothing_enable_flag = 1).
    """
    top, left = _split_refs(refs, n)                     # (nb, 2N+1) each
    corner = top[:, 0:1]
    fc = (left[:, 1:2] + 2 * corner + top[:, 1:2] + 2) >> 2

    def filt(arr):
        # arr: (nb, 2N+1) corner-at-0; path neighbor of arr[1] is corner
        prev = arr[:, :-2]                               # corner..arr[2N-1]
        cur = arr[:, 1:-1]
        nxt = arr[:, 2:]
        body = (prev + 2 * cur + nxt + 2) >> 2           # arr[1..2N-1]
        return jnp.concatenate([fc, body, arr[:, -1:]], axis=1)

    f_top, f_left = filt(top), filt(left)

    if strong and n == 32:
        thresh = 1 << (bit_depth - 5)
        flat_t = (
            jnp.abs(corner + top[:, 2 * n : 2 * n + 1] - 2 * top[:, n : n + 1])
            < thresh
        )
        flat_l = (
            jnp.abs(corner + left[:, 2 * n : 2 * n + 1] - 2 * left[:, n : n + 1])
            < thresh
        )
        use_strong = flat_t & flat_l                     # (nb, 1)
        x = jnp.arange(2 * n - 1, dtype=jnp.int32)[None, :]   # samples 1..2N-1

        def bilinear(arr):
            end = arr[:, 2 * n : 2 * n + 1]
            ramp = ((2 * n - 1 - x) * corner + (x + 1) * end + n) >> (
                n.bit_length()
            )                                            # (+32) >> 6 at N=32
            return jnp.concatenate([corner, ramp, end], axis=1)

        f_top = jnp.where(use_strong, bilinear(top), f_top)
        f_left = jnp.where(use_strong, bilinear(left), f_left)

    return jnp.concatenate([f_top, f_left], axis=1)


def cat_refs(refs: jnp.ndarray, n: int, bit_depth: int = 8) -> jnp.ndarray:
    """(nb, 4N+2) -> (nb, 2*(4N+2)): raw refs beside smoothed refs.

    Pairs with cat_weight_matrices: each mode's weights live in the
    raw or the filtered half per its static filter flag, so smoothing
    costs one extra filter pass and a 2x-K matmul — no per-mode
    branching, no gathers.
    """
    return jnp.concatenate([refs, smooth_refs(refs, n, bit_depth)], axis=1)


def cat_weight_matrices(n: int):
    """(33, 2*(4N+2), N*N) weight stack routed by mode_filter_flags."""
    import numpy as np

    w = angular_weight_matrices(n)                       # (33, R, N*N)
    r = w.shape[1]
    flags = mode_filter_flags(n)
    out = np.zeros((33, 2 * r, w.shape[2]), w.dtype)
    for k in range(33):
        half = slice(r, 2 * r) if flags[k + 2] else slice(0, r)
        out[k, half] = w[k]
    return out


def _split_refs(refs: jnp.ndarray, n: int):
    """Combined (nb, 4N+2) -> top (nb, 2N+1), left (nb, 2N+1)."""
    return refs[:, : 2 * n + 1], refs[:, 2 * n + 1 :]


def dc_predict(refs: jnp.ndarray, n: int) -> jnp.ndarray:
    """(nb, 4N+2) -> (nb, N, N): floor((sum top + sum left + N) / 2N)."""
    top, left = _split_refs(refs, n)
    total = top[:, 1 : n + 1].sum(axis=1) + left[:, 1 : n + 1].sum(axis=1)
    dc = (total + n) // (2 * n)
    return jnp.broadcast_to(dc[:, None, None], (refs.shape[0], n, n))


def planar_predict(
    refs: jnp.ndarray,
    n: int,
    top_right: jnp.ndarray | None = None,
    bottom_left: jnp.ndarray | None = None,
) -> jnp.ndarray:
    """(nb, 4N+2) -> (nb, N, N) planar gradient (spec 8.4.4.2.4).

    By default top_right/bottom_left are the Nth reference samples
    (top[N], left[N] in corner-at-0 layout) — i.e. the last sample of
    the length-N neighbor row, matching the reference encoder's
    `top[-1]` convention (__main__.py:167-168).  Pass refs[:, n+1] /
    refs[:, 3n+2] for the spec-exact beyond-block samples instead.
    """
    top, left = _split_refs(refs, n)
    if top_right is None:
        top_right = top[:, n]
    if bottom_left is None:
        bottom_left = left[:, n]
    shift = n.bit_length()  # log2(n) + 1
    x = jnp.arange(n, dtype=jnp.int32)
    y = x
    h = (n - 1 - x)[None, None, :] * left[:, 1 : n + 1, None] + (x + 1)[
        None, None, :
    ] * top_right[:, None, None]
    v = (n - 1 - y)[None, :, None] * top[:, None, 1 : n + 1] + (y + 1)[
        None, :, None
    ] * bottom_left[:, None, None]
    return (h + v + n) >> shift


def _angular_from_tables(refs: jnp.ndarray, n: int, tabs) -> jnp.ndarray:
    """Shared gather+lerp: (nb, 4N+2) -> (nb, M, N, N)."""
    nb = refs.shape[0]
    m = len(tabs.modes)
    ref_len = 3 * n + 1
    # Stage 1: per-mode projection reference arrays (static gather).
    ref_m = refs[:, jnp.asarray(tabs.src)]                    # (nb, M, 3N+1)
    # Stage 2: projection (static gather along the ref axis) + lerp.
    idx = jnp.asarray(tabs.idx.reshape(m, n * n))
    a = jnp.take_along_axis(ref_m, jnp.broadcast_to(idx[None], (nb, m, n * n)), axis=2)
    idx1 = jnp.minimum(idx + 1, ref_len - 1)   # +1 only used when frac != 0
    b = jnp.take_along_axis(ref_m, jnp.broadcast_to(idx1[None], (nb, m, n * n)), axis=2)
    frac = jnp.asarray(tabs.frac.reshape(1, m, n * n))
    pred = ((32 - frac) * a + frac * b + 16) >> 5
    return pred.reshape(nb, m, n, n)


def angular_predict_all(refs: jnp.ndarray, n: int) -> jnp.ndarray:
    """All 33 angular modes at once: (nb, 4N+2) -> (nb, 33, N, N)."""
    return _angular_from_tables(refs, n, angular_tables(n))


def angular_predict_modes(
    refs: jnp.ndarray, n: int, modes: Sequence[int]
) -> jnp.ndarray:
    """A static subset of angular modes: -> (nb, len(modes), N, N)."""
    return _angular_from_tables(refs, n, angular_tables(n, tuple(modes)))


def angular_predict_mm(refs: jnp.ndarray, n: int, mode: int) -> jnp.ndarray:
    """One angular mode, gather-free: (refs @ W_mode + 16) >> 5.

    Bit-identical to the gather path (both implement the same lerp).
    """
    w = jnp.asarray(angular_weight_matrices(n, (mode,))[0])    # (4N+2, N*N)
    acc = jnp.einsum("br,rp->bp", refs, w, preferred_element_type=jnp.int32)
    return ((acc + 16) >> 5).reshape(refs.shape[0], n, n)


def predict_by_mode_mm(
    refs: jnp.ndarray, n: int, mode_idx: jnp.ndarray,
    smoothing: bool = False, bit_depth: int = 8,
) -> jnp.ndarray:
    """Gather-free per-block mode application.

    Selects each block's weight matrix by a one-hot (nb, 33) matmul
    over the stacked tables — pred = (refs_b @ W[mode_b]) computed as
    einsum with the one-hot folded in — then overlays DC/planar.
    With smoothing, the refs vector doubles to [raw | filtered] and
    each mode's weights route to the half its filter flag selects, so
    per-block dynamic modes still need no branching.
    """
    nb = refs.shape[0]
    if smoothing and n > 4:
        flags = mode_filter_flags(n)
        refs_in = cat_refs(refs, n, bit_depth)
        w_all = jnp.asarray(cat_weight_matrices(n))            # (33, 2R, N*N)
        pl_refs = (
            refs_in[:, refs.shape[1]:] if flags[PLANAR_MODE] else refs
        )
    else:
        refs_in = refs
        w_all = jnp.asarray(angular_weight_matrices(n))        # (33, R, N*N)
        pl_refs = refs
    onehot = jax.nn.one_hot(
        jnp.clip(mode_idx - 2, 0, 32), 33, dtype=jnp.int32
    )                                                           # (nb, 33)
    # per-block weight matrix: (nb, R, N*N) is too big; instead compute
    # all-mode predictions per block chunk? Fold differently:
    # acc[b, p] = sum_r refs[b, r] * W[m_b, r, p]
    #           = sum_m onehot[b, m] * (refs[b] @ W[m])[p]
    per_mode = jnp.einsum(
        "br,mrp->bmp", refs_in, w_all, preferred_element_type=jnp.int32
    )                                                           # (nb, 33, N*N)
    acc = jnp.einsum(
        "bm,bmp->bp", onehot, per_mode, preferred_element_type=jnp.int32
    )
    ang_pred = ((acc + 16) >> 5).reshape(nb, n, n)
    sel = mode_idx[:, None, None]
    return jnp.where(
        sel == PLANAR_MODE,
        planar_predict(pl_refs, n),
        jnp.where(sel == DC_MODE, dc_predict(refs, n), ang_pred),
    )


def predict_by_mode(refs: jnp.ndarray, n: int, mode_idx: jnp.ndarray) -> jnp.ndarray:
    """Per-block mode selection: (nb, 4N+2), (nb,) -> (nb, N, N).

    mode_idx uses HEVC numbering (0 planar, 1 DC, 2..34 angular) and
    may differ per block; the angular tables are gathered dynamically
    by block, so this stays O(nb * N^2) regardless of the mode mix.
    """
    nb = refs.shape[0]
    tabs = angular_tables(n)
    ang = jnp.clip(mode_idx - 2, 0, 32)
    src_b = jnp.asarray(tabs.src)[ang]                         # (nb, 3N+1)
    ref_b = jnp.take_along_axis(refs, src_b, axis=1)
    idx_b = jnp.asarray(tabs.idx.reshape(33, n * n))[ang]      # (nb, N*N)
    frac_b = jnp.asarray(tabs.frac.reshape(33, n * n))[ang]
    a = jnp.take_along_axis(ref_b, idx_b, axis=1)
    b = jnp.take_along_axis(ref_b, jnp.minimum(idx_b + 1, 3 * n), axis=1)
    ang_pred = (((32 - frac_b) * a + frac_b * b + 16) >> 5).reshape(nb, n, n)

    sel = mode_idx[:, None, None]
    return jnp.where(
        sel == PLANAR_MODE,
        planar_predict(refs, n),
        jnp.where(sel == DC_MODE, dc_predict(refs, n), ang_pred),
    )
