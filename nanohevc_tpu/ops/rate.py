"""Device-side rate model calibrated against the shipped range coder.

The RD coded-block decision (models/all_intra.py rdo_cbf) needs the
bit cost of coding each block's levels.  The true cost comes from the
adaptive range coder (runtime/native nhr_block_bits), which is
sequential host code — so the device uses a *static-context* model of
the same syntax:

    rate(block) = cbf_cost
                + sum_p sig_cost[min(p, 31), sig_p]          (ctx bins)
                + sum_sig gt1_cost + gt2_cost                (ctx bins)
                + sum_gt2 (2*floor(log2(|l|-2)) + 1)         (EG0, exact)
                + nnz                                        (signs, exact)

The context-bin costs are -log2 of empirical bin probabilities
measured from real quantized-level streams (a QP x content sweep, see
calibrate_rate_table) — the adaptive coder's code length approaches
that empirical entropy, so the model tracks nhr_block_bits closely
(< a few % per frame; quantified in tests/test_rate_model.py).  The
bypass parts (EG0 remainders, signs) cost exactly 1 bit/bin in the
coder and are exact here.

This replaces the round-1 heuristic sum(log2(|l|+1)) + 2*nnz, whose
errors flipped RD decisions (the reference's estimate_bits is the same
heuristic, its quant.py:153-168).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import jax
import jax.numpy as jnp


@dataclass(frozen=True)
class RateTable:
    """Static-context bin costs, all in bits (floats).

    sig0/sig1: cost of sig_coeff_flag = 0/1 at scan context 0..31;
    cbf0/cbf1, gt1_*, gt2_*, lastfull_*: scalar bin costs;
    lastp0/lastp1: last-position truncated-unary prefix bins 0..10.
    """

    sig0: tuple
    sig1: tuple
    cbf0: float
    cbf1: float
    gt1_0: float
    gt1_1: float
    gt2_0: float
    gt2_1: float
    lastfull0: float = 1.0
    lastfull1: float = 1.0
    lastp0: tuple = (1.0,) * 11
    lastp1: tuple = (1.0,) * 11


def calibrate_rate_table(levels: np.ndarray) -> RateTable:
    """Measure empirical bin probabilities of the residual syntax.

    levels: (nb, ncoef) int32 scan-ordered training data (concatenate
    several QPs/contents for a general-purpose table).  Costs are
    -log2(p) with +1 Laplace smoothing.
    """
    a = np.abs(levels.astype(np.int64))
    sig = a > 0
    nb, ncoef = a.shape
    coded = sig.any(axis=1)

    def cost(ones: float, total: float) -> tuple:
        p1 = (ones + 1.0) / (total + 2.0)
        return -np.log2(p1), -np.log2(1.0 - p1)

    cbf1_cost, cbf0_cost = cost(coded.sum(), nb)

    # last-position bins (coded blocks only): the full-block escape,
    # then the truncated-unary prefix of bit_length(last+1)-1.
    lastidx = ncoef - 1 - np.argmax(sig[:, ::-1], axis=1)
    full = coded & (lastidx == ncoef - 1)
    lf1, lf0 = cost(full.sum(), coded.sum())
    max_len = int(np.floor(np.log2(max(ncoef - 1, 2))))
    klen = np.zeros(nb, np.int64)
    for k in range(1, max_len + 1):
        klen += (lastidx + 1) >= (1 << k)
    nf = coded & ~full
    lastp0 = np.ones(11)
    lastp1 = np.ones(11)
    for i in range(max_len):
        total = (nf & (klen >= i)).sum()
        ones = (nf & (klen > i)).sum()
        l1, l0 = cost(ones, total)
        lastp1[i], lastp0[i] = l1, l0

    # sig bins are emitted only at positions BEFORE the last one
    emitted = coded[:, None] & (np.arange(ncoef)[None, :] < lastidx[:, None])
    pos = np.minimum(np.arange(ncoef), 31)
    sig1 = np.zeros(32)
    sig0 = np.zeros(32)
    for c in range(32):
        cols = pos == c
        m = emitted[:, cols]
        total = m.sum()
        ones = (sig[:, cols] & m).sum()
        s1, s0 = cost(ones, total)
        sig1[c], sig0[c] = s1, s0

    sig_vals = a[sig]
    gt1 = sig_vals > 1
    g11, g10 = cost(gt1.sum(), sig_vals.size)
    gt2_vals = sig_vals[gt1]
    g21, g20 = cost((gt2_vals > 2).sum(), max(gt2_vals.size, 1))
    return RateTable(
        sig0=tuple(sig0), sig1=tuple(sig1),
        cbf0=float(cbf0_cost), cbf1=float(cbf1_cost),
        gt1_0=float(g10), gt1_1=float(g11),
        gt2_0=float(g20), gt2_1=float(g21),
        lastfull0=float(lf0), lastfull1=float(lf1),
        lastp0=tuple(lastp0), lastp1=tuple(lastp1),
    )


def default_table(ncoef: int) -> RateTable:
    """The committed calibrated table for a coefficient count.

    Generated by tools/calibrate_rates.py (QP x content sweep through
    encode_plane_full, bin frequencies per scan context); one table per
    block size because position statistics differ across sizes.
    """
    from nanohevc_tpu.ops.rate_tables import DEFAULT_TABLES

    if ncoef in DEFAULT_TABLES:
        return DEFAULT_TABLES[ncoef]
    return DEFAULT_TABLES[max(DEFAULT_TABLES)]


@lru_cache(maxsize=8)
def _table_arrays(table: RateTable):
    return (
        jnp.asarray(table.sig0, jnp.float32),
        jnp.asarray(table.sig1, jnp.float32),
    )


def _last_info(sig: jnp.ndarray, ncoef: int):
    """Per-block last significant index and its prefix bit length.

    Returns (lastidx (nb,), klen (nb,), max_len): lastidx is valid only
    where the block is coded; klen = bit_length(lastidx+1) - 1 matches
    the coder's truncated-unary prefix (nanohevc_runtime.cpp
    encode_last), whose bound is max_len = floor(log2(ncoef-1)) because
    the full-block case is escaped separately.
    """
    lastidx = ncoef - 1 - jnp.argmax(sig[:, ::-1], axis=-1)
    x = lastidx + 1
    max_len = int(np.floor(np.log2(max(ncoef - 1, 2))))
    klen = sum(
        ((x >= (1 << k)).astype(jnp.int32) for k in range(1, max_len + 1)),
        start=jnp.zeros((), jnp.int32),
    )
    return lastidx, klen, max_len


def model_bits(packed: jnp.ndarray, table: RateTable | None = None
               ) -> jnp.ndarray:
    """Jittable rate model: (nb, ncoef) scan-packed levels -> (nb,) bits.

    Structurally faithful to the coder's residual syntax; context bins
    cost their calibrated -log2(p), bypass bins cost exactly 1.
    """
    if table is None:
        table = default_table(packed.shape[-1])
    sig0, sig1 = _table_arrays(table)
    a = jnp.abs(packed.astype(jnp.int32))
    sig = a > 0
    ncoef = packed.shape[-1]
    pos = jnp.minimum(jnp.arange(ncoef), 31)

    # last-position cost: full-block escape bin, else prefix + suffix
    lastidx, klen, max_len = _last_info(sig, ncoef)
    full = lastidx == ncoef - 1
    cum1 = jnp.asarray(
        np.concatenate([[0.0], np.cumsum(table.lastp1)]), jnp.float32
    )
    lp0 = jnp.asarray(table.lastp0, jnp.float32)
    prefix = cum1[klen] + jnp.where(klen < max_len, lp0[klen], 0.0)
    last_cost = jnp.where(
        full, table.lastfull1,
        table.lastfull0 + prefix + klen.astype(jnp.float32),  # suffix bypass
    )

    # sig bins exist only before the last position
    emitted = jnp.arange(ncoef)[None, :] < lastidx[:, None]
    cost_sig = jnp.where(
        emitted, jnp.where(sig, sig1[pos], sig0[pos]), 0.0
    )                                                         # (nb, ncoef)

    gt1 = a > 1
    gt2 = a > 2
    eg = 2.0 * jnp.floor(
        jnp.log2(jnp.maximum(a - 2, 1).astype(jnp.float32))
    ) + 1.0
    per = cost_sig + jnp.where(
        sig,
        jnp.where(gt1, table.gt1_1 + jnp.where(gt2, table.gt2_1 + eg,
                                               table.gt2_0),
                  table.gt1_0)
        + 1.0,                                                # sign bypass
        0.0,
    )
    coded = sig.any(axis=-1)
    return jnp.where(
        coded, table.cbf1 + last_cost + per.sum(axis=-1), table.cbf0
    )


# The coder's context estimator decays with gamma = 1 - 2^-kAdaptShift
# per opposing bin (nanohevc_runtime.cpp Context::update, shift 5).
_GAMMA = 31.0 / 32.0
_LN2 = float(np.log(2.0))


def _ctx_total(n1, n):
    """Approximate TOTAL adaptive-coder bits for one context.

    The shift-5 estimator starts at p = 0.5 and decays geometrically
    toward the context's true rate; on zero-dominated contexts (the
    codec's common case) the convergence transient dominates short
    streams.  Model: a transient of t* = log_gamma(p_hat / 0.5) bins
    priced by the exact decay-curve sum (sum -log2(1 - 0.5 gamma^t)
    ~ sum 0.5 gamma^t / ln 2), then (n - t*) bins at the empirical
    entropy H(p_hat).  Tracks nhr_block_bits to ~10-17% per frame
    across content types (tests/test_rate_model.py).
    """
    n1 = jnp.asarray(n1, jnp.float32)
    n = jnp.asarray(n, jnp.float32)
    n0 = n - n1
    p_hat = (n1 + 0.5) / (n + 1.0)
    t_star = jnp.clip(
        jnp.log(jnp.maximum(p_hat, 1e-6) / 0.5) / np.log(_GAMMA), 0.0, n
    )
    trans = (0.5 * (1.0 - _GAMMA ** t_star) / (1.0 - _GAMMA)) / _LN2
    ent = -(
        jnp.where(n1 > 0, n1 * jnp.log2(p_hat), 0.0)
        + jnp.where(n0 > 0, n0 * jnp.log2(1.0 - p_hat), 0.0)
    ) / jnp.maximum(n, 1.0)
    steady = jnp.maximum(n - t_star, 0.0) * ent
    return jnp.where(n > 0, trans + steady, 0.0)


def model_bits_adaptive(packed: jnp.ndarray) -> jnp.ndarray:
    """Per-frame adaptive rate model: (nb, ncoef) packed -> (nb,) bits.

    Estimates every context's bin probability from THIS frame's own
    statistics (pure reductions — stays inside the jitted graph),
    prices bins at -log2(p_hat), then scales each context's prices so
    the context total matches _ctx_total — the adaptive coder's code
    length including its convergence transient.  This tracks the real
    coder where a fixed table cannot (the coder adapts per stream; see
    tests/test_rate_model.py for the flat-content case that breaks the
    static table, and for accuracy vs nhr_block_bits ground truth).

    Used by the rdo_cbf RD decision (models/all_intra.py).
    """
    a = jnp.abs(packed.astype(jnp.int32))
    sig = a > 0
    nb, ncoef = packed.shape
    pos = jnp.minimum(jnp.arange(ncoef), 31)
    onehot = jax.nn.one_hot(pos, 32, dtype=jnp.float32)      # (ncoef, 32)

    coded = sig.any(axis=-1)
    n_coded = coded.sum().astype(jnp.float32)

    def prices(n1, n):
        """Per-bin costs scaled so the context totals match the coder."""
        n1 = jnp.asarray(n1, jnp.float32)
        n = jnp.asarray(n, jnp.float32)
        p1 = (n1 + 0.5) / (n + 1.0)
        c1, c0 = -jnp.log2(p1), -jnp.log2(1.0 - p1)
        emp = n1 * c1 + (n - n1) * c0
        scale = jnp.where(
            emp > 0, _ctx_total(n1, n) / jnp.maximum(emp, 1e-9), 1.0
        )
        return c1 * scale, c0 * scale

    # cbf: one bin per block
    cbf1_c, cbf0_c = prices(n_coded, jnp.float32(nb))

    # last-position bins: full-block escape, then the truncated-unary
    # prefix over non-full coded blocks (one ctx per prefix index)
    lastidx, klen, max_len = _last_info(sig, ncoef)
    full = coded & (lastidx == ncoef - 1)
    n_full = full.sum().astype(jnp.float32)
    lf1_c, lf0_c = prices(n_full, n_coded)
    nf = (coded & ~full).astype(jnp.float32)                 # (nb,)
    idx = jnp.arange(max_len)                                # (max_len,)
    tot_i = (nf[:, None] * (klen[:, None] >= idx[None, :])).sum(axis=0)
    one_i = (nf[:, None] * (klen[:, None] > idx[None, :])).sum(axis=0)
    lp1_c, lp0_c = prices(one_i, tot_i)                      # (max_len,)
    cum1 = jnp.concatenate([jnp.zeros(1), jnp.cumsum(lp1_c)])
    lp0_pad = jnp.concatenate([lp0_c, jnp.zeros(1)])
    prefix = cum1[klen] + jnp.where(klen < max_len, lp0_pad[klen], 0.0)
    last_cost = jnp.where(
        full, lf1_c, lf0_c + prefix + klen.astype(jnp.float32)
    )

    # sig bins: emitted by coded blocks at positions before the last
    emitted = coded[:, None] & (
        jnp.arange(ncoef)[None, :] < lastidx[:, None]
    )                                                         # (nb, ncoef)
    sig_c = (sig & emitted).astype(jnp.float32)
    # Context counts from 0/1 operands: HIGHEST keeps the GPU from
    # running them in TF32, so the sums match the CPU's float32 ones
    # wherever the counts stay below 2^24.
    hi = jax.lax.Precision.HIGHEST
    ones = jnp.einsum("bp,pc->c", sig_c, onehot, precision=hi)      # (32,)
    totals = jnp.einsum(
        "bp,pc->c", emitted.astype(jnp.float32), onehot, precision=hi
    )                                                         # (32,)
    sig1_c, sig0_c = prices(ones, totals)

    # gt1 / gt2 bins: per significant / per gt1 coefficient
    gt1 = a > 1
    gt2 = a > 2
    n_sig = sig.sum().astype(jnp.float32)
    n_gt1 = gt1.sum().astype(jnp.float32)
    g11, g10 = prices(n_gt1, n_sig)
    g21, g20 = prices(gt2.sum().astype(jnp.float32), n_gt1)

    eg = 2.0 * jnp.floor(
        jnp.log2(jnp.maximum(a - 2, 1).astype(jnp.float32))
    ) + 1.0
    cost_sig = jnp.where(
        emitted, jnp.where(sig, sig1_c[pos], sig0_c[pos]), 0.0
    )
    per = cost_sig + jnp.where(
        sig,
        jnp.where(gt1, g11 + jnp.where(gt2, g21 + eg, g20), g10) + 1.0,
        0.0,
    )
    return jnp.where(coded, cbf1_c + last_cost + per.sum(axis=-1), cbf0_c)
