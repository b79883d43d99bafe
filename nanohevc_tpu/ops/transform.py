"""Batched integer transforms as einsums (HEVC spec 8.6).

Each pass of the separable transform over the whole block axis is one
int32 contraction — the batched replacement for the reference's
per-block O(N^3) Python loops (transform.py:179-194, :221-236).

Exactness: with 8/10-bit residual inputs, per-pass accumulators stay
below 2^22 (N=32: 32*90*2047 ~ 5.9e6 < 2^23), so the contraction is
exact in int32 — and also in float32 should XLA choose a float
path (sums of integers < 2^24 are exact in f32).  Verified bit-exact
against the int64 numpy oracle in tests/test_parity.py.
"""

from __future__ import annotations

import jax.numpy as jnp

from nanohevc_tpu.tables import transform_matrix


def _matrix(n: int, use_dst: bool) -> jnp.ndarray:
    return jnp.asarray(transform_matrix(n, use_dst), dtype=jnp.int32)


def forward_transform(blocks: jnp.ndarray, use_dst: bool = False) -> jnp.ndarray:
    """(nb, N, N) int32 residuals -> (nb, N, N) int32 coefficients."""
    n = blocks.shape[-1]
    t = _matrix(n, use_dst)
    shift = n.bit_length() - 1 + 5
    rnd = 1 << (shift - 1)
    x = blocks.astype(jnp.int32)
    temp = (jnp.einsum("ik,bkj->bij", t, x, preferred_element_type=jnp.int32) + rnd) >> shift
    return (jnp.einsum("bik,jk->bij", temp, t, preferred_element_type=jnp.int32) + rnd) >> shift


def inverse_transform(coeffs: jnp.ndarray, use_dst: bool = False) -> jnp.ndarray:
    """(nb, N, N) int32 coefficients -> (nb, N, N) int32 residuals."""
    n = coeffs.shape[-1]
    t = _matrix(n, use_dst)
    shift = n.bit_length() - 1 + 5
    rnd = 1 << (shift - 1)
    x = coeffs.astype(jnp.int32)
    temp = (jnp.einsum("ki,bkj->bij", t, x, preferred_element_type=jnp.int32) + rnd) >> shift
    return (jnp.einsum("bik,kj->bij", temp, t, preferred_element_type=jnp.int32) + rnd) >> shift
