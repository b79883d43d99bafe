"""Jittable quality metrics (parity: /root/reference/nano_hevc/metrics.py).

Per-block variants operate over the (nb, N, N) block tensor and return
(nb,) vectors; frame-level mse/psnr reduce in float32 (JAX's default
without 64-bit mode — PSNR is a float metric, the <1e-4 dB difference
vs the float64 oracle is irrelevant and covered by test tolerances).
"""

from __future__ import annotations

import jax.numpy as jnp

from nanohevc_tpu.ref.metrics import hadamard_matrix


def mse(original: jnp.ndarray, reconstructed: jnp.ndarray) -> jnp.ndarray:
    d = original.astype(jnp.float32) - reconstructed.astype(jnp.float32)
    return jnp.mean(d * d)


def psnr(original: jnp.ndarray, reconstructed: jnp.ndarray, peak: int = 255) -> jnp.ndarray:
    err = mse(original, reconstructed)
    return jnp.where(
        err == 0, jnp.inf, 10.0 * jnp.log10((peak * peak) / err)
    )


def sad_blocks(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Sum of absolute differences per block over the last two axes
    (broadcasts, e.g. (nb, 1, N, N) vs (nb, M, N, N) -> (nb, M))."""
    d = a.astype(jnp.int32) - b.astype(jnp.int32)
    return jnp.abs(d).sum(axis=(-2, -1))


def satd_blocks(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Hadamard-transformed SAD per block: (nb, N, N) x2 -> (nb,).

    Uses the Sylvester Hadamard basis; SATD is invariant to the row
    order difference vs the reference's sequency-ordered 4x4 H
    (metrics.py:35-42) because row/column permutations only permute
    the summed absolute values.  Generalizes beyond 4x4 to all block
    sizes (the reference supports 4x4 only).
    """
    n = a.shape[-1]
    h = jnp.asarray(hadamard_matrix(n), dtype=jnp.int32)
    d = a.astype(jnp.int32) - b.astype(jnp.int32)
    t = jnp.einsum("ik,...kj->...ij", h, d, preferred_element_type=jnp.int32)
    t = jnp.einsum("...ik,jk->...ij", t, h, preferred_element_type=jnp.int32)
    return jnp.abs(t).sum(axis=(-2, -1))


def ssim(original: jnp.ndarray, reconstructed: jnp.ndarray, peak: int = 255,
         window: int = 8) -> jnp.ndarray:
    """Uniform-window SSIM, jittable (float32; matches the oracle to
    ~1e-3, adequate for a perceptual metric)."""
    import jax

    x = original.astype(jnp.float32)
    y = reconstructed.astype(jnp.float32)

    def box(a):
        s = jax.lax.reduce_window(
            a, 0.0, jax.lax.add, (window, window), (1, 1), "VALID"
        )
        return s / (window * window)

    mx, my = box(x), box(y)
    mxx, myy, mxy = box(x * x), box(y * y), box(x * y)
    vx = mxx - mx * mx
    vy = myy - my * my
    cxy = mxy - mx * my
    c1 = (0.01 * peak) ** 2
    c2 = (0.03 * peak) ** 2
    s = ((2 * mx * my + c1) * (2 * cxy + c2)) / (
        (mx * mx + my * my + c1) * (vx + vy + c2)
    )
    return jnp.mean(s)


def estimate_bits_blocks(levels: jnp.ndarray) -> jnp.ndarray:
    """Per-block rate estimate: sum(log2(|l|+1)) + 2 per nonzero.

    Batched analog of the oracle's estimate_bits (quant.py:153-168).
    """
    a = jnp.abs(levels.astype(jnp.float32))
    bits = jnp.log2(a + 1.0) + jnp.where(a > 0, 2.0, 0.0)
    return bits.sum(axis=tuple(range(1, levels.ndim)))


def count_nonzero_blocks(levels: jnp.ndarray) -> jnp.ndarray:
    """Per-block non-zero level count."""
    return (levels != 0).sum(axis=tuple(range(1, levels.ndim)))


def residual_energy_blocks(residual: jnp.ndarray) -> jnp.ndarray:
    """Sum of squared residuals per block: (nb, N, N) -> (nb,) int32.

    Exact for 8/10-bit video (32*32*1023^2 < 2^31).
    """
    r = residual.astype(jnp.int32)
    return (r * r).sum(axis=(-2, -1))
