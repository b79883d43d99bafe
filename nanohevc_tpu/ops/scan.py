"""Coefficient scan packing for the host entropy stage (spec 6.5.3).

The reference declares scan.py but never implements it
(/root/reference/README.md:19, docs roadmap); BASELINE.json config 5
requires a zig-zag scan-packing stage feeding host-side entropy
coding.  Implemented as a static permutation gather over the flattened
block tensor that fuses into whatever produced the levels.

Scan kinds: "diag" / "horizontal" / "vertical" are the spec 6.5.3
group-based orders applied uniformly; "mode" applies the spec's
mode-dependent scan rule (7.4.9.11): at 4x4 and 8x8, near-horizontal
intra modes 6-14 select the vertical scan, near-vertical modes 22-30
the horizontal scan, everything else (and all 16x16/32x32 blocks) the
up-right diagonal.  The per-block selection is two jnp.where ops over
three constant-permutation packings — no dynamic gather.
"""

from __future__ import annotations

from functools import lru_cache

import jax.numpy as jnp
import numpy as np

from nanohevc_tpu.tables import (
    diag_scan_order,
    horizontal_scan_order,
    vertical_scan_order,
)

_ORDERS = {
    "diag": diag_scan_order,
    "horizontal": horizontal_scan_order,
    "vertical": vertical_scan_order,
}

SCAN_DIAG, SCAN_HORIZONTAL, SCAN_VERTICAL = 0, 1, 2


@lru_cache(maxsize=None)
def _order_and_inverse(n: int, kind: str) -> tuple[np.ndarray, np.ndarray]:
    order = _ORDERS[kind](n)
    inverse = np.argsort(order).astype(np.int32)
    return order, inverse


def mode_scan_idx(modes: jnp.ndarray, n: int) -> jnp.ndarray:
    """Spec 7.4.9.11 scanIdx from the intra prediction mode.

    (nb,) int modes -> (nb,) int32 in {0 diag, 1 horizontal,
    2 vertical}.  Mode-dependent selection applies only at 4x4/8x8
    transform blocks; larger blocks always scan diagonally.
    """
    modes = jnp.asarray(modes)
    if n not in (4, 8):
        return jnp.zeros(modes.shape, jnp.int32)
    sel = jnp.full(modes.shape, SCAN_DIAG, jnp.int32)
    sel = jnp.where((modes >= 6) & (modes <= 14), SCAN_VERTICAL, sel)
    sel = jnp.where((modes >= 22) & (modes <= 30), SCAN_HORIZONTAL, sel)
    return sel


def _select_packed(per_kind: dict, sel: jnp.ndarray) -> jnp.ndarray:
    sel = sel[:, None]
    out = per_kind["diag"]
    out = jnp.where(sel == SCAN_HORIZONTAL, per_kind["horizontal"], out)
    out = jnp.where(sel == SCAN_VERTICAL, per_kind["vertical"], out)
    return out


def scan_pack(
    levels: jnp.ndarray, kind: str = "diag", modes: jnp.ndarray | None = None
) -> jnp.ndarray:
    """(nb, N, N) -> (nb, N*N) in scan order (position 0 = DC).

    kind="mode" selects the scan per block from `modes` (required).
    """
    nb, n, _ = levels.shape
    flat = levels.reshape(nb, n * n)
    if kind == "mode":
        if n not in (4, 8):
            kind = "diag"
        else:
            if modes is None:
                raise ValueError("scan_pack(kind='mode') needs per-block modes")
            per_kind = {
                k: flat[:, jnp.asarray(_order_and_inverse(n, k)[0])]
                for k in _ORDERS
            }
            return _select_packed(per_kind, mode_scan_idx(modes, n))
    order, _ = _order_and_inverse(n, kind)
    return flat[:, jnp.asarray(order)]


def scan_unpack(
    packed: jnp.ndarray, kind: str = "diag", modes: jnp.ndarray | None = None
) -> jnp.ndarray:
    """(nb, N*N) scan-ordered -> (nb, N, N) raster blocks."""
    nb, sq = packed.shape
    n = int(round(sq ** 0.5))
    if kind == "mode":
        if n not in (4, 8):
            kind = "diag"
        else:
            if modes is None:
                raise ValueError(
                    "scan_unpack(kind='mode') needs per-block modes"
                )
            per_kind = {
                k: packed[:, jnp.asarray(_order_and_inverse(n, k)[1])]
                for k in _ORDERS
            }
            return _select_packed(per_kind, mode_scan_idx(modes, n)).reshape(
                nb, n, n
            )
    _, inverse = _order_and_inverse(n, kind)
    return packed[:, jnp.asarray(inverse)].reshape(nb, n, n)
