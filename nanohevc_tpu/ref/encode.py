"""Sequential per-block reference encoders (numpy).

The plain, one-block-at-a-time statement of what the batched device
pipelines compute, built only from this package's single-block ops:

- `encode_plane_open_loop` is models/all_intra.encode_plane_full:
  neighbours are read from the SOURCE plane (reference-encoder
  semantics), so blocks are independent.
- `encode_plane_closed_loop` is models/wavefront's closed loop:
  neighbours are read from the reconstruction, blocks are visited in
  anti-diagonal (wavefront) order, and a diagonal's reconstructions
  become visible only after the whole diagonal is coded, so
  same-diagonal extensions (top-right, below-left) read as zeros.

Both cover mode_set "dc_planar" (residual-energy decision, ties to DC)
and "all" (SATD over planar, DC and angular 2-34, ties to the lowest
mode), DCT or 4x4 DST-VII, any bit depth and the dequant rescale flag.
They are the bit-exactness references for the device paths in the
tests and in chip_smoke.py.
"""

from __future__ import annotations

import numpy as np

from nanohevc_tpu.ref.intra import (
    intra_angular_predict,
    intra_dc_predict,
    intra_planar_predict,
)
from nanohevc_tpu.ref.metrics import hadamard_matrix, residual_energy
from nanohevc_tpu.ref.quant import dequantize, quantize
from nanohevc_tpu.ref.transform import forward_transform, inverse_transform

__all__ = [
    "open_loop_block",
    "encode_plane_open_loop",
    "encode_plane_closed_loop",
]

PLANAR, DC = 0, 1


def _decide(orig, top, left, n, mode_set):
    """Best prediction for one block from its (2N+1) top/left arrays
    (corner at index 0) -> (pred int32 (N, N), mode)."""
    planar = intra_planar_predict(
        top[1 : n + 1], left[1 : n + 1], int(top[n]), int(left[n]), n
    ).astype(np.int32)
    dc = intra_dc_predict(top[1 : n + 1], left[1 : n + 1], n).astype(np.int32)
    if mode_set == "dc_planar":
        if residual_energy(orig - dc) <= residual_energy(orig - planar):
            return dc, DC
        return planar, PLANAR
    if mode_set != "all":
        raise ValueError(f"mode_set {mode_set!r}: expected dc_planar or all")
    hmat = hadamard_matrix(n).astype(np.int64)
    cands = [planar, dc] + [
        intra_angular_predict(top, left, int(top[0]), m, n).astype(np.int32)
        for m in range(2, 35)
    ]
    costs = [
        int(np.abs(hmat @ (orig - p).astype(np.int64) @ hmat.T).sum())
        for p in cands
    ]
    mode = int(np.argmin(costs))            # ties -> lowest mode index
    return cands[mode], mode


def _code(orig, pred, qp, n, use_dst, bit_depth, dequant_rescale):
    """Residual chain of one block -> (levels (N, N), recon (N, N))."""
    lvl = quantize(forward_transform(orig - pred, use_dst), qp, n)
    inv = inverse_transform(
        dequantize(lvl, qp, n, rescale=dequant_rescale), use_dst
    )
    return lvl, np.clip(pred + inv, 0, (1 << bit_depth) - 1)


def open_loop_block(plane, n, qp, by, bx, *, mode_set="dc_planar",
                    use_dst=False, bit_depth=8, dequant_rescale=False):
    """Open-loop encode of block (by, bx) of a source plane.

    References come from the source: frame-edge sides and the corner
    take the boundary fill 1 << (bit_depth - 1), extensions past the
    right/bottom edge replicate the plane's last column/row.
    Returns (recon (N, N), levels (N, N), mode).
    """
    h, w = plane.shape
    p = np.asarray(plane, np.int32)
    fill = 1 << (bit_depth - 1)
    y0, x0 = by * n, bx * n
    i = np.arange(2 * n + 1)
    if y0 == 0:
        top = np.full(2 * n + 1, fill, np.int32)
    else:
        top = p[y0 - 1, np.clip(x0 + i - 1, 0, w - 1)].copy()
    if x0 == 0:
        left = np.full(2 * n + 1, fill, np.int32)
    else:
        left = p[np.clip(y0 + i - 1, 0, h - 1), x0 - 1].copy()
    if y0 == 0 or x0 == 0:
        top[0] = left[0] = fill
    orig = p[y0 : y0 + n, x0 : x0 + n]
    pred, mode = _decide(orig, top, left, n, mode_set)
    lvl, rec = _code(orig, pred, qp, n, use_dst, bit_depth, dequant_rescale)
    return rec, lvl, mode


def encode_plane_open_loop(plane, n, qp, **kw):
    """Every whole block of the plane through `open_loop_block`.

    Returns (recon (H, W) int32, levels (nb, N, N) int32 in raster
    order, modes (nb,) int32).  Pixels outside the whole-block grid
    keep their source values, as in encode_plane_full.
    """
    h, w = plane.shape
    nby, nbx = h // n, w // n
    recon = np.asarray(plane, np.int32).copy()
    levels = np.zeros((nby * nbx, n, n), np.int32)
    modes = np.zeros(nby * nbx, np.int32)
    for by in range(nby):
        for bx in range(nbx):
            rec, lvl, mode = open_loop_block(plane, n, qp, by, bx, **kw)
            recon[by * n : (by + 1) * n, bx * n : (bx + 1) * n] = rec
            levels[by * nbx + bx] = lvl
            modes[by * nbx + bx] = mode
    return recon, levels, modes


def encode_plane_closed_loop(plane, n, qp, *, mode_set="dc_planar",
                             use_dst=False, bit_depth=8,
                             dequant_rescale=False):
    """Reconstruction-fed encode, one block at a time in wavefront order.

    A plane that is not block-aligned is first padded by replicating its
    last row/column (the conformance-window pattern); the returned
    recon is cropped back to (H, W).  Returns (recon (H, W) int32,
    levels (nb, N, N) int32 raster order over the padded grid, modes
    (nb,) int32).
    """
    h, w = plane.shape
    hp, wp = -(-h // n) * n, -(-w // n) * n
    src = np.pad(np.asarray(plane, np.int32), ((0, hp - h), (0, wp - w)),
                 mode="edge")
    nby, nbx = hp // n, wp // n
    fill = 1 << (bit_depth - 1)
    recon = np.zeros((hp, wp), np.int32)
    levels = np.zeros((nby * nbx, n, n), np.int32)
    modes = np.zeros(nby * nbx, np.int32)
    for d in range(nby + nbx - 1):
        writes = []
        for by in range(max(0, d - nbx + 1), min(nby, d + 1)):
            bx = d - by
            y0, x0 = by * n, bx * n
            corner = fill if by == 0 or bx == 0 else int(recon[y0 - 1, x0 - 1])
            top = np.full(2 * n + 1, fill, np.int32)
            left = np.full(2 * n + 1, fill, np.int32)
            if by > 0:
                top[0] = corner
                top[1 : n + 1] = recon[y0 - 1, x0 : x0 + n]
                if bx == nbx - 1:
                    top[n + 1 :] = top[n]           # frame-right replication
                else:
                    top[n + 1 :] = recon[y0 - 1, x0 + n : x0 + 2 * n]
            if bx > 0:
                left[0] = corner
                left[1 : n + 1] = recon[y0 : y0 + n, x0 - 1]
                if by == nby - 1:
                    left[n + 1 :] = left[n]         # frame-bottom replication
                else:
                    left[n + 1 :] = recon[y0 + n : y0 + 2 * n, x0 - 1]
            orig = src[y0 : y0 + n, x0 : x0 + n]
            pred, mode = _decide(orig, top, left, n, mode_set)
            lvl, rec = _code(orig, pred, qp, n, use_dst, bit_depth,
                             dequant_rescale)
            writes.append((y0, x0, rec))
            levels[by * nbx + bx] = lvl
            modes[by * nbx + bx] = mode
        for y0, x0, rec in writes:
            recon[y0 : y0 + n, x0 : x0 + n] = rec
    return recon[:h, :w], levels, modes
