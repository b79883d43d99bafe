"""Device mesh construction for the all-intra encoder.

The codec's parallel axes (SURVEY §2 "parallelism inventory"):
  frame - data parallelism over the frame batch (embarrassingly
          parallel; the reference has no equivalent, it loops blocks
          serially, block.py:68-74)
  space - spatial partitioning of each plane (rows of the blocked
          frame tensor); the one cross-device dependency is the
          top-neighbor halo row, which XLA materializes as a small
          collective-permute under jit.

The mesh follows the algorithm alone: devices that all reach each
other at the same rate (GPUs of one host over NVLink) are laid out
'frame' x 'space'; on a single device both axes are 1 and the same
code runs unsharded.
"""

from __future__ import annotations

from typing import Sequence

import jax
from jax.sharding import Mesh


def make_mesh(
    devices: Sequence[jax.Device] | None = None,
    axis_names: tuple[str, str] = ("frame", "space"),
    space: int | None = None,
) -> Mesh:
    """Build a 2-D (frame, space) mesh over the given devices.

    `space` fixes the spatial axis length (must divide the device
    count); by default spatial sharding is 1 (pure frame-data
    parallelism) — the right default for throughput, since frames are
    independent while spatial sharding pays a halo exchange.
    """
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    sp = 1 if space is None else space
    if n % sp != 0:
        raise ValueError(f"space={sp} does not divide device count {n}")
    import numpy as np

    arr = np.asarray(devices).reshape(n // sp, sp)
    return Mesh(arr, axis_names)
