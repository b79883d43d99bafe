"""Batched JAX device ops: the accelerator compute path.

Everything in this package operates on a `(num_blocks, N, N)` int32
block tensor (plus `(num_blocks, ...)` reference tensors) — the
batched inversion of the reference's one-block-at-a-time design.
All ops are jittable, integer-exact, and verified bit-exact against
the numpy oracle in `nanohevc_tpu.ref` (tests/test_parity.py).
"""

from nanohevc_tpu.ops.tiling import (
    tile_plane,
    untile_plane,
    extract_refs,
    num_blocks,
)
from nanohevc_tpu.ops.intra import (
    dc_predict,
    planar_predict,
    smooth_refs,
    mode_filter_flags,
    angular_predict_all,
    angular_predict_modes,
    predict_by_mode,
)
from nanohevc_tpu.ops.transform import forward_transform, inverse_transform
from nanohevc_tpu.ops.quant import quantize, dequantize
from nanohevc_tpu.ops.metrics import (
    mse,
    psnr,
    ssim,
    sad_blocks,
    satd_blocks,
    residual_energy_blocks,
    estimate_bits_blocks,
    count_nonzero_blocks,
)
from nanohevc_tpu.ops.scan import scan_pack, scan_unpack
from nanohevc_tpu.ops.deblock import deblock_plane
from nanohevc_tpu.ops.rate import (
    RateTable,
    calibrate_rate_table,
    model_bits as rate_model_bits,
    model_bits_adaptive as rate_model_bits_adaptive,
)
from nanohevc_tpu.ops.rdoq import rdoq_levels, rdoq_gain

__all__ = [
    "tile_plane",
    "untile_plane",
    "extract_refs",
    "num_blocks",
    "dc_predict",
    "planar_predict",
    "smooth_refs",
    "mode_filter_flags",
    "angular_predict_all",
    "angular_predict_modes",
    "predict_by_mode",
    "forward_transform",
    "inverse_transform",
    "quantize",
    "dequantize",
    "mse",
    "psnr",
    "ssim",
    "sad_blocks",
    "satd_blocks",
    "residual_energy_blocks",
    "estimate_bits_blocks",
    "count_nonzero_blocks",
    "scan_pack",
    "deblock_plane",
    "RateTable",
    "calibrate_rate_table",
    "rate_model_bits",
    "rate_model_bits_adaptive",
    "scan_unpack",
    "rdoq_levels",
    "rdoq_gain",
]
