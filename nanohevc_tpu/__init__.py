"""nanohevc-tpu: an HEVC all-intra encoding framework in JAX.

Public API parity: every name exported by the reference package
(/root/reference/nano_hevc/__init__.py:50-91, 41 names) is re-exported
here with identical observable behavior.  The single-block functions
are served by the vectorized numpy oracle (`nanohevc_tpu.ref`) — the
"CPU numpy path" — while batched device execution lives in
`nanohevc_tpu.ops` (jnp) and `nanohevc_tpu.models` (full-frame
pipelines).
"""

__version__ = "0.1.0"

from nanohevc_tpu.frame import Plane, Frame, PackedFrame, FrameBufferPool
from nanohevc_tpu.block import BlockView, iterate_blocks
from nanohevc_tpu.ref.intra import (
    INTRA_PRED_ANGLE,
    intra_dc_predict_4x4,
    intra_dc_predict,
    intra_planar_predict,
    intra_angular_predict,
    residual_block,
    reconstruct_block,
    clip_to_pixel_range,
)
from nanohevc_tpu.ref.transform import (
    forward_transform,
    inverse_transform,
    forward_transform_4x4,
    inverse_transform_4x4,
    forward_transform_8x8,
    inverse_transform_8x8,
    forward_transform_16x16,
    inverse_transform_16x16,
    forward_transform_32x32,
    inverse_transform_32x32,
    DCT4,
    DCT8,
    DCT16,
    DCT32,
    DST4,
)
from nanohevc_tpu.ref.quant import (
    quantize,
    dequantize,
    quantize_block,
    dequantize_block,
    QUANT_SCALE,
    DEQUANT_SCALE,
)
from nanohevc_tpu.ref.metrics import (
    psnr,
    mse,
    sad,
    satd_4x4,
    residual_energy,
)

__all__ = [
    "Plane",
    "Frame",
    "PackedFrame",
    "FrameBufferPool",
    "BlockView",
    "iterate_blocks",
    "INTRA_PRED_ANGLE",
    "intra_dc_predict_4x4",
    "intra_dc_predict",
    "intra_planar_predict",
    "intra_angular_predict",
    "residual_block",
    "reconstruct_block",
    "clip_to_pixel_range",
    "forward_transform",
    "inverse_transform",
    "forward_transform_4x4",
    "inverse_transform_4x4",
    "forward_transform_8x8",
    "inverse_transform_8x8",
    "forward_transform_16x16",
    "inverse_transform_16x16",
    "forward_transform_32x32",
    "inverse_transform_32x32",
    "DCT4",
    "DCT8",
    "DCT16",
    "DCT32",
    "DST4",
    "quantize",
    "dequantize",
    "quantize_block",
    "dequantize_block",
    "QUANT_SCALE",
    "DEQUANT_SCALE",
    "psnr",
    "mse",
    "sad",
    "satd_4x4",
    "residual_energy",
]
