"""Rate control: choose QP to hit a bit budget.

The reference has no rate control at all — QP is a free function
parameter (reference quant.py:41) and nothing relates it to output
size.  This module closes that loop using the shipped range coder's
own size as ground truth:

- `find_frame_qp`: per-frame bisection over QP.  Coded size is
  monotonically non-increasing in QP (larger QP -> coarser levels ->
  fewer/smaller coefficients), so ~6 real encodes bracket the best
  quality that fits the budget.  All device paths take QP as a
  *traced* scalar, so the probes share one compiled program.
- `RateController`: sequence-level feedback in the log-bits domain.
  The codec's "+6 QP halves magnitudes" property (vendored reference
  test, tests/test_quant.py) makes log2(actual/target) the natural
  error axis: one octave of overshoot maps to roughly +6 QP.  The
  controller also carries the cumulative budget surplus/deficit so a
  hard scene early on is paid back later (a one-pass ABR buffer
  model).

Per-frame QP changes ride the per-slice qp field of the bitstream
(runtime/bitstream.py) — the decoder needs no out-of-band schedule.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field, replace

from nanohevc_tpu.config import EncoderConfig


def frame_coded_bytes(frame, config: EncoderConfig, closed_loop: bool = True) -> int:
    """Real coded size of one frame at config.qp (entropy included)."""
    if closed_loop:
        from nanohevc_tpu.models.wavefront import encode_frame_closed_loop

        _, bs = encode_frame_closed_loop(frame, config)
        return len(bs)
    import numpy as np

    from nanohevc_tpu.models.all_intra import encode_frame_full
    from nanohevc_tpu.runtime.bitstream import assemble_bitstream

    _, info = encode_frame_full(frame, config)
    planes = {
        name: (np.asarray(p["levels"]), p["block_size"])
        for name, p in info["planes"].items()
    }
    modes = {name: np.asarray(p["modes"]) for name, p in info["planes"].items()}
    return len(
        assemble_bitstream(
            frame.width, frame.height, config.qp, planes, modes,
            bit_depth=config.bit_depth, scan=config.scan,
            dequant_rescale=config.dequant_rescale,
            intra_smoothing=config.intra_smoothing,
            entropy_coder=config.entropy_coder,
        )
    )


def find_frame_qp(
    frame,
    config: EncoderConfig,
    target_bytes: int,
    *,
    closed_loop: bool = True,
    qp_min: int = 0,
    qp_max: int = 51,
) -> tuple[int, int]:
    """Lowest QP (= best quality) whose coded frame fits target_bytes.

    Returns (qp, coded_bytes).  If even qp_max overshoots the budget,
    returns (qp_max, its size) — the caller decides whether to accept.
    Bisection over the integer QP range: ~log2(52) = 6 encodes.
    """
    lo, hi = qp_min, qp_max
    best = None
    while lo <= hi:
        mid = (lo + hi) // 2
        size = frame_coded_bytes(frame, replace(config, qp=mid), closed_loop)
        if size <= target_bytes:
            best = (mid, size)
            hi = mid - 1          # fits: try better quality
        else:
            lo = mid + 1          # too big: coarser
    if best is None:
        size = frame_coded_bytes(frame, replace(config, qp=qp_max), closed_loop)
        return qp_max, size
    return best


@dataclass
class RateController:
    """One-pass ABR controller over a frame sequence.

    update(actual_bits) after each coded unit returns the QP for the
    next one.  `strength` is QP steps per octave of rate error (6 =
    the codec's natural rate-QP slope; default is damped to 3 for
    stability).  The cumulative budget error is folded in with a
    gentle gain so the *average* converges to target, not just the
    instantaneous rate.
    """

    target_bits: float                 # per coded unit (frame or batch)
    qp: int
    strength: float = 3.0
    window: int = 8                    # units over which debt is repaid
    qp_min: int = 0
    qp_max: int = 51
    _debt_bits: float = field(default=0.0, repr=False)

    def update(self, actual_bits: float) -> int:
        self._debt_bits += actual_bits - self.target_bits
        # instantaneous error plus the per-window share of accumulated debt
        eff = actual_bits + self._debt_bits / self.window
        err_octaves = math.log2(max(eff, 1.0) / max(self.target_bits, 1.0))
        step = round(self.strength * err_octaves)
        self.qp = int(min(self.qp_max, max(self.qp_min, self.qp + step)))
        return self.qp
