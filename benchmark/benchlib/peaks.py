"""Published peaks of one NVIDIA H100 SXM (NVIDIA's H100 data sheet,
dense rates, at the card's full 700 W; each run prints the card's power
limit beside its numbers).

- HBM3: 3.35 TB/s.
- Float32 outside the tensor cores: 67 TFLOP/s, which counts a fused
  multiply-add as two operations: 33.5 T lane instructions a second, one
  a lane a clock on each of the 132 SMs' 128 lanes. Every instruction,
  whichever pipe runs it (an exp2 or log2 on the special-function unit, a
  compare, a select), takes one of those slots, so operations
  counted one an instruction are bounded by this rate.
"""

PEAK_BYTES_PER_S = 3.35e12
PEAK_LANE_OPS_PER_S = 67e12 / 2


def bound_s(ops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the operations
    over the lane rate and the bytes over the memory rate."""
    return max(ops / PEAK_LANE_OPS_PER_S, nbytes / PEAK_BYTES_PER_S)
