"""What the wavefront kernels' counts share: the live band of a gap-affine
wavefront fill, and the rate that bounds its integer work.

A launch of B lanes over rows n1 and n2 bytes wide at ceiling smax has
diagonals |k| <= kmax = min(n1 + n2, smax, (smax - o) // e) (the
program's `wfa_kernels.kmax_of`, no heuristic band). Step 0 holds
diagonal 0; step s = 1 .. S holds the live band

    |k| <= min(s, kmax, reach(s)),  -l2 - 1 <= k <= l1 + 1,

reach(s) = (s - o) // e for s > o and 0 below: the widest gap a penalty
of s pays for. A lane's last step S is its penalty, or smax where it is
censored (its penalty reads smax + 1). Every other (step, diagonal) is
empty: a value on diagonal k costs at least o + e |k|, and the edges
l1 + 1 and -l2 - 1 hold the gap extends from the rectangle's sides.

The recurrence is 32-bit integer arithmetic, so its bound is the int32
lane rate of one NVIDIA H100 SXM: 64 a clock an SM on 132 SMs (NVIDIA's
arithmetic-instruction throughput table, compute capability 9.0), at the
1.98 GHz boost clock, 16.75 T operations/s, half `peaks.py`'s float32
lane rate.
"""

import numpy as np

from benchlib import peaks

PEAK_INT32_OPS_PER_S = peaks.PEAK_LANE_OPS_PER_S / 2


def kmax(n1: int, n2: int, smax: int, o: int, e: int) -> int:
    return min(n1 + n2, smax, max(0, (smax - o) // max(e, 1)))


def cells(n1, n2, smax, o, e, l1, l2, pen) -> int:
    """Live-band cells of one launch's lanes (lengths l1, l2 and
    penalties pen, int arrays), step 0 included."""
    l1 = np.asarray(l1, np.int64)
    l2 = np.asarray(l2, np.int64)
    last = np.minimum(np.asarray(pen, np.int64), smax)
    s = np.arange(1, smax + 1, dtype=np.int64)
    r = np.minimum(np.minimum(s, kmax(n1, n2, smax, o, e)),
                   np.where(s > o, (s - o) // max(e, 1), 0))[None]
    width = np.minimum(r, l1[:, None] + 1) + np.minimum(r, l2[:, None] + 1) \
        + 1
    return int((width * (s[None] <= last[:, None])).sum()) + len(l1)


def bound_s(ops: float, nbytes: float) -> float:
    """The least time: operations over the int32 rate or bytes over the
    memory rate, the larger."""
    return max(ops / PEAK_INT32_OPS_PER_S, nbytes / peaks.PEAK_BYTES_PER_S)


def roofline_pct(ctx, kernel, calls):
    """The kernel's share of its int32 roofline over the traced window, in
    %: the least time of its launches' work over its device time. `calls`
    are argument tuples of counts/<kernel>.py's work()."""
    from benchlib import readers

    counts = ctx.counts(kernel)
    t = readers.kernel_seconds(ctx, counts.KERNEL)
    if t <= 0 or not calls:
        return None
    ops = nbytes = 0
    for args in calls:
        o, b = counts.work(*args)
        ops += o
        nbytes += b
    return 100.0 * bound_s(ops, nbytes) / t
