"""Operations and bytes of one `wfa_align` launch (the gap-affine fill with
its op store, and the walk), from its arguments and its penalties.

Name of the kernel in the device trace: `KERNEL` (`wfa_kernel<G = 1, op
store, no midpoint, ...>`).

The cells are the live band's (benchlib/wfa_band.py), counted for each
lane up to its penalty, or its ceiling where censored: the recurrence's
work, whatever kernel runs it. A cell needs, counting one operation for
each add, max, compare, select, shift and or:
  I: the larger of the open and extend candidates, and the extend bit
     (compare): 2;
  D: as I, and the +1 of a deletion: 3;
  M: the mismatch candidate's +1, the largest of three (2), its source
     (two compares, two selects): 7;
  the rectangle: the read offset h - k, its two bounds and a select for
     each plane: 6;
  greedy extension, at least one compare of the bytes where the run
     stops, its length and its add: 3;
  the op byte: two shifts, two ors: 4.
So 25 operations a cell. The walk back through the op store is one
step a skeleton operation, fewer than the cells: not counted.
Bytes: each lane's reference and read (l1 + l2) and two int32 lengths
in; its penalty, one op-store byte a cell, its skeleton row (smax + 1)
and its end row out. The zeroing of the op store before the launch is
a copy engine's memset, not the kernel's.
"""

import numpy as np

from benchlib import wfa_band

KERNEL = "::wfa_kernel<1, true, false"
OPS_PER_CELL = 25


def work(n1, n2, smax, o, e, l1, l2, pen):
    """(operations, bytes) of a launch over rows n1 and n2 wide at ceiling
    smax, gap penalties o and e, lanes of lengths l1, l2 and penalties
    pen (arrays)."""
    cells = wfa_band.cells(n1, n2, smax, o, e, l1, l2, pen)
    B = len(l1)
    nbytes = int(np.sum(l1) + np.sum(l2)) + 8 * B + 4 * B + cells \
        + B * (smax + 1) + 4 * B
    return OPS_PER_CELL * cells, nbytes
