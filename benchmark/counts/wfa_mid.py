"""Operations and bytes of one `wfa_mid` launch (the bialign engine's
gap-affine midpoint fill), from its arguments and its penalties.

Name of the kernel in the device trace: `KERNEL` (`wfa_kernel<G = 1, no
op store, midpoint, ...>`).

The cells are the live band's (benchlib/wfa_band.py), counted for each
lane up to its penalty, or its ceiling where censored. A cell needs the
affine recurrence of counts/wfa_align.py without its op byte, 21
operations, and its payloads:
  the D and I payloads, a select each on the extend bit: 2;
  the M payload, two selects on the source: 2;
  moving it across the greedy extension: (mid + k) >> 1 (2), clamped
     into the run (max, min: 2), on or before the middle anti-diagonal
     (h > NEG, 2 cand - k, <= mid, and: 5), the cell's code
     cand * 2^16 + cand - k (3), the select (1): 13.
So 38 operations a cell. Bytes: each lane's reference and read and two
int32 lengths in, its penalty and payload out. The payload planes are
the kernel's scratch and are not counted.
"""

import numpy as np

from benchlib import wfa_band

KERNEL = "::wfa_kernel<1, false, true"
OPS_PER_CELL = 38


def work(n1, n2, smax, o, e, l1, l2, pen):
    """(operations, bytes) of a launch; arguments as counts/wfa_align.py's
    work()."""
    cells = wfa_band.cells(n1, n2, smax, o, e, l1, l2, pen)
    B = len(l1)
    nbytes = int(np.sum(l1) + np.sum(l2)) + 8 * B + 8 * B
    return OPS_PER_CELL * cells, nbytes
