"""Operations and bytes of the global affine DP with traceback, from
shapes alone.

Name of the kernel in the device trace: `KERNEL`.

A cell of the recurrence (reference/affine_dp.py) needs: the substitution
score (compare, wildcard test, two selects: 4); the terminal-gap select
(1); for M one add of the score to the best of three (max3 with its
direction: two compares and two selects for the value, two for the
direction) (7); for D and I three candidate adds and max3 (3 + 6 each);
the three directions packed into the traceback byte (2): 30 operations a
cell (the count `chip_smoke.py` uses), over the l1 x l2 interior cells of
each alignment. Bytes: each pair's reference and read rows and two int32
lengths in; out, the walk's operations at two bits each (l1 + l2 at
most) and an int32 score and length. The traceback is the kernel's own
scratch and is not counted.
"""

import numpy as np

KERNEL = "::align_kernel<"
OPS_PER_CELL = 30


def work(ref_lens, read_lens):
    """(operations, bytes) of aligning read i against reference i."""
    f = np.asarray(ref_lens, np.int64)
    r = np.asarray(read_lens, np.int64)
    cells = int((f * r).sum())
    nbytes = int((f + r).sum()) + 8 * len(f) \
        + int(((f + r + 3) // 4).sum()) + 8 * len(f)
    return OPS_PER_CELL * cells, nbytes
