"""Operations and bytes of the pair-HMM forward, from shapes alone.

Name of the kernel in the device trace: `KERNEL`.

A cell of the recurrence (reference/pair_hmm.py) needs, counting one
operation for each add, subtract, max, compare, select, exp and log:
  M: three transition adds; LSE3 as max (2), two subtractions of the max
     (the third term's is zero), two exps, two adds (1 + e + e), a log and
     the add of the max; the emission (compare, wildcard test, select)
     and its add: 3 + 2 + 2 + 2 + 2 + 1 + 1 + 3 + 1 = 17;
  D: two transition adds; LSE2 as max, one subtraction, one exp, one add,
     a log and the add of the max: 2 + 1 + 1 + 1 + 1 + 1 + 1 = 8;
  I: as D, 8.
So 33 operations a cell, over the l1 x l2 interior cells of every pair
(the border cells are constants). Bytes: each pair's reference and read
rows (one byte a base), its two int32 lengths, and its float32 result.
"""

import numpy as np

KERNEL = "hmm_forward_kernel"
OPS_PER_CELL = 33


def work(read_lens, ref_lens):
    """(operations, bytes) of one call scoring every read against every
    reference: read_lens and ref_lens are int arrays of the lengths."""
    r = np.asarray(read_lens, np.int64)
    f = np.asarray(ref_lens, np.int64)
    pairs = len(r) * len(f)
    cells = int(r.sum()) * int(f.sum())
    nbytes = int(r.sum()) * len(f) + int(f.sum()) * len(r) + 12 * pairs
    return OPS_PER_CELL * cells, nbytes
