"""Plain end-to-end gap-affine alignment penalties, batched over pairs in
plain PyTorch: the optimum the program's wavefront engines must reach.

The penalty of an alignment is x for each mismatch, 0 for each match and
o + n e for each gap of n bases (WFA2-lib's gap-affine model, whose
defaults x=4, o=6, e=2 the program uses). Gotoh's three planes over
(reference i, read j), least penalties:

    I[i,j] = min(H[i,j-1] + o + e, I[i,j-1] + e)      (read base, insertion)
    D[i,j] = min(H[i-1,j] + o + e, D[i-1,j] + e)      (reference base)
    H[i,j] = min(H[i-1,j-1] + x [a_i != b_j], I[i,j], D[i,j])

with H[0,0] = 0, H[0,j] = I[0,j] = o + j e, H[i,0] = D[i,0] = o + i e, and
I[i,0] = D[0,j] = infinity. The penalty is H[l1,l2]. `penalty` sweeps
anti-diagonals i + j = d over a batch, keeping the two H diagonals and
one of I and D before the current one (O(L) memory), and takes no
traceback.

Departures from WFA2-lib: none in the model; every byte is taken
literally (two bytes match only where equal). The program's engine
treats a byte below '0' + 10 or 'N' as matching anything; the benchmark's
reads and amplicons hold only A, C, G and T, so that rule never applies.

`cigar_penalty` re-scores a CIGAR under the same model.
"""

from __future__ import annotations

import re
from typing import Optional, Sequence

import numpy as np
import torch

INF = 1 << 28
_RUN = re.compile(r"(\d+)(\D)")


def _rows(seqs: Sequence[bytes], device):
    lens = torch.tensor([len(s) for s in seqs], dtype=torch.long)
    mat = np.zeros((len(seqs), max(1, int(lens.max()))), np.uint8)
    for i, s in enumerate(seqs):
        mat[i, :len(s)] = np.frombuffer(s, np.uint8)
    return torch.from_numpy(mat).to(device), lens.to(device)


def penalty(refs: Sequence[bytes], reads: Sequence[bytes], x: int, o: int,
            e: int, device, dtype=torch.int32) -> np.ndarray:
    """The least penalty of aligning refs[k] to reads[k] end to end, for
    each k (int64). `dtype` is the planes' type: int32 is exact; a
    control may compute the same recurrence in a lower precision."""
    B = len(refs)
    if B == 0:
        return np.zeros(0, np.int64)
    R, l1 = _rows(refs, device)
    Q, l2 = _rows(reads, device)
    n1 = R.shape[1]
    iv = torch.arange(n1 + 1, device=device)
    a = torch.nn.functional.pad(R, (1, 0))                   # a[i - 1] at i
    # a float type below float32 cannot hold INF: a quarter of its range
    big = min(INF, torch.finfo(dtype).max / 4) if dtype.is_floating_point \
        else INF
    inf = torch.full((B, n1 + 1), big, dtype=dtype, device=device)

    def shift(t):                                            # t[i - 1] at i
        return torch.nn.functional.pad(t[:, :-1], (1, 0), value=big)

    end = l1 + l2
    ends = set(end.tolist())
    out = torch.zeros(B, dtype=dtype, device=device)
    h2 = h1 = i1 = d1 = inf
    for d in range(max(ends) + 1):
        j = d - iv                                           # [n1 + 1]
        b = Q[:, (j - 1).clamp(0, Q.shape[1] - 1)]
        sub = (a != b).to(dtype) * x
        ins = torch.minimum(h1 + (o + e), i1 + e)
        dele = torch.minimum(shift(h1) + (o + e), shift(d1) + e)
        h = torch.minimum(shift(h2) + sub, torch.minimum(ins, dele))
        # the borders, and nothing left of the first column
        top, left, off = (iv == 0) & (j >= 1), (j == 0) & (iv >= 1), j < 0
        h = torch.where(top | left, o + d * e, torch.where(off, big, h))
        ins = torch.where(top, o + d * e, torch.where(left | off, big, ins))
        dele = torch.where(left, o + d * e, torch.where(top | off, big, dele))
        if d == 0:
            h = torch.where(iv == 0, 0, h)
        if d in ends:
            out = torch.where(end == d, h.gather(1, l1[:, None])[:, 0], out)
        h2, h1, i1, d1 = h1, h, ins, dele
    return out.to(torch.float64).cpu().numpy().astype(np.int64)


def cigar_penalty(cigar: str, ref: bytes, read: bytes, x: int, o: int,
                  e: int) -> Optional[int]:
    """The penalty of a CIGAR string over (ref, read), or None where it
    does not consume both whole, holds an operation other than M, =, X, I
    and D or an empty run, or has an = run over differing bases or an X
    run over equal ones."""
    runs = _RUN.findall(cigar)
    if "".join(f"{n}{op}" for n, op in runs) != cigar:
        return None
    n = np.array([int(k) for k, _op in runs], np.int64)
    ops = np.array([op for _n, op in runs])
    if (n <= 0).any() or not np.isin(ops, list("M=XID")).all():
        return None
    diag = np.isin(ops, list("M=X"))
    dh = np.where(diag | (ops == "D"), n, 0)
    dv = np.where(diag | (ops == "I"), n, 0)
    if dh.sum() != len(ref) or dv.sum() != len(read):
        return None
    h0, v0 = np.cumsum(dh) - dh, np.cumsum(dv) - dv
    m = n[diag]
    # every base of the diagonal runs: its run's start plus its offset
    first = np.cumsum(m) - m
    off = np.arange(int(m.sum())) - np.repeat(first, m)
    a = np.frombuffer(ref, np.uint8)[np.repeat(h0[diag], m) + off]
    b = np.frombuffer(read, np.uint8)[np.repeat(v0[diag], m) + off]
    neq = (a != b).astype(np.int64)
    per_run = np.add.reduceat(neq, first) if len(m) else neq[:0]
    kind = ops[diag]
    if ((kind == "=") & (per_run != 0)).any() or \
            ((kind == "X") & (per_run != m)).any():
        return None
    gaps = n[~diag]
    return int(x * neq.sum() + len(gaps) * o + e * gaps.sum())
