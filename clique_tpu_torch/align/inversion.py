"""Batched inversion-aware alignment on PyTorch + CUDA.

Counterpart of clique_tpu/align/inversion.py::inversion_alignment_batch
(:248-342), with the same three phases and the same results:

1. a screen of the whole batch on the device: one Waterman-Eggert local
   alignment of the reference against revcomp(read) (the local fill and
   walk kernels; `local_screen_rows`). A read whose best local hit is
   shorter than min_inversion_length provably has no inversion block
   (alignment_matrix.rs:920-934);
2. for those screen negatives, one global fill with InversionScoring
   params, special_mode "none" and keep-last ties on the device, walked by
   the global walk kernel (`keep_last_rows`);
3. for screen positives, one after another, the shared jax-free host
   clique_tpu.align.inversion.inversion_alignment (path zeroing and
   secondary extraction).

The traceback of a launch is B * (n1 + n2 - 1) * n1 bytes (twice that for
the local screen, which stores zero flags beside it); the batch is split
so that no launch holds more than batch.MAX_TRACEBACK_BYTES. Splitting
does not change any result.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from clique_tpu.align.cpu import AlignmentResult
from clique_tpu.align.inversion import inversion_alignment
from clique_tpu.align.scoring import AffineScoring, InversionScoring
from clique_tpu.utils.seq import reverse_complement, to_bytes
from clique_tpu_torch.align import batch as dbatch


def inversion_params(inv_scoring: InversionScoring, device) -> torch.Tensor:
    """float32 [6] params of the keep-last fill: InversionScoring's match,
    mismatch and gaps, no special-byte score, no terminal-gap multiplier
    (clique_tpu/align/inversion.py:303-306)."""
    return torch.tensor(
        [inv_scoring.match_score, inv_scoring.mismatch_score, 0.0,
         inv_scoring.gap_open, inv_scoring.gap_extend, 1.0],
        dtype=torch.float32, device=device)


def _fused_rows(s1: bytes, seqs: List[bytes], local: bool, params,
                dev) -> np.ndarray:
    """Fill + walk of `s1` against every sequence of `seqs` on `dev`, in
    launches that stay under batch.MAX_TRACEBACK_BYTES: the fused rows,
    uint8 [len(seqs), W], checked for marked rows."""
    L1, L2 = len(s1), max(len(r) for r in seqs)
    n1, n2 = L1 + 1, L2 + 1
    cell_bytes = (n1 + n2 - 1) * n1 * (2 if local else 1)
    rows = max(1, dbatch.MAX_TRACEBACK_BYTES // cell_bytes)
    ref_row = torch.from_numpy(
        np.frombuffer(s1, dtype=np.uint8)[None, :].copy()).to(dev)
    out = []
    for start in range(0, len(seqs), rows):
        part = seqs[start:start + rows]
        arr, lens = dbatch.pad_batch(part, pad_to=L2)
        args = (ref_row, torch.from_numpy(arr).to(dev),
                torch.from_numpy(np.full(len(part), L1, np.int32)).to(dev),
                torch.from_numpy(lens).to(dev), params)
        if local:
            fused = dbatch.align_batch_local(*args, n1=n1, n2=n2)
        else:
            fused, _tb = dbatch.align_batch(*args, n1=n1, n2=n2,
                                            special_mode="none",
                                            tie_order="last")
        out.append(fused.cpu().numpy())
    rows_np = np.concatenate(out)
    dbatch.check_marked_rows(dbatch.unfuse_result(rows_np, local)[1])
    return rows_np


def local_screen_rows(s1: bytes, reads_b: List[bytes],
                      aff_scoring: AffineScoring, device) -> np.ndarray:
    """Phase 1: the fused local rows (batch.unfuse_result(..., local=True))
    of `s1` against revcomp of every read, with the affine scoring."""
    dev = torch.device(device)
    return _fused_rows(s1, [reverse_complement(r) for r in reads_b], True,
                       dbatch.scoring_to_params(aff_scoring, dev), dev)


def keep_last_rows(s1: bytes, reads_b: List[bytes],
                   inv_scoring: InversionScoring, device) -> np.ndarray:
    """Phase 2: the fused global rows (batch.unfuse_result) of `s1` against
    every read, InversionScoring params, special_mode "none", keep-last
    ties."""
    dev = torch.device(device)
    return _fused_rows(s1, reads_b, False, inversion_params(inv_scoring, dev),
                       dev)


def inversion_alignment_batch(reference, reads: List[bytes],
                              reference_name: str, read_names: List[str],
                              inv_scoring: InversionScoring,
                              aff_scoring: AffineScoring, device="cuda"
                              ) -> List[AlignmentResult]:
    """Inversion-aware global alignment of every read against `reference`
    (the JAX package's inversion_alignment_batch). `device` runs the screen
    and the keep-last fill ("cuda", "cuda:N" or "cpu", where the plain
    PyTorch versions run)."""
    s1 = to_bytes(reference)
    reads_b = [to_bytes(r) for r in reads]
    B = len(reads_b)
    if B == 0:
        return []
    if not s1:
        raise ValueError("the reference is empty")

    # phase 1: the local screen against revcomp(read)
    _packed, n_ops, _score, _coords = dbatch.unfuse_result(
        local_screen_rows(s1, reads_b, aff_scoring, device), local=True)
    screen_positive = n_ops >= inv_scoring.min_inversion_length
    results: List[Optional[AlignmentResult]] = [None] * B

    # phase 2: screen negatives through one keep-last global fill
    negatives = [i for i in range(B) if not screen_positive[i]]
    if negatives:
        seqs = [reads_b[i] for i in negatives]
        packed, counts, scores = dbatch.unfuse_result(
            keep_last_rows(s1, seqs, inv_scoring, device))
        ops = dbatch.unpack_ops(packed,
                                len(s1) + max(len(r) for r in seqs) + 2)
        for j, i in enumerate(negatives):
            a1, a2, cigar = dbatch.ops_to_alignment(ops[j], int(counts[j]),
                                                    s1, reads_b[i])
            results[i] = AlignmentResult(
                reference_name=reference_name, read_name=read_names[i],
                reference_aligned=a1, read_aligned=a2, read_quals=None,
                cigar=cigar, path=[], score=float(scores[j]))

    # phase 3: the exact host machinery for screen positives
    for i in range(B):
        if screen_positive[i]:
            results[i] = inversion_alignment(
                s1, reads_b[i], reference_name, read_names[i], inv_scoring,
                aff_scoring, False)
    return results
