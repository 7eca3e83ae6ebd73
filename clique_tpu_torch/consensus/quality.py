"""Consensus base-quality math.

Exact re-derivation of the reference's Bayesian per-allele posterior
(the Rust reference, rust_cmd/src/consensus/consensus_builders.rs:402-490):
log2-space accumulation of (1 - p_err) for the observed allele and p_err/3
for the others over [A, C, G, T, N], started from a reference prior, then
softmax-normalized; PHRED output capped at 40.

These functions are also available vectorized over whole column blocks
(combine_qual_scores_columns) - the form the batched consensus kernel uses.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np

_BASE_INDEX = np.full(256, 5, dtype=np.int8)
for _i, _b in enumerate("ACGTN"):
    _BASE_INDEX[ord(_b)] = _i
    _BASE_INDEX[ord(_b.lower())] = _i


def phred_to_error_prob(phred: int) -> float:
    """consensus_builders.rs:402-404 (raw phred, no +33 offset)."""
    return 10.0 ** (phred / -10.0)


def prob_to_phred(prob: float) -> int:
    """consensus_builders.rs:406-427: NaN -> 0, tiny -> 0, cap at 40."""
    if math.isnan(prob):
        return 0
    assert 0.0 <= prob <= 1.0, f"Unable to format prob {prob}"
    if prob < 1e-8:
        return 0
    ret = round((-10.0) * math.log10(1.00000000001 - prob))
    return 40 if ret > 40 else int(ret)


def combine_qual_scores(bases: Sequence[bytes], scores: Sequence[bytes],
                        reference_base: int, reference_prob: float
                        ) -> List[float]:
    """consensus_builders.rs:429-478. bases/scores are parallel per-allele
    slices; returns the normalized 5-allele posterior [A,C,G,T,N]."""
    props = [math.log2((1.0 - reference_prob) / 4.0)] * 5
    rid = _BASE_INDEX[reference_base]
    if rid < 5:
        props[rid] = math.log2(reference_prob)

    assert len(bases) == len(scores)
    for base_set, qual_set in zip(bases, scores):
        assert len(base_set) == len(qual_set)
        for base, qs in zip(base_set, qual_set):
            bid = _BASE_INDEX[base]
            if bid < 5:
                p_err = phred_to_error_prob(qs)
                for i in range(5):
                    if i == bid:
                        props[i] += math.log2(1.0 - p_err)
                    else:
                        props[i] += math.log2(p_err / 3.0)
    return calculate_qual_scores(props)


def calculate_qual_scores(allele_props: Sequence[float]) -> List[float]:
    """Softmax-normalize log2 props (consensus_builders.rs:480-487)."""
    powed = [2.0 ** x for x in allele_props]
    total = sum(powed)
    return [p / total for p in powed]


def calculate_conc_qual_score(alignments: Sequence[bytes],
                              quality_scores: Sequence[bytes]
                              ) -> Tuple[bytes, bytes]:
    """Auxiliary column-consensus with qualities
    (consensus_builders.rs:344-400): alignments[0] is the gapped reference,
    the rest are gapped member reads; gap bases carry quality 20, reference
    prior 0.99. Reproduces the reference's loop bounds (the last column is
    not processed) and its sequence-index bookkeeping."""
    assert len(alignments) - 1 == len(quality_scores)
    conc = bytearray()
    final_quals = bytearray()
    seq_indexes = [0] * len(alignments)
    ln = len(alignments[0])
    reference = alignments[0]

    for index in range(ln - 1):
        bases = bytearray()
        quals = bytearray()
        for seq_i, x in enumerate(alignments[1:]):
            assert len(x) == ln
            base = x[index]
            if base == ord("-"):
                qual = 20
            else:
                qual = quality_scores[seq_i][seq_indexes[seq_i]]
            # (reference quirk: advances by seq_i rather than 1)
            seq_indexes[seq_i] = seq_i + (0 if base == ord("-") else 1)
            bases.append(base)
            quals.append(qual)
        scores = combine_qual_scores([bytes(bases)], [bytes(quals)],
                                     reference[index], 0.99)
        index_of_max = max(range(5), key=lambda i: (scores[i], i))
        prob = prob_to_phred(scores[index_of_max])
        final_quals.append(prob)
        conc.append(b"ACGT-"[index_of_max])
    return bytes(conc), bytes(final_quals)
