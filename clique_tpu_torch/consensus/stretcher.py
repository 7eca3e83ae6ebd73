"""Column-model consensus ("stretcher").

Re-derivation of the Rust reference, rust_cmd/src/consensus/stretcher.rs: the
reference sequence is held as a list of columns (Original reference bases +
Insertion columns discovered in member reads); each member's gapped
(ref_aligned, read_aligned) pair is merged into the running column counts
(add_alignment :275-342, right-aligned insertions), and to_consensus
(:344-407) calls each column: gap if the gap fraction >= threshold is NOT
met... precisely: a gap is called when gap_fraction >= threshold is false?
(see NucCounts::consensus_base :136-175 - base is called when
gap/total < threshold, else a gap); Insertion columns are kept only when
supported by >= threshold of the group's reads. Base quality comes from the
Bayesian posterior with reference prior 0.75.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from clique_tpu_torch.align.cpu import AlignmentResult, simplify_cigar
from clique_tpu_torch.consensus.quality import (
    calculate_qual_scores,
    combine_qual_scores,
    prob_to_phred,
)

GAP = ord("-")

_IDX = {ord("A"): 0, ord("a"): 0, ord("C"): 1, ord("c"): 1,
        ord("G"): 2, ord("g"): 2, ord("T"): 3, ord("t"): 3}


@dataclass
class NucCounts:
    """Per-column allele counts + per-allele quality lists
    (stretcher.rs:12-176)."""

    ref_base: int
    counts: List[int] = field(default_factory=lambda: [0, 0, 0, 0, 0, 0])
    # [A, C, G, T, N, gap]
    quals: List[List[int]] = field(
        default_factory=lambda: [[], [], [], [], []])

    def update(self, base: int, qual: Optional[int]) -> None:
        idx = _IDX.get(base)
        if idx is not None:
            self.counts[idx] += 1
            self.quals[idx].append(qual)
        elif base == GAP:
            self.counts[5] += 1
        else:
            self.counts[4] += 1
            self.quals[4].append(qual)

    def total(self) -> int:
        return sum(self.counts)

    def __repr__(self) -> str:
        # mirrors the reference Display (stretcher.rs:47-51)
        a, c, g, t, n, gap = self.counts
        return f"a: {a} c {c} g{g} t{t} n {n} gap {gap}"

    def proportion(self, base: int, read_count: int) -> float:
        idx = _IDX.get(base)
        if idx is None:
            idx = 5 if base == GAP else 4
        return self.counts[idx] / read_count

    def consensus_base(self, gap_call_threshold: float
                       ) -> Tuple[int, Optional[int]]:
        """stretcher.rs:136-175: call a gap when the gap fraction reaches the
        threshold; otherwise argmax over [A,C,G,T] (N excluded from the
        argmax - reference behavior) with the Bayesian posterior quality."""
        total = self.total()
        # Rust: gap/total < threshold calls a base, else (incl. NaN on
        # total==0) calls a gap
        if total == 0 or (self.counts[5] / total) >= gap_call_threshold:
            return GAP, None
        bases = [bytes([b]) * self.counts[i]
                 for i, b in enumerate(b"ACGTN")]
        quals = [bytes(self.quals[i]) for i in range(5)]
        props = combine_qual_scores(bases, quals, self.ref_base, 0.75)
        acgt = self.counts[:4]
        # Rust max_by keeps the LAST maximum: ties break to the higher index
        index_of_max = max(range(4), key=lambda i: (acgt[i], i))
        phred = prob_to_phred(props[index_of_max])
        return b"ACGT"[index_of_max], phred


@dataclass
class _Column:
    base: int
    counts: NucCounts
    original_position: Optional[int]  # None = Insertion column


class AlignmentCandidate:
    """stretcher.rs:237-407."""

    def __init__(self, reference: bytes, reference_name: str):
        self.columns: List[_Column] = [
            _Column(b, NucCounts(b), i) for i, b in enumerate(reference)]
        self.read_names: List[str] = []
        self.reference_name = reference_name

    def add_alignment(self, reference_aligned: bytes, read_aligned: bytes,
                      read_name: str,
                      read_quals: Optional[bytes] = None) -> None:
        """Merge one member's gapped pair into the column model
        (stretcher.rs:275-342). Raises ValueError on mismatched reference
        bases (the caller tolerates <= 1 such failure per group)."""
        self.read_names.append(read_name)
        if read_quals is None:
            read_quals = b"h" * len(read_aligned)

        ei = 0       # existing column index
        ii = 0       # incoming aligned index
        qi = 0       # incoming read-qual index
        n_exist = len(self.columns)
        while ei < n_exist and ii < len(reference_aligned):
            in_ref = reference_aligned[ii]
            in_read = read_aligned[ii]
            in_qual = ord("+") if in_read == GAP else read_quals[qi]
            col = self.columns[ei]

            if col.original_position is None and in_ref == GAP:
                # insertion column on both sides
                col.counts.update(in_read, in_qual)
                ii += 1
                ei += 1
            elif col.original_position is None:
                # existing insertion the new read doesn't have
                ei += 1
            elif in_ref == GAP:
                # new insertion column (right-aligned by inserting here)
                nc = NucCounts(GAP)
                nc.update(in_read, in_qual)
                self.columns.insert(ei, _Column(in_read, nc, None))
                n_exist += 1
                ii += 1
                ei += 1
                if in_read != GAP:
                    qi += 1
            elif col.base != in_ref and col.base != GAP and in_ref != GAP:
                raise ValueError(
                    f"Two mismatched reference nucleotides that are not "
                    f"gaps: {chr(col.base)} and {chr(in_ref)}, pos {ei} and {ii}")
            elif col.base == in_ref and col.base != GAP:
                col.counts.update(in_read, in_qual)
                ii += 1
                ei += 1
                if in_read != GAP:
                    qi += 1
            else:
                raise ValueError(
                    f"Unmanaged alignment merging issue at {ei}/{ii}")

    def to_consensus(self, gap_call_threshold: float = 0.75) -> AlignmentResult:
        """stretcher.rs:344-407."""
        assert self.read_names
        read = bytearray()
        ref = bytearray()
        quals = bytearray()
        cigar: List[Tuple[int, str]] = []
        n_reads = len(self.read_names)

        for col in self.columns:
            if col.original_position is not None:
                base, q = col.counts.consensus_base(gap_call_threshold)
                ref.append(col.base)
                read.append(base)
                if base == GAP:
                    cigar.append((1, "D"))
                else:
                    quals.append(q + 33)
                    cigar.append((1, "M"))
            elif col.counts.proportion(col.base, n_reads) >= gap_call_threshold:
                base, q = col.counts.consensus_base(gap_call_threshold)
                ref.append(GAP)
                read.append(base)
                if base == GAP:
                    raise ValueError("Can't insert a deletion")
                cigar.append((1, "I"))
                quals.append(q + 33)
            # else: unsupported insertion column dropped

        return AlignmentResult(
            reference_name=self.reference_name,
            read_name=self.read_names[0],
            reference_aligned=bytes(ref),
            read_aligned=bytes(read),
            read_quals=bytes(quals),
            cigar=simplify_cigar(cigar),
            path=[],
            score=0.0,
        )
