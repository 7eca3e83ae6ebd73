"""Read merging (paired-end -> single unified read).

Host-side equivalent of the Rust reference, rust_cmd/src/merger.rs: per the
layout's merge strategy, either concatenate oriented read segments + spacers
(merge_reads_by_concatenation, :40-108) or globally align R1 against
revcomp(R2) and build a PHRED-combined overlap consensus
(merge_reads_by_alignment :348-368, alignment_rate_and_consensus :428-498).

For throughput the align-merge's DP runs on device in the batched pipeline
(align/pipeline.py); this module holds the strategy/consensus logic and a
host fallback using the golden aligner.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

from clique_tpu_torch.align.cpu import affine_align
from clique_tpu_torch.align.scoring import AffineScoring
from clique_tpu_torch.config.layout import (
    AlignedReadOrientation,
    MergeStrategy,
    ReadPosition,
    SequenceLayout,
)
from clique_tpu_torch.io.fastq import ReadSetContainer
from clique_tpu_torch.utils.seq import GAP, combine_phred_scores, reverse_complement

# DEFAULT_ALIGNMENT_AFFINE_SCORING (merger.rs:130-139)
MERGE_SCORING = AffineScoring.merge_default()


@dataclass
class MergedRead:
    name: str
    seq: bytes
    quals: bytes
    # set when the pipeline defers the align-merge to the device batch
    pending_pair: Optional[Tuple[bytes, bytes, bytes, bytes]] = None


def orient_sequence(seq: bytes, orientation: AlignedReadOrientation) -> bytes:
    """merger.rs:110-128."""
    if orientation == AlignedReadOrientation.FORWARD:
        return seq
    if orientation == AlignedReadOrientation.REVERSE:
        return seq[::-1]
    if orientation == AlignedReadOrientation.REVERSE_COMPLEMENT:
        return reverse_complement(seq)
    raise ValueError(
        "We can't merge reads when the orientation is marked 'Unknown' in "
        "the yaml specification file")


def merge_by_concatenation(reads: ReadSetContainer,
                           layout: SequenceLayout) -> MergedRead:
    """Concatenate declared read positions after orientation; spacers get
    fake quality 'H' (merger.rs:40-108)."""
    seq = bytearray()
    quals = bytearray()
    for pos in layout.reads:
        if pos.kind == "Read1":
            seq += orient_sequence(reads.read_one.seq, pos.orientation)
            quals += reads.read_one.qual
        elif pos.kind == "Read2":
            assert reads.read_two is not None
            seq += orient_sequence(reads.read_two.seq, pos.orientation)
            quals += reads.read_two.qual
        elif pos.kind == "Index1":
            assert reads.index_one is not None
            seq += orient_sequence(reads.index_one.seq, pos.orientation)
            quals += reads.index_one.qual
        elif pos.kind == "Index2":
            assert reads.index_two is not None
            seq += orient_sequence(reads.index_two.seq, pos.orientation)
            quals += reads.index_two.qual
        elif pos.kind == "Spacer":
            sp = (pos.spacer_sequence or "").encode()
            seq += sp
            quals += b"H" * len(sp)
    return MergedRead(name=reads.read_one.name, seq=bytes(seq),
                      quals=bytes(quals))


def alignment_rate_and_consensus(aln1: bytes, quals1: bytes, aln2: bytes,
                                 quals2: bytes) -> Tuple[bytes, bytes]:
    """Column-wise consensus of two gapped alignments with PHRED combination
    (merger.rs:428-498): agreeing bases combine qualities; one-sided gaps
    take the present base; disagreements take the higher-quality base."""
    assert len(aln1) == len(aln2)
    seq = bytearray()
    quals = bytearray()
    q1 = q2 = 0
    for a, b in zip(aln1, aln2):
        if a == b:
            seq.append(a)
            quals.append(combine_phred_scores(quals1[q1], quals2[q2], True))
            q1 += 1
            q2 += 1
        elif a == GAP:
            seq.append(b)
            quals.append(quals2[q2])
            q2 += 1
        elif b == GAP:
            seq.append(a)
            quals.append(quals1[q1])
            q1 += 1
        else:
            if quals1[q1] >= quals2[q2]:
                seq.append(a)
            else:
                seq.append(b)
            quals.append(combine_phred_scores(quals1[q1], quals2[q2], False))
            q1 += 1
            q2 += 1
    return bytes(seq), bytes(quals)


def merge_by_alignment(reads: ReadSetContainer,
                       scoring: AffineScoring = MERGE_SCORING) -> MergedRead:
    """Global-align R1 vs revcomp(R2), consensus the columns
    (merger.rs:348-396). Host fallback path; the pipeline batches these DPs
    on device."""
    r1 = reads.read_one.seq
    r2 = reverse_complement(reads.read_two.seq)
    q2 = reads.read_two.qual[::-1]
    res = affine_align(r1, r2, scoring)
    seq, quals = alignment_rate_and_consensus(
        res.reference_aligned, reads.read_one.qual, res.read_aligned, q2)
    return MergedRead(name=reads.read_one.name, seq=seq, quals=quals)


def unify_read(reads: ReadSetContainer, layout: SequenceLayout,
               defer_align_merge: bool = False) -> MergedRead:
    """UnifiedRead::decision_tree (merger.rs:243-302): dispatch on the
    (read-pattern, merge-strategy) combination.

    With defer_align_merge=True, Align-strategy pairs are returned with
    pending_pair set so the caller can batch the merge DP on device.
    """
    has = (True, reads.read_two is not None, reads.index_one is not None,
           reads.index_two is not None)
    declared = {p.kind for p in layout.reads}
    pattern = ("Read1" in declared,
               "Read2" in declared and has[1],
               "Index1" in declared and has[2],
               "Index2" in declared and has[3])

    if pattern[:2] == (True, True) and layout.merge == MergeStrategy.ALIGN:
        if defer_align_merge:
            return MergedRead(
                name=reads.read_one.name, seq=b"", quals=b"",
                pending_pair=(reads.read_one.seq, reads.read_one.qual,
                              reverse_complement(reads.read_two.seq),
                              reads.read_two.qual[::-1]))
        return merge_by_alignment(reads)
    if layout.merge in (MergeStrategy.CONCATENATE,
                        MergeStrategy.CONCATENATE_BOTH_FORWARD):
        # concatenate whatever read positions the layout declares (the
        # reference's decision tree only supports the (R1,R2[,I1]) patterns
        # and panics otherwise, merger.rs:295-300; any declared-and-present
        # combination works here)
        available = {"Read1": True, "Read2": has[1], "Index1": has[2],
                     "Index2": has[3]}
        missing = [p.kind for p in layout.reads
                   if p.kind != "Spacer" and not available.get(p.kind, False)]
        if not missing:
            return merge_by_concatenation(reads, layout)
    if pattern[0] and not pattern[1]:
        orientation = next(
            (p.orientation for p in layout.reads if p.kind == "Read1"),
            AlignedReadOrientation.FORWARD)
        return MergedRead(
            name=reads.read_one.name,
            seq=orient_sequence(reads.read_one.seq, orientation),
            quals=reads.read_one.qual)
    raise ValueError(f"We don't support this read structure yet: {layout.reads}")
