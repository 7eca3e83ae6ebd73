"""Anchored (seed-and-extend) alignment.

Host implementation of the Rust reference, rust_cmd/src/linked_alignment.rs
(align_string_with_anchors :147-266, validate_cigar_string :269-304,
calculate_score_from_strings :313-331): exact shared segments found by the
seed index become M runs; the gaps between anchors are aligned with the
affine DP (optionally inversion-aware); tiny equal-length gaps (<5bp)
become direct match segments. This shrinks giant DP problems exactly as the
reference does - the TPU analogue batches the small inter-anchor DPs.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from clique_tpu_torch.align.cpu import (
    AlignmentResult,
    affine_align,
    simplify_cigar,
)
from clique_tpu_torch.align.inversion import inversion_alignment
from clique_tpu_torch.align.scoring import AffineScoring, InversionScoring
from clique_tpu_torch.reference.manager import SharedSegments
from clique_tpu_torch.utils.seq import GAP


def _match_segment_result(ref_slice: bytes, read_slice: bytes,
                          ref_name: str, read_name: str, start_x: int,
                          start_y: int,
                          scoring: AffineScoring) -> AlignmentResult:
    """AlignmentResult::from_match_segment (alignment_matrix.rs:710-734)."""
    score = sum(scoring.match_mismatch(a, b)
                for a, b in zip(ref_slice, read_slice))
    return AlignmentResult(
        reference_name=ref_name, read_name=read_name,
        reference_aligned=ref_slice, read_aligned=read_slice,
        read_quals=None,
        cigar=[(len(ref_slice), "M")] if ref_slice else [],
        path=[(start_x + i, start_y + i) for i in range(len(ref_slice))],
        score=score, reference_start=start_x, read_start=start_y)


def calculate_score_from_strings(reference: bytes, read: bytes,
                                 scoring: AffineScoring) -> float:
    """linked_alignment.rs:313-331, reproduced with its exact arm order
    (the first arm catches ref-base/read-gap columns as match_mismatch)."""
    assert len(reference) == len(read)
    in_indel = False
    total = 0.0
    for a, b in zip(reference, read):
        if a != GAP and b == GAP:
            in_indel = False
            total += scoring.match_mismatch(a, b)
        elif in_indel:
            total += scoring.gap_extend
        else:
            in_indel = True
            total += scoring.gap_open
    return total


def validate_cigar_string(reference: bytes, read: bytes,
                          cigar: List[Tuple[int, str]]) -> None:
    """linked_alignment.rs:269-304."""
    assert len(reference) == len(read)
    pos = 0
    for length, op in cigar:
        if op == "M":
            assert GAP not in reference[pos:pos + length]
            assert GAP not in read[pos:pos + length]
            pos += length
        elif op == "D":
            assert GAP not in reference[pos:pos + length]
            assert read[pos:pos + length].count(GAP) == length
            pos += length
        elif op == "I":
            assert reference[pos:pos + length].count(GAP) == length
            assert GAP not in read[pos:pos + length]
            pos += length
        elif op == "S":
            pos += length
        # inversion markers and hard clips consume nothing
    assert pos == len(reference)


def slice_for_alignment(read: bytes, start: int, end: int) -> bytes:
    """linked_alignment.rs:240-247: bounds-checked read slice (Rust
    panics out of bounds; we raise)."""
    if end > len(read):
        raise IndexError(
            f"slice [{start}:{end}] out of bounds for read of length "
            f"{len(read)}")
    return read[start:end]


def cigar_alignment_to_full_string(read: bytes, reference: bytes,
                                   alignment_start: int,
                                   cigar: List[Tuple[int, str]]
                                   ) -> Tuple[str, str]:
    """linked_alignment.rs cigar_alignment_to_full_string: expand an
    offset + tag list into gapped (read, reference) strings; reference
    positions before alignment_start pair with read gaps."""
    out_read = bytearray(b"-" * alignment_start)
    out_ref = bytearray(reference[:alignment_start])
    read_pos, ref_pos = 0, alignment_start
    for length, op in cigar:
        if op in ("M", "X", "="):
            out_read += read[read_pos:read_pos + length]
            out_ref += reference[ref_pos:ref_pos + length]
            read_pos += length
            ref_pos += length
        elif op == "I":
            out_read += read[read_pos:read_pos + length]
            out_ref += b"-" * length
            read_pos += length
        elif op == "D":
            out_read += b"-" * length
            out_ref += reference[ref_pos:ref_pos + length]
            ref_pos += length
    return out_read.decode(), out_ref.decode()


def plan_anchor_pieces(search_string: bytes, reference: bytes,
                       overlaps: SharedSegments):
    """Phase 1 of anchored alignment: walk the shared segments and emit the
    piece plan without running any DP. Returns (pieces, subproblems) where
    subproblems = [(ref_slice, read_slice)] to be aligned (batchable), and
    pieces is the stitch order: ('sub', j) for subproblem j,
    ('match', ref_slice, read_slice) for tiny equal-length gaps,
    ('anchor', ref_slice, read_slice) for exact anchor runs,
    ('del', ref_slice) for a trailing reference gap."""
    pieces: List[Tuple] = []
    subproblems: List[Tuple[bytes, bytes]] = []
    read_last = 0
    ref_last = 0
    for seg in overlaps.alignment_segments:
        assert read_last <= seg.search_start, "READ START FAILURE"
        assert ref_last <= seg.ref_start, "REF START FAILURE"
        read_slice = search_string[read_last:seg.search_start]
        ref_slice = reference[ref_last:seg.ref_start]
        if len(read_slice) < 5 and len(ref_slice) < 5 and \
                len(read_slice) == len(ref_slice):
            pieces.append(("match", ref_slice, read_slice))
        else:
            pieces.append(("sub", len(subproblems)))
            subproblems.append((ref_slice, read_slice))
        read_last += len(read_slice)
        ref_last += len(ref_slice)
        pieces.append((
            "anchor", reference[seg.ref_start:seg.ref_start + seg.length],
            search_string[seg.search_start:seg.search_start + seg.length]))
        read_last += seg.length
        ref_last += seg.length
    if overlaps.alignment_segments:
        last = overlaps.alignment_segments[-1]
        read_stop = last.search_start + last.length
        if read_stop < len(search_string):
            pieces.append(("sub", len(subproblems)))
            subproblems.append((reference[ref_last:],
                                search_string[read_last:]))
        elif ref_last < len(reference):
            pieces.append(("del", reference[ref_last:]))
    else:
        pieces.append(("sub", len(subproblems)))
        subproblems.append((reference, search_string))
    return pieces, subproblems


def stitch_anchor_pieces(pieces, sub_results,
                         aff_scoring: AffineScoring
                         ) -> Tuple[bytes, bytes, List[Tuple[int, str]],
                                    float]:
    """Phase 2: assemble aligned strings + CIGAR from the piece plan and
    the solved subproblems ([(ref_aligned, read_aligned, cigar)] per
    subproblem). Returns (ref_aligned, read_aligned, cigar, score) with
    the same validation + rescoring as align_string_with_anchors."""
    aln_ref = bytearray()
    aln_read = bytearray()
    cigar: List[Tuple[int, str]] = []
    for piece in pieces:
        kind = piece[0]
        if kind == "sub":
            ra, da, cg = sub_results[piece[1]]
            aln_ref.extend(ra)
            aln_read.extend(da)
            cigar.extend(cg)
        elif kind in ("match", "anchor"):
            _k, ref_slice, read_slice = piece
            aln_ref.extend(ref_slice)
            aln_read.extend(read_slice)
            if ref_slice:
                cigar.append((len(ref_slice), "M"))
        else:  # del
            ref_slice = piece[1]
            aln_ref.extend(ref_slice)
            aln_read.extend(bytes([GAP]) * len(ref_slice))
            cigar.append((len(ref_slice), "D"))
    score = calculate_score_from_strings(bytes(aln_ref), bytes(aln_read),
                                         aff_scoring)
    validate_cigar_string(bytes(aln_ref), bytes(aln_read), cigar)
    return (bytes(aln_ref), bytes(aln_read), simplify_cigar(cigar), score)


class AnchoredBatchAligner:
    """Batched seed-and-extend alignment for long reads (VERDICT r1 item
    7; reference wiring alignment_functions.rs:260-321 ->
    linked_alignment.rs:147-266).

    Drop-in align_pairs(refs, reads): exact anchor segments are found on
    host with the seed index; EVERY inter-anchor gap sub-DP across the
    whole batch is batched through one inner BatchAligner pass (the small
    gap problems bucket tightly, so a 10kb read costs a handful of 128^2
    device tiles instead of one 10k^2 fill). Output is identical to
    align_string_with_anchors with the same scoring (the device sub-DP is
    bit-identical to the host golden)."""

    def __init__(self, inner, scoring: AffineScoring, seed_size: int = 12):
        from clique_tpu_torch.reference.manager import SeedIndex

        self.inner = inner
        self.scoring = scoring
        self.seed_size = seed_size
        self._SeedIndex = SeedIndex
        self._index_cache = {}
        self.pairs_aligned = 0

    def _index_for(self, ref: bytes):
        idx = self._index_cache.get(ref)
        if idx is None:
            idx = self._SeedIndex(ref, self.seed_size)
            self._index_cache[ref] = idx
        return idx

    def align_pairs(self, refs: List[bytes], reads: List[bytes],
                    indexes: Optional[List] = None):
        from clique_tpu_torch.reference.manager import (
            find_greedy_non_overlapping_segments,
        )

        plans = []
        all_subs: List[Tuple[bytes, bytes]] = []
        spans: List[Tuple[int, int]] = []
        for i, (ref, read) in enumerate(zip(refs, reads)):
            index = indexes[i] if indexes is not None else \
                self._index_for(ref)
            segs = find_greedy_non_overlapping_segments(read, ref, index)
            pieces, subs = plan_anchor_pieces(read, ref, segs)
            plans.append(pieces)
            spans.append((len(all_subs), len(subs)))
            all_subs.extend(subs)

        outs = self.inner.align_pairs([s[0] for s in all_subs],
                                      [s[1] for s in all_subs])
        results = []
        for pieces, (start, count) in zip(plans, spans):
            subs = [(outs[start + j][0], outs[start + j][1],
                     outs[start + j][2]) for j in range(count)]
            results.append(stitch_anchor_pieces(pieces, subs, self.scoring))
        self.pairs_aligned += len(refs)
        return results

    # metrics passthrough for align_reads' metrics block
    @property
    def device_seconds(self):
        return self.inner.device_seconds

    @property
    def post_seconds(self):
        return self.inner.post_seconds

    @property
    def cells_filled(self):
        return self.inner.cells_filled


def align_string_with_anchors(
        read_name: str, ref_name: str, search_string: bytes,
        reference: bytes, overlaps: SharedSegments,
        inv_scoring: Optional[InversionScoring],
        aff_scoring: AffineScoring) -> AlignmentResult:
    """linked_alignment.rs:147-266.

    NOTE on argument roles (matching the reference call sites): the
    SharedSegments were found by searching `search_string` against
    `reference`'s seed index; segments' search_start indexes search_string
    and ref_start indexes reference. The reference engine treats
    search_string slices as the 'reference side' of each sub-DP, as its
    align_two_strings caller does (alignment_functions.rs:283-298)."""
    aln_ref = bytearray()
    aln_read = bytearray()
    cigar: List[Tuple[int, str]] = []
    read_last = 0
    ref_last = 0

    def sub_align(ref_slice: bytes, read_slice: bytes) -> AlignmentResult:
        if inv_scoring is not None:
            return inversion_alignment(ref_slice, read_slice, ref_name,
                                       read_name, inv_scoring, aff_scoring,
                                       False)
        return affine_align(ref_slice, read_slice, aff_scoring,
                            seq1_name=ref_name, seq2_name=read_name)

    for seg in overlaps.alignment_segments:
        assert read_last <= seg.search_start, "READ START FAILURE"
        assert ref_last <= seg.ref_start, "REF START FAILURE"
        read_slice = search_string[read_last:seg.search_start]
        ref_slice = reference[ref_last:seg.ref_start]

        if inv_scoring is None and len(read_slice) < 5 and \
                len(ref_slice) < 5 and len(read_slice) == len(ref_slice):
            sub = _match_segment_result(ref_slice, read_slice, ref_name,
                                        read_name, ref_last, read_last,
                                        aff_scoring)
        else:
            sub = sub_align(ref_slice, read_slice)
        read_last += len(read_slice)
        ref_last += len(ref_slice)
        aln_ref.extend(sub.reference_aligned)
        aln_read.extend(sub.read_aligned)
        # NOTE: the reference pushes sub-alignment cigars REVERSED
        # (linked_alignment.rs:188) which breaks its own validate call for
        # non-palindromic sub-cigars (its end-to-end test is disabled);
        # we keep forward order so validation holds.
        cigar.extend(sub.cigar)

        aln_ref.extend(reference[seg.ref_start:seg.ref_start + seg.length])
        aln_read.extend(
            search_string[seg.search_start:seg.search_start + seg.length])
        read_last += seg.length
        ref_last += seg.length
        cigar.append((seg.length, "M"))

    if overlaps.alignment_segments:
        last = overlaps.alignment_segments[-1]
        read_stop = last.search_start + last.length
        if read_stop < len(search_string):
            read_slice = search_string[read_last:]
            ref_slice = reference[ref_last:]
            sub = sub_align(ref_slice, read_slice)
            aln_ref.extend(sub.reference_aligned)
            aln_read.extend(sub.read_aligned)
            cigar.extend(sub.cigar)
        elif ref_last < len(reference):
            gap_len = len(reference) - ref_last
            aln_ref.extend(reference[ref_last:])
            aln_read.extend(bytes([GAP]) * gap_len)
            cigar.append((gap_len, "D"))
    else:
        sub = sub_align(reference, search_string)
        aln_ref.extend(sub.reference_aligned)
        aln_read.extend(sub.read_aligned)
        cigar.extend(sub.cigar)

    score = calculate_score_from_strings(bytes(aln_ref), bytes(aln_read),
                                         aff_scoring)
    validate_cigar_string(bytes(aln_ref), bytes(aln_read), cigar)

    return AlignmentResult(
        reference_name=ref_name, read_name=read_name,
        reference_aligned=bytes(aln_ref), read_aligned=bytes(aln_read),
        read_quals=None, cigar=simplify_cigar(cigar), path=[],
        score=score, reference_start=0, read_start=0)
