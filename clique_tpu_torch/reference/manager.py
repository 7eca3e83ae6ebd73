"""Reference management: kmer routing index + exact-segment search.

Host-side equivalent of the Rust reference, rust_cmd/src/reference/
fasta_reference.rs (ReferenceManager, unique-kmer voting) and the seed
machinery of linked_alignment.rs (find_greedy_non_overlapping_segments,
extend_hit, orient_by_longest_segment). These indexes are tiny (amplicon
panels) and stay on host; the heavy alignment work happens on device.

Instead of a suffix table we index every seed-size kmer position of each
reference in a dict - equivalent lookups for fixed-length seeds, O(1) per
query, and trivially serializable.
"""

from __future__ import annotations

from collections import Counter, defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from clique_tpu_torch.config.layout import SequenceLayout
from clique_tpu_torch.utils.seq import DEGENERATE_MASK, reverse_complement, to_bytes


@dataclass(frozen=True)
class MatchedPosition:
    search_start: int
    ref_start: int
    length: int


@dataclass(frozen=True)
class SharedSegments:
    start_position: int
    alignment_segments: Tuple[MatchedPosition, ...]

    def total_length(self) -> int:
        return sum(s.length for s in self.alignment_segments)


class SeedIndex:
    """Positions of every `seed_size`-mer of a reference (suffix-table
    equivalent for fixed-length queries, fasta_reference.rs:155-157)."""

    def __init__(self, sequence: bytes, seed_size: int):
        self.seed_size = seed_size
        self.sequence = sequence
        self._index: Dict[bytes, List[int]] = defaultdict(list)
        for i in range(max(0, len(sequence) - seed_size + 1)):
            self._index[sequence[i:i + seed_size]].append(i)

    def positions(self, query: bytes) -> List[int]:
        return self._index.get(query, [])


@dataclass
class Reference:
    sequence: bytes
    name: str
    index: SeedIndex
    record_name: Optional[str] = None  # layout key


_BASE_BIT = {ord("A"): 1, ord("C"): 2, ord("G"): 4, ord("T"): 8}


def _contains(code: int, byte: int) -> bool:
    """DEGENERATEBASES[code] contains the key `byte`: byte must be a concrete
    ACGT (any case) in code's IUPAC set (fasta_comparisons.rs:21-68)."""
    from clique_tpu_torch.utils.seq import KNOWN_BASE
    canon = KNOWN_BASE[byte]
    if canon == 0:
        return False
    return (DEGENERATE_MASK[code] & _BASE_BIT[canon]) != 0


def extend_hit(search: bytes, s_loc: int, reference: bytes, r_loc: int) -> int:
    """Degenerate-aware mutual-containment seed extension
    (linked_alignment.rs:341-362): extend while each byte is a valid IUPAC
    code AND each side's set contains the other byte as a concrete base."""
    n = 0
    while s_loc + n < len(search) and r_loc + n < len(reference):
        a, b = search[s_loc + n], reference[r_loc + n]
        if DEGENERATE_MASK[a] == 0 or DEGENERATE_MASK[b] == 0:
            return n
        if not (_contains(a, b) and _contains(b, a)):
            return n
        n += 1
    return n


def find_greedy_non_overlapping_segments(
        search: bytes, reference: bytes, index: SeedIndex) -> SharedSegments:
    """Greedy seed-and-extend shared segments
    (linked_alignment.rs:97-128), including its position-advance behavior."""
    hits: List[MatchedPosition] = []
    position = 0
    least_ref = len(reference)
    greatest_ref = 0
    seed = index.seed_size
    while position <= len(search) - seed:
        longest = 0
        for ref_pos in index.positions(search[position:position + seed]):
            if ref_pos >= greatest_ref:
                ext = extend_hit(search, position, reference, ref_pos)
                if ext > longest:
                    hits.append(MatchedPosition(position, ref_pos, ext))
                    position += ext
                    least_ref = min(ref_pos, least_ref)
                    greatest_ref = max(ref_pos + ext, greatest_ref)
                    longest = ext
        position += 1
    return SharedSegments(least_ref, tuple(hits))


def orient_by_longest_segment(search: bytes, reference: bytes,
                              index: SeedIndex) -> Tuple[bool, SharedSegments, SharedSegments]:
    """True if forward orientation shares more exact sequence with the
    reference than the reverse complement (linked_alignment.rs:24-32)."""
    fwd = find_greedy_non_overlapping_segments(search, reference, index)
    rev = find_greedy_non_overlapping_segments(
        reverse_complement(search), reference, index)
    return fwd.total_length() > rev.total_length(), fwd, rev


class ReferenceManager:
    """Panel of amplicon references with a unique-kmer routing index
    (fasta_reference.rs:66-218). Default kmer size 8, spacing 4 as in the
    reference CLI (main.rs:271)."""

    def __init__(self, references: List[Reference], kmer_size: int = 8,
                 kmer_spacing: int = 4):
        self.references: Dict[int, Reference] = dict(enumerate(references))
        self.name_to_id: Dict[str, int] = {
            r.name: i for i, r in self.references.items()}
        self.kmer_size = kmer_size
        self.kmer_spacing = kmer_spacing
        self.longest_ref = max((len(r.sequence) for r in references), default=0)
        self._build_unique_kmers()

    # -- construction -------------------------------------------------------

    @staticmethod
    def from_layout(layout: SequenceLayout, kmer_size: int = 8,
                    kmer_spacing: int = 4) -> "ReferenceManager":
        refs = [
            Reference(sequence=rec.sequence.encode(), name=name,
                      index=SeedIndex(rec.sequence.encode(), kmer_size),
                      record_name=name)
            for name, rec in layout.references.items()
        ]
        layout.validate_reference_symbols()
        return ReferenceManager(refs, kmer_size, kmer_spacing)

    @staticmethod
    def from_fasta(path: str, kmer_size: int = 8,
                   kmer_spacing: int = 4) -> "ReferenceManager":
        from clique_tpu_torch.io.fastq import read_fasta
        refs = [
            Reference(sequence=seq, name=name,
                      index=SeedIndex(seq, kmer_size))
            for name, seq in read_fasta(path)
        ]
        return ReferenceManager(refs, kmer_size, kmer_spacing)

    # -- kmers (fasta_reference.rs:159-218) ---------------------------------

    @staticmethod
    def sequence_to_kmers(sequence: bytes, kmer_size: int,
                          kmer_spacing: int) -> List[Tuple[bytes, int]]:
        seq = sequence.upper()
        kmers = [seq[i:i + kmer_size]
                 for i in range(0, len(seq) - kmer_size + 1, kmer_spacing)]
        # dedup_with_count over consecutive runs (itertools-style)
        out: List[Tuple[bytes, int]] = []
        for k in kmers:
            if out and out[-1][0] == k:
                out[-1] = (k, out[-1][1] + 1)
            else:
                out.append((k, 1))
        return out

    def _build_unique_kmers(self) -> None:
        counts: Counter = Counter()
        per_ref: Dict[int, List[Tuple[bytes, int]]] = {}
        for i, ref in self.references.items():
            kmers = self.sequence_to_kmers(ref.sequence, self.kmer_size,
                                           self.kmer_spacing)
            per_ref[i] = kmers
            for k, c in kmers:
                counts[k] += c
        self.kmer_to_reference: Dict[bytes, int] = {}
        self.reference_to_kmer: Dict[int, List[bytes]] = {}
        self.all_have_unique_mappings = True
        for i, kmers in per_ref.items():
            unique = [k for k, _c in kmers if counts[k] == 1]
            if not unique:
                self.all_have_unique_mappings = False
            for k in unique:
                self.kmer_to_reference[k] = i
            self.reference_to_kmer[i] = unique

    def vote_references(self, read: bytes) -> Counter:
        """Per-reference unique-kmer vote counts for a read
        (quick_alignment_search, alignment_functions.rs:702-716)."""
        votes: Counter = Counter()
        for k, _c in self.sequence_to_kmers(read, self.kmer_size,
                                            self.kmer_spacing):
            hit = self.kmer_to_reference.get(k)
            if hit is not None:
                votes[hit] += 1
        return votes
