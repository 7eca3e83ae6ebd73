"""Alignment scoring schemes.

Semantics mirror the Rust reference, rust_cmd/src/alignment/scoring_functions.rs.
All preset constants are dyadic rationals (k / 2^m); this is load-bearing:
it makes float32 device arithmetic produce bit-identical max/argmax decisions
to the float64 host reference, so the TPU kernels can run in f32.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from clique_tpu_torch.utils.seq import FASTA_N

MAX_NEG_SCORE = -100000.0  # alignment_matrix.rs:34


def _is_dyadic(x: float, max_denom_bits: int = 8) -> bool:
    return float(x * (1 << max_denom_bits)).is_integer()


@dataclass(frozen=True)
class AffineScoring:
    """Affine gap scoring with terminal-gap discounting and capture-wildcard
    handling (scoring_functions.rs:65-113).

    ``special_character_score`` applies whenever either byte is 'N' or any
    byte < 58 (digits '0'-'9' and symbols like '*', '&', '$', '#'), letting
    reads align straight through the reference's UMI/barcode capture
    wildcards (scoring_functions.rs:100-102).
    """

    match_score: float
    mismatch_score: float
    special_character_score: float
    gap_open: float
    gap_extend: float
    final_gap_multiplier: float

    @staticmethod
    def default_dna() -> "AffineScoring":
        # matches DNAFull from EMBOSS WATER (scoring_functions.rs:77-86)
        return AffineScoring(5.0, -4.0, 4.0, -10.0, -0.5, 0.5)

    @staticmethod
    def distance_dna() -> "AffineScoring":
        return AffineScoring(0.0, -1.0, -1.0, 0.0, -1.0, 1.0)

    @staticmethod
    def aligner_default() -> "AffineScoring":
        # the hardcoded scoring of the `align` command driver
        # (alignment_functions.rs:104-111)
        return AffineScoring(10.0, -9.0, 9.0, -20.0, -2.0, 1.0)

    @staticmethod
    def merge_default() -> "AffineScoring":
        # paired-end merge scoring (merger.rs:130-139)
        return AffineScoring(10.0, -5.0, 8.0, -15.0, -1.0, 0.25)

    @staticmethod
    def hifi_default() -> "AffineScoring":
        # PacBio-HiFi low-error mode (BASELINE config 2): errors are rare,
        # so mismatches and gap opens cost more relative to matches,
        # sharpening allele boundaries on clean reads
        return AffineScoring(5.0, -16.0, 4.0, -32.0, -4.0, 1.0)

    def match_mismatch(self, a: int, b: int) -> float:
        if a == FASTA_N or b == FASTA_N or a < 58 or b < 58:
            return self.special_character_score
        return self.match_score if a == b else self.mismatch_score

    def match_matrix(self) -> np.ndarray:
        """Dense 256x256 f64 substitution matrix implementing match_mismatch."""
        a = np.arange(256, dtype=np.uint8)
        special = (a == FASTA_N) | (a < 58)
        sp = special[:, None] | special[None, :]
        eq = a[:, None] == a[None, :]
        out = np.where(sp, self.special_character_score,
                       np.where(eq, self.match_score, self.mismatch_score))
        return out.astype(np.float64)

    def assert_dyadic(self):
        for v in (self.match_score, self.mismatch_score, self.special_character_score,
                  self.gap_open, self.gap_extend, self.final_gap_multiplier,
                  self.gap_extend * self.final_gap_multiplier):
            assert _is_dyadic(v), f"non-dyadic scoring constant {v}; f32 device path unsafe"


@dataclass(frozen=True)
class SimpleScoring:
    match_score: float
    mismatch_score: float
    gap_score: float

    def match_mismatch(self, a: int, b: int) -> float:
        return self.match_score if a == b else self.mismatch_score

    def gap(self, length: int) -> float:
        return self.gap_score * length


@dataclass(frozen=True)
class ConvexScoring:
    """Convex (log-length) gap cost: gap(len) = gap_open + log10(len)
    (scoring_functions.rs:36-53). Present for parity; the reference never
    wires it into a DP fill. Our wavefront kernel's dual-affine mode is the
    practical convex approximation (see align/wavefront.py)."""

    match_score: float
    mismatch_score: float
    gap_score: float
    gap_open: float
    gap_extend: float

    def match_mismatch(self, a: int, b: int) -> float:
        return self.match_score if a == b else self.mismatch_score

    def gap(self, length: int) -> float:
        return self.gap_open + float(np.log10(length))


@dataclass(frozen=True)
class InversionScoring:
    match_score: float = 9.0
    mismatch_score: float = -21.0
    gap_open: float = -25.0
    gap_extend: float = -1.0
    inversion_penalty: float = -40.0
    min_inversion_length: int = 20

    def match_mismatch(self, a: int, b: int) -> float:
        return self.match_score if a == b else self.mismatch_score
