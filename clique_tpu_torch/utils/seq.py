"""Sequence / base utilities.

Re-derives the base dictionaries and PHRED math of the reference engine
(see the Rust reference, rust_cmd/src/fasta_comparisons.rs and
utils/read_utils.rs, utils/base_utils.rs) as numpy-friendly tables so the
same rules can run both on host (numpy) and on device (jax, via the uint8
lookup tables below).

Conventions (shared with the reference pipeline):
- sequences are byte strings / uint8 arrays of ASCII;
- ``GAP`` (b'-') is the alignment gap / unset base (FASTA_UNSET);
- reference strings may contain capture wildcards: digits '0'-'9' and
  symbols like '*', '&', '$', '#' (any byte < 58 scores as a "special"
  match during alignment, reference scoring_functions.rs:100-102).
"""

from __future__ import annotations

import numpy as np

GAP = ord("-")  # FASTA_UNSET in the reference (rust_cmd/src/main.rs:70)
FASTA_N = ord("N")

# IUPAC complement map as a 256-entry uint8 table. Matches the reference's
# reverse_complement (read_utils.rs:50-72): case-folds to uppercase, maps
# purine<->pyrimidine classes, leaves unrecognized bytes unchanged.
_COMPLEMENT = np.arange(256, dtype=np.uint8)
for _a, _b in [
    ("A", "T"), ("T", "A"), ("G", "C"), ("C", "G"),
    ("R", "Y"), ("Y", "R"), ("S", "S"), ("W", "W"),
    ("K", "M"), ("M", "K"), ("B", "V"), ("D", "H"),
    ("H", "D"), ("V", "B"), ("N", "N"),
]:
    _COMPLEMENT[ord(_a)] = ord(_b)
    _COMPLEMENT[ord(_a.lower())] = ord(_b)  # case-folds to uppercase
COMPLEMENT_TABLE = _COMPLEMENT

# Degenerate IUPAC membership: DEGENERATE_MASK[byte] is a 4-bit mask over
# (A=1, C=2, G=4, T=8); 0 for non-base bytes. Mirrors DEGENERATEBASES
# (fasta_comparisons.rs:21-68).
_IUPAC = {
    "A": "A", "C": "C", "G": "G", "T": "T", "U": "T",
    "R": "AG", "Y": "CT", "K": "GT", "M": "AC", "S": "CG", "W": "AT",
    "B": "CGT", "D": "AGT", "H": "ACT", "V": "ACG", "N": "ACGT",
}
_BITS = {"A": 1, "C": 2, "G": 4, "T": 8}
DEGENERATE_MASK = np.zeros(256, dtype=np.uint8)
for _sym, _bases in _IUPAC.items():
    _mask = sum(_BITS[b] for b in _bases)
    DEGENERATE_MASK[ord(_sym)] = _mask
    DEGENERATE_MASK[ord(_sym.lower())] = _mask

# Canonical (case-folded) ACGT for exact-match tests; 0 for anything else.
# Mirrors KNOWNBASES (fasta_comparisons.rs:8-19).
KNOWN_BASE = np.zeros(256, dtype=np.uint8)
for _b in "ACGT":
    KNOWN_BASE[ord(_b)] = ord(_b)
    KNOWN_BASE[ord(_b.lower())] = ord(_b)


def to_bytes(seq) -> bytes:
    if isinstance(seq, bytes):
        return seq
    if isinstance(seq, str):
        return seq.encode()
    return bytes(np.asarray(seq, dtype=np.uint8))


def to_array(seq) -> np.ndarray:
    """ASCII sequence -> uint8 numpy array."""
    if isinstance(seq, np.ndarray) and seq.dtype == np.uint8:
        return seq
    return np.frombuffer(to_bytes(seq), dtype=np.uint8).copy()


def reverse_complement(seq):
    """IUPAC-aware reverse complement; returns same flavor (bytes in/out)."""
    arr = to_array(seq)[::-1]
    out = COMPLEMENT_TABLE[arr]
    if isinstance(seq, str):
        return out.tobytes().decode()
    if isinstance(seq, bytes):
        return out.tobytes()
    return out


def is_valid_fasta_base(byte: int) -> bool:
    """True for ACGTU + IUPAC degenerate codes, any case (base_utils.rs:17-23)."""
    return DEGENERATE_MASK[byte] != 0


def degenerate_match(a: int, b: int) -> bool:
    """Degenerate-aware base compatibility (base_utils.rs edit_distance rule):
    compatible if either byte's IUPAC set contains the other's canonical base."""
    ka, kb = KNOWN_BASE[a], KNOWN_BASE[b]
    ma, mb = DEGENERATE_MASK[a], DEGENERATE_MASK[b]
    if ma and kb and (ma & _BITS[chr(kb)]):
        return True
    if mb and ka and (mb & _BITS[chr(ka)]):
        return True
    return False


def edit_distance(s1, s2) -> int:
    """Degenerate-aware Hamming distance over equal-length strings
    (base_utils.rs:4-15)."""
    a1, a2 = to_array(s1), to_array(s2)
    assert a1.shape == a2.shape
    m1, m2 = DEGENERATE_MASK[a1], DEGENERATE_MASK[a2]
    # compatible when the IUPAC sets intersect AND at least one side is a
    # recognized base (mirrors the reference's DEGENERATEBASES lookups)
    compatible = (m1 & m2) != 0
    return int(np.sum(~compatible))


def hamming_distance(s1, s2) -> int:
    a1, a2 = to_array(s1), to_array(s2)
    assert a1.shape == a2.shape
    return int(np.sum(a1 != a2))


# --- PHRED math (read_utils.rs:6-38) -----------------------------------------

def phred_to_prob(phred: int) -> float:
    return 10.0 ** (-(phred - 33) / 10.0)


def prob_to_phred(prob: float) -> int:
    # reference truncates toward zero via `as u8`
    return int((-10.0) * np.log10(prob) + 33.0)


def combine_phred_scores(phred_one: int, phred_two: int, agree: bool) -> int:
    """Combine two PHRED+33 scores (read_utils.rs:26-38). Reproduces the
    reference formulas exactly, including its disagreement formula
    ``1 - (1 - p2) * p1``."""
    p1 = phred_to_prob(phred_one)
    p2 = phred_to_prob(phred_two)
    if agree:
        return prob_to_phred(p1 * p2)
    return prob_to_phred(1.0 - ((1.0 - p2) * (1.0 * p1)))


def strip_gaps(seq):
    arr = to_array(seq)
    out = arr[arr != GAP]
    if isinstance(seq, str):
        return out.tobytes().decode()
    if isinstance(seq, bytes):
        return out.tobytes()
    return out


def normalize_tag(tag: bytes, length: int) -> bytes:
    """Gap-strip then right-pad with '-' to `length` (longer tags keep their
    length). Mirrors clique_tpu/collapse/correct.py:65-71; here so that the
    collapse worker processes reach it without importing torch."""
    stripped = tag.replace(b"-", b"")
    if len(stripped) < length:
        return stripped.ljust(length, b"-")
    return stripped


def pad_right(seq: bytes, target_len: int, pad_byte: int) -> bytes:
    """Resize to target_len, padding with pad_byte — and, like Vec::resize,
    TRUNCATING when target_len is shorter (read_utils.rs:44-48)."""
    if target_len <= len(seq):
        return seq[:target_len]
    return seq + bytes([pad_byte]) * (target_len - len(seq))


def all_combinations(n: int) -> list:
    """All length-n strings over ACGT, in the reference's suffix-major
    generation order (read_utils.rs:85-93; n=2 is the base case)."""
    chars = ["A", "C", "G", "T"]
    acc = [d + c for c in chars for d in chars]
    for _ in range(2, n):
        acc = [d + c for c in acc for d in chars]
    return acc


def create_fake_quality_scores(length: int) -> bytes:
    """Uniform 'H' qualities (read_utils.rs:94-96)."""
    return b"H" * length


def random_sequence(length: int, rng=None) -> str:
    """Uniform ACGT string. The reference's version (read_utils.rs:78-83)
    samples WITHOUT replacement from one copy of ACGT — a documented bug
    that silently truncates past 4 bases; we sample with replacement."""
    rng = np.random.default_rng() if rng is None else rng
    return "".join("ACGT"[i] for i in rng.integers(0, 4, size=length))
