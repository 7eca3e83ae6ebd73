"""Tag extraction from gapped alignments.

Host/vectorizable equivalent of the Rust reference, rust_cmd/src/extractor.rs:
walk the aligned (reference, read) pair; digit wildcards '0'-'9' in the
reference capture the matching read bases keyed by the digit
(extract_tagged_sequences :271-332); uppercase reference stretches amid
lowercase context open paired "extractor" zones keyed 'A','B',... (reference
side) / 'a','b',... (read side). Also: CIGAR-based alignment reconstruction
with soft-clip realignment (recover_soft_clipped_align_sequences :56-190)
and reference re-stretching (stretch_sequence_to_alignment :228-251).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

from clique_tpu_torch.align.cpu import affine_align, affine_align_fast


def _realign(ref_slice: bytes, read_slice: bytes, scoring):
    """Soft-clip realignment dispatch: the vectorized exact twin wins past
    ~60bp sides (anti-diagonal numpy loop overhead dominates below); both
    produce identical output (tests/test_align_cpu.py)."""
    if len(ref_slice) * len(read_slice) >= 3600:
        return affine_align_fast(ref_slice, read_slice, scoring)
    return affine_align(ref_slice, read_slice, scoring)
from clique_tpu_torch.align.scoring import AffineScoring
from clique_tpu_torch.config.layout import ReferenceRecord
from clique_tpu_torch.utils.seq import GAP, is_valid_fasta_base

REFERENCE_CHAR = ord("R")
READ_CHAR = ord("E")

SPECIAL_CHARACTERS = frozenset(b"0123456789")


def extract_tagged_sequences(aligned_read: bytes,
                             aligned_ref: bytes) -> Dict[int, str]:
    """extractor.rs:271-332. Returns {key byte -> captured string} where keys
    are digit bytes for wildcard captures and 'A'/'a'.. pairs for uppercase
    extractor zones."""
    special: Dict[int, bytearray] = {}
    in_extractor = False
    next_read_key = ord("a")
    next_ref_key = ord("A")

    for ref_b, read_b in zip(aligned_ref, aligned_read):
        is_upper_zone = (chr(ref_b).isascii() and chr(ref_b).isupper()) or \
            (ref_b == GAP and in_extractor)
        if is_upper_zone:
            in_extractor = True
            special.setdefault(next_ref_key, bytearray()).append(ref_b)
            special.setdefault(next_read_key, bytearray()).append(read_b)
        elif not is_valid_fasta_base(ref_b) and ref_b in SPECIAL_CHARACTERS:
            if in_extractor:
                special.setdefault(next_ref_key, bytearray()).append(ref_b)
                special.setdefault(next_read_key, bytearray()).append(read_b)
            special.setdefault(ref_b, bytearray()).append(read_b)
        else:
            if in_extractor:
                next_read_key += 1
                next_ref_key += 1
            in_extractor = False

    return {k: bytes(v).decode() for k, v in sorted(special.items())}


def stretch_sequence_to_alignment(aligned_version: bytes,
                                  native_version: bytes) -> bytes:
    """Re-inflate the native (wildcard-bearing) sequence to match a gapped
    alignment (extractor.rs:228-251), reproducing its loop bounds exactly
    (trailing gaps after the native bases are consumed are dropped)."""
    assert len(aligned_version) >= len(native_version), (
        "The aligned version is shorter than the native (unaligned) version")
    out = bytearray()
    ni = ai = 0
    while ai < len(aligned_version) and ni < len(native_version):
        if aligned_version[ai] == GAP:
            ai += 1
            out.append(GAP)
        else:
            out.append(native_version[ni])
            ai += 1
            ni += 1
    return bytes(out)


def gap_proportion_per_tag(tags: Dict[int, str]) -> List[float]:
    """extractor.rs:253-269: per digit-keyed tag, fraction of gap chars."""
    out = []
    for key, value in sorted(tags.items()):
        if key not in (REFERENCE_CHAR, READ_CHAR) and ord("0") <= key <= ord("9"):
            gaps = value.count("-")
            out.append(gaps / len(value) if value else 0.0)
    return out


def extract_tag_sequences(reference_record: ReferenceRecord,
                          tags: Dict[int, str]
                          ) -> Tuple[bool, List[Tuple[str, bytes]]]:
    """extractor.rs:355-410: order the extracted tags by UMI configuration,
    flagging the read invalid on length mismatch, missing capture, or too
    many gaps."""
    invalid = False
    collected: List[Tuple[int, Tuple[str, bytes]]] = []
    for _name, umi in reference_record.umi_configurations.items():
        hit = tags.get(ord(umi.symbol))
        if hit is None:
            invalid = True
            continue
        if len(hit) != umi.length:
            invalid = True
        data = hit.encode()
        gaps = data.count(GAP)
        if umi.max_gaps is not None and gaps > umi.max_gaps:
            invalid = True
        collected.append((umi.order, (umi.symbol, data)))
    collected.sort(key=lambda t: t[0])
    return invalid, [kv for _o, kv in collected]


def extract_digit_tags_fast(aligned_read: bytes, aligned_ref: bytes,
                            symbols: List[str]) -> Dict[str, str]:
    """Vectorized digit-wildcard capture for the pipeline hot path.

    Produces exactly the digit-keyed subset of extract_tagged_sequences:
    the reference walk pushes read bases for a digit reference byte in both
    its in-zone and out-of-zone arms (extractor.rs:294-313), so for digit
    keys a plain positional mask is equivalent.
    """
    import numpy as np

    ref_a = np.frombuffer(aligned_ref, dtype=np.uint8)
    read_a = np.frombuffer(aligned_read, dtype=np.uint8)
    out = {}
    for sym in symbols:
        mask = ref_a == ord(sym)
        if mask.any():
            out[sym] = read_a[mask].tobytes().decode()
    return out


def recover_aligned_sequences_fast(unaligned_read: bytes,
                                   one_based_start: int,
                                   cigar, reference: bytes):
    """Vectorized CIGAR reconstruction for records without soft clips
    (M/=/X/I/D/N/H/P only). Returns (aligned_read, aligned_ref) matching
    recover_aligned_sequences, or None when a soft clip requires the
    realignment path."""
    import numpy as np

    if not cigar or any(op == "S" for _c, op in cigar):
        return None
    ref_pos = one_based_start - 1
    read_a = np.frombuffer(unaligned_read, dtype=np.uint8)
    ref_a = np.frombuffer(reference, dtype=np.uint8)

    if all(op in "M=X" for _c, op in cigar):
        # pure match/mismatch (the common case for substitution-only reads):
        # the read sits verbatim under the reference, gaps on both flanks
        n = sum(c for c, _op in cigar)
        end = ref_pos + n
        aligned_read = (b"-" * ref_pos + unaligned_read[:n]
                        + b"-" * max(len(ref_a) - end, 0))
        return aligned_read, reference

    code = {"M": 0, "=": 0, "X": 0, "I": 1, "D": 2, "N": 2}
    ops = np.repeat(
        np.array([code.get(op, 3) for _c, op in cigar], dtype=np.uint8),
        np.array([c for c, _op in cigar], dtype=np.int64))
    core = ops[ops != 3]

    r_step = core != 1          # consumes reference
    d_step = core != 2          # consumes read
    r_idx = np.cumsum(r_step) + ref_pos
    d_idx = np.cumsum(d_step)
    mid_ref = np.where(r_step,
                       ref_a[np.clip(r_idx - 1, 0, len(ref_a) - 1)],
                       GAP).astype(np.uint8)
    mid_read = np.where(d_step,
                        read_a[np.clip(d_idx - 1, 0, len(read_a) - 1)],
                        GAP).astype(np.uint8)
    end_ref_pos = ref_pos + int(r_step.sum())

    lead_ref = ref_a[:ref_pos]
    lead_read = np.full(ref_pos, GAP, dtype=np.uint8)
    tail_ref = ref_a[end_ref_pos:]
    tail_read = np.full(len(ref_a) - end_ref_pos, GAP, dtype=np.uint8)
    aligned_ref = np.concatenate([lead_ref, mid_ref, tail_ref]).tobytes()
    aligned_read = np.concatenate([lead_read, mid_read, tail_read]).tobytes()
    return aligned_read, aligned_ref


def stretch_sequence_to_alignment_fast(aligned_version: bytes,
                                       native_version: bytes) -> bytes:
    """Vectorized stretch_sequence_to_alignment (same trailing-gap-dropping
    quirk)."""
    import numpy as np

    if b"-" not in aligned_version:
        # no gaps to re-inflate: the native (wildcard) sequence positionally
        # covers the whole alignment
        return native_version[:len(aligned_version)]
    av = np.frombuffer(aligned_version, dtype=np.uint8)
    nv = np.frombuffer(native_version, dtype=np.uint8)
    if len(nv) == 0:
        return b""
    gap = av == GAP
    nongap_before = np.concatenate(([0], np.cumsum(~gap)[:-1]))
    emit = nongap_before < len(nv)
    out = np.where(gap, GAP,
                   nv[np.clip(nongap_before, 0, max(len(nv) - 1, 0))]
                   ).astype(np.uint8)
    return out[emit].tobytes()


def alignment_rate_fast(aligned_ref: bytes, aligned_read: bytes) -> float:
    """Vectorized get_reference_alignment_rate
    (consensus_builders.rs:288-307)."""
    import numpy as np

    r = np.frombuffer(aligned_ref, dtype=np.uint8)
    d = np.frombuffer(aligned_read, dtype=np.uint8)
    counted = (r > 64) & (r != 78) & (d > 64)
    total = int(counted.sum())
    if total == 0:
        return float("nan")
    return float(int(((r == d) & counted).sum()) / total)


def alignment_rates_rows(a_ref, a_read):
    """Row-wise alignment_rate_fast over [N, L] uint8 matrices: identity
    over columns where the reference is a non-N letter and the read is a
    letter (consensus_builders.rs:288-307), NaN for rows with no counted
    columns. a_ref may broadcast (e.g. one [1, L] reference row against
    [G, L] consensus rows). Padding bytes of 0 are never counted. The
    single shared implementation for every batched rate site — the
    formula must stay bit-identical across the align fast path, collapse
    outputs, and consensus, or the golden pins diverge between paths."""
    import numpy as np

    counted = (a_ref > 64) & (a_ref != 78) & (a_read > 64)
    tot = counted.sum(axis=1)
    match = ((a_ref == a_read) & counted).sum(axis=1)
    with np.errstate(invalid="ignore"):
        return np.where(tot > 0, match / np.maximum(tot, 1), np.nan)


def custom_umi_score(a: int, b: int) -> int:
    """Nucleotide/degenerate scoring for UMI matching (extractor.rs:414-442):
    10 for matching/degenerate-compatible known bases, -8 for known-base
    mismatches, 7 for special characters."""
    from clique_tpu_torch.utils.seq import DEGENERATE_MASK, KNOWN_BASE

    ka, kb = KNOWN_BASE[a], KNOWN_BASE[b]
    if ka and kb and ka == kb:
        return 10
    bits = {ord("A"): 1, ord("C"): 2, ord("G"): 4, ord("T"): 8}
    if ka and kb and DEGENERATE_MASK[a] and kb in bits and \
            (DEGENERATE_MASK[a] & bits[kb]):
        return 10
    if ka and kb and DEGENERATE_MASK[b] and ka in bits and \
            (DEGENERATE_MASK[b] & bits[ka]):
        return 10
    if ka and kb:
        return -8
    return 7


# --- CIGAR-based alignment reconstruction (extractor.rs:56-190) -------------

def recover_aligned_sequences(
        unaligned_read: bytes,
        one_based_start: int,
        cigar: List[Tuple[int, str]],
        reference: bytes,
        soft_clip: str = "Realign",
        realign_scoring: Optional[AffineScoring] = None,
) -> Tuple[bytes, bytes]:
    """Rebuild the full-length (aligned_read, aligned_ref) pair from a BAM
    record's CIGAR. soft_clip in {"Clip", "MatchMismatch", "Realign"};
    Realign re-runs the affine DP on clipped ends with default_dna scoring
    (the collapse path's setting, collapse.rs:615)."""
    scoring = realign_scoring or AffineScoring.default_dna()
    aligned_read = bytearray()
    aligned_ref = bytearray()
    read_pos = 0
    ref_pos = one_based_start - 1

    if ref_pos > 0 and cigar and cigar[0][1] != "S":
        aligned_read += b"-" * ref_pos
        aligned_ref += reference[:ref_pos]

    for idx, (length, op) in enumerate(cigar):
        if op in ("M", "=", "X"):
            aligned_read += unaligned_read[read_pos:read_pos + length]
            aligned_ref += reference[ref_pos:ref_pos + length]
            read_pos += length
            ref_pos += length
        elif op == "I":
            aligned_read += unaligned_read[read_pos:read_pos + length]
            aligned_ref += b"-" * length
            read_pos += length
        elif op in ("D", "N"):
            aligned_read += b"-" * length
            aligned_ref += reference[ref_pos:ref_pos + length]
            ref_pos += length
        elif op == "S":
            if soft_clip == "Clip":
                aligned_ref += b"-" * length
                aligned_read += unaligned_read[read_pos:read_pos + length]
                read_pos += length
            elif soft_clip == "MatchMismatch":
                if idx == 0:
                    if ref_pos >= length:
                        aligned_ref += reference[:ref_pos]
                        aligned_read += b"-" * (ref_pos - length)
                        aligned_read += unaligned_read[:length]
                    else:
                        aligned_ref += b"-" * (length - ref_pos)
                        aligned_ref += reference[:ref_pos]
                        aligned_read += unaligned_read[:length]
                    read_pos += length
                elif ref_pos + length >= len(reference):
                    dashes = ref_pos + length - len(reference)
                    aligned_ref += reference[ref_pos:]
                    aligned_ref += b"-" * dashes
                    aligned_read += unaligned_read[read_pos:read_pos + length]
                    read_pos += length
                    ref_pos = len(reference)
                else:
                    aligned_read += unaligned_read[read_pos:read_pos + length]
                    aligned_ref += reference[ref_pos:ref_pos + length]
                    read_pos += length
                    ref_pos += length
            else:  # Realign (extractor.rs:143-171)
                if idx == 0:
                    clipped_read = unaligned_read[:length]
                    clipped_ref = reference[:ref_pos]
                    res = _realign(clipped_ref, clipped_read, scoring)
                    aligned_ref += res.reference_aligned
                    aligned_read += res.read_aligned
                    read_pos += length
                elif idx == len(cigar) - 1:
                    right = min(read_pos + length, len(unaligned_read))
                    clipped_read = unaligned_read[read_pos:right]
                    clipped_ref = reference[ref_pos:]
                    res = _realign(clipped_ref, clipped_read, scoring)
                    aligned_ref += res.reference_aligned
                    aligned_read += res.read_aligned
                    read_pos += length
                    ref_pos = len(reference)
                # interior soft clips: reference ignores them entirely
        elif op in ("H", "P"):
            pass
        else:
            raise ValueError(f"unsupported CIGAR op {op}")

    if ref_pos < len(reference):
        aligned_ref += reference[ref_pos:]
        aligned_read += b"-" * (len(reference) - ref_pos)

    return bytes(aligned_read), bytes(aligned_ref)
