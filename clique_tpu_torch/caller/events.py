"""Editing-event caller: tagged BAM -> per-target lineage alleles.

Completes the reference's work-in-progress caller
(the Rust reference, python_package/clique/callers.py - its call_events is a
syntax error and never emits events). The pinned surface (test_callers.py):

- TargetType {CAS9_DSB, CAS12A_DSB, CAS9_ABE, CAS9_CBE, CAS9_PAL_ABE} with
  guide lengths 23/24/26, strand-dependent editing windows, and PAM
  validation (CC.../...GG, TTT.../...AAA);
- the GESTALT-style Event grammar: "10D+44" (deletion), "1I+177+T"
  (insertion with bases), "5S+120+TTTTT" (substitution scar), bare
  NONE/WT/UNKNOWN; compound events joined with '&', per-target strings
  joined with '_';
- overlapping_targets window-overlap test.

The completed call_events walks the gapped (reference, read) pair, merges
adjacent edit columns into Events positioned in ungapped reference
coordinates, and assigns each event to every target whose editing window it
overlaps; windows with no events call NONE, windows the read doesn't cover
call UNKNOWN.
"""

from __future__ import annotations

import enum
import logging
import re
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from clique_tpu_torch.config.layout import SequenceLayout
from clique_tpu_torch.config.layout import TargetType as LayoutTargetType

log = logging.getLogger(__name__)

FASTA_BASES = set("ACGTUIRYKMSWBDHVN-")


class TargetType(enum.Enum):
    """callers.py:9-59."""

    CAS9_DSB = 1
    CAS12A_DSB = 2
    CAS9_ABE = 3
    CAS9_CBE = 4
    CAS9_PAL_ABE = 5

    def length(self) -> int:
        if self in (TargetType.CAS9_DSB, TargetType.CAS9_ABE,
                    TargetType.CAS9_CBE):
            return 23
        if self is TargetType.CAS12A_DSB:
            return 24
        if self is TargetType.CAS9_PAL_ABE:
            return 26
        raise NameError(f"Unknown type {self.name}")

    def editing_window(self, is_forward: bool) -> Tuple[int, int]:
        if self is TargetType.CAS9_DSB:
            return (14, 19) if is_forward else (3, 9)
        if self is TargetType.CAS9_PAL_ABE:
            return (2, 19)
        if self in (TargetType.CAS9_ABE, TargetType.CAS9_CBE):
            return (2, 19) if is_forward else (3, 21)
        if self is TargetType.CAS12A_DSB:
            return (14, 23) if is_forward else (1, 10)
        raise NameError(f"Unknown type {self.name}")

    def validate_sequence(self, sequence: str) -> bool:
        if self.length() != len(sequence):
            raise NameError(f"Invalid length for {self.name}")
        s = sequence.upper()
        if self in (TargetType.CAS9_DSB, TargetType.CAS9_ABE,
                    TargetType.CAS9_CBE):
            return s[:2] == "CC" or s[-2:] == "GG"
        if self is TargetType.CAS9_PAL_ABE:
            return s[:2] == "CC" and s[-2:] == "GG"
        if self is TargetType.CAS12A_DSB:
            return s[:3] == "TTT" or s[-3:] == "AAA"
        raise NameError(f"Unknown type {self.name}")

    @staticmethod
    def from_layout(t: LayoutTargetType) -> "TargetType":
        """Map the layout schema's 11 target types onto caller semantics."""
        mapping = {
            LayoutTargetType.CAS9_WT: TargetType.CAS9_DSB,
            LayoutTargetType.CAS12A_WT: TargetType.CAS12A_DSB,
            LayoutTargetType.CAS9_ABE: TargetType.CAS9_ABE,
            LayoutTargetType.CAS9_CBE: TargetType.CAS9_CBE,
            LayoutTargetType.CAS9_ABE_CBE: TargetType.CAS9_ABE,
            LayoutTargetType.CAS12_ABE: TargetType.CAS12A_DSB,
            LayoutTargetType.CAS12_CBE: TargetType.CAS12A_DSB,
            LayoutTargetType.CAS12_ABE_CBE: TargetType.CAS12A_DSB,
            LayoutTargetType.CAS9_HOMING: TargetType.CAS9_DSB,
            LayoutTargetType.CAS9_ABE_PALINDROME: TargetType.CAS9_PAL_ABE,
            LayoutTargetType.STATIC: TargetType.CAS9_DSB,
        }
        return mapping[t]


@dataclass(frozen=True)
class Target:
    """callers.py:61-70 (validation optional for layout-driven targets of
    nonstandard length)."""

    target: str
    crispr_type: TargetType
    rc_valid: bool = True
    validate: bool = True

    def __post_init__(self):
        if self.validate and not self.crispr_type.validate_sequence(self.target):
            raise TypeError(
                f"Invalid sequence {self.target} for type {self.crispr_type}")


@dataclass(frozen=True)
class TargetPosition:
    target: Target
    position: int
    forward_orientation: bool


class EventCigar(enum.Enum):
    D = 0
    I = 1
    S = 2
    NONE = 3
    WT = 4
    UNKNOWN = 5

    def __str__(self) -> str:
        return self.name

    @staticmethod
    def from_str(label: str) -> "EventCigar":
        up = label.upper()
        if up in ("I", "D", "S", "NONE", "WT", "UNKNOWN"):
            return EventCigar[up]
        raise TypeError(f"Unable to parse EventCigar symbol: {label}")


@dataclass(frozen=True)
class Event:
    """One editing event (callers.py:136-215). String forms:
    "<len>D+<pos>", "<len>I+<pos>+<bases>", "<len>S+<pos>+<bases>", or bare
    NONE/WT/UNKNOWN."""

    event_cigar: EventCigar
    event_length: Optional[int]
    position: Optional[int]
    bases: Optional[str] = None

    def __post_init__(self):
        bare = self.event_cigar in (EventCigar.UNKNOWN, EventCigar.WT,
                                    EventCigar.NONE)
        if self.event_length is None and not bare:
            raise TypeError(
                f"Event length must be >= 1 for type {self.event_cigar}")
        if self.event_length is not None and self.event_length < 1:
            raise TypeError(
                f"Event length must be >= 1 for type {self.event_cigar}")
        if (self.position is None or (self.position < 0 and not bare)) \
                and not bare:
            raise TypeError("Position must be >= 0")
        if self.bases is not None:
            if self.bases == "":
                raise TypeError("Event bases cannot be empty")
            for x in self.bases:
                if x.upper() not in FASTA_BASES:
                    raise TypeError(f"Invalid base: {x}")
            if len(self.bases) != self.event_length:
                raise TypeError(
                    f"Event length and bases must be equal: "
                    f"{len(self.bases)} and {self.event_length}")

    def __str__(self) -> str:
        if self.event_length is None:
            return self.event_cigar.name
        ret = f"{self.event_length}{self.event_cigar.name}+{self.position}"
        if self.bases is not None:
            ret += f"+{self.bases}"
        return ret

    @staticmethod
    def parse_event_string(event_string: str) -> List["Event"]:
        if "_" in event_string:
            raise TypeError(
                "Individual event strings should not have a separator (_), "
                f"saw one in: {event_string}")
        return [Event.parse_single_event(x) for x in event_string.split("&")]

    @staticmethod
    def parse_single_event(event_string: str) -> "Event":
        tokens = event_string.split("+")
        # order matters for exception parity with the reference
        # (callers.py:188-215): the length int() parse precedes from_str, so
        # "WT+5" raises ValueError, not TypeError
        if len(tokens) == 3:
            length = int(tokens[0][:-1])
            cigar = EventCigar.from_str(tokens[0][-1])
            if cigar in (EventCigar.I, EventCigar.S):
                return Event(cigar, length, int(tokens[1]), tokens[2])
            raise TypeError(
                f"unable to parse a INS or SCAR from a length 3 event "
                f"string: {event_string}")
        if len(tokens) == 2:
            length = int(tokens[0][:-1])
            cigar = EventCigar.from_str(tokens[0][-1])
            if cigar is EventCigar.D:
                return Event(cigar, length, int(tokens[1]), None)
            raise TypeError(
                f"unable to parse a DEL from a length 2 event string: "
                f"{event_string}")
        if len(tokens) == 1:
            cigar = EventCigar.from_str(tokens[0])
            if cigar in (EventCigar.UNKNOWN, EventCigar.WT, EventCigar.NONE):
                return Event(cigar, None, -1, None)
            raise TypeError(
                f"unable to parse a event from a length 1 event string: "
                f"{event_string}")
        raise TypeError(f"unable to parse event string: {event_string}")


def reverse_comp(string: str) -> str:
    """callers.py:81-105 including its non-base handling (lowercase
    unknowns -> 'n', uppercase -> 'N')."""
    comp = {"A": "T", "a": "t", "C": "G", "c": "g",
            "G": "C", "g": "c", "T": "A", "t": "a"}
    out = []
    for c in reversed(string):
        if c in comp:
            out.append(comp[c])
        elif c > "a":
            out.append("n")
        else:
            out.append("N")
    return "".join(out)


class EventCaller:
    """Finds target occurrences and calls per-target editing events from a
    gapped alignment (completing callers.py:217-356)."""

    def __init__(self, reference: str, targets: Sequence[Target]):
        self.reference_original = reference
        self.reference = reference.upper()
        self.targets = list(targets)
        self.validate_and_discover_targets()

    def validate_and_discover_targets(self) -> None:
        """callers.py:264-273: forward matches by substring search; rc_valid
        targets also searched in the reverse complement (positions reported
        in revcomp coordinates, as the reference does)."""
        positions: Dict[Target, List[TargetPosition]] = {}
        for target in self.targets:
            found = [TargetPosition(target, m.start(), True)
                     for m in re.finditer(re.escape(target.target.upper()),
                                          self.reference)]
            if target.rc_valid:
                found += [TargetPosition(target, m.start(), True)
                          for m in re.finditer(
                              re.escape(target.target.upper()),
                              reverse_comp(self.reference))]
            positions[target] = found
        self.target_locations = positions

    def overlapping_targets(self, event_start: int, event_stop: int) -> bool:
        """callers.py:344-356."""
        for target, tpos_list in self.target_locations.items():
            for tp in tpos_list:
                w = target.crispr_type.editing_window(tp.forward_orientation)
                s = tp.position + w[0]
                e = tp.position + w[1]
                if (event_start <= s <= event_stop) or \
                        (s <= event_start <= e) or \
                        (event_start >= s and event_stop <= e) or \
                        (event_start <= s and event_stop >= e):
                    return True
        return False

    # ---- completed calling ------------------------------------------------

    def events_from_alignment(self, aligned_ref: str, aligned_read: str,
                              call_substitutions: bool = False
                              ) -> List[Tuple[int, int, Event]]:
        """Walk a gapped pair; emit (ref_start, ref_stop, Event) with
        positions in ungapped reference coordinates. Runs of gap columns
        merge into one D/I event; with call_substitutions, runs of
        mismatching bases merge into S events (base-editor targets)."""
        assert len(aligned_ref) == len(aligned_read)
        events: List[Tuple[int, int, Event]] = []
        ref_pos = 0
        i = 0
        n = len(aligned_ref)

        # trailing/leading read gaps = uncovered, not deletions
        first_covered = next(
            (k for k in range(n) if aligned_read[k] != "-"), n)
        last_covered = next(
            (n - 1 - k for k in range(n) if aligned_read[n - 1 - k] != "-"),
            -1)

        while i < n:
            r = aligned_ref[i]
            d = aligned_read[i]
            if r != "-" and d == "-" and first_covered <= i <= last_covered:
                start = ref_pos
                j = i
                while j < n and aligned_ref[j] != "-" and \
                        aligned_read[j] == "-" and j <= last_covered:
                    ref_pos += 1
                    j += 1
                length = ref_pos - start
                events.append((start, ref_pos - 1,
                               Event(EventCigar.D, length, start)))
                i = j
            elif r == "-" and d != "-":
                start = ref_pos
                j = i
                bases = []
                while j < n and aligned_ref[j] == "-" and \
                        aligned_read[j] != "-":
                    bases.append(aligned_read[j])
                    j += 1
                events.append((start, start,
                               Event(EventCigar.I, len(bases), start,
                                     "".join(bases))))
                i = j
            elif call_substitutions and r != "-" and d != "-" and \
                    r.upper() != d.upper() and d.upper() != "N" and \
                    r.upper() in "ACGT" and d.upper() in "ACGT":
                start = ref_pos
                j = i
                bases = []
                while j < n and aligned_ref[j] != "-" and \
                        aligned_read[j] != "-" and \
                        aligned_ref[j].upper() != aligned_read[j].upper() and \
                        aligned_read[j].upper() in "ACGT" and \
                        aligned_ref[j].upper() in "ACGT":
                    bases.append(aligned_read[j])
                    ref_pos += 1
                    j += 1
                events.append((start, ref_pos - 1,
                               Event(EventCigar.S, len(bases), start,
                                     "".join(bases))))
                i = j
            else:
                if r != "-":
                    ref_pos += 1
                i += 1
        return events

    def _flat_positions(self) -> List[TargetPosition]:
        """Target positions in target order, with per-position windows and
        the substitution-calling flag cached (constant per caller)."""
        cached = getattr(self, "_flat_cache", None)
        if cached is not None:
            return cached
        flat: List[TargetPosition] = []
        for target in self.targets:
            for tp in self.target_locations.get(target, []):
                flat.append(tp)
        sub_types = (TargetType.CAS9_ABE, TargetType.CAS9_CBE,
                     TargetType.CAS9_PAL_ABE)
        self._flat_windows = []
        for tp in flat:
            w = tp.target.crispr_type.editing_window(tp.forward_orientation)
            self._flat_windows.append((tp.position + w[0],
                                       tp.position + w[1],
                                       tp.target.crispr_type in sub_types))
        self._any_subs = any(is_sub for _s, _e, is_sub in self._flat_windows)
        self._flat_cache = flat
        return flat

    def call_events_fast(self, aligned_ref: bytes,
                         aligned_read: bytes) -> str:
        """Vectorized call_events over the byte pair: identical event
        strings (property-tested in tests/test_caller_fast.py), with the
        per-column Python walk replaced by numpy run detection — the walk
        was the `call` stage's hottest loop at bench scale."""
        import numpy as np

        flat_positions = self._flat_positions()
        if not flat_positions:
            return ""
        r = np.frombuffer(aligned_ref, dtype=np.uint8)
        d = np.frombuffer(aligned_read, dtype=np.uint8)
        n = len(r)
        gap = 0x2D  # '-'
        read_ng = d != gap
        ref_ng = r != gap
        nz = np.flatnonzero(read_ng)
        if len(nz):
            first_covered, last_covered = int(nz[0]), int(nz[-1])
        else:
            first_covered, last_covered = n, -1
        # ungapped reference coordinate of each column
        ref_coord = np.cumsum(ref_ng) - ref_ng
        rp_total = int(ref_ng.sum())
        cov_start = int(ref_coord[first_covered]) if first_covered < n \
            else rp_total
        cov_stop = int(ref_coord[last_covered]) if last_covered >= 0 else -1

        def runs(mask):
            edges = np.flatnonzero(np.diff(
                np.concatenate(([0], mask.view(np.int8), [0]))))
            return zip(edges[0::2].tolist(), edges[1::2].tolist())

        events: List[Tuple[int, int, int, Event]] = []  # (col, start, stop)
        dmask = ref_ng & ~read_ng
        if last_covered >= 0:
            dmask[:first_covered] = False
            dmask[last_covered + 1:] = False
        else:
            dmask[:] = False
        for s_i, e_i in runs(dmask):
            start = int(ref_coord[s_i])
            length = e_i - s_i
            events.append((s_i, start, start + length - 1,
                           Event(EventCigar.D, length, start)))
        imask = ~ref_ng & read_ng
        for s_i, e_i in runs(imask):
            start = int(ref_coord[s_i])
            bases = aligned_read[s_i:e_i].decode()
            events.append((s_i, start, start,
                           Event(EventCigar.I, e_i - s_i, start, bases)))
        if self._any_subs:
            up_r = np.where((r >= 97) & (r <= 122), r - 32, r)
            up_d = np.where((d >= 97) & (d <= 122), d - 32, d)
            acgt = np.zeros(256, dtype=bool)
            for b in b"ACGT":
                acgt[b] = True
            smask = acgt[up_r] & acgt[up_d] & (up_r != up_d)
            for s_i, e_i in runs(smask):
                start = int(ref_coord[s_i])
                bases = aligned_read[s_i:e_i].decode()
                events.append((s_i, start, start + (e_i - s_i) - 1,
                               Event(EventCigar.S, e_i - s_i, start, bases)))
        events.sort(key=lambda t: t[0])  # column order = the walk's order

        out_strings: List[str] = []
        for win_s, win_e, is_sub in self._flat_windows:
            if win_s > cov_stop or win_e < cov_start:
                out_strings.append(str(Event(EventCigar.UNKNOWN, None, -1)))
                continue
            hits = []
            for _c, es, ee, ev in events:
                if ev.event_cigar is EventCigar.S and not is_sub:
                    continue
                if es <= win_e and ee >= win_s:
                    hits.append(ev)
            if hits:
                out_strings.append("&".join(str(h) for h in hits))
            else:
                out_strings.append(str(Event(EventCigar.NONE, None, -1)))
        return "_".join(out_strings)

    def call_events(self, aligned_ref: str, aligned_read: str) -> str:
        """Per-target event strings joined with '_' (the lineage-allele
        encoding, e.g. "10D+44_NONE_1I+177+T&3D+179")."""
        per_target: List[List[Event]] = []
        window_spans: List[Tuple[int, int]] = []
        flat_positions: List[TargetPosition] = []
        for target in self.targets:
            for tp in self.target_locations.get(target, []):
                flat_positions.append(tp)

        # coverage in ungapped reference coords
        n = len(aligned_ref)
        first_covered = next(
            (k for k in range(n) if aligned_read[k] != "-"), n)
        last_covered = next(
            (n - 1 - k for k in range(n) if aligned_read[n - 1 - k] != "-"),
            -1)
        ref_coord = []
        rp = 0
        for k in range(n):
            ref_coord.append(rp)
            if aligned_ref[k] != "-":
                rp += 1
        cov_start = ref_coord[first_covered] if first_covered < n else rp
        cov_stop = ref_coord[last_covered] if last_covered >= 0 else -1

        sub_types = (TargetType.CAS9_ABE, TargetType.CAS9_CBE,
                     TargetType.CAS9_PAL_ABE)
        any_subs = any(tp.target.crispr_type in sub_types
                       for tp in flat_positions)
        events = self.events_from_alignment(
            aligned_ref, aligned_read, call_substitutions=any_subs)

        out_strings: List[str] = []
        for tp in flat_positions:
            w = tp.target.crispr_type.editing_window(tp.forward_orientation)
            win_s = tp.position + w[0]
            win_e = tp.position + w[1]
            if win_s > cov_stop or win_e < cov_start:
                out_strings.append(str(Event(EventCigar.UNKNOWN, None, -1)))
                continue
            hits = []
            for es, ee, ev in events:
                if ev.event_cigar is EventCigar.S and \
                        tp.target.crispr_type not in sub_types:
                    continue
                if es <= win_e and ee >= win_s:
                    hits.append(ev)
            if hits:
                out_strings.append("&".join(str(h) for h in hits))
            else:
                out_strings.append(str(Event(EventCigar.NONE, None, -1)))
        return "_".join(out_strings)


def _build_callers(layout: SequenceLayout) -> Dict[str, "EventCaller"]:
    callers: Dict[str, EventCaller] = {}
    for name, rec in layout.references.items():
        targets = []
        for t, tt in zip(rec.targets, rec.target_types):
            targets.append(Target(t, TargetType.from_layout(tt),
                                  validate=False))
        callers[name] = EventCaller(rec.sequence, targets)
    return callers


def call_events_from_records(layout: SequenceLayout, records,
                             output_path: str,
                             min_alignment_rate: float = 0.9,
                             min_read_count: int = 1) -> int:
    """Call events over in-memory SamRecords (the fused chain's tap on
    collapse's writer: identical rows to re-reading the BAM, minus the
    BGZF round trip — parity pinned in tests/test_chain_fused.py)."""
    from clique_tpu_torch.caller.output import write_allele_table, write_vcf
    from clique_tpu_torch.extract.extractor import (
        recover_aligned_sequences,
        recover_aligned_sequences_fast,
    )

    callers = _build_callers(layout)
    ref_seqs = {name: rec.sequence.encode()
                for name, rec in layout.references.items()}
    # Allele memo for non-base-editor panels: without substitution
    # calling, the allele string is a pure function of (pos, CIGAR,
    # inserted bases, read length) — D/I runs and coverage all derive
    # from the CIGAR, and read bases only enter through I insertions.
    # Consensus records cluster into a handful of distinct indel shapes,
    # so the memo collapses the per-record recovery + call.
    memo: Dict[tuple, str] = {}
    rows = []
    for rec in records:
        if rec.reference_name is None or rec.reference_name not in callers:
            continue
        rm = float(rec.tags.get("rm", "nan"))
        rc = int(rec.tags.get("rc", "1"))
        if not (rm >= min_alignment_rate) or rc < min_read_count:
            continue
        name = rec.reference_name
        caller = callers[name]
        caller._flat_positions()
        key = None
        if not caller._any_subs:
            ins: List[bytes] = []
            rp = 0
            for c, op in rec.cigar:
                if op == "I":
                    ins.append(rec.seq[rp:rp + c])
                    rp += c
                elif op in "M=XS":
                    rp += c
            key = (name, rec.pos, len(rec.seq), tuple(rec.cigar),
                   tuple(ins))
            allele = memo.get(key)
            if allele is not None:
                tag_cols = {k: v for k, v in rec.tags.items()
                            if k.startswith("e") or k in ("rc", "rm")}
                rows.append((rec.name, name, allele, tag_cols))
                continue
        ref_seq = ref_seqs[name]
        fast = recover_aligned_sequences_fast(
            rec.seq, rec.pos, rec.cigar, ref_seq)
        if fast is not None:
            aligned_read, aligned_ref = fast
        else:
            aligned_read, aligned_ref = recover_aligned_sequences(
                rec.seq, rec.pos, rec.cigar, ref_seq, soft_clip="Clip")
        allele = caller.call_events_fast(aligned_ref, aligned_read)
        if key is not None:
            memo[key] = allele
        tag_cols = {k: v for k, v in rec.tags.items()
                    if k.startswith("e") or k in ("rc", "rm")}
        rows.append((rec.name, name, allele, tag_cols))

    if str(output_path).endswith(".vcf"):
        write_vcf(rows, layout, output_path)
    else:
        write_allele_table(rows, output_path)
    return len(rows)


def call_events_from_bam(layout: SequenceLayout, input_bam: str,
                         output_path: str, min_alignment_rate: float = 0.9,
                         min_read_count: int = 1) -> int:
    """The `clique-tpu call` command: stream a tagged (collapsed) BAM, call
    per-target events, write an allele table (.tsv) or VCF (.vcf)."""
    from clique_tpu_torch.io.sam import BamReader

    with BamReader(input_bam) as reader:
        return call_events_from_records(
            layout, reader, output_path,
            min_alignment_rate=min_alignment_rate,
            min_read_count=min_read_count)
