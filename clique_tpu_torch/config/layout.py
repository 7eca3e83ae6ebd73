"""Sequence-layout YAML schema.

Parses the amplicon layout format of the reference engine
(the Rust reference, rust_cmd/src/read_strategies/sequence_layout.rs and the
schema documented in rust_cmd/readme.md:16-140): merge strategy, read
positions (with !Read1-style YAML tags), per-reference UMI configurations,
and CRISPR target descriptions. Validation rules match the reference:
sequential UMI orders from 0, targets/target_types same length, target
positions auto-filled by exact substring search (panic if absent), and every
UMI symbol must appear in the reference sequence.
"""

from __future__ import annotations

import enum
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import yaml


class UMISortType(enum.Enum):
    KNOWN_TAG = "KnownTag"
    DEGENERATE_TAG = "DegenerateTag"


class MergeStrategy(enum.Enum):
    ALIGN = "Align"
    CONCATENATE = "Concatenate"
    CONCATENATE_BOTH_FORWARD = "ConcatenateBothForward"


class AlignedReadOrientation(enum.Enum):
    FORWARD = "Forward"
    REVERSE = "Reverse"
    REVERSE_COMPLEMENT = "ReverseComplement"
    UNKNOWN = "Unknown"


class UMIPadding(enum.Enum):
    LEFT = "Left"
    RIGHT = "Right"


class TargetType(enum.Enum):
    STATIC = "Static"
    CAS9_WT = "Cas9WT"
    CAS12A_WT = "Cas12AWT"
    CAS9_ABE = "Cas9ABE"
    CAS9_CBE = "Cas9CBE"
    CAS9_ABE_CBE = "Cas9ABECBE"
    CAS12_ABE = "Cas12ABE"
    CAS12_CBE = "Cas12CBE"
    CAS12_ABE_CBE = "Cas12ABECBE"
    CAS9_HOMING = "Cas9Homing"
    CAS9_ABE_PALINDROME = "Cas9ABEPalindrome"


@dataclass(frozen=True)
class ReadPosition:
    """One entry of the `reads:` list: Read1/Read2/Index1/Index2 with an
    orientation, or a literal Spacer sequence."""

    kind: str  # Read1 | Read2 | Index1 | Index2 | Spacer
    orientation: AlignedReadOrientation = AlignedReadOrientation.FORWARD
    spacer_sequence: Optional[str] = None


@dataclass
class UMIConfiguration:
    """One UMI/barcode capture group (sequence_layout.rs:121-135)."""

    symbol: str
    sort_type: UMISortType
    length: int
    order: int
    max_distance: int
    file: Optional[str] = None
    reverse_complement_sequences: Optional[bool] = None
    pad: Optional[UMIPadding] = None
    maximum_subsequences: Optional[int] = None
    max_gaps: Optional[int] = None
    minimum_collapsing_difference: Optional[float] = None
    levenshtein_distance: Optional[bool] = None


@dataclass
class ReferenceRecord:
    """One amplicon reference (sequence_layout.rs:153-175)."""

    sequence: str
    umi_configurations: Dict[str, UMIConfiguration] = field(default_factory=dict)
    targets: List[str] = field(default_factory=list)
    target_types: List[TargetType] = field(default_factory=list)
    target_locations: Optional[List[int]] = None

    def fill_and_validate_target_positions(self) -> None:
        assert self.target_locations is None
        positions = []
        for target in self.targets:
            pos = self.sequence.find(target)
            if pos < 0:
                raise ValueError(
                    f"Unable to find target {target} in reference "
                    f"{self.sequence}, please check your target sequences")
            positions.append(pos)
        self.target_locations = positions


@dataclass
class SequenceLayout:
    """Top-level layout document (sequence_layout.rs:178-185)."""

    known_strand: bool
    reads: List[ReadPosition]
    references: Dict[str, ReferenceRecord]
    merge: Optional[MergeStrategy] = None
    aligner: Optional[str] = None

    # ---- parsing ----------------------------------------------------------

    @staticmethod
    def from_yaml(path: str) -> "SequenceLayout":
        with open(path) as fh:
            return SequenceLayout.from_yaml_string(fh.read())

    @staticmethod
    def from_yaml_string(text: str) -> "SequenceLayout":
        # serde_yaml encodes enum variants as local tags (`- !Read1 {...}`);
        # pyyaml needs them registered. We fold the tag into a dict key.
        loader = yaml.SafeLoader
        doc = yaml.load(_detag(text), Loader=loader)
        layout = SequenceLayout._from_dict(doc)
        layout.validate()
        return layout

    @staticmethod
    def _from_dict(doc: dict) -> "SequenceLayout":
        reads = []
        for item in doc.get("reads", []):
            if isinstance(item, str):
                # legacy schema: bare READ1 / READ2 entries
                reads.append(ReadPosition(kind=_canon_read_kind(item)))
            elif isinstance(item, dict):
                # after _detag, `- !Read1\n    orientation: X` may parse as
                # either {"Read1": {...}} or {"Read1": None, "orientation": X}
                kinds = [k for k in item if k in _READ_KINDS]
                if len(kinds) != 1:
                    raise ValueError(f"Unparseable read position: {item}")
                kind = kinds[0]
                body = item[kind]
                if body is None:
                    body = {k: v for k, v in item.items() if k != kind}
                if kind == "Spacer":
                    reads.append(ReadPosition(
                        kind="Spacer",
                        spacer_sequence=body.get("spacer_sequence", "")))
                else:
                    reads.append(ReadPosition(
                        kind=kind,
                        orientation=AlignedReadOrientation(
                            body.get("orientation", "Forward"))))
            else:
                raise ValueError(f"Unparseable read position: {item}")

        # legacy schema (mouse_lineage_test/maryam_fwd_both.yaml): top-level
        # `umi_configurations` with no references map; treat as a single
        # unnamed reference whose sequence is provided separately (a FASTA).
        doc_refs = doc.get("references")
        if doc_refs is None and "umi_configurations" in doc:
            doc_refs = {"default": {
                "sequence": doc.get("sequence", ""),
                "umi_configurations": doc["umi_configurations"],
            }}

        references = {}
        for name, rec in (doc_refs or {}).items():
            umis = {}
            for uname, ucfg in (rec.get("umi_configurations") or {}).items():
                umis[uname] = UMIConfiguration(
                    symbol=str(ucfg["symbol"]),
                    sort_type=UMISortType(ucfg["sort_type"]),
                    length=int(ucfg["length"]),
                    order=int(ucfg["order"]),
                    max_distance=int(ucfg["max_distance"]),
                    file=ucfg.get("file"),
                    reverse_complement_sequences=ucfg.get(
                        "reverse_complement_sequences"),
                    pad=UMIPadding(ucfg["pad"]) if ucfg.get("pad") else None,
                    maximum_subsequences=ucfg.get("maximum_subsequences"),
                    max_gaps=ucfg.get("max_gaps"),
                    minimum_collapsing_difference=ucfg.get(
                        "minimum_collapsing_difference"),
                    levenshtein_distance=ucfg.get("levenshtein_distance"),
                )
            references[name] = ReferenceRecord(
                sequence=rec["sequence"],
                umi_configurations=umis,
                targets=list(rec.get("targets") or []),
                target_types=[TargetType(t) for t in (rec.get("target_types") or [])],
            )

        merge = doc.get("merge")
        return SequenceLayout(
            known_strand=bool(doc.get("known_strand",
                                      doc.get("known_orientation", False))),
            reads=reads,
            references=references,
            merge=MergeStrategy(merge) if merge else None,
            aligner=doc.get("aligner"),
        )

    # ---- validation (sequence_layout.rs:47-86) ----------------------------

    def validate(self) -> None:
        for name, ref in self.references.items():
            orders = sorted(u.order for u in ref.umi_configurations.values())
            if orders != list(range(len(orders))):
                raise ValueError(
                    "The UMIConfigurations must have sequential order numbers,"
                    " starting at 0")
            if len(ref.targets) != len(ref.target_types):
                raise ValueError(
                    "Target sequences and target type lists must be the same"
                    " length")
            if ref.target_locations is None:
                ref.fill_and_validate_target_positions()

    @staticmethod
    def validate_reference_sequence(ref_bases: bytes,
                                    configurations) -> bool:
        """True when every UMIConfiguration's capture symbol appears in the
        reference sequence (sequence_layout.rs:79-90). ``configurations``
        is any iterable of UMIConfiguration (or a dict of them)."""
        if hasattr(configurations, "values"):
            configurations = configurations.values()
        text = ref_bases.decode() if isinstance(ref_bases, bytes) else ref_bases
        return all(u.symbol in text for u in configurations)

    def validate_reference_symbols(self) -> None:
        """UMI symbols must appear in their reference sequence. The reference
        engine enforces this at ReferenceManager construction
        (fasta_reference.rs:108-122), not at YAML parse time."""
        for name, ref in self.references.items():
            for umi in ref.umi_configurations.values():
                if umi.symbol not in ref.sequence:
                    raise ValueError(
                        "The reference sequences do not match the capture "
                        f"groups specified in the read structure file: {name} "
                        f"lacks symbol {umi.symbol!r}")

    # ---- helpers ----------------------------------------------------------

    def get_sorted_umi_configurations(self, reference_name: str) -> List[UMIConfiguration]:
        ref = self.references.get(reference_name)
        if ref is None:
            raise KeyError(f"Unable to find reference {reference_name}")
        return sorted(ref.umi_configurations.values(), key=lambda u: u.order)

    def get_sorting_order(self, reference_name: str) -> List[str]:
        return [u.symbol for u in
                self.get_sorted_umi_configurations(reference_name)]


_READ_KINDS = {"Read1", "Read2", "Index1", "Index2", "Spacer"}


def _canon_read_kind(s: str) -> str:
    canon = {"READ1": "Read1", "READ2": "Read2", "INDEX1": "Index1",
             "INDEX2": "Index2"}
    return canon.get(s.strip().upper(), s)


def _detag(text: str) -> str:
    """Convert serde_yaml local tags (`- !Read1\\n  orientation: X`) into
    single-key mappings pyyaml can parse (`- Read1:\\n    orientation: X`)."""

    out_lines = []
    for line in text.splitlines():
        m = re.match(r"^(\s*)-\s*!(\w+)\s*$", line)
        if m:
            out_lines.append(f"{m.group(1)}- {m.group(2)}:")
            continue
        m = re.match(r"^(\s*)-\s*!(\w+)\s+(.*)$", line)
        if m:
            out_lines.append(f"{m.group(1)}- {m.group(2)}: {m.group(3)}")
            continue
        # indent continuation lines under a converted tag one extra level is
        # unnecessary: pyyaml accepts the original indentation because the
        # mapping value starts on the following line at deeper indent already.
        out_lines.append(line)
    return "\n".join(out_lines)
