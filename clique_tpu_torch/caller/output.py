"""Caller output writers: allele table (TSV) and VCF.

The reference's README promises VCF output that was never implemented
(SURVEY 2.10, 5); we define it here: one VCF record per distinct editing
event (D -> symbolic deletion with anchored REF bases, I -> insertion,
S -> substitution block), with per-allele read counts in INFO.
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, List, Tuple

from clique_tpu_torch.caller.events import Event, EventCigar

Row = Tuple[str, str, str, Dict[str, str]]  # (read, reference, allele, tags)


def write_allele_table(rows: List[Row], output_path: str) -> None:
    tag_keys: List[str] = []
    seen = set()
    for _r, _ref, _a, tags in rows:
        for k in tags:
            if k not in seen:
                seen.add(k)
                tag_keys.append(k)
    with open(output_path, "w") as fh:
        fh.write("\t".join(["read", "reference", "allele"] + tag_keys) + "\n")
        for read, ref, allele, tags in rows:
            fh.write("\t".join(
                [read, ref, allele] + [tags.get(k, "") for k in tag_keys])
                + "\n")


def write_vcf(rows: List[Row], layout, output_path: str) -> None:
    """Emit one record per distinct (reference, event); AC = supporting
    reads (weighted by rc when present), AN = total calls on the site's
    reference."""
    event_counts: Counter = Counter()
    ref_totals: Counter = Counter()
    for _read, ref_name, allele, tags in rows:
        weight = int(tags.get("rc", "1"))
        ref_totals[ref_name] += weight
        seen_events = set()
        for target_string in allele.split("_"):
            for ev_str in target_string.split("&"):
                if ev_str in ("NONE", "WT", "UNKNOWN", ""):
                    continue
                seen_events.add(ev_str)
        for ev_str in seen_events:
            event_counts[(ref_name, ev_str)] += weight

    with open(output_path, "w") as fh:
        fh.write("##fileformat=VCFv4.2\n")
        fh.write("##source=clique_tpu\n")
        for name, rec in layout.references.items():
            clean = "".join(c for c in rec.sequence.upper()
                            if c in "ACGTN")
            fh.write(f"##contig=<ID={name},length={len(rec.sequence)}>\n")
        fh.write('##INFO=<ID=AC,Number=1,Type=Integer,'
                 'Description="Supporting read count">\n')
        fh.write('##INFO=<ID=AN,Number=1,Type=Integer,'
                 'Description="Total calls on this reference">\n')
        fh.write('##INFO=<ID=EVENT,Number=1,Type=String,'
                 'Description="Clique event string">\n')
        fh.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n")
        for (ref_name, ev_str), count in sorted(event_counts.items()):
            ev = Event.parse_single_event(ev_str)
            seq = layout.references[ref_name].sequence.upper()
            pos = ev.position or 0
            if ev.event_cigar is EventCigar.D:
                # anchored: REF = base before + deleted bases, ALT = anchor
                anchor = seq[pos - 1] if pos > 0 else "N"
                ref_field = anchor + seq[pos:pos + ev.event_length]
                alt_field = anchor
                vcf_pos = pos  # 1-based anchored position
            elif ev.event_cigar is EventCigar.I:
                anchor = seq[pos - 1] if pos > 0 else "N"
                ref_field = anchor
                alt_field = anchor + (ev.bases or "")
                vcf_pos = pos
            else:  # S
                ref_field = seq[pos:pos + ev.event_length] or "N"
                alt_field = ev.bases or "N"
                vcf_pos = pos + 1
            fh.write("\t".join([
                ref_name, str(max(vcf_pos, 1)), ev_str, ref_field,
                alt_field, ".", "PASS",
                f"AC={count};AN={ref_totals[ref_name]};EVENT={ev_str}",
            ]) + "\n")
