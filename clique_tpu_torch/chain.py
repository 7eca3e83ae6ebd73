"""Fused align -> collapse (-> call) chain on PyTorch + CUDA: collapse
ingests align's in-memory results instead of re-parsing the BAM.

Counterpart of clique_tpu/chain.py:336-431 on the port's align and collapse.
The tap itself is the shared CollapseSink (clique_tpu/chain.py), fed by the
port's align_reads in BAM record order; the fused call is the shared
call_events_from_records. The align BAM is still written, and the collapsed
output is byte-identical to running `align` then `collapse`.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

from clique_tpu.chain import CollapseSink
from clique_tpu.collapse.pipeline import (
    CollapseStats,
    SortingRead,
    finish_collapse_metrics,
    load_known_lists,
)
from clique_tpu.config.layout import SequenceLayout
from clique_tpu.reference.manager import ReferenceManager
from clique_tpu_torch.collapse import distance
from clique_tpu_torch.collapse.pipeline import (add_device_metrics,
                                                run_ref_levels_and_outputs)


def collapse_from_reads(output_path: str, layout: SequenceLayout,
                        rm: ReferenceManager,
                        reads_by_ref: Dict[str, List[SortingRead]],
                        stats: CollapseStats,
                        n_passing: Optional[Dict[str, int]] = None,
                        correct_only: bool = False,
                        downsample_cap: int = 40,
                        metrics_path: Optional[str] = None,
                        gap_call_threshold: float = 0.75,
                        ingest_seconds: float = 0.0,
                        record_tap: Optional[list] = None,
                        device="cuda") -> CollapseStats:
    """Correction levels + consensus outputs over already-ingested reads:
    the in-RAM half of collapse() with ingestion supplied by the caller
    (CollapseSink). Mirrors clique_tpu/chain.py:336-383."""
    from clique_tpu.io.sam import open_alignment_writer
    from clique_tpu.utils.gcctl import hot_section

    dev = distance.resolve_device(device)
    launches0 = (distance.match_count_launches,
                 distance.edit_distance_launches)
    with hot_section():
        known_lists = load_known_lists(layout)
        references = [(r.name, len(r.sequence))
                      for r in rm.references.values()]
        writer = open_alignment_writer(output_path, references)
        metrics = {"references": {}, "started": time.time(),
                   "ingest_s": round(ingest_seconds, 3)}
        t_levels = time.time()
        outputs_seconds = [0.0]

        for ref in rm.references.values():
            reads = reads_by_ref.get(ref.name, [])
            ref_metrics = {"passing_reads": (n_passing or {}).get(
                ref.name, len(reads)), "levels": []}
            metrics["references"][ref.name] = ref_metrics
            run_ref_levels_and_outputs(
                reads, ref.name, layout, rm, writer, known_lists,
                correct_only, downsample_cap, gap_call_threshold,
                ref_metrics, outputs_seconds, record_tap=record_tap,
                log_suffix=" (fused chain)", device=dev)

        writer.close()
        add_device_metrics(metrics, dev, launches0)
        finish_collapse_metrics(metrics, stats, t_levels,
                                outputs_seconds[0], metrics_path,
                                output_path)
        return stats


def run_chain(layout: SequenceLayout, rm: ReferenceManager,
              align_bam: str, collapsed_bam: str,
              read1: str, read2: Optional[str] = None,
              index1: Optional[str] = None, index2: Optional[str] = None,
              correct_only: bool = False, downsample_cap: int = 40,
              min_aligned_bases: int = 45, min_identical: float = 0.8,
              gap_call_threshold: float = 0.75,
              align_metrics_path: Optional[str] = None,
              collapse_metrics_path: Optional[str] = None,
              alleles_path: Optional[str] = None,
              vcf_path: Optional[str] = None,
              min_read_count: int = 1,
              device="cuda",
              **align_kwargs) -> Tuple[object, CollapseStats]:
    """Fused align -> collapse (-> call) in one job on `device`.

    Writes BOTH artifacts (tagged BAM + collapsed BAM) like the two-stage
    CLI, but collapse ingestion happens inline on align's record stream;
    with alleles_path/vcf_path the caller runs on the collapsed records
    in memory. Mirrors clique_tpu/chain.py:386-431."""
    from clique_tpu_torch.align.pipeline import align_reads

    distance.resolve_device(device)
    sink = CollapseSink(layout, rm, min_aligned_bases, min_identical)
    align_stats = align_reads(layout, rm, align_bam, read1=read1,
                              read2=read2, index1=index1, index2=index2,
                              metrics_path=align_metrics_path,
                              sink=sink, device=device, **align_kwargs)
    reads_by_ref = sink.finish()
    tap: Optional[list] = [] if (alleles_path or vcf_path) else None
    collapse_stats = collapse_from_reads(
        collapsed_bam, layout, rm, reads_by_ref, sink.stats,
        n_passing=sink.n_passing, correct_only=correct_only,
        downsample_cap=downsample_cap,
        metrics_path=collapse_metrics_path,
        gap_call_threshold=gap_call_threshold,
        ingest_seconds=sink.seconds, record_tap=tap, device=device)
    if tap is not None:
        # fused call: the collapsed records are already in memory, no BGZF
        # round trip (rows identical to call_events_from_bam)
        from clique_tpu.caller.events import call_events_from_records

        for out in (alleles_path, vcf_path):
            if out:
                call_events_from_records(layout, tap, out,
                                         min_read_count=min_read_count)
    return align_stats, collapse_stats
