"""Fused align -> collapse (-> call) chain on PyTorch + CUDA: collapse
ingests align's in-memory results instead of re-parsing the BAM.

Counterpart of clique_tpu/chain.py on the port's align and collapse. The
tap is CollapseSink (a copy of the JAX package's), fed by the port's
align_reads in BAM record order: it builds collapse's SortingReads straight
from the device results, which for the global DP records (pos 1, no soft
clips) equal collapse's CIGAR recovery byte for byte. The fused call is
call_events_from_records. The align BAM is still written, and the collapsed
output is byte-identical to running `align` then `collapse`.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Dict, List, Optional, Tuple

from clique_tpu_torch.collapse import distance
from clique_tpu_torch.collapse.pipeline import (
    CollapseStats,
    SortingRead,
    add_device_metrics,
    alignment_check_batch,
    finish_collapse_metrics,
    load_known_lists,
    run_ref_levels_and_outputs,
)
from clique_tpu_torch.config.layout import SequenceLayout
from clique_tpu_torch.extract.extractor import (
    extract_tag_sequences,
    extract_tagged_sequences,
)
from clique_tpu_torch.reference.manager import ReferenceManager
from clique_tpu_torch.utils import trace
from clique_tpu_torch.utils.seq import FASTA_N

GAP_B = ord("-")


class CollapseSink:
    """Tap on align's writer stream that builds collapse's ingestion state.

    Consumed on ONE align pipeline thread — the port's align_reads feeds
    a dedicated sink thread in BAM record order — so SortingRead
    construction overlaps the next chunk's parse + device dispatch; by
    the time align returns (all pipeline threads joined), collapse
    ingestion is already done (ingest_s ~ 0 in the chain breakdown).
    Sink state is only safe to read after align_reads returns.
    """

    def __init__(self, layout: SequenceLayout, rm: ReferenceManager,
                 min_aligned_bases: int = 45, min_identical: float = 0.8):
        self.layout = layout
        self.rm = rm
        self.stats = CollapseStats()
        self.min_aligned_bases = min_aligned_bases
        self.min_identical = min_identical
        self.by_ref: Dict[str, List[SortingRead]] = {
            r.name: [] for r in rm.references.values()}
        self.n_passing: Dict[str, int] = {}
        self._names = {rid: r.name for rid, r in rm.references.items()}
        self._seqs = {r.name: r.sequence for r in rm.references.values()}
        self._cfgs = {name: layout.references[name]
                      for name in self.by_ref if name in layout.references}
        # per reference: UMI configs in correction order, split digit /
        # extractor-zone (extract_tag_sequences collection semantics)
        self._ordered_umis = {
            name: sorted(cfg.umi_configurations.values(),
                         key=lambda u: u.order)
            for name, cfg in self._cfgs.items()}
        self._all_digit = {
            name: all(u.symbol.isdigit() for u in umis)
            for name, umis in self._ordered_umis.items()}
        self._ordinal = 0
        # ingestion's seconds: align_reads sets it from its align.sink
        # spans once the sink thread has joined
        self.seconds = 0.0

    # -- consumption (align writer thread) --------------------------------

    def consume_flush(self, raws, pend, recs, caps=None,
                      cigars_by_k=None, seq_len_by_k=None) -> None:
        """One fast-path flush: raw device groups + the SamRecords built
        from them — or, on the native-encoder path (recs=None), the
        per-read cigars/sequence lengths directly (the records were
        assembled as raw BAM bytes and never exist as python objects).
        Digit-tag capture and validity gating run vectorized
        over the whole [G, T] matrices (one mask pass per symbol, as
        extract_digit_tags_fast's positional-mask equivalence allows);
        rows are staged per pend index so appends follow BAM write order
        (recs order), not device group order."""
        import numpy as np

        staged: List[Optional[SortingRead]] = [None] * len(pend)
        # failed_filter[k]: row k was tag-valid but failed AlignmentCheck
        # (precomputed below on the [G, T] matrices — same math as
        # alignment_check_batch, which would otherwise re-marshal every
        # row's bytes back into fresh padded arrays; ~0.8s/80k reads of
        # sink-thread time saved). Tag-invalid still takes precedence in
        # the stats, exactly like the staged-None short-circuit did.
        failed_filter = [False] * len(pend)
        for raw_i, raw in enumerate(raws):
            group, a_ref, a_read, valid, _ops, n_ops, _scores = raw
            # AlignmentCheck (collapse.rs:251-279) vectorized on the raw
            # matrices: per row the alignment is cols < n_ops[j], which is
            # exactly the byte range alignment_check_batch would see
            # (read_aligned/reference_aligned are those cols' tobytes()).
            n_col = np.asarray(n_ops, dtype=np.int64).reshape(-1)
            inb = np.arange(a_ref.shape[1], dtype=np.int64)[None, :] < \
                n_col[:, None]
            m = inb & (a_ref > 59) & (a_read > 59) & (a_ref != FASTA_N)
            alignable = m.sum(axis=1)
            matches = ((a_ref == a_read) & m).sum(axis=1)
            keep_rows = (alignable > 0) & \
                (alignable >= self.min_aligned_bases) & \
                (matches / np.maximum(alignable, 1) >= self.min_identical)
            ref_ids = [pend[k].ref_id for k in group]
            names = {rid: self._names[rid] for rid in set(ref_ids)}
            # union of digit symbols across the group's references: a
            # digit byte only occurs in the owning reference's aligned
            # row, so the union mask is exact per row
            union: Dict[str, None] = {}
            all_digit = True
            for name in set(names.values()):
                umis = self._ordered_umis.get(name, [])
                all_digit &= self._all_digit.get(name, True)
                for u in umis:
                    if u.symbol.isdigit():
                        union[u.symbol] = None
            pre = caps[raw_i] if caps is not None and raw_i < len(caps) \
                else {}
            row_caps = {}
            for sym in union:
                if sym in pre:
                    # reuse _fill_records_from_raw's capture arrays; gap
                    # counts come from the flat capture via prefix sums
                    cnt, flat, bounds = pre[sym]
                else:
                    mask = (a_ref == ord(sym)) & valid
                    cnt = mask.sum(axis=1)
                    flat = a_read[mask]
                    bounds = np.concatenate(([0], np.cumsum(cnt)))
                gap_cum = np.concatenate(([0], np.cumsum(flat == GAP_B)))
                gapcnt = gap_cum[bounds[1:]] - gap_cum[bounds[:-1]]
                row_caps[sym] = (cnt.tolist(), flat, bounds.tolist(),
                                 gapcnt.tolist())
            for j, k in enumerate(group):
                name = names[ref_ids[j]]
                umis = self._ordered_umis.get(name)
                if umis is None:
                    staged[k] = None
                    continue
                rec = recs[k] if recs is not None else None
                invalid = False
                # tag-validity must still be evaluated for filtered rows
                # (invalid_tags beats failed_filters in the stats), but
                # their tag bytes / SortingRead never get built
                filtered = not keep_rows[j]
                ordered = []
                fallback = None
                for u in umis:
                    if u.symbol.isdigit():
                        cnt, flat, bounds, gapcnt = row_caps[u.symbol]
                        c = cnt[j]
                        if c == 0:
                            invalid = True  # missing capture: not collected
                            continue
                        if c != u.length:
                            invalid = True
                        if u.max_gaps is not None and gapcnt[j] > u.max_gaps:
                            invalid = True
                        if not (invalid or filtered):
                            ordered.append(
                                (u.symbol,
                                 flat[bounds[j]:bounds[j + 1]].tobytes()))
                    else:
                        # extractor-zone symbol: per-row fallback through
                        # the reference-semantics walk
                        if fallback is None:
                            n = int(n_ops[j])
                            fallback = extract_tagged_sequences(
                                a_read[j, :n].tobytes(),
                                a_ref[j, :n].tobytes())
                        hit = fallback.get(ord(u.symbol))
                        if hit is None:
                            invalid = True
                            continue
                        data = hit.encode()
                        if len(data) != u.length:
                            invalid = True
                        if u.max_gaps is not None and \
                                data.count(GAP_B) > u.max_gaps:
                            invalid = True
                        if not (invalid or filtered):
                            ordered.append((u.symbol, data))
                if invalid:
                    staged[k] = None
                    continue
                if filtered:
                    failed_filter[k] = True
                    continue
                n = int(n_ops[j])
                ra = a_ref[j, :n].tobytes()
                native = self._seqs[name]
                if ra == native:
                    ra = native  # share the one native object
                if rec is not None:
                    rd_name, cig = rec.name, rec.cigar
                    quals = rec.qual if rec.qual != b"*" else None
                    start = rec.pos
                else:
                    # native-encoder path: same values the record would
                    # carry (name from pend, qual 'H' per stripped base,
                    # pos 1 — the fast path's constants)
                    rd_name, cig = pend[k].name, cigars_by_k[k]
                    quals = b"H" * seq_len_by_k[k]
                    start = 1
                staged[k] = SortingRead(
                    read_name=rd_name,
                    reference_name=name,
                    reference_aligned=ra,
                    read_aligned=a_read[j, :n].tobytes(),
                    read_quals=quals,
                    cigar=cig,
                    reference_start=start,
                    score=0.0,
                    unsorted_keys=deque(ordered),
                )
        self._push_filtered(staged, failed_filter)

    def consume_aligned(self, aligned_out, recs) -> None:
        """AlignedRead outputs (WFA / anchored / merge engines): the gapped
        pair is carried on the object already."""
        staged = [self._build(self.rm.name_to_id[alr.reference_name], rec,
                              alr.reference_aligned, alr.read_aligned)
                  for alr, rec in zip(aligned_out, recs)]
        self._push_filtered(staged)

    def _build(self, ref_id: int, rec, reference_aligned: bytes,
               read_aligned: bytes) -> Optional[SortingRead]:
        """SortingRead from align's own outputs; None on invalid tags
        (identical semantics to _RefIngest._ingest_one post-recovery)."""
        name = self._names[ref_id]
        cfg = self._cfgs.get(name)
        if cfg is None:
            return None
        # the record's e<sym> tags ARE the extraction collapse would redo
        # (same positional-mask captures over the same gapped pair)
        tags = {}
        for umi in cfg.umi_configurations.values():
            hit = rec.tags.get(f"e{umi.symbol}")
            if hit is not None:
                tags[ord(umi.symbol)] = hit
        invalid, ordered = extract_tag_sequences(cfg, tags)
        if invalid:
            return None
        native = self._seqs[name]
        if reference_aligned == native:
            reference_aligned = native  # share the one native object
        return SortingRead(
            read_name=rec.name,
            reference_name=name,
            reference_aligned=reference_aligned,
            read_aligned=read_aligned,
            read_quals=rec.qual if rec.qual != b"*" else None,
            cigar=list(rec.cigar),
            reference_start=rec.pos,
            score=0.0,
            unsorted_keys=deque(ordered),
        )

    def _push_filtered(self, staged: List[Optional[SortingRead]],
                       failed_filter: Optional[List[bool]] = None) -> None:
        """Stamp ordinals in BAM order, apply the AlignmentCheck filter
        batch-wise over the flush (collapse.rs:251-279 via
        alignment_check_batch — same keep decisions, same surviving
        order as filtering at the end), and append survivors.

        When `failed_filter` is given (the fast-path flush), the filter
        already ran vectorized on the device matrices: every non-None
        staged read passed, and failed_filter[k] marks tag-valid rows the
        check rejected (their SortingRead was never built)."""
        if failed_filter is None:
            built = [s for s in staged if s is not None]
            keep = iter(alignment_check_batch(
                built, self.min_aligned_bases, self.min_identical))
        for i, s in enumerate(staged):
            self.stats.total_reads += 1
            ordn = self._ordinal
            self._ordinal += 1
            if s is None:
                if failed_filter is not None and failed_filter[i]:
                    self.stats.failed_filters += 1
                else:
                    self.stats.invalid_tags += 1
                continue
            if failed_filter is None and not next(keep):
                self.stats.failed_filters += 1
                continue
            s.ordinal = ordn
            self.stats.passing += 1
            self.n_passing[s.reference_name] = \
                self.n_passing.get(s.reference_name, 0) + 1
            self.by_ref[s.reference_name].append(s)

    # -- finalization (main thread, after the writer joins) ---------------

    def finish(self) -> Dict[str, List[SortingRead]]:
        """Hand back the per-reference passing read sets (filtering
        already happened flush-wise on the writer thread)."""
        for name in self.by_ref:
            self.n_passing.setdefault(name, 0)
        out = self.by_ref
        self.by_ref = {}
        return out




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
    from clique_tpu_torch.io.sam import open_alignment_writer
    from clique_tpu_torch.utils.gcctl import hot_section

    dev = distance.resolve_device(device)
    launches0 = (distance.match_hits_launches,
                 distance.edit_distance_launches,
                 distance.edit_hits_launches)
    with hot_section():
        known_lists = load_known_lists(layout)
        references = [(r.name, len(r.sequence))
                      for r in rm.references.values()]
        writer = open_alignment_writer(output_path, references)
        metrics = {"references": {}, "started": time.time(),
                   "ingest_s": round(ingest_seconds, 3)}

        with trace.recording() as recorder:
            for ref in rm.references.values():
                reads = reads_by_ref.get(ref.name, [])
                ref_metrics = {"passing_reads": (n_passing or {}).get(
                    ref.name, len(reads)), "levels": []}
                metrics["references"][ref.name] = ref_metrics
                run_ref_levels_and_outputs(
                    reads, ref.name, layout, rm, writer, known_lists,
                    correct_only, downsample_cap, gap_call_threshold,
                    ref_metrics, record_tap=record_tap,
                    log_suffix=" (fused chain)", device=dev)

            writer.close()
            add_device_metrics(metrics, dev, launches0)
            finish_collapse_metrics(metrics, stats, recorder, metrics_path,
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
        from clique_tpu_torch.caller.events import call_events_from_records

        for out in (alleles_path, vcf_path):
            if out:
                call_events_from_records(layout, tap, out,
                                         min_read_count=min_read_count)
    return align_stats, collapse_stats
