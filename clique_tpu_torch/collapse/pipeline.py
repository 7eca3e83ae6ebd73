"""The `collapse` verb on PyTorch + CUDA: tagged BAM -> hierarchically
corrected / collapsed consensus BAM.

Counterpart of clique_tpu/collapse/pipeline.py. Ingestion, the
AlignmentCheck filter, consensus, the writers, the spill shards, the
checkpoint files and the metrics JSON are the shared jax-free code, imported
unchanged. The functions that reach tag correction are copied here, because
the shared ones import clique_tpu.collapse.correct (and through it jax)
lazily at run time: sort_level, sort_level_spill, _known_correction,
_apply_correction_one, _apply_correction, run_ref_levels_and_outputs and
collapse/_collapse_impl. Each takes the torch `device` the distance kernels
run on.

Per level (= one UMIConfiguration, in `order`):
- group reads by the already-corrected key tuple;
- within each group, count the next tag (gap-stripped, length-gated to
  length +- max_distance);
- build the correction map by sort_type (KnownTag Hamming or Levenshtein,
  DegenerateTag clustering: collapse/correct.py);
- apply: corrected reads advance with (symbol, original, corrected) pushed
  onto their sorting keys; KnownTag misses are dropped.

The host-parallel worker pool (n_workers > 1, collapse/workers.py) is not
ported and raises.
"""

from __future__ import annotations

import logging
import os
import shutil
import tempfile
import time
from collections import Counter
from typing import Dict, List, Optional, Tuple

from clique_tpu.collapse.pipeline import (
    CollapseStats,
    SortingRead,
    _checkpoint_path,
    _gate_tag,
    _load_checkpoint,
    _RefIngest,
    _save_checkpoint,
    finish_collapse_metrics,
    ingest_bam_single_pass,
    load_known_lists,
    write_outputs,
    write_outputs_spill,
)
from clique_tpu.config.layout import (
    SequenceLayout,
    UMIConfiguration,
    UMISortType,
)
from clique_tpu.io.sam import open_alignment_writer
from clique_tpu.reference.manager import ReferenceManager
from clique_tpu_torch.collapse import distance
from clique_tpu_torch.collapse.correct import (
    correct_degenerate_groups,
    correct_known_hamming,
    correct_known_levenshtein,
    normalize_tag,
)

log = logging.getLogger(__name__)


def sort_level(reads: List[SortingRead], tag: UMIConfiguration,
               known_lists: Dict[str, List[bytes]],
               device="cuda") -> List[SortingRead]:
    """One correction level: group by prior keys, correct the next tag
    within each group, re-emit. Groups key on the integer gid class
    threaded by the previous level (== grouping by (reference,
    key_tuple())), in first-seen order. Mirrors
    clique_tpu/collapse/pipeline.py:500-563."""
    grouped: Dict[int, List[SortingRead]] = {}
    for r in reads:
        grouped.setdefault(r.gid, []).append(r)
    groups: List[List[SortingRead]] = list(grouped.values())

    # phase 1: per-group counts (push() length gating)
    group_counts: List[Counter] = []
    group_kept: List[List[SortingRead]] = []
    for group in groups:
        counts: Counter = Counter()
        kept: List[SortingRead] = []
        for read in group:
            gapless = _gate_tag(read, tag)
            if gapless is not None:
                counts[gapless] += 1
                kept.append(read)
        group_counts.append(counts)
        group_kept.append(kept)

    # phase 2: corrections; degenerate levels batch every group's pair
    # distances into one distance call
    if tag.sort_type == UMISortType.DEGENERATE_TAG:
        corrections = correct_degenerate_groups(
            group_counts, tag.max_distance, tag.length,
            tag.minimum_collapsing_difference or 5.0, device=device)
    else:
        corrections = [
            _known_correction(counts, tag, known_lists, device=device)
            for counts in group_counts]

    # phase 3: apply; child gids assigned per (bin, corrected value)
    out: List[SortingRead] = []
    next_gid = 0
    for kept, correction in zip(group_kept, corrections):
        applied = _apply_correction(kept, tag, correction)
        local: Dict[bytes, int] = {}
        for read in applied:
            corrected = read.sorting_keys[-1][2]
            g = local.get(corrected)
            if g is None:
                g = next_gid
                next_gid += 1
                local[corrected] = g
            read.gid = g
        out.extend(applied)
    log.info("level %s (%s): %d groups, %d reads in, %d passed",
             tag.symbol, tag.sort_type.value, len(groups), len(reads),
             len(out))
    return out


def sort_level_spill(in_dir, tag: UMIConfiguration,
                     known_lists: Dict[str, List[bytes]], out_dir: str,
                     n_shards: int = 32, device="cuda") -> Tuple[int, int]:
    """Out-of-core sort_level: pass 1 streams the input shards and counts
    one tag Counter per correction bin (= prior corrected-key tuple); pass
    2 streams again, applies the correction maps per read and respills.
    Only tag counters and correction maps stay in RAM. Returns (reads_in,
    reads_out). Mirrors clique_tpu/collapse/pipeline.py:578-627."""
    from clique_tpu.collapse.shards import ShardWriter, iter_items

    counts_by_bin: Dict[Tuple, Counter] = {}
    n_in = 0
    for _key, read in iter_items(in_dir):
        n_in += 1
        gapless = _gate_tag(read, tag)
        if gapless is not None:
            bin_key = (read.reference_name,) + read.key_tuple()
            counts_by_bin.setdefault(bin_key, Counter())[gapless] += 1

    bins = list(counts_by_bin)
    if tag.sort_type == UMISortType.DEGENERATE_TAG:
        corrections = correct_degenerate_groups(
            [counts_by_bin[b] for b in bins], tag.max_distance, tag.length,
            tag.minimum_collapsing_difference or 5.0, device=device)
    else:
        corrections = [_known_correction(counts_by_bin[b], tag, known_lists,
                                         device=device)
                       for b in bins]
    corr_by_bin = dict(zip(bins, corrections))

    n_out = 0
    with ShardWriter(out_dir, n_shards=n_shards) as out_writer:
        for _key, read in iter_items(in_dir):
            if _gate_tag(read, tag) is None:
                continue
            bin_key = (read.reference_name,) + read.key_tuple()
            out = _apply_correction_one(read, tag, corr_by_bin[bin_key])
            if out is not None:
                out_writer.push(out.spill_key(), out)
                n_out += 1
    log.info("level %s (%s, out-of-core): %d bins, %d reads in, %d passed",
             tag.symbol, tag.sort_type.value, len(bins), n_in, n_out)
    return n_in, n_out


def _known_correction(counts: Counter, tag: UMIConfiguration,
                      known_lists: Dict[str, List[bytes]], device="cuda"):
    """KnownTag correction dispatch: levenshtein_distance None or true goes
    to the Levenshtein correction, false to Hamming (the JAX package's
    deliberate routing of None, see its docstring). Mirrors
    clique_tpu/collapse/pipeline.py:667-699."""
    allow = known_lists.get(tag.file or "", [])
    if not allow:
        # KnownTag without an allowlist file: tags pass through uncorrected
        log.warning(
            "KnownTag level %s has no allowlist file; passing tags "
            "through uncorrected", tag.symbol)
        return {normalize_tag(t, tag.length): normalize_tag(t, tag.length)
                for t in counts}
    if tag.levenshtein_distance is None or tag.levenshtein_distance:
        return correct_known_levenshtein(
            counts, allow, tag.max_distance, tag.length, device=device)
    return correct_known_hamming(
        counts, allow, tag.max_distance, tag.length, device=device)


def _apply_correction_one(read: SortingRead, tag: UMIConfiguration,
                          correction) -> Optional[SortingRead]:
    """Apply one bin's correction map to a single read. Returns None for
    dropped KnownTag misses. Mirrors
    clique_tpu/collapse/pipeline.py:702-724."""
    sym, raw = read.unsorted_keys.popleft()
    key_norm = normalize_tag(raw, tag.length)
    corrected = correction.get(key_norm)
    if corrected is None and tag.sort_type == UMISortType.KNOWN_TAG and \
            not (tag.levenshtein_distance is None or
                 tag.levenshtein_distance):
        # hamming path keys its map on the raw gapless tag
        gapless = raw.replace(b"-", b"")
        corrected = correction.get(gapless)
    if corrected is None:
        if tag.sort_type == UMISortType.DEGENERATE_TAG:
            raise RuntimeError(
                f"Unable to find match for key {key_norm!r} in corrected "
                f"values")
        return None  # KnownTag miss: dropped
    read.sorting_keys.append((tag.symbol, key_norm, corrected))
    return read


def _apply_correction(kept: List[SortingRead], tag: UMIConfiguration,
                      correction) -> List[SortingRead]:
    """Mirrors clique_tpu/collapse/pipeline.py:727-734."""
    out: List[SortingRead] = []
    for read in kept:
        applied = _apply_correction_one(read, tag, correction)
        if applied is not None:
            out.append(applied)
    return out


def collapse(*args, **kwargs) -> CollapseStats:
    """GC-controlled wrapper (see _collapse_impl for the pipeline and the
    full signature): ingest and levels hold millions of acyclic objects
    (utils/gcctl.py). Mirrors clique_tpu/collapse/pipeline.py:1051-1058."""
    from clique_tpu.utils.gcctl import hot_section

    with hot_section():
        return _collapse_impl(*args, **kwargs)


def _collapse_impl(output_path: str, layout: SequenceLayout, input_bam: str,
                   temp_dir: Optional[str] = None, correct_only: bool = False,
                   downsample_cap: int = 40,
                   metrics_path: Optional[str] = None,
                   checkpoint: bool = False,
                   out_of_core: bool = False,
                   n_workers: int = 1,
                   min_aligned_bases: int = 45,
                   min_identical: float = 0.8,
                   gap_call_threshold: float = 0.75,
                   shards: Optional[int] = None,
                   device="cuda") -> CollapseStats:
    """The `clique collapse` equivalent. Mirrors
    clique_tpu/collapse/pipeline.py:1061-1268 for one process: the in-RAM
    path, the out-of-core path (`out_of_core`, or switched on for inputs
    over 4 GB and for layouts whose maximum_subsequences cap can bind) and
    checkpoint/resume (`checkpoint`, under `temp_dir`). Out-of-core output
    groups equal the in-RAM path's, ordered by shard rather than by a
    global key sort.

    device: where the distance kernels run ("cuda", "cuda:N" or "cpu"); a
    CUDA device without a GPU raises before any work. n_workers > 1 (the
    JAX package's host-parallel pool) is not ported and raises.

    The metrics JSON (collapse_metrics.json) carries the shared fields plus
    `device` and the kernel launches of this run."""
    if n_workers and n_workers > 1:
        from clique_tpu_torch.align.pipeline import unported_message

        raise NotImplementedError(unported_message(
            "n_workers > 1 (collapse --threads > 1)", "collapse_workers"))
    dev = distance.resolve_device(device)
    launches0 = (distance.match_count_launches,
                 distance.edit_distance_launches)

    rm = ReferenceManager.from_layout(layout)
    known_lists = load_known_lists(layout)
    references = [(r.name, len(r.sequence)) for r in rm.references.values()]
    writer = open_alignment_writer(output_path, references)
    stats = CollapseStats()
    metrics = {"input_bam": input_bam, "references": {},
               "started": time.time()}

    try:
        bam_bytes = os.path.getsize(input_bam)
    except OSError:
        bam_bytes = 0
    if not out_of_core:
        if bam_bytes > 4 << 30:
            # BGZF ~3-4x expands in RAM as SortingReads; beyond a few GB
            # the spill path is the safe default
            log.info("input BAM is %.1f GB; enabling out-of-core collapse",
                     bam_bytes / 2**30)
            out_of_core = True
        elif any(cfg.maximum_subsequences is not None
                 for ref in layout.references.values()
                 for cfg in ref.umi_configurations.values()):
            # maximum_subsequences caps per-bin RESIDENT reads; the in-RAM
            # path keeps everything resident, so honoring the cap means
            # the streaming path, whose per-bin residency is O(1) - unless
            # the BAM's chunk index proves the whole file holds no more
            # records than the smallest cap
            from clique_tpu.io.sam import read_cqi

            min_cap = min(cfg.maximum_subsequences
                          for ref in layout.references.values()
                          for cfg in ref.umi_configurations.values()
                          if cfg.maximum_subsequences is not None)
            cqi = read_cqi(input_bam)
            total = cqi[-1][1] if cqi else None
            if total is not None and total <= min_cap:
                log.info("maximum_subsequences set but the BAM holds %d "
                         "records <= the smallest cap %d; the cap cannot "
                         "bind - staying in RAM", total, min_cap)
            else:
                log.info("maximum_subsequences set; enabling out-of-core "
                         "collapse to honor the per-bin resident cap")
                out_of_core = True

    spill_root = None
    n_shards = shards or 32
    if out_of_core:
        spill_root = tempfile.mkdtemp(prefix="clique_spill.", dir=temp_dir)
        # final consensus grouping materializes one shard at a time; size
        # shards so ~4x-expanded records stay around <=256MB per shard
        if shards is None:
            n_shards = max(32, int(4 * bam_bytes / (256 << 20)) + 1)

    from clique_tpu.collapse.shards import ShardWriter

    ingests: Dict[str, _RefIngest] = {}
    spill_dirs: Dict[str, str] = {}
    spill_writers: List[ShardWriter] = []
    for ref in rm.references.values():
        sw = None
        if out_of_core:
            safe = "".join(c if c.isalnum() else "_" for c in ref.name)
            level_dir = os.path.join(spill_root, f"{safe}.l0")
            sw = ShardWriter(level_dir, n_shards=n_shards)
            spill_dirs[ref.name] = level_dir
            spill_writers.append(sw)
        ingests[ref.name] = _RefIngest(
            ref.name, rm, layout, spill=sw,
            min_aligned_bases=min_aligned_bases,
            min_identical=min_identical)
    log.info("processing reads from input BAM file: %s "
             "(%d references, single pass)", input_bam, len(ingests))
    t_ingest = time.time()
    reads_by_ref = ingest_bam_single_pass(input_bam, ingests, stats)
    for sw in spill_writers:
        sw.close()
    metrics["ingest_s"] = round(time.time() - t_ingest, 3)
    t_levels = time.time()
    outputs_seconds = [0.0]

    for ref in rm.references.values():
        ing = ingests[ref.name]
        if out_of_core:
            safe = "".join(c if c.isalnum() else "_" for c in ref.name)
            level_dir = spill_dirs[ref.name]
            ref_metrics = {"passing_reads": ing.n_passing, "levels": []}
            if ing.n_passing == 0:
                log.warning("No valid reads found for reference %s",
                            ref.name)
                metrics["references"][ref.name] = ref_metrics
                continue
            configs = layout.get_sorted_umi_configurations(ref.name)
            for lvl, tag in enumerate(configs):
                next_dir = os.path.join(spill_root, f"{safe}.l{lvl + 1}")
                n_in, n_out = sort_level_spill(level_dir, tag, known_lists,
                                               next_dir, n_shards=n_shards,
                                               device=dev)
                ref_metrics["levels"].append({
                    "symbol": tag.symbol, "sort_type": tag.sort_type.value,
                    "reads_in": n_in, "reads_out": n_out})
                shutil.rmtree(level_dir)
                level_dir = next_dir
            t_out = time.time()
            written = write_outputs_spill(level_dir, writer, rm,
                                          correct_only, downsample_cap,
                                          gap_call_threshold)
            outputs_seconds[0] += time.time() - t_out
            shutil.rmtree(level_dir)
            ref_metrics["output_records"] = written
            metrics["references"][ref.name] = ref_metrics
            log.info("reference %s: wrote %d records (out-of-core)",
                     ref.name, written)
            continue
        reads = reads_by_ref[ref.name]
        ref_metrics = {"passing_reads": ing.n_passing, "levels": []}
        metrics["references"][ref.name] = ref_metrics
        run_ref_levels_and_outputs(
            reads, ref.name, layout, rm, writer, known_lists, correct_only,
            downsample_cap, gap_call_threshold, ref_metrics,
            outputs_seconds,
            checkpoint_dir=temp_dir if checkpoint else None, device=dev)

    writer.close()
    if spill_root is not None:
        shutil.rmtree(spill_root, ignore_errors=True)
    add_device_metrics(metrics, dev, launches0)
    finish_collapse_metrics(metrics, stats, t_levels, outputs_seconds[0],
                            metrics_path, output_path)
    return stats


def add_device_metrics(metrics: dict, dev, launches0) -> None:
    """The port's fields of the collapse metrics JSON: the device the
    distance kernels ran on and their launches since `launches0` (0 on a
    CPU device, where the plain versions run)."""
    import torch

    metrics["device"] = torch.cuda.get_device_name(dev) \
        if dev.type == "cuda" else "cpu"
    metrics["kernel_launches"] = {
        "match_count": distance.match_count_launches - launches0[0],
        "edit_distance": distance.edit_distance_launches - launches0[1]}


def run_ref_levels_and_outputs(reads: List[SortingRead], ref_name: str,
                               layout: SequenceLayout,
                               rm: ReferenceManager, writer,
                               known_lists, correct_only: bool,
                               downsample_cap: int,
                               gap_call_threshold: float,
                               ref_metrics: dict,
                               outputs_seconds: List[float],
                               checkpoint_dir: Optional[str] = None,
                               record_tap: Optional[list] = None,
                               log_suffix: str = "",
                               device="cuda") -> int:
    """Per-reference in-RAM correction levels + consensus outputs: the one
    implementation behind collapse() and the fused chain's
    collapse_from_reads. Appends per-level rows and output records/phases
    to ref_metrics; adds the outputs wall to outputs_seconds[0]. Mirrors
    clique_tpu/collapse/pipeline.py:1271-1325."""
    if not reads:
        log.warning("No valid reads found for reference %s", ref_name)
        return 0
    configs = layout.get_sorted_umi_configurations(ref_name)
    start_level = 0
    if checkpoint_dir:
        # resume from the deepest completed level
        for lvl in range(len(configs), 0, -1):
            saved = _load_checkpoint(
                _checkpoint_path(checkpoint_dir, ref_name, lvl))
            if saved is not None:
                reads = saved
                start_level = lvl
                log.info("resumed reference %s from level %d "
                         "(%d reads)", ref_name, lvl, len(reads))
                break
    for lvl, tag in enumerate(configs):
        if lvl < start_level:
            continue
        n_in = len(reads)
        reads = sort_level(reads, tag, known_lists, device=device)
        ref_metrics["levels"].append({
            "symbol": tag.symbol, "sort_type": tag.sort_type.value,
            "reads_in": n_in, "reads_out": len(reads)})
        if checkpoint_dir:
            _save_checkpoint(
                _checkpoint_path(checkpoint_dir, ref_name, lvl + 1), reads)
    t_out = time.time()
    out_phases: dict = {}
    written = write_outputs(reads, writer, rm, correct_only,
                            downsample_cap, gap_call_threshold,
                            record_tap=record_tap, phase_out=out_phases)
    outputs_seconds[0] += time.time() - t_out
    ref_metrics["output_records"] = written
    ref_metrics["output_phases"] = out_phases
    log.info("reference %s: wrote %d records%s", ref_name, written,
             log_suffix)
    return written
