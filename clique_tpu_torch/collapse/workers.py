"""Host-parallel collapse: torch-free worker processes around the one
process that holds the card.

Counterpart of clique_tpu/collapse/workers.py, kept textually close to it.
The reference engine gets its host parallelism from a rayon thread pool
(alignment_functions.rs:90-93, consensus_builders.rs:91-96). Python
threads cannot parallelize the record-building work (GIL), so the pool is
spawned processes; the main process keeps the correction kernels
(match_hits, edit_hits, edit_distance) on its `device`.

Pipeline shape (mirrors the shardio boundary of collapse.rs:468-469):
- ingest: the main process splits the decompressed BAM record stream into
  complete-record chunks (or, with the .cqi chunk index align writes,
  deals BGZF byte ranges); each worker task decodes its chunk, rebuilds
  alignments, extracts + validates tags, filters, and spills passing reads
  into its OWN hash-partitioned ShardWriter directory (same n_shards
  everywhere, so equal keys land in the same shard id across directories)
  or returns light reads whose payloads sit in a blob file;
- levels: the main process runs the corrections on the card (in-RAM), or
  workers count and apply per shard around them (out-of-core);
- outputs: groups or shard ids are dealt to workers; each builds
  consensus records and returns BGZF-compressed BAM blocks (BGZF blocks
  are independent, so the main process just appends bytes).

Ingest results arrive unordered (imap_unordered) and are put back in
input order by read ordinal; outputs arrive in task order (imap), so the
output bytes do not depend on which worker ran what.

Workers are spawned, never forked: the main process holds a CUDA context,
which a forked child cannot use. They never touch the card: the modules
they import (collapse/pipeline.py and the host code under it) load torch
only inside the functions that run corrections, so a worker does not even
import torch; worker_report says what each one has loaded. Spawned
children take the parent's sys.path, so the pool works from a checkout
that is not installed.
"""

from __future__ import annotations

import logging
import os
import pickle
import struct
from typing import Dict, Iterator, List, Optional, Tuple

log = logging.getLogger(__name__)

_CHUNK_READ = 4 << 20

# ~1MB decompressed per ingest task: small enough that a 10-20MB input
# still fans out over every worker (2 chunks of 4MB measured as a 2-way
# bottleneck), large enough that per-task setup (layout unpickle +
# ReferenceManager build, ~10ms) stays <5% of task time
_CHUNK_TARGET = 1 << 20


def iter_record_chunks(input_bam: str, chunk_target: int = _CHUNK_TARGET
                       ) -> Tuple[List[Tuple[str, int]], Iterator[bytes]]:
    """Open a BAM and return (references, iterator of decompressed
    record-stream chunks split at record boundaries)."""
    from clique_tpu_torch.io.sam import BamReader

    reader = BamReader(input_bam, parse_tags=False)

    def chunks() -> Iterator[bytes]:
        buf = b""
        complete = 0          # bytes of buf forming complete records
        while True:
            data = reader._fh.read(_CHUNK_READ)
            if not data and not buf:
                break
            buf += data
            # advance the complete-record watermark
            while complete + 4 <= len(buf):
                (block_size,) = struct.unpack_from("<i", buf, complete)
                if complete + 4 + block_size > len(buf):
                    break
                complete += 4 + block_size
            if complete >= chunk_target or (not data and complete):
                yield buf[:complete]
                buf = buf[complete:]
                complete = 0
            if not data:
                if buf:
                    log.warning("%d trailing bytes after the last complete "
                                "BAM record", len(buf))
                break
        reader.close()

    return reader.references, chunks()


# --- worker tasks (top-level: picklable for the spawn context) ---------------

def _count_chunk_records(chunk: bytes) -> int:
    """Record count of a decompressed BAM record-stream chunk (cheap
    block_size walk — used to keep read ordinals globally monotone
    across chunk tasks)."""
    p, n = 0, 0
    while p + 4 <= len(chunk):
        (sz,) = struct.unpack_from("<i", chunk, p)
        p += 4 + sz
        n += 1
    return n


def ingest_range_task(args) -> Tuple[str, Dict[str, int], Tuple[int, ...]]:
    """ingest_chunk_task over a BGZF byte range (see
    ingest_range_reads_task): the worker inflates its own BAM slice."""
    (bam_path, vbeg, vend, references, layout_blob, spill_dir, n_shards,
     base_ord, min_aligned_bases, min_identical) = args
    from clique_tpu_torch.io.sam import read_voffset_range

    chunk = read_voffset_range(bam_path, vbeg, vend)
    return ingest_chunk_task(
        (chunk, references, layout_blob, spill_dir, n_shards, base_ord,
         min_aligned_bases, min_identical))


def ingest_chunk_task(args) -> Tuple[str, Dict[str, int], Tuple[int, ...]]:
    """Decode + ingest one record chunk into a task-private shard dir.
    Returns (shard_dir, per-ref passing counts, stats tuple)."""
    (chunk, references, layout_blob, spill_dir, n_shards, base_ord,
     min_aligned_bases, min_identical) = args
    from clique_tpu_torch.collapse.pipeline import CollapseStats, _RefIngest
    from clique_tpu_torch.collapse.shards import ShardWriter
    from clique_tpu_torch.io.sam import decode_record_stream
    from clique_tpu_torch.reference.manager import ReferenceManager

    layout = pickle.loads(layout_blob)
    rm = ReferenceManager.from_layout(layout)
    stats = CollapseStats()
    with ShardWriter(spill_dir, n_shards=n_shards) as sw:
        ingests = {name: _RefIngest(name, rm, layout, spill=sw,
                                    min_aligned_bases=min_aligned_bases,
                                    min_identical=min_identical)
                   for name in layout.references}
        for j, rec in enumerate(decode_record_stream(chunk, references,
                                                     parse_tags=False)):
            ing = ingests.get(rec.reference_name or "")
            if ing is None:
                continue
            stats.total_reads += 1
            if rec.flag & 0x100:
                stats.secondary += 1
                continue
            if rec.flag & 0x4:
                stats.unmapped += 1
                continue
            ing._next_ordinal = base_ord + j
            ing.ingest(rec, stats)
        for ing in ingests.values():
            ing.finish(stats)
    per_ref = {name: ing.n_passing for name, ing in ingests.items()}
    return spill_dir, per_ref, (stats.total_reads, stats.unmapped,
                                stats.secondary, stats.failed_filters,
                                stats.invalid_tags, stats.passing)


def ingest_range_reads_task(args) -> Tuple[bytes, Tuple[int, ...]]:
    """ingest_chunk_reads_task over a BGZF byte range: the worker seeks
    and inflates its own slice of the BAM (read_voffset_range via the
    .cqi chunk index align mints), so the main process neither inflates
    the stream nor ships chunk bytes through the task pipe."""
    (bam_path, vbeg, vend, references, layout_blob, blob_path, base_ord,
     min_aligned_bases, min_identical) = args
    from clique_tpu_torch.io.sam import read_voffset_range

    chunk = read_voffset_range(bam_path, vbeg, vend)
    return ingest_chunk_reads_task(
        (chunk, references, layout_blob, blob_path, base_ord,
         min_aligned_bases, min_identical))


def ingest_chunk_reads_task(args) -> Tuple[bytes, Tuple[int, ...]]:
    """Decode + ingest one record chunk for the in-RAM parallel path.

    The heavy per-read payload (aligned strings, quals, cigar — ~1.5KB)
    is appended to a task-private blob file; the returned reads are LIGHT
    (name, tags, blob pointer), so the pipe back to the main process
    carries ~10x less. Correction levels only need the light fields;
    consensus workers rehydrate from the blob files."""
    (chunk, references, layout_blob, blob_path, base_ord,
     min_aligned_bases, min_identical) = args
    from clique_tpu_torch.collapse.pipeline import CollapseStats, _RefIngest
    from clique_tpu_torch.io.sam import decode_record_stream
    from clique_tpu_torch.reference.manager import ReferenceManager

    layout = pickle.loads(layout_blob)
    rm = ReferenceManager.from_layout(layout)
    stats = CollapseStats()
    ingests = {name: _RefIngest(name, rm, layout,
                                min_aligned_bases=min_aligned_bases,
                                min_identical=min_identical)
               for name in layout.references}
    for j, rec in enumerate(decode_record_stream(chunk, references,
                                                 parse_tags=False)):
        ing = ingests.get(rec.reference_name or "")
        if ing is None:
            continue
        stats.total_reads += 1
        if rec.flag & 0x100:
            stats.secondary += 1
            continue
        if rec.flag & 0x4:
            stats.unmapped += 1
            continue
        ing._next_ordinal = base_ord + j
        ing.ingest(rec, stats)
    reads = {name: ing.finish(stats) for name, ing in ingests.items()}
    native_seqs = {name: ing.sequence for name, ing in ingests.items()}
    with open(blob_path, "wb") as fh:
        off = 0
        for name, passing in reads.items():
            native = native_seqs[name]
            for r in passing:
                # the dominant read class (gapless amplicon alignments)
                # has reference_aligned == the native reference; store a
                # None marker instead of duplicating ~L bytes per read
                # in the blob (rehydrate_reads restores from ref_seqs)
                ra = None if r.reference_aligned == native \
                    else r.reference_aligned
                payload = pickle.dumps(
                    (ra, r.read_aligned, r.read_quals, r.cigar),
                    protocol=4)
                fh.write(payload)
                r.blob = (blob_path, off, len(payload))
                off += len(payload)
                r.reference_aligned = b""
                r.read_aligned = b""
                r.read_quals = None
                r.cigar = []
    return (pickle.dumps(reads, protocol=4),
            (stats.total_reads, stats.unmapped, stats.secondary,
             stats.failed_filters, stats.invalid_tags, stats.passing))


def rehydrate_reads(reads, ref_seqs: Optional[Dict[str, bytes]] = None
                    ) -> None:
    """Load heavy payloads back into light SortingReads from their blob
    files (grouped by file, sequential-ish preads). A None
    reference_aligned in the payload means it equals the native
    reference (the gapless hot class) — restored from ref_seqs."""
    by_path: Dict[str, List] = {}
    for r in reads:
        if r.blob is not None:
            by_path.setdefault(r.blob[0], []).append(r)
    for path, rs in by_path.items():
        rs.sort(key=lambda r: r.blob[1])
        with open(path, "rb") as fh:
            for r in rs:
                _p, off, size = r.blob
                fh.seek(off)
                (ra, r.read_aligned, r.read_quals,
                 r.cigar) = pickle.loads(fh.read(size))
                r.reference_aligned = ra if ra is not None \
                    else (ref_seqs or {})[r.reference_name]
                r.blob = None


def consensus_groups_task(args) -> Tuple[int, bytes, int]:
    """Build consensus records for a batch of already-grouped reads and
    return (batch_index, payload, count). Payload is BGZF-compressed BAM
    blocks when want_bgzf and the C codec are available, else pickled
    SamRecords for the main process to encode."""
    (batch_idx, groups_blob, ref_seqs, ref_ids_map, correct_only,
     downsample_cap, gap_call_threshold, want_bgzf) = args
    from clique_tpu_torch.collapse.pipeline import (
        _consensus_record,
        _precompute_group_consensus,
    )
    from clique_tpu_torch.io.sam import encode_records_bytes

    groups = pickle.loads(groups_blob)
    rehydrate_reads([r for g in groups for r in g], ref_seqs)
    pre = _precompute_group_consensus(groups, ref_seqs, gap_call_threshold) \
        if not correct_only else {}
    records = []
    for gi, group in enumerate(groups):
        units = [[r] for r in group] if correct_only else [group]
        for g in units:
            rec = _consensus_record(
                g, ref_seqs, downsample_cap if not correct_only else 0,
                gap_call_threshold, pre.get(gi))
            if rec is not None:
                records.append(rec)
    if want_bgzf:
        encoded = encode_records_bytes(records, ref_ids_map)
        if encoded is not None:
            return batch_idx, _bgzf_compress_bytes(encoded), len(records)
    return batch_idx, pickle.dumps(records, protocol=4), len(records)


def consensus_shard_task(args) -> Tuple[int, bytes, int]:
    """Group one shard id's reads (across directories), build consensus
    records, and return (shard_index, bgzf-compressed BAM blocks, count)."""
    (shard_idx, paths, ref_seqs, ref_ids_map, correct_only,
     downsample_cap, gap_call_threshold) = args
    from clique_tpu_torch.collapse.pipeline import _consensus_record
    from clique_tpu_torch.collapse.shards import _read_shard
    from clique_tpu_torch.io.sam import encode_records_bytes

    items: List = []
    for p in paths:
        items.extend(_read_shard(p))
    # ordinal tiebreak: group members in input-BAM order regardless of
    # which worker/level stream spilled them
    items.sort(key=lambda kv: (kv[0], getattr(kv[1], "ordinal", 0)))

    records = []
    i = 0
    while i < len(items):
        j = i
        key = items[i][0]
        while j < len(items) and items[j][0] == key:
            j += 1
        group = [it for _k, it in items[i:j]]
        i = j
        units = [[r] for r in group] if correct_only else [group]
        for g in units:
            rec = _consensus_record(
                g, ref_seqs, downsample_cap if not correct_only else 0,
                gap_call_threshold)
            if rec is not None:
                records.append(rec)

    encoded = encode_records_bytes(records, ref_ids_map)
    if encoded is None:
        # no C codec (or empty batch): ship the records back for the main
        # process to encode
        return shard_idx, pickle.dumps(records, protocol=4), len(records)
    return shard_idx, _bgzf_compress_bytes(encoded), len(records)


def level_count_task(args) -> Tuple[int, bytes, int]:
    """Pass 1 of one correction level for ONE shard id: stream the
    shard's frames (across ingest/level dirs) and accumulate one tag
    Counter per correction bin. A bin CAN span shards (the spill hash
    includes the raw next tag, the bin key does not), so the main process
    merges the returned per-shard counters per bin before clustering.
    Returns (shard_idx, pickled {bin_key: Counter}, reads_seen)."""
    (shard_idx, paths, tag_map_blob) = args
    from collections import Counter

    from clique_tpu_torch.collapse.pipeline import _gate_tag
    from clique_tpu_torch.collapse.shards import ShardReader

    tag_map = pickle.loads(tag_map_blob)
    counts: Dict[Tuple, Counter] = {}
    n = 0
    for p in paths:
        for _k, read in ShardReader(p):
            n += 1
            tag = tag_map.get(read.reference_name)
            if tag is None:
                continue
            gapless = _gate_tag(read, tag)
            if gapless is not None:
                bin_key = (read.reference_name,) + read.key_tuple()
                counts.setdefault(bin_key, Counter())[gapless] += 1
    return shard_idx, pickle.dumps(counts, protocol=4), n


def level_apply_task(args) -> Tuple[str, int]:
    """Pass 2 of one correction level for ONE shard id: stream again,
    apply the main process's precomputed correction maps, respill into a
    task-private dir keyed by the NEXT spill_key. Reads whose reference
    has no tag at this level (shorter hierarchies in multi-ref layouts)
    pass through unchanged. Returns (out_dir, reads_out)."""
    (shard_idx, paths, tag_map_blob, corr_blob, out_dir, n_shards) = args
    from clique_tpu_torch.collapse.pipeline import _apply_correction_one, _gate_tag
    from clique_tpu_torch.collapse.shards import ShardReader, ShardWriter

    tag_map = pickle.loads(tag_map_blob)
    corr = pickle.loads(corr_blob)
    n_out = 0
    with ShardWriter(out_dir, n_shards=n_shards) as sw:
        for p in paths:
            for _k, read in ShardReader(p):
                tag = tag_map.get(read.reference_name)
                if tag is None:
                    sw.push(read.spill_key(), read)
                    n_out += 1
                    continue
                if _gate_tag(read, tag) is None:
                    continue
                bin_key = (read.reference_name,) + read.key_tuple()
                applied = _apply_correction_one(read, tag, corr[bin_key])
                if applied is not None:
                    sw.push(applied.spill_key(), applied)
                    n_out += 1
    return out_dir, n_out


def _bgzf_compress_bytes(data: bytes) -> bytes:
    """Compress raw bytes into self-contained BGZF blocks (no EOF marker).
    Uses the native codec when available, else the python BgzfWriter."""
    from clique_tpu_torch.native import get_lib

    lib = get_lib()
    if lib is not None and data:
        import ctypes

        from clique_tpu_torch.io.sam import BgzfWriter

        level = int(os.environ.get("CLIQUE_TPU_BGZF_LEVEL",
                                   str(BgzfWriter.LEVEL)))
        cap = len(data) + (len(data) // 0xFF00 + 2) * 1024 + 1024
        out = ctypes.create_string_buffer(cap)
        written = lib.bgzf_compress(data, len(data), level,
                                    ctypes.addressof(out), cap)
        if written > 0:
            return out.raw[:written]
    import io as _io

    from clique_tpu_torch.io.sam import BgzfWriter

    sink = _io.BytesIO()
    w = BgzfWriter(sink)
    w.write(data)
    if w._buf:
        w._flush_block(bytes(w._buf))
        w._buf.clear()
    return sink.getvalue()


# --- pool management ----------------------------------------------------------

def warmup_task(_i) -> None:
    """Import the worker-side modules so the first real task doesn't pay
    the import latency; submitted async right after pool creation so the
    imports overlap the main process's BAM streaming."""
    import clique_tpu_torch.collapse.pipeline  # noqa: F401
    import clique_tpu_torch.io.sam  # noqa: F401


def worker_state(_i) -> Dict:
    """What one worker has loaded: its pid, whether torch is imported and
    has made a CUDA context, and any loaded module of jax or of the JAX
    package (a name blocked with None does not count)."""
    import sys
    import time

    time.sleep(0.02)          # let the other workers take the next tasks
    torch = sys.modules.get("torch")
    return {"pid": os.getpid(), "torch": torch is not None,
            "cuda_initialized": bool(torch is not None
                                     and torch.cuda.is_initialized()),
            "forbidden": sorted(m for m, mod in sys.modules.items()
                                if mod is not None and m.split(".")[0] in
                                ("jax", "jaxlib", "clique_tpu"))}


def worker_report(pool, n_workers: int) -> List[Dict]:
    """worker_state of the pool's workers after a run, one entry a pid
    (a few tasks each, so that every worker is likely to answer)."""
    seen: Dict[int, Dict] = {}
    for st in pool.imap_unordered(worker_state, range(2 * n_workers)):
        seen[st["pid"]] = st
    return [seen[p] for p in sorted(seen)]


def make_pool(n_workers: int):
    """Spawn the worker pool (never fork a process that holds a CUDA
    context)."""
    import multiprocessing as mp

    return mp.get_context("spawn").Pool(n_workers)


def parallel_ingest(pool, input_bam: str, layout, spill_root: str,
                    n_shards: int, stats, min_aligned_bases: int = 45,
                    min_identical: float = 0.8
                    ) -> Tuple[List[str], Dict[str, int]]:
    """Fan the BAM's record chunks over the pool. Returns (list of worker
    shard dirs, per-reference passing counts); stats is updated in place.
    With a .cqi chunk index, workers inflate their own byte ranges (see
    parallel_ingest_inram)."""
    from clique_tpu_torch.io.sam import bam_ingest_ranges

    layout_blob = pickle.dumps(layout, protocol=4)
    references, ranges = bam_ingest_ranges(input_bam)
    if ranges:
        def tasks():
            for i, (vbeg, vend, base_ord) in enumerate(ranges):
                yield (input_bam, vbeg, vend, references, layout_blob,
                       os.path.join(spill_root, f"ing{i:04d}"), n_shards,
                       base_ord, min_aligned_bases, min_identical)
        task_fn = ingest_range_task
    else:
        references, chunks = iter_record_chunks(input_bam)

        def tasks():
            base_ord = 0
            for i, chunk in enumerate(chunks):
                yield (chunk, references, layout_blob,
                       os.path.join(spill_root, f"ing{i:04d}"), n_shards,
                       base_ord, min_aligned_bases, min_identical)
                base_ord += _count_chunk_records(chunk)
        task_fn = ingest_chunk_task

    dirs: List[str] = []
    per_ref: Dict[str, int] = {}
    for spill_dir, ref_counts, st in pool.imap_unordered(task_fn,
                                                         tasks()):
        dirs.append(spill_dir)
        for name, c in ref_counts.items():
            per_ref[name] = per_ref.get(name, 0) + c
        stats.total_reads += st[0]
        stats.unmapped += st[1]
        stats.secondary += st[2]
        stats.failed_filters += st[3]
        stats.invalid_tags += st[4]
        stats.passing += st[5]
    return dirs, per_ref


def parallel_ingest_inram(pool, input_bam: str, layout, blob_dir: str,
                          stats, min_aligned_bases: int = 45,
                          min_identical: float = 0.8) -> Dict[str, List]:
    """Fan the BAM's record chunks over the pool; merge the returned
    per-reference passing reads (light records whose heavy payloads live
    in per-task blob files under blob_dir). stats is updated in place.

    With a .cqi chunk index (minted by align), workers seek + inflate
    their OWN byte ranges — the main process ships only (path, range)
    tuples instead of inflating the stream and piping chunk bytes.
    Without one, falls back to main-process chunking."""
    from clique_tpu_torch.io.sam import bam_ingest_ranges

    layout_blob = pickle.dumps(layout, protocol=4)
    references, ranges = bam_ingest_ranges(input_bam)
    if ranges:
        def tasks():
            for i, (vbeg, vend, base_ord) in enumerate(ranges):
                yield (input_bam, vbeg, vend, references, layout_blob,
                       os.path.join(blob_dir, f"ingest{i:04d}.blob"),
                       base_ord, min_aligned_bases, min_identical)
        task_fn = ingest_range_reads_task
    else:
        references, chunks = iter_record_chunks(input_bam)

        def tasks():
            base_ord = 0
            for i, chunk in enumerate(chunks):
                yield (chunk, references, layout_blob,
                       os.path.join(blob_dir, f"ingest{i:04d}.blob"),
                       base_ord, min_aligned_bases, min_identical)
                base_ord += _count_chunk_records(chunk)
        task_fn = ingest_chunk_reads_task

    reads_by_ref: Dict[str, List] = {name: [] for name in layout.references}
    for blob, st in pool.imap_unordered(task_fn, tasks()):
        for name, reads in pickle.loads(blob).items():
            reads_by_ref[name].extend(reads)
        stats.total_reads += st[0]
        stats.unmapped += st[1]
        stats.secondary += st[2]
        stats.failed_filters += st[3]
        stats.invalid_tags += st[4]
        stats.passing += st[5]
    # chunk tasks complete in ANY order (imap_unordered): restore global
    # input-BAM order via the per-record ordinals so group-member order
    # matches the single-process path exactly
    for reads in reads_by_ref.values():
        reads.sort(key=lambda r: r.ordinal)
    return reads_by_ref


def parallel_outputs_groups(pool, groups: List[List], writer, ref_seqs,
                            correct_only: bool, downsample_cap: int,
                            gap_call_threshold: float = 0.75,
                            batch_groups: int = 256) -> int:
    """Deal batches of read groups to workers for consensus building;
    append their BGZF blocks (or encode returned records) in batch order.
    Returns records written."""
    want_bgzf = hasattr(writer, "write_bgzf_blocks")
    ref_ids_map = getattr(writer, "_ref_ids", {})

    def job_args():
        for bi in range(0, len(groups), batch_groups):
            yield (bi, pickle.dumps(groups[bi:bi + batch_groups],
                                    protocol=4),
                   ref_seqs, ref_ids_map, correct_only, downsample_cap,
                   gap_call_threshold, want_bgzf)

    written = 0
    for _idx, payload, count in pool.imap(consensus_groups_task, job_args()):
        if payload[:2] == b"\x1f\x8b":           # BGZF blocks
            writer.write_bgzf_blocks(payload)
        elif count:
            for rec in pickle.loads(payload):
                writer.write(rec)
        written += count
    return written


def collapse_parallel(output_path: str, layout, input_bam: str,
                      temp_dir: Optional[str] = None,
                      correct_only: bool = False,
                      downsample_cap: int = 40,
                      metrics_path: Optional[str] = None,
                      n_workers: Optional[int] = None,
                      min_aligned_bases: int = 45,
                      min_identical: float = 0.8,
                      gap_call_threshold: float = 0.75,
                      device="cuda"):
    """Host-parallel in-RAM collapse: torch-free workers handle ingestion
    (BAM decode + alignment recovery + tag extraction + filters) and
    consensus/encoding; the main process keeps the correction kernels on
    `device` (the reference's rayon fanout, alignment_functions.rs:90-93,
    consensus_builders.rs:91-96).

    Output record multiset is identical to collapse(); record order
    follows (reference, key) group order like the single-process path.
    The metrics JSON adds `device`, the kernels' launches and `workers`
    (worker_report after the run)."""
    import json
    import time

    from clique_tpu_torch.collapse import distance
    from clique_tpu_torch.collapse.pipeline import (
        CollapseStats,
        add_device_metrics,
        launch_counts,
        load_known_lists,
        ref_seq_map,
        sort_level,
    )
    from clique_tpu_torch.io.sam import open_alignment_writer
    from clique_tpu_torch.reference.manager import ReferenceManager

    dev = distance.resolve_device(device)
    launches0 = launch_counts()
    n_workers = n_workers or max(1, (os.cpu_count() or 2) - 1)
    rm = ReferenceManager.from_layout(layout)
    known_lists = load_known_lists(layout)
    references = [(r.name, len(r.sequence)) for r in rm.references.values()]
    writer = open_alignment_writer(output_path, references)
    stats = CollapseStats()
    metrics = {"input_bam": input_bam, "references": {},
               "n_workers": n_workers, "started": time.time()}
    ref_seqs = ref_seq_map(rm)

    import shutil
    import tempfile

    blob_dir = tempfile.mkdtemp(prefix="clique_blobs.", dir=temp_dir)
    pool = make_pool(n_workers)
    pool.map_async(warmup_task, range(n_workers), chunksize=1)
    try:
        log.info("processing reads from input BAM file: %s "
                 "(%d references, %d workers)", input_bam,
                 len(rm.references), n_workers)
        t0 = time.time()
        # Small inputs: batched single-process ingest beats the worker
        # fanout's spawn/import + pickle floor (the batch-vectorized
        # _RefIngest path runs ~60k reads/s single-threaded); the pool
        # keeps warming asynchronously for the consensus stage. Large
        # inputs fan chunks over the pool as before.
        inline_max = int(os.environ.get("CLIQUE_PAR_INGEST_MIN",
                                        str(8 << 20)))
        try:
            inline = os.path.getsize(input_bam) < inline_max
        except OSError:
            inline = False
        if inline:
            from clique_tpu_torch.collapse.pipeline import (
                _RefIngest,
                ingest_bam_single_pass,
            )

            ings = {name: _RefIngest(name, rm, layout,
                                     min_aligned_bases=min_aligned_bases,
                                     min_identical=min_identical)
                    for name in layout.references}
            reads_by_ref = ingest_bam_single_pass(input_bam, ings, stats)
        else:
            reads_by_ref = parallel_ingest_inram(
                pool, input_bam, layout, blob_dir, stats,
                min_aligned_bases, min_identical)
        metrics["ingest_s"] = round(time.time() - t0, 3)

        t0 = time.time()
        all_groups: List[List] = []
        for ref in rm.references.values():
            reads = reads_by_ref.get(ref.name, [])
            ref_metrics = {"passing_reads": len(reads), "levels": []}
            if not reads:
                log.warning("No valid reads found for reference %s",
                            ref.name)
                metrics["references"][ref.name] = ref_metrics
                continue
            for tag in layout.get_sorted_umi_configurations(ref.name):
                n_in = len(reads)
                reads = sort_level(reads, tag, known_lists, device=dev)
                ref_metrics["levels"].append({
                    "symbol": tag.symbol, "sort_type": tag.sort_type.value,
                    "reads_in": n_in, "reads_out": len(reads)})
            reads.sort(key=lambda r: (r.reference_name, r.key_tuple()))
            i = 0
            n_groups0 = len(all_groups)
            while i < len(reads):
                j = i
                key = reads[i].key_tuple()
                while j < len(reads) and reads[j].key_tuple() == key:
                    j += 1
                all_groups.append(reads[i:j])
                i = j
            ref_metrics["groups"] = len(all_groups) - n_groups0
            metrics["references"][ref.name] = ref_metrics
        metrics["levels_s"] = round(time.time() - t0, 3)

        t0 = time.time()
        written = parallel_outputs_groups(
            pool, all_groups, writer, ref_seqs, correct_only,
            downsample_cap, gap_call_threshold)
        metrics["outputs_s"] = round(time.time() - t0, 3)
        metrics["output_records"] = written
        log.info("wrote %d records (%d workers)", written, n_workers)
        metrics["workers"] = worker_report(pool, n_workers)
    finally:
        pool.close()
        pool.join()
        shutil.rmtree(blob_dir, ignore_errors=True)

    writer.close()
    add_device_metrics(metrics, dev, launches0)
    metrics["elapsed_s"] = round(time.time() - metrics["started"], 3)
    metrics["read_stats"] = {
        "total": stats.total_reads, "unmapped": stats.unmapped,
        "secondary": stats.secondary, "failed_filters": stats.failed_filters,
        "invalid_tags": stats.invalid_tags, "passing": stats.passing}
    mpath = metrics_path or (str(output_path) + ".collapse_metrics.json")
    with open(mpath, "w") as fh:
        json.dump(metrics, fh, indent=2)
    return stats


def collapse_parallel_spill(output_path: str, layout, input_bam: str,
                            temp_dir: Optional[str] = None,
                            correct_only: bool = False,
                            downsample_cap: int = 40,
                            metrics_path: Optional[str] = None,
                            n_workers: Optional[int] = None,
                            min_aligned_bases: int = 45,
                            min_identical: float = 0.8,
                            gap_call_threshold: float = 0.75,
                            shards: Optional[int] = None,
                            device="cuda"):
    """Host-parallel OUT-OF-CORE collapse: the worker pool and the spill
    path unified (VERDICT r2 item 6 — previously n_workers>1 silently
    downgraded to single-process whenever maximum_subsequences or a >4GB
    BAM forced out-of-core, exactly the runs that need workers most).

    Stages, all shard-parallel over the pool:
    - ingest: record chunks fan out; each task spills passing reads into
      its own hash-partitioned dir (parallel_ingest);
    - levels: per level, workers stream shard ids for pass 1 (bin tag
      counters) — bins never span shards — the MAIN process builds every
      correction map with the device kernels, then workers stream pass 2
      (apply + respill). Per-bin resident reads stay O(1), honoring
      maximum_subsequences (collapse.rs:884-888);
    - outputs: final shard ids fan out for consensus + BGZF encoding
      (parallel_outputs).

    Output records match single-process collapse(): read ordinals keep
    group-member order equal to input-BAM order in every path. The
    corrections run in this process on `device`; the metrics JSON is
    collapse_parallel's."""
    import json
    import shutil
    import tempfile
    import time

    from clique_tpu_torch.collapse import distance
    from clique_tpu_torch.collapse.pipeline import (
        CollapseStats,
        _known_correction,
        add_device_metrics,
        launch_counts,
        load_known_lists,
        ref_seq_map,
    )
    from clique_tpu_torch.collapse.shards import shard_paths
    from clique_tpu_torch.config.layout import UMISortType
    from clique_tpu_torch.io.sam import open_alignment_writer
    from clique_tpu_torch.reference.manager import ReferenceManager

    dev = distance.resolve_device(device)
    launches0 = launch_counts()
    n_workers = n_workers or max(1, (os.cpu_count() or 2) - 1)
    rm = ReferenceManager.from_layout(layout)
    known_lists = load_known_lists(layout)
    references = [(r.name, len(r.sequence)) for r in rm.references.values()]
    writer = open_alignment_writer(output_path, references)
    stats = CollapseStats()
    metrics = {"input_bam": input_bam, "references": {},
               "n_workers": n_workers, "out_of_core": True,
               "started": time.time()}
    ref_seqs = ref_seq_map(rm)

    try:
        bam_bytes = os.path.getsize(input_bam)
    except OSError:
        bam_bytes = 0
    n_shards = shards or max(32, int(4 * bam_bytes / (256 << 20)) + 1)
    spill_root = tempfile.mkdtemp(prefix="clique_spill.", dir=temp_dir)
    pool = make_pool(n_workers)
    pool.map_async(warmup_task, range(n_workers), chunksize=1)
    try:
        log.info("processing reads from input BAM file: %s (%d references,"
                 " %d workers, out-of-core, %d shards)", input_bam,
                 len(rm.references), n_workers, n_shards)
        t0 = time.time()
        dirs, _per_ref = parallel_ingest(
            pool, input_bam, layout, os.path.join(spill_root, "l0"),
            n_shards, stats, min_aligned_bases, min_identical)
        metrics["ingest_s"] = round(time.time() - t0, 3)

        t0 = time.time()
        configs = {name: layout.get_sorted_umi_configurations(name)
                   for name in layout.references}
        n_levels = max((len(c) for c in configs.values()), default=0)
        level_metrics = []
        for lvl in range(n_levels):
            tag_map = {name: (c[lvl] if lvl < len(c) else None)
                       for name, c in configs.items()}
            tag_map_blob = pickle.dumps(tag_map, protocol=4)
            by_name: Dict[str, List[str]] = {}
            for d in dirs:
                for p in shard_paths(d):
                    by_name.setdefault(os.path.basename(p), []).append(p)
            shard_jobs = sorted(by_name.items())

            # pass 1 (workers): per-shard bin counters
            count_jobs = [(i, paths, tag_map_blob)
                          for i, (_n, paths) in enumerate(shard_jobs)]
            counts_by_shard: Dict[int, Dict] = {}
            reads_in = 0
            for idx, blob, n in pool.imap_unordered(level_count_task,
                                                    count_jobs):
                counts_by_shard[idx] = pickle.loads(blob)
                reads_in += n

            # correction maps (main process, the card's kernels). A bin (the
            # correction unit: reference + corrected prefix) SPANS shards
            # — the spill hash includes the raw next tag — so per-shard
            # counters merge per bin before clustering, and the built map
            # fans back out to every shard holding part of the bin.
            from collections import Counter as _Counter

            merged: Dict[Tuple, _Counter] = {}
            holders: Dict[Tuple, List[int]] = {}
            for i, counts in counts_by_shard.items():
                for bk, counter in counts.items():
                    if bk in merged:
                        merged[bk].update(counter)
                    else:
                        merged[bk] = _Counter(counter)
                    holders.setdefault(bk, []).append(i)
            corr_by_shard: Dict[int, Dict] = {i: {} for i in counts_by_shard}
            for name, tag in tag_map.items():
                if tag is None:
                    continue
                bins = [bk for bk in merged if bk[0] == name]
                if not bins:
                    continue
                if tag.sort_type == UMISortType.DEGENERATE_TAG:
                    from clique_tpu_torch.collapse.correct import (
                        correct_degenerate_groups,
                    )

                    corrections = correct_degenerate_groups(
                        [merged[bk] for bk in bins], tag.max_distance,
                        tag.length,
                        tag.minimum_collapsing_difference or 5.0,
                        device=dev)
                else:
                    corrections = [_known_correction(merged[bk], tag,
                                                     known_lists, device=dev)
                                   for bk in bins]
                for bk, corr in zip(bins, corrections):
                    for i in holders[bk]:
                        corr_by_shard[i][bk] = corr

            # pass 2 (workers): apply + respill
            next_root = os.path.join(spill_root, f"l{lvl + 1}")
            apply_jobs = [
                (i, paths, tag_map_blob,
                 pickle.dumps(corr_by_shard.get(i, {}), protocol=4),
                 os.path.join(next_root, f"s{i:04d}"), n_shards)
                for i, (_n, paths) in enumerate(shard_jobs)]
            new_dirs: List[str] = []
            reads_out = 0
            for out_dir, n_out in pool.imap_unordered(level_apply_task,
                                                      apply_jobs):
                new_dirs.append(out_dir)
                reads_out += n_out
            level_metrics.append({
                "level": lvl, "reads_in": reads_in, "reads_out": reads_out,
                "bins": len(merged)})
            for d in dirs:
                shutil.rmtree(d, ignore_errors=True)
            dirs = new_dirs
            log.info("level %d (parallel out-of-core): %d -> %d reads",
                     lvl, reads_in, reads_out)
        metrics["levels"] = level_metrics
        metrics["levels_s"] = round(time.time() - t0, 3)

        t0 = time.time()
        written = parallel_outputs(pool, dirs, writer, ref_seqs,
                                   correct_only, downsample_cap,
                                   gap_call_threshold)
        metrics["outputs_s"] = round(time.time() - t0, 3)
        metrics["output_records"] = written
        log.info("wrote %d records (%d workers, out-of-core)", written,
                 n_workers)
        metrics["workers"] = worker_report(pool, n_workers)
    finally:
        pool.close()
        pool.join()
        shutil.rmtree(spill_root, ignore_errors=True)

    writer.close()
    add_device_metrics(metrics, dev, launches0)
    metrics["elapsed_s"] = round(time.time() - metrics["started"], 3)
    metrics["read_stats"] = {
        "total": stats.total_reads, "unmapped": stats.unmapped,
        "secondary": stats.secondary, "failed_filters": stats.failed_filters,
        "invalid_tags": stats.invalid_tags, "passing": stats.passing}
    mpath = metrics_path or (str(output_path) + ".collapse_metrics.json")
    with open(mpath, "w") as fh:
        json.dump(metrics, fh, indent=2)
    return stats


def parallel_outputs(pool, level_dirs: List[str], writer, ref_seqs,
                     correct_only: bool, downsample_cap: int,
                     gap_call_threshold: float = 0.75) -> int:
    """Deal final-level shard ids to workers; append their BGZF blocks in
    shard order. Returns records written."""
    from clique_tpu_torch.collapse.shards import shard_paths

    by_name: Dict[str, List[str]] = {}
    for d in level_dirs:
        for p in shard_paths(d):
            by_name.setdefault(os.path.basename(p), []).append(p)
    ref_ids_map = writer._ref_ids

    job_args = [
        (i, paths, ref_seqs, ref_ids_map, correct_only, downsample_cap,
         gap_call_threshold)
        for i, (_name, paths) in enumerate(sorted(by_name.items()))]
    written = 0
    for _idx, payload, count in pool.imap(consensus_shard_task, job_args):
        if payload[:2] == b"\x1f\x8b":           # BGZF blocks
            writer.write_bgzf_blocks(payload)
        elif count:
            for rec in pickle.loads(payload):
                writer.write(rec)
        written += count
    return written
