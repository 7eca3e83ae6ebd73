"""Multi-process `align` and `collapse` on torch.distributed.

Counterpart of clique_tpu/parallel/distributed.py, kept textually close to
it. The reference engine is single-node: its shardio external-memory sort
(collapse.rs:468-469) is the boundary that becomes cross-process
communication here. The design and the bytes are the JAX package's:

- align: every process aligns its deterministic stripe of read chunks
  (align_reads read_shard) into a part BAM in the shared work dir; process
  0 merges the parts by raw BGZF-block append (concat_bam_parts);
- collapse: every process ingests a deterministic slice of the input BAM
  (byte ranges from the <bam>.cqi sidecar, else record chunks dealt
  round-robin from a full walk); with out_of_core (auto when
  maximum_subsequences caps are set or the BAM exceeds 4GB) it spills its
  slice to local per-reference shards and runs every level as two
  streaming passes;
- per correction level, tag counting is local; per-bin count dictionaries
  are exchanged through the shared filesystem, while the bin-bucket
  histogram is summed over the process group (psum_histogram, an
  all_reduce) to give each bin a deterministic owner balanced by load;
- each owner builds its bins' correction maps with the device kernels on
  its own device, publishes them, and every process applies the merged
  maps to its local reads;
- before consensus, reads are spilled into hash-partitioned shards keyed
  by their final group key (collapse/shards.py), shard ids are dealt to
  owners, each owner consensus-collapses its shards into a part BAM, and
  process 0 merges the parts.

What differs from the JAX module:

- Synchronisation is torch.distributed: `init_distributed` joins a
  tcp://host:port rendezvous with a timeout, so that a rank that dies
  fails the others at their next barrier instead of hanging them;
  `_barrier` is dist.barrier() (every process reaches the barriers in the
  same order; the names only label the log).
- The backend is NCCL where every process has a GPU of its own (as many
  CUDA devices on the host as processes), else gloo: NCCL refuses two
  ranks on one GPU. The transport does not move any work: each process
  runs its kernels on `device`, a bare "cuda" meaning cuda:(rank % device
  count), set as the current device before anything is built or launched.
- Each process logs one summary line ("distributed <verb> summary" and a
  JSON object: rank, world, device, backend, reads, kernel launches,
  wall, on rank 0 the merge wall, and for collapse each correction
  level's psum_histogram seconds).

Run one process per rank with identical arguments plus a distinct
process_id; num_processes=1 needs no coordinator and reduces to the
single-process semantics. Output record MULTISET is identical to
single-process align_reads / collapse(); record order follows (rank,
stripe) or shard order.
"""

from __future__ import annotations

import datetime
import json
import logging
import os
import pickle
import time
from collections import Counter
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

log = logging.getLogger(__name__)

# seconds a rank waits at the rendezvous or a collective before it fails
# (CLIQUE_TPU_DIST_TIMEOUT overrides)
DEFAULT_TIMEOUT_S = 600.0


def rank_device(device, process_id: int) -> torch.device:
    """The device this rank runs its kernels on: `device`, a bare "cuda"
    meaning cuda:(process_id % device count). A CUDA device becomes the
    current device; asking for one without a GPU raises."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r} was asked for, but no "
                               "CUDA device is available")
        if dev.index is None:
            dev = torch.device("cuda",
                               process_id % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def choose_backend(dev: torch.device, num_processes: int) -> str:
    """NCCL where the ranks run on CUDA and the host has a GPU for each,
    else gloo."""
    import torch.distributed as dist

    if dev.type == "cuda" and dist.is_nccl_available() and \
            torch.cuda.device_count() >= num_processes:
        return "nccl"
    return "gloo"


def init_distributed(coordinator_address: Optional[str],
                     num_processes: int, process_id: int,
                     device="cuda") -> Optional[str]:
    """Join the process group (idempotent): a tcp:// rendezvous at
    coordinator_address ("host:port", rank 0's), with CLIQUE_TPU_DIST_TIMEOUT
    seconds (default DEFAULT_TIMEOUT_S) for the rendezvous and every later
    collective. Returns the backend ("nccl" or
    "gloo"), None for one process (nothing to join)."""
    import torch.distributed as dist

    if num_processes <= 1:
        return None
    if dist.is_initialized():
        return dist.get_backend()
    if not coordinator_address:
        raise ValueError("a coordinator address (host:port) is needed for "
                         "more than one process")
    timeout = float(os.environ.get("CLIQUE_TPU_DIST_TIMEOUT",
                                   DEFAULT_TIMEOUT_S))
    dev = rank_device(device, process_id)
    backend = choose_backend(dev, num_processes)
    url = coordinator_address if "://" in coordinator_address \
        else f"tcp://{coordinator_address}"
    kwargs = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(
        backend, init_method=url, world_size=num_processes,
        rank=process_id, timeout=datetime.timedelta(seconds=timeout),
        **kwargs)
    log.info("p%d: torch.distributed %s backend, %d processes, kernels on "
             "%s, timeout %.0f s", process_id, backend, num_processes, dev,
             timeout)
    return backend


def shutdown_distributed() -> None:
    """Leave the process group, if this process joined one."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def _barrier(name: str, num_processes: int) -> None:
    if num_processes <= 1:
        return
    import torch.distributed as dist

    log.debug("barrier %s", name)
    dist.barrier()


def global_mesh():
    """The process group of every process (torch.distributed's default
    group; None, a world of one process, where none was joined)."""
    import torch.distributed as dist

    return dist.group.WORLD if dist.is_initialized() else None


def psum_histogram(mesh, local_hist) -> np.ndarray:
    """Cross-process merge of per-bucket counts: this process's histogram
    summed over the group by an all_reduce; the same result on every
    process. `mesh` is the process group (global_mesh())."""
    from clique_tpu_torch.parallel.groupby import all_reduce_sum

    t = torch.as_tensor(np.asarray(local_hist, dtype=np.int64))
    return all_reduce_sum(t, mesh).numpy()


def _backend_name(num_processes: int) -> Optional[str]:
    import torch.distributed as dist

    if num_processes > 1 and dist.is_initialized():
        return dist.get_backend()
    return None


def _summary(verb: str, process_id: int, num_processes: int, dev, **kw):
    log.info("distributed %s summary %s", verb, json.dumps(dict(
        rank=process_id, world=num_processes, device=str(dev),
        backend=_backend_name(num_processes), **kw)))


# --- distributed align --------------------------------------------------------

def align_distributed(layout, rm, output_path: str, work_dir: str, *,
                      read1: str, read2: Optional[str] = None,
                      index1: Optional[str] = None,
                      index2: Optional[str] = None,
                      process_id: int = 0, num_processes: int = 1,
                      coordinator_address: Optional[str] = None,
                      device="cuda", **align_kwargs):
    """Multi-process align (SURVEY 2.11 P1; the rayon fanout of
    alignment_functions.rs:90-93 scaled across processes).

    Every process calls this with identical arguments except process_id:
    each runs the full align_reads pipeline on its deterministic stripe of
    read chunks (align_reads read_shard) against replicated references on
    its own device (rank_device), writing a part BAM in the shared
    work_dir; rank 0 merges the parts by raw BGZF-block append
    (io/sam.py:concat_bam_parts). Output record MULTISET equals
    single-process align_reads; record order follows (rank, stripe) order.
    output_path must be .bam. Returns AlignStats for the LOCAL slice.

    Part BAMs are explicit resume points: a restarted rank whose part is
    already complete (EOF block present, the .cqi sidecar's sentinel
    matches the file, the run signature of world size and inputs equal)
    skips its alignment and goes straight to the barrier (returns None).
    An interrupted part fails this validation and is redone."""
    from clique_tpu_torch.align import dp_kernels
    from clique_tpu_torch.align.pipeline import align_reads
    from clique_tpu_torch.io.sam import concat_bam_parts, read_cqi

    if not str(output_path).endswith(".bam"):
        raise ValueError("distributed align writes BAM output only")
    dev = rank_device(device, process_id)
    init_distributed(coordinator_address, num_processes, process_id, dev)
    os.makedirs(work_dir, exist_ok=True)
    t0 = time.time()
    if num_processes > 1 and align_kwargs.get("metrics_path"):
        # per-rank metrics: every process reports its LOCAL slice — a
        # shared path would race and misreport one rank's stats as the
        # run's
        align_kwargs["metrics_path"] = \
            f"{align_kwargs['metrics_path']}.rank{process_id}"
    part = os.path.join(work_dir, f"part.p{process_id}.bam")

    # resume requires BOTH internal completeness (EOF + cqi sentinel) and
    # a matching run signature — a stale part from a different world size
    # or input set must be redone, not silently merged
    def _sig(p):
        try:
            st = os.stat(p)
            return [str(p), st.st_size, int(st.st_mtime)]
        except OSError:
            return [str(p), -1, -1]
    run_sig = {"world": num_processes,
               "inputs": [_sig(p) for p in (read1, read2, index1, index2)
                          if p and p != "NONE"]}
    sig_path = part + ".run"
    resume_ok = False
    if os.path.exists(part) and read_cqi(part) is not None:
        try:
            with open(sig_path) as fh:
                resume_ok = json.load(fh) == run_sig
        except (OSError, ValueError):
            resume_ok = False
    launches0 = dp_kernels.align_launches
    if resume_ok:
        log.info("p%d: part BAM already complete for this run signature, "
                 "resuming past align", process_id)
        stats = None
    else:
        stats = align_reads(
            layout, rm, part, read1=read1, read2=read2, index1=index1,
            index2=index2,
            read_shard=(process_id, num_processes) if num_processes > 1
            else None, device=dev,
            **align_kwargs)
        with open(sig_path + ".tmp", "w") as fh:
            json.dump(run_sig, fh)
        os.replace(sig_path + ".tmp", sig_path)
    t_align = time.time() - t0
    _barrier("align-parts", num_processes)
    merge_s = None
    if process_id == 0:
        t_merge = time.time()
        references = [(r.name, len(r.sequence))
                      for r in rm.references.values()]
        nbytes = concat_bam_parts(
            output_path, references,
            [os.path.join(work_dir, f"part.p{p}.bam")
             for p in range(num_processes)])
        merge_s = time.time() - t_merge
        log.info("distributed align: %d processes, %d part bytes merged, "
                 "%.1fs", num_processes, nbytes, time.time() - t0)
    _barrier("align-done", num_processes)
    _summary("align", process_id, num_processes, dev,
             reads=stats.total if stats is not None else None,
             aligned=stats.aligned if stats is not None else None,
             launches={"dp_align": dp_kernels.align_launches - launches0},
             align_s=t_align, merge_s=merge_s, wall_s=time.time() - t0)
    return stats


# --- distributed collapse -----------------------------------------------------

def _iter_slice_chunks(input_bam: str, process_id: int,
                       num_processes: int):
    """(references, iterator of this process's decompressed record-stream
    chunks): a deterministic disjoint cover of the input BAM.

    With a chunk-index sidecar (<bam>.cqi, minted by align_reads /
    concat_bam_parts) each process seeks straight to its byte ranges and
    inflates ONLY those BGZF blocks. Without one, every process walks the
    whole stream and keeps chunks i with i % P == rank."""
    from clique_tpu_torch.io.sam import bam_ingest_ranges, read_voffset_range
    from clique_tpu_torch.collapse.workers import (_count_chunk_records,
                                                   iter_record_chunks)

    references, ranges = bam_ingest_ranges(input_bam)
    if ranges:
        def chunks():
            for i in range(process_id, len(ranges), num_processes):
                vbeg, vend, base_ord = ranges[i]
                yield read_voffset_range(input_bam, vbeg, vend), base_ord
        return references, chunks()

    references, all_chunks = iter_record_chunks(input_bam)

    def dealt():
        base_ord = 0
        for i, chunk in enumerate(all_chunks):
            if i % num_processes == process_id:
                yield chunk, base_ord
            # count records in every chunk (cheap block_size walk over
            # the already-inflated bytes) so ordinals stay global
            base_ord += _count_chunk_records(chunk)
    return references, dealt()


def _ingest_slice(input_bam: str, layout, rm, process_id: int,
                  num_processes: int, stats,
                  spill_writers: Optional[Dict[str, object]] = None
                  ) -> Dict[str, List]:
    """Ingest this process's slice of the input BAM (_iter_slice_chunks).
    With spill_writers (name -> ShardWriter), reads spill out-of-core
    instead of accumulating in RAM; the returned lists are then empty."""
    from clique_tpu_torch.collapse.pipeline import _RefIngest
    from clique_tpu_torch.io.sam import decode_record_stream

    references, chunks = _iter_slice_chunks(input_bam, process_id,
                                            num_processes)
    ingests = {name: _RefIngest(name, rm, layout,
                                spill=(spill_writers or {}).get(name))
               for name in layout.references}
    for chunk, base_ord in chunks:
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
            # globally monotone input-position stamp (chunk base + index)
            ing._next_ordinal = base_ord + j
            ing.ingest(rec, stats)
    return {name: ing.finish(stats) for name, ing in ingests.items()}


def _local_bin_counts(reads: List, tag) -> Dict[Tuple, Counter]:
    """Per-bin (reference, corrected-prefix) counters of the gap-stripped
    next tag, after the push() length gate (correct_tags.rs:50-120)."""
    from clique_tpu_torch.collapse.pipeline import _gate_tag

    counts: Dict[Tuple, Counter] = {}
    for read in reads:
        gapless = _gate_tag(read, tag)
        if gapless is not None:
            bin_key = (read.reference_name,) + read.key_tuple()
            counts.setdefault(bin_key, Counter())[gapless] += 1
    return counts


def _merge_level_counts(level_dir: str, num_processes: int
                        ) -> Dict[Tuple, Counter]:
    merged: Dict[Tuple, Counter] = {}
    for p in range(num_processes):
        with open(os.path.join(level_dir, f"counts.p{p}.pkl"), "rb") as fh:
            for bin_key, counter in pickle.load(fh).items():
                if bin_key in merged:
                    merged[bin_key].update(counter)
                else:
                    merged[bin_key] = Counter(counter)
    return merged


def _exchange_correction_maps(local_counts: Dict[Tuple, Counter], tag,
                              known_lists, mesh, level_dir: str,
                              process_id: int, num_processes: int,
                              n_buckets: int, device="cuda",
                              psum_s: Optional[List[float]] = None
                              ) -> Dict[Tuple, Dict]:
    """The cross-process core of one correction level: publish local tag
    counters (shared-FS payload), sum the bin-bucket histogram over the
    group for deterministic load-balanced ownership, owners build
    correction maps over the GLOBAL counts with the device kernels on
    `device`, and the merged maps are returned on every process. The
    psum_histogram's seconds are appended to psum_s when it is given."""
    from clique_tpu_torch.collapse.pipeline import _known_correction
    from clique_tpu_torch.config.layout import UMISortType
    from clique_tpu_torch.parallel.groupby import (assign_bucket_owners,
                                                   tag_bucket)

    os.makedirs(level_dir, exist_ok=True)
    with open(os.path.join(level_dir, f"counts.p{process_id}.pkl.tmp"),
              "wb") as fh:
        pickle.dump(local_counts, fh, protocol=4)
    os.replace(os.path.join(level_dir, f"counts.p{process_id}.pkl.tmp"),
               os.path.join(level_dir, f"counts.p{process_id}.pkl"))

    local_hist = np.zeros(n_buckets, dtype=np.int32)
    for bin_key, counter in local_counts.items():
        local_hist[tag_bucket(pickle.dumps(bin_key, protocol=4),
                              n_buckets)] += sum(counter.values())
    _barrier(f"counts-level-{tag.order}", num_processes)
    t_psum = time.perf_counter()
    hist = psum_histogram(mesh, local_hist)
    if psum_s is not None:
        psum_s.append(time.perf_counter() - t_psum)
    owner = assign_bucket_owners(hist, num_processes)

    merged = _merge_level_counts(level_dir, num_processes)
    mine = [bk for bk in merged
            if int(owner[tag_bucket(pickle.dumps(bk, protocol=4),
                                    n_buckets)]) == process_id]
    from clique_tpu_torch.collapse.correct import correct_degenerate_groups

    if tag.sort_type == UMISortType.DEGENERATE_TAG:
        corrections = correct_degenerate_groups(
            [merged[bk] for bk in mine], tag.max_distance, tag.length,
            tag.minimum_collapsing_difference or 5.0, device=device)
    else:
        corrections = [_known_correction(merged[bk], tag, known_lists,
                                         device=device)
                       for bk in mine]
    with open(os.path.join(level_dir, f"maps.p{process_id}.pkl.tmp"),
              "wb") as fh:
        pickle.dump(dict(zip(mine, corrections)), fh, protocol=4)
    os.replace(os.path.join(level_dir, f"maps.p{process_id}.pkl.tmp"),
               os.path.join(level_dir, f"maps.p{process_id}.pkl"))
    _barrier(f"maps-level-{tag.order}", num_processes)

    maps: Dict[Tuple, Dict] = {}
    for p in range(num_processes):
        with open(os.path.join(level_dir, f"maps.p{p}.pkl"), "rb") as fh:
            maps.update(pickle.load(fh))
    log.info("p%d level %s: %d bins (%d owned)", process_id, tag.symbol,
             len(merged), len(mine))
    return maps


def distributed_sort_level(reads: List, tag, known_lists, mesh,
                           level_dir: str, process_id: int,
                           num_processes: int,
                           n_buckets: int = 256, device="cuda",
                           psum_s: Optional[List[float]] = None) -> List:
    """One correction level across processes (in-RAM local reads): count
    locally, exchange maps, apply. Returns this process's corrected
    reads; the level's psum_histogram seconds go to psum_s if given."""
    from clique_tpu_torch.collapse.pipeline import (_apply_correction_one,
                                                    _gate_tag)

    local_counts = _local_bin_counts(reads, tag)
    maps = _exchange_correction_maps(local_counts, tag, known_lists, mesh,
                                     level_dir, process_id, num_processes,
                                     n_buckets, device, psum_s)
    out: List = []
    for read in reads:
        if _gate_tag(read, tag) is None:
            continue
        bin_key = (read.reference_name,) + read.key_tuple()
        applied = _apply_correction_one(read, tag, maps[bin_key])
        if applied is not None:
            out.append(applied)
    log.info("p%d level %s: %d -> %d reads", process_id, tag.symbol,
             len(reads), len(out))
    return out


def distributed_sort_level_spill(in_dir: str, tag, known_lists, mesh,
                                 level_dir: str, out_dir: str,
                                 process_id: int, num_processes: int,
                                 n_buckets: int = 256,
                                 n_shards: int = 32,
                                 device="cuda",
                                 psum_s: Optional[List[float]] = None
                                 ) -> Tuple[int, int]:
    """Out-of-core distributed level: two streaming passes over this
    process's LOCAL spill shards (per-bin resident reads O(1), honoring
    maximum_subsequences exactly like sort_level_spill), with the same
    cross-process count/map exchange as the in-RAM path. Returns local
    (reads_in, reads_out); psum_s as distributed_sort_level's."""
    from clique_tpu_torch.collapse.pipeline import (_apply_correction_one,
                                                    _gate_tag)
    from clique_tpu_torch.collapse.shards import ShardWriter, iter_items

    local_counts: Dict[Tuple, Counter] = {}
    n_in = 0
    for _key, read in iter_items(in_dir):
        n_in += 1
        gapless = _gate_tag(read, tag)
        if gapless is not None:
            bin_key = (read.reference_name,) + read.key_tuple()
            local_counts.setdefault(bin_key, Counter())[gapless] += 1

    maps = _exchange_correction_maps(local_counts, tag, known_lists, mesh,
                                     level_dir, process_id, num_processes,
                                     n_buckets, device, psum_s)
    n_out = 0
    with ShardWriter(out_dir, n_shards=n_shards) as out_writer:
        for _key, read in iter_items(in_dir):
            if _gate_tag(read, tag) is None:
                continue
            bin_key = (read.reference_name,) + read.key_tuple()
            applied = _apply_correction_one(read, tag, maps[bin_key])
            if applied is not None:
                out_writer.push(applied.spill_key(), applied)
                n_out += 1
    log.info("p%d level %s (out-of-core): %d -> %d reads", process_id,
             tag.symbol, n_in, n_out)
    return n_in, n_out


def collapse_distributed(output_path: str, layout, input_bam: str,
                         work_dir: str, *, process_id: int = 0,
                         num_processes: int = 1,
                         coordinator_address: Optional[str] = None,
                         correct_only: bool = False,
                         downsample_cap: int = 40,
                         n_shards: int = 32,
                         n_buckets: int = 256,
                         out_of_core: Optional[bool] = None,
                         device="cuda"):
    """Distributed collapse over num_processes processes sharing work_dir.

    Every process calls this with identical arguments except process_id;
    process 0 writes the output BAM (returns CollapseStats for the LOCAL
    slice on every process). The corrections run on this rank's device
    (rank_device).

    out_of_core=None auto-enables the streaming path exactly like
    collapse(): when any maximum_subsequences cap is set (per-bin
    resident reads must stay O(1), collapse.rs:884-888) or the input BAM
    exceeds 4GB. In that mode each process spills its slice to LOCAL
    per-reference shards and every level runs as two streaming passes
    (distributed_sort_level_spill)."""
    import shutil

    from clique_tpu_torch.collapse import distance
    from clique_tpu_torch.collapse.pipeline import (
        CollapseStats,
        _consensus_record,
        load_known_lists,
        ref_seq_map,
    )
    from clique_tpu_torch.collapse.shards import (ShardWriter, iter_items,
                                                  _read_shard)
    from clique_tpu_torch.reference.manager import ReferenceManager

    if not str(output_path).endswith(".bam"):
        raise ValueError("distributed collapse writes BAM output only")
    dev = rank_device(device, process_id)
    init_distributed(coordinator_address, num_processes, process_id, dev)
    mesh = global_mesh()
    rm = ReferenceManager.from_layout(layout)
    known_lists = load_known_lists(layout)
    stats = CollapseStats()
    t0 = time.time()
    psum_s: List[float] = []
    launches0 = (distance.match_hits_launches,
                 distance.edit_distance_launches,
                 distance.edit_hits_launches)

    if out_of_core is None:
        caps = any(cfg.maximum_subsequences is not None
                   for ref in layout.references.values()
                   for cfg in ref.umi_configurations.values())
        try:
            big = os.path.getsize(input_bam) > 4 << 30
        except OSError:
            big = False
        out_of_core = caps or big
        if out_of_core:
            log.info("distributed collapse: out-of-core enabled "
                     "(caps=%s, big=%s)", caps, big)

    def _safe(name: str) -> str:
        return "".join(c if c.isalnum() else "_" for c in name)

    # the one read exchange target: spill by final group key, owners
    # collapse (filled either from RAM lists or local level shards)
    spill_dir = os.path.join(work_dir, f"final.p{process_id}")

    if out_of_core:
        local_root = os.path.join(work_dir, f"local.p{process_id}")
        spill_writers = {}
        for ref in rm.references.values():
            sw = ShardWriter(os.path.join(local_root, f"{_safe(ref.name)}.l0"),
                             n_shards=n_shards)
            spill_writers[ref.name] = sw
        _ingest_slice(input_bam, layout, rm, process_id, num_processes,
                      stats, spill_writers=spill_writers)
        for sw in spill_writers.values():
            sw.close()
        with ShardWriter(spill_dir, n_shards=n_shards) as final_sw:
            for ref in rm.references.values():
                safe = _safe(ref.name)
                in_dir = os.path.join(local_root, f"{safe}.l0")
                for lvl, tag in enumerate(
                        layout.get_sorted_umi_configurations(ref.name)):
                    level_dir = os.path.join(work_dir, f"{safe}.l{lvl}")
                    out_dir = os.path.join(local_root, f"{safe}.l{lvl + 1}")
                    distributed_sort_level_spill(
                        in_dir, tag, known_lists, mesh, level_dir, out_dir,
                        process_id, num_processes, n_buckets=n_buckets,
                        n_shards=n_shards, device=dev, psum_s=psum_s)
                    shutil.rmtree(in_dir, ignore_errors=True)
                    in_dir = out_dir
                for _key, r in iter_items(in_dir):
                    final_sw.push((r.reference_name,) + r.key_tuple(), r)
                shutil.rmtree(in_dir, ignore_errors=True)
    else:
        reads_by_ref = _ingest_slice(input_bam, layout, rm, process_id,
                                     num_processes, stats)
        for ref in rm.references.values():
            reads = reads_by_ref.get(ref.name, [])
            safe = _safe(ref.name)
            for lvl, tag in enumerate(
                    layout.get_sorted_umi_configurations(ref.name)):
                level_dir = os.path.join(work_dir, f"{safe}.l{lvl}")
                reads = distributed_sort_level(
                    reads, tag, known_lists, mesh, level_dir, process_id,
                    num_processes, n_buckets=n_buckets, device=dev,
                    psum_s=psum_s)
            reads_by_ref[ref.name] = reads

        with ShardWriter(spill_dir, n_shards=n_shards) as sw:
            for reads in reads_by_ref.values():
                for r in reads:
                    sw.push((r.reference_name,) + r.key_tuple(), r)
    t_levels = time.time() - t0
    _barrier("final-spill", num_processes)

    # owners consensus-collapse their shards and write a part BAM each;
    # rank 0 merges the parts by raw BGZF-block append (no pickling, no
    # re-encode — the same merge as distributed align)
    from clique_tpu_torch.io.sam import BamWriter, concat_bam_parts

    references = [(r.name, len(r.sequence)) for r in rm.references.values()]
    ref_seqs = ref_seq_map(rm)
    part_path = os.path.join(work_dir, f"outpart.p{process_id}.bam")
    total_local = 0
    with BamWriter(part_path, references) as part_writer:
        for s in range(n_shards):
            if s % num_processes != process_id:
                continue
            items: List = []
            for p in range(num_processes):
                path = os.path.join(work_dir, f"final.p{p}",
                                    f"shard{s:04d}.cqs")
                if os.path.exists(path):
                    items.extend(_read_shard(path))
            # ordinal tiebreak: group members in input-BAM order no
            # matter which process ingested them
            items.sort(key=lambda kv: (kv[0], kv[1].ordinal))
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
                        g, ref_seqs,
                        downsample_cap if not correct_only else 0, 0.75)
                    if rec is not None:
                        records.append(rec)
            part_writer.write_batch(records)
            total_local += len(records)
    _barrier("records", num_processes)

    merge_s = None
    if process_id == 0:
        t_merge = time.time()
        total = concat_bam_parts(
            output_path, references,
            [os.path.join(work_dir, f"outpart.p{p}.bam")
             for p in range(num_processes)])
        merge_s = time.time() - t_merge
        log.info("distributed collapse: %d processes, %d local records, "
                 "%d part bytes merged, %.1fs", num_processes, total_local,
                 total, time.time() - t0)
    _barrier("done", num_processes)
    now = (distance.match_hits_launches, distance.edit_distance_launches,
           distance.edit_hits_launches)
    _summary("collapse", process_id, num_processes, dev,
             reads=stats.total_reads, records=total_local,
             launches=dict(zip(("match_hits", "edit_distance", "edit_hits"),
                               (b - a for a, b in zip(launches0, now)))),
             ingest_levels_s=t_levels, merge_s=merge_s,
             psum_s=psum_s, wall_s=time.time() - t0)
    return stats
