"""End-to-end `align` pipeline on PyTorch + CUDA: FASTQ -> merge ->
batched DP on the card -> tag extraction -> tagged SAM/BAM.

Counterpart of clique_tpu/align/pipeline.py, kept textually close to it so
that a diff between the two reads easily. What differs:

- BatchAligner dispatches each length bucket on one explicit CUDA stream
  through the hand-written fused fill + walk kernel and copies the fused
  result into pinned host memory; pulls() waits on a per-group event. On
  a CPU device the plain PyTorch versions run instead. The TPU
  workarounds (batch pad-up to a compiled shape, the wave, fetch-fuse,
  the device mesh) are gone.
- align_reads runs the dp engine or the wavefront engines (--engine
  wfa|convex, align/wavefront.py's WfaAligner, their fill and walk a
  hand-written kernel) with the kmer router (single reference, kmer vote,
  exhaustive search, screened by the score-only wavefront kernel on the
  wavefront engines) or the pair-HMM router (align/hmm.py, its forward
  recurrence a hand-written kernel, one route call kept in flight while
  the reads before it are picked and flushed), a full or partial band,
  the anchored seed-and-extend path for long reads, and a torch.profiler
  trace (profile_dir), and read_shard: one process's stripe of the read
  chunks (the multi-process align of parallel/distributed.py).
- BatchAligner splits a length bucket into groups whose traceback stays
  within batch.MAX_TRACEBACK_BYTES (the JAX package pads groups up
  instead); outputs do not change.

Reference-selection semantics (align_to_reference_choices, :520-631):
- single reference: orient by longest shared segment when !known_strand,
  then global affine alignment with the rust-bio-compat scoring via the
  `ref_n_only` special rule (single_ref_native=True for the engine's own
  affine scoring instead).
- multiple references: unique-kmer vote; if the top reference holds > 0.90
  of votes align to it, else exhaustively align against every candidate and
  keep the best score (quick/exhaustive_alignment_search, :693-827).

SAM tags written per read (:193-226 and alignment_matrix.rs:741-771):
e<sym> = extracted tag per UMI symbol, rc = 1, ar = read name,
rm = reference alignment rate, as/rs = alignment score.
"""

from __future__ import annotations

import functools
import logging
import os
import time
from dataclasses import dataclass
from decimal import Decimal
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from clique_tpu_torch.align.merge import MERGE_SCORING, alignment_rate_and_consensus, unify_read
from clique_tpu_torch.align.scoring import AffineScoring
from clique_tpu_torch.config.layout import (AlignedReadOrientation, MergeStrategy,
                                      SequenceLayout)
from clique_tpu_torch.extract.extractor import (
    alignment_rate_fast,
    extract_digit_tags_fast,
    extract_tagged_sequences,
)
from clique_tpu_torch.io.fastq import ReadIterator
from clique_tpu_torch.io.sam import SamRecord, open_alignment_writer
from clique_tpu_torch.reference.manager import ReferenceManager, orient_by_longest_segment
from clique_tpu_torch.utils import trace
from clique_tpu_torch.utils.seq import GAP, reverse_complement
from clique_tpu_torch.utils.trace import span
from clique_tpu_torch.align import batch as dbatch
from clique_tpu_torch.align import dp_kernels, hmm, wfa_kernels
from clique_tpu_torch.align.wavefront import (WfaAligner,
                                              wfa_screen_candidates)

# read-chunk size for multi-process striping (align_reads read_shard):
# large enough that each process's device batches stay dense, small enough
# to balance 2+ processes on modest inputs (env-overridable for tests), as
# clique_tpu/align/pipeline.py reads it
_SHARD_CHUNK = int(os.environ.get("CLIQUE_TPU_SHARD_CHUNK", "1024"))

log = logging.getLogger(__name__)

# rust-bio-compatible scoring used by the reference's single-reference path
# (alignment_functions.rs:48-61): match/ref-N = 1, mismatch = -1, gap -5/-1.
RUST_BIO_COMPAT = AffineScoring(1.0, -1.0, 1.0, -5.0, -1.0, 1.0)

# device batches accumulated before a flush, the JAX pipeline's default
# (clique_tpu/align/pipeline.py, CLIQUE_TPU_FLUSH_FACTOR)
FLUSH_FACTOR = 8


def bam_codec() -> str:
    """Which BAM codec the writer uses: "native C" (native/bamcodec.c,
    built with the C compiler and zlib at first use) or "pure Python"."""
    from clique_tpu_torch.native import get_lib

    return "native C" if get_lib() is not None else "pure Python"


@dataclass
class AlignedRead:
    """One aligned read ready for tag extraction / writing."""

    read_name: str
    reference_name: str
    reference_aligned: bytes
    read_aligned: bytes
    quals: Optional[bytes]
    cigar: List[Tuple[int, str]]
    score: float
    reference_start: int = 0

    def to_sam_record(self, extra_tags: Dict[str, str]) -> SamRecord:
        """AlignmentResult::to_sam_record (alignment_matrix.rs:741-771):
        gap-stripped sequence, qual hardcoded 'H', pos = start+1, tags
        rm/rs/ar/as + extras."""
        arr = np.frombuffer(self.read_aligned, dtype=np.uint8)
        seq = arr[arr != GAP].tobytes()
        tags = dict(extra_tags)
        tags["rm"] = _fmt(alignment_rate_fast(
            self.reference_aligned, self.read_aligned))
        tags["rs"] = _fmt(self.score)
        tags["as"] = _fmt(self.score)
        return SamRecord(
            name=self.read_name,
            flag=0,
            reference_name=self.reference_name,
            pos=self.reference_start + 1,
            mapq=255,
            cigar=list(self.cigar),
            seq=seq,
            qual=b"H" * len(seq),
            tags=tags,
        )


def _fmt(x: float) -> str:
    """Render a float exactly as Rust's f64 `Display` does (used for the
    rm/as SAM tags, reference alignment_matrix.rs:741-771).

    Rust Display prints the shortest decimal that round-trips and NEVER
    uses scientific notation: 290.0 -> "290", 1e16 -> "10000000000000000",
    1.5e-7 -> "0.00000015", -0.0 -> "-0". Python `repr` matches the
    shortest-round-trip digits but switches to exponent form outside
    ~[1e-4, 1e16); expand those through Decimal (exact, since Decimal is
    constructed from repr's digit string, not the binary float)."""
    if x != x:  # NaN
        return "NaN"
    if x == float("inf"):
        return "inf"
    if x == float("-inf"):
        return "-inf"
    s = repr(x)
    if s.endswith(".0"):
        return s[:-2]  # 290.0 -> "290", -0.0 -> "-0"
    if "e" not in s and "E" not in s:
        return s
    return format(Decimal(s), "f")


@dataclass
class _Pending:
    name: str
    seq: bytes
    quals: bytes
    ref_id: int


class BatchAligner:
    """Length-bucketed batcher around align_batch, on one device.

    On a CUDA device every group goes out on ONE explicit stream, in order:
    the H2D copies of its reads (and of one reference row when the group
    shares it), the fused fill + walk kernel, and a non-blocking copy of
    the fused result into pinned host memory, followed by an event. pulls()
    waits on each group's event, so it may run on any thread (the drain
    thread does) without touching that thread's current stream. Only the
    fused buffers outlive a dispatch: the traceback is freed on the stream
    as soon as the kernel is enqueued. On a CPU device the plain PyTorch
    fill and walk run synchronously at dispatch.

    bandwidth: the half-width of a partial band around the f64 band
    centers (perform_affine_alignment_bandwidth, alignment_matrix.rs
    :376-425); each group then sends its [B] widths and [B, n1] centers
    table. None is the full band.

    pinned_inputs: copy each group's inputs from pinned memory, so that a
    dispatch does not wait for work queued ahead of it on the stream (the
    HMM router's forward passes share it in align_reads). Else the copies
    are pageable, which costs the host less where only this aligner's own
    kernels are queued."""

    def __init__(self, scoring: AffineScoring, batch_size: int = 128,
                 length_quantum: int = 128, special_mode: str = "both",
                 device="cuda", bandwidth: Optional[int] = None,
                 pinned_inputs: bool = False):
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.params = dbatch.scoring_to_params(scoring, self.device)
        self.batch_size = batch_size
        self.quantum = length_quantum
        self.special_mode = special_mode
        self.bandwidth = bandwidth
        self.pinned_inputs = pinned_inputs
        self.stream = None
        if self.device.type == "cuda":
            self.stream = torch.cuda.Stream(self.device)
            # the params were written on the current stream
            self.stream.wait_stream(torch.cuda.current_stream(self.device))
        # a host clock of dispatches and event waits, not device time
        self.device_seconds = 0.0
        self.post_seconds = 0.0     # host-side expansion
        # dispatch runs on the main thread while pulls/expansion run on
        # the drain thread: the timing counters need a lock or the
        # unsynchronized += interleaves and drops increments
        import threading

        self._t_lock = threading.Lock()
        self.pairs_aligned = 0
        self.cells_filled = 0
        self.dispatches = 0

    def _bucket_len(self, n: int) -> int:
        q = self.quantum
        return max(q, -(-n // q) * q)

    def align_pairs_entries(self, refs: List[bytes], reads: List[bytes]):
        """Dispatch + pull WITHOUT host expansion: returns pulled entries
        (group metadata + the fused result bytes) for expand_entry. The
        align_reads writer thread expands them off the critical path;
        align_pairs_raw expands inline for everyone else.

        Every group is dispatched before any result is pulled back (the
        kernels and copies run asynchronously on the stream), so the
        device works while the host expands earlier groups."""
        i = 0
        # precompute each pair's bucket shape once
        shapes = [(self._bucket_len(len(refs[k]) + 1),
                   self._bucket_len(len(reads[k]) + 1))
                  for k in range(len(refs))]
        idxs = sorted(range(len(refs)), key=shapes.__getitem__)
        t0 = time.time()
        buckets = []
        while i < len(idxs):
            n1, n2 = shapes[idxs[i]]
            cap = min(self.batch_size, max(
                1, dbatch.MAX_TRACEBACK_BYTES
                // dbatch.traceback_bytes(n1, n2)))
            group = []
            while i < len(idxs) and len(group) < cap and \
                    shapes[idxs[i]] == (n1, n2):
                group.append(idxs[i])
                i += 1
            buckets.append((group, n1, n2))
            self.cells_filled += len(group) * (n1 - 1) * (n2 - 1)
        self.pairs_aligned += len(idxs)

        inflight = [self._dispatch_group(group, refs, reads, n1, n2)
                    for group, n1, n2 in buckets]

        with self._t_lock:
            self.device_seconds += time.time() - t0

        def pulls():
            # lazy per-group pulls: align_pairs_raw expands one entry
            # while the next group's copy completes
            for entry in inflight:
                *head, host, event = entry
                with span("align.pull") as pull:
                    if event is not None:
                        event.synchronize()
                    fused_np = host.numpy() \
                        if isinstance(host, torch.Tensor) else host
                with self._t_lock:
                    self.device_seconds += pull.seconds
                yield tuple(head) + (fused_np,)
        return pulls()

    def expand_entry(self, entry):
        """Expand one pulled entry (align_pairs_entries) into per-group
        raw tuples (group, a_ref, a_read, valid, ops, n_ops, scores).
        Pure host numpy — safe to run on the writer thread so expansion
        overlaps the next chunk's parse + dispatch."""
        t1 = time.time()
        out = []

        def expand(group, packed, n_ops, scores, refs_host, reads_host):
            # trim to real rows and to the batch's longest op sequence:
            # T is padded to the worst case n1+n2-1, but typical
            # alignments use ~half — halves every expansion pass
            g = len(group)
            n_o = n_ops[:g]
            P = max(1, (int(n_o.max(initial=0)) + 3) // 4)
            ops = dbatch.unpack_ops(packed[:g, :P], P * 4)
            a_ref, a_read, valid = dbatch.ops_to_alignments_batch(
                ops, n_o, refs_host[:g], reads_host[:g])
            out.append((group, a_ref, a_read, valid, ops, n_o,
                        scores[:g]))

        _tag, group, refs_arr, reads_arr, T, fused = entry
        packed, n_ops, scores = dbatch.unfuse_result(fused)
        dbatch.check_marked_rows(n_ops[:len(group)])
        expand(group, packed, n_ops, scores, refs_arr, reads_arr)
        dt = time.time() - t1
        with self._t_lock:
            self.post_seconds += dt
        return out

    def align_pairs_raw(self, refs: List[bytes], reads: List[bytes]):
        """Expanded view of align_pairs_entries (see expand_entry)."""
        out = []
        for entry in self.align_pairs_entries(refs, reads):
            out.extend(self.expand_entry(entry))
        return out

    def align_pairs(self, refs: List[bytes], reads: List[bytes]
                    ) -> List[Tuple[bytes, bytes, List[Tuple[int, str]], float]]:
        """Per-pair (ref_aligned, read_aligned, cigar, score) view of
        align_pairs_raw, in input order."""
        results: List = [None] * len(refs)
        for group, a_ref, a_read, _valid, ops, n_ops, scores in \
                self.align_pairs_raw(refs, reads):
            t1 = time.time()
            cigars = dbatch.cigars_from_ops_batch(ops, n_ops)
            for j, k in enumerate(group):
                n = int(n_ops[j])
                results[k] = (a_ref[j, :n].tobytes(),
                              a_read[j, :n].tobytes(),
                              cigars[j],
                              float(scores[j]))
            dt = time.time() - t1
            with self._t_lock:
                self.post_seconds += dt
        return results

    def _dispatch_group(self, group, refs, reads, n1, n2):
        """Enqueue one group; returns ("single", group, refs_arr,
        reads_arr, T, host result, event or None)."""
        B = len(group)
        r0 = refs[group[0]]
        uniform_ref = all(refs[k] is r0 for k in group)
        refs_arr = np.zeros((B, n1 - 1), dtype=np.uint8)
        reads_arr = np.zeros((B, n2 - 1), dtype=np.uint8)
        ref_lens = np.zeros(B, dtype=np.int32)
        read_lens = np.zeros(B, dtype=np.int32)
        d0 = len(reads[group[0]])
        if uniform_ref and all(len(reads[k]) == d0 for k in group):
            # equal-length batch (the fixed-layout amplicon hot path):
            # one C-speed join + reshape instead of a per-read copy loop
            refs_arr[:, :len(r0)] = np.frombuffer(r0, dtype=np.uint8)
            reads_arr[:, :d0] = np.frombuffer(
                b"".join(reads[k] for k in group),
                dtype=np.uint8).reshape(B, d0)
            ref_lens[:] = len(r0)
            read_lens[:] = d0
        else:
            for j, k in enumerate(group):
                r, d = refs[k], reads[k]
                refs_arr[j, :len(r)] = np.frombuffer(r, dtype=np.uint8)
                reads_arr[j, :len(d)] = np.frombuffer(d, dtype=np.uint8)
                ref_lens[j] = len(r)
                read_lens[j] = len(d)
        # uniform-reference batch (the single-amplicon hot path): ship ONE
        # reference row; the fill reads it for every alignment
        dev_refs = refs_arr[:1] if uniform_ref else refs_arr
        host_args = [dev_refs, reads_arr, ref_lens, read_lens]
        if self.bandwidth is not None:
            bw = np.minimum(np.maximum(ref_lens, np.maximum(read_lens, 1)),
                            np.int32(self.bandwidth)).astype(np.int32)
            host_args += [bw, dbatch.band_centers_f64(ref_lens, read_lens,
                                                      n1)]
        T = n1 + n2
        self.dispatches += 1
        if self.stream is None:
            fused = self._launch([torch.from_numpy(a) for a in host_args],
                                 n1, n2)
            return "single", group, refs_arr, reads_arr, T, fused.numpy(), \
                None
        with torch.cuda.stream(self.stream):
            fused = self._launch([self._to_device(a) for a in host_args],
                                 n1, n2)
            host = torch.empty(fused.shape, dtype=torch.uint8,
                               pin_memory=True)
            host.copy_(fused, non_blocking=True)
            event = torch.cuda.Event()
            event.record(self.stream)
        return "single", group, refs_arr, reads_arr, T, host, event

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(a)
        if self.pinned_inputs:
            t = t.pin_memory()
        return t.to(self.device, non_blocking=True)

    def _launch(self, args, n1, n2):
        """align_batch on (refs, reads, ref_lens, read_lens[, bandwidth,
        band_centers]) tensors; returns the fused rows."""
        refs, reads, ref_lens, read_lens, *band = args
        bandwidth, band_centers = band or (None, None)
        fused, _tb = dbatch.align_batch(
            refs, reads, ref_lens, read_lens, self.params, n1=n1, n2=n2,
            special_mode=self.special_mode, bandwidth=bandwidth,
            band_centers=band_centers, stream=self.stream)
        return fused


@dataclass
class AlignStats:
    total: int = 0
    aligned: int = 0
    dropped_length: int = 0
    dropped_short: int = 0
    failed: int = 0


def align_reads(*args, **kwargs) -> AlignStats:
    """GC-controlled wrapper (see _align_reads_impl for the pipeline and
    the full signature): the align stage allocates millions of acyclic
    record objects, and cyclic-GC heap scans made it superlinear in
    dataset size (utils/gcctl.py)."""
    from clique_tpu_torch.utils.gcctl import hot_section

    with hot_section():
        return _align_reads_impl(*args, **kwargs)


def _align_reads_impl(
    layout: SequenceLayout,
    rm: ReferenceManager,
    output_path: str,
    read1: str,
    read2: Optional[str] = None,
    index1: Optional[str] = None,
    index2: Optional[str] = None,
    max_reference_multiplier: int = 2,
    min_read_length: int = 50,
    batch_size: int = 256,
    scoring: Optional[AffineScoring] = None,
    single_ref_native: bool = False,
    quick_match_threshold: float = 0.90,
    mode: str = "ont",
    router: str = "kmer",
    engine: Optional[str] = None,
    anchored_min_length: int = 2048,
    metrics_path: Optional[str] = None,
    profile_dir: Optional[str] = None,
    bandwidth: Optional[int] = None,
    read_shard: Optional[Tuple[int, int]] = None,
    sink=None,
    device="cuda",
) -> AlignStats:
    """The `clique align` equivalent (alignment_functions.rs:63-257).

    mode: "ont" (reference-compatible scoring) or "hifi" (PacBio low-error
    preset, BASELINE config 2). router: "kmer" (unique-kmer vote, the
    reference's quick_alignment_search) or "hmm" (pair-HMM forward routing
    over several references, align/hmm.py, on `device`; with one
    reference nothing is routed).

    anchored_min_length: reads at least this long (and passing the
    max_reference_multiplier gate) take the anchored seed-and-extend path:
    exact anchors from the reference's seed index on the host
    (align/anchored.py::AnchoredBatchAligner), every inter-anchor
    sub-DP of a flush batched through one full-band BatchAligner with the
    engine's own scoring, written after the flush's other reads.

    bandwidth: half-width of a partial band around the f64 band centers
    (alignment_matrix.rs:376-425) for the main aligner; None is the full
    band, as every reference call site passes.

    engine: "dp" (or None), the exact 3-plane affine DP; "wfa", the
    wavefront engine with traceback (align/wavefront.py::WfaAligner, the
    DP as its fallback); "convex", the same engine under the dual-affine
    penalties. Scores on the wavefront engines are negated penalties, and
    the exhaustive search screens candidates by penalty (last minimum
    wins).

    read_shard: (rank, world) — process only the read chunks dealt to this
    rank (chunks of _SHARD_CHUNK read sets, round-robin by chunk index:
    a deterministic disjoint cover). The multi-process align
    (parallel/distributed.py:align_distributed) gives each process one
    shard and merges the per-process part BAMs; stats then cover the
    LOCAL slice only.

    profile_dir: a torch.profiler trace of the run (CPU activity, and the
    card's with a CUDA device), written there as a Chrome trace when the
    run ends; the span of the JAX package's jax.profiler.trace.

    sink: optional CollapseSink (chain.py), the fused chain's
    tap on the record stream: a sink thread feeds it every flush in BAM
    record order (consume_flush, or consume_aligned for exhaustive-search
    reads), so collapse ingestion is done when align_reads returns. The
    JAX version's single-threaded writer (pipeline_threads=False) and its
    environment knobs are not carried over.

    device: where the DP runs ("cuda", "cuda:N" or "cpu"); the metrics
    JSON names it and counts the kernel launches."""
    if engine is None:
        engine = "dp"
    if engine not in ("dp", "wfa", "convex"):
        raise ValueError(f"unknown engine {engine!r}")
    if router not in ("kmer", "hmm"):
        raise ValueError(f"unknown router {router!r}")
    if scoring is None:
        scoring = AffineScoring.hifi_default() if mode == "hifi" \
            else AffineScoring.aligner_default()
    stats = AlignStats()
    flush_factor = FLUSH_FACTOR
    max_read_size = (rm.longest_ref + 1) * max_reference_multiplier
    single_ref = len(rm.references) == 1
    use_hmm = router == "hmm" and not single_ref

    if single_ref and not single_ref_native and engine == "dp":
        aligner = BatchAligner(RUST_BIO_COMPAT, batch_size,
                               special_mode="ref_n_only", device=device,
                               bandwidth=bandwidth)
        report_zero_score = True   # the reference reports 0.0 here (:579)
    else:
        aligner = BatchAligner(scoring, batch_size, device=device,
                               bandwidth=bandwidth, pinned_inputs=use_hmm)
        report_zero_score = False
    dp_fallback = None
    if engine in ("wfa", "convex"):
        dp_fallback = aligner
        aligner = WfaAligner(
            batch_size=batch_size, dp_fallback=aligner,
            model="affine2p" if engine == "convex" else "affine",
            device=device)
    merge_aligner = BatchAligner(MERGE_SCORING, batch_size, device=device)
    hmm_router = None
    if use_hmm:
        # on the aligner's stream: a flush's DP kernels queue behind the
        # route call launched before it instead of sharing the card with it
        hmm_router = hmm.HmmRouter(
            [r.sequence for r in rm.references.values()], device=device,
            stream=aligner.stream)
    launches0 = (dp_kernels.align_launches,
                 dict(dp_kernels.fill_mode_launches),
                 hmm.hmm_forward_launches, wfa_kernels.wfa_align_launches,
                 wfa_kernels.wfa_score_launches, wfa_kernels.wfa_mid_launches)

    profiler = _start_profiler(profile_dir, aligner.device)

    with trace.recording(tracing=profiler is not None) as recorder, \
            span("align.run"):
        references = [(r.name, len(r.sequence))
                      for r in rm.references.values()]
        writer = open_alignment_writer(output_path, references)
        start = time.time()

        # two-stage writer pipeline: a BUILD thread does record construction
        # (numpy-heavy), feeding a WRITER thread doing BAM encode + BGZF
        # compression (C paths that release the GIL). Both overlap the main
        # thread's parse/dispatch, and construction of flush N overlaps
        # compression of flush N-1 instead of serializing on one thread.
        import queue
        import threading

        write_queue: "queue.Queue" = queue.Queue(maxsize=8)
        encode_queue: "queue.Queue" = queue.Queue(maxsize=8)
        writer_error: List[BaseException] = []
        bam_ref_idx = {rid: i for i, rid in enumerate(rm.references.keys())}
        writer_encoded_ok = hasattr(writer, "write_encoded")

        # collapse ingestion (sink) on its own thread, fed by the build thread:
        # one FIFO consumer, so the sink sees flushes in BAM record order and
        # its state is touched only by this thread until the join
        sink_queue: "queue.Queue" = queue.Queue(maxsize=8)

        def _sink_loop():
            while True:
                item = sink_queue.get()
                if item is None:
                    return
                with span("align.sink"):
                    try:
                        if item[0] == "flush":
                            _t, raws_, pend_, recs_, caps_, cig_, slen_ = item
                            sink.consume_flush(raws_, pend_, recs_,
                                               caps=caps_, cigars_by_k=cig_,
                                               seq_len_by_k=slen_)
                        else:          # ("aligned", aligned_out, recs)
                            sink.consume_aligned(item[1], item[2])
                    except BaseException as exc:  # surfaced on close
                        writer_error.append(exc)

        def _to_sink(item):
            # a full sink queue blocks the build thread: its own span, so
            # align.build's self time is the build work alone
            with span("align.build_put"):
                sink_queue.put(item)

        def _build_one(item):
            """The writer thread's item for one drained item."""
            if item[0] == "raw":
                # deferred record construction, two forms. Fast path: the
                # native assembler builds the flush's BAM record bytes
                # straight from the batch blobs (no SamRecord objects /
                # tags dicts / per-record encode loop). Falls back to
                # per-record python construction for extractor-zone
                # symbols, mixed symbol orders, or no C compiler.
                _tag, raws, pend = item
                fast = None
                if writer_encoded_ok:
                    syms = _flush_fastpath_syms(pend, layout, rm)
                    if syms is not None:
                        fast = _encode_flush_fastpath(
                            raws, pend, layout, rm, report_zero_score,
                            bam_ref_idx, syms, for_sink=sink is not None)
                if fast is not None:
                    # native-encoder path: no SamRecords exist, the sink
                    # takes the cigars and sequence lengths
                    data, caps_g, cig_by_k, slen_by_k = fast
                    if sink is not None:
                        _to_sink(("flush", raws, pend, None, caps_g,
                                  cig_by_k, slen_by_k))
                    return ("encoded", data, len(pend))
                recs: List = [None] * len(pend)
                caps: Optional[List] = [] if sink is not None else None
                for raw in raws:
                    _fill_records_from_raw(raw, pend, recs, layout, rm,
                                           report_zero_score, out_caps=caps)
                if sink is not None:
                    _to_sink(("flush", raws, pend, recs, caps, None, None))
                return recs
            # ("aligned", [AlignedRead]): exhaustive search
            recs = [_make_record(alr, layout) for alr in item[1]]
            if sink is not None:
                _to_sink(("aligned", item[1], recs))
            return recs

        def _build_loop():
            while True:
                item = write_queue.get()
                if item is None:
                    encode_queue.put(None)
                    return
                with span("align.build"):
                    try:
                        item = _build_one(item)
                    except BaseException as exc:  # surfaced on close
                        writer_error.append(exc)
                        item = []
                encode_queue.put(item)

        def _writer_loop():
            while True:
                item = encode_queue.get()
                if item is None:
                    return
                with span("align.write"):
                    try:
                        if isinstance(item, tuple) and item and \
                                item[0] == "encoded":
                            writer.write_encoded(item[1], item[2])
                        elif hasattr(writer, "write_batch"):
                            writer.write_batch(item)
                        else:
                            for rec in item:
                                writer.write(rec)
                    except BaseException as exc:  # surfaced on close
                        writer_error.append(exc)

        # third pipeline stage: a DRAIN thread pulls device results (event
        # waits) and runs the numpy expansion (expand_entry) off the main
        # thread, so expansion overlaps the next chunk's parse + dispatch. A
        # single FIFO queue preserves output record order; maxsize bounds
        # undrained flushes (fused result buffers in flight).
        drain_queue: "queue.Queue" = queue.Queue(maxsize=4)

        def _drain_loop():
            while True:
                item = drain_queue.get()
                if item is None:
                    write_queue.put(None)
                    return
                with span("align.drain"):
                    try:
                        if item[0] == "entries":
                            _tag, entries, pend = item
                            raws = []
                            for entry in entries:
                                raws.extend(aligner.expand_entry(entry))
                            write_queue.put(("raw", raws, pend))
                        else:          # ("fwd", payload): ordered passthrough
                            write_queue.put(item[1])
                    except BaseException as exc:  # surfaced on close
                        writer_error.append(exc)

        threads = [threading.Thread(target=recorder.bind(fn), daemon=True)
                   for fn in (_build_loop, _writer_loop, _drain_loop)]
        sink_thread = threading.Thread(target=recorder.bind(_sink_loop),
                                       daemon=True) \
            if sink is not None else None
        for t in threads + ([sink_thread] if sink_thread else []):
            t.start()

        def emit_aligned(aligned_out):
            """Emit AlignedReads; record construction runs on the build thread,
            after every earlier flush (the drain queue keeps input order)."""
            drain_queue.put(("fwd", ("aligned", aligned_out)))

        reader = ReadIterator(read1, read2, index1, index2)
        needs_align_merge = layout.merge == MergeStrategy.ALIGN

        anchored_state: List = [None]
        n_anchored = [0]

        def _anchored_aligner():
            if anchored_state[0] is None:
                from clique_tpu_torch.align.anchored import AnchoredBatchAligner

                anchored_state[0] = AnchoredBatchAligner(
                    BatchAligner(scoring, batch_size, device=device), scoring)
            return anchored_state[0]

        def flush(pending: List[_Pending]):
            if not pending:
                return
            with span("align.flush"):
                _flush_inner(pending)

        def _flush_inner(pending: List[_Pending]):
            long_pending = []
            if not isinstance(aligner, WfaAligner):
                long_pending = [p for p in pending
                                if len(p.seq) >= anchored_min_length]
                if long_pending:
                    pending = [p for p in pending
                               if len(p.seq) < anchored_min_length]
            if pending and isinstance(aligner, WfaAligner):
                out = zip(pending, aligner.align_pairs(
                    [rm.references[p.ref_id].sequence for p in pending],
                    [p.seq for p in pending]))
                emit_aligned([AlignedRead(
                    read_name=p.name,
                    reference_name=rm.references[p.ref_id].name,
                    reference_aligned=a1, read_aligned=a2, quals=p.quals,
                    cigar=cigar, score=0.0 if report_zero_score else score,
                ) for p, (a1, a2, cigar, score) in out])
                stats.aligned += len(pending)
            elif pending:
                refs = [rm.references[p.ref_id].sequence for p in pending]
                reads = [p.seq for p in pending]
                # dispatch here (align_pairs_entries is eager about dispatch +
                # the async device->host copy, lazy about pulls), then hand the
                # pulls to the drain thread: event waits AND numpy expansion
                # leave the main thread. A full queue is backpressure (4
                # undrained flushes in flight), its own span
                entries = aligner.align_pairs_entries(refs, reads)
                stats.aligned += len(pending)
                with span("align.drain_put"):
                    drain_queue.put(("entries", entries, list(pending)))
            if long_pending:
                out = zip(long_pending, _anchored_aligner().align_pairs(
                    [rm.references[p.ref_id].sequence for p in long_pending],
                    [p.seq for p in long_pending],
                    indexes=[rm.references[p.ref_id].index
                             for p in long_pending]))
                # after the flush's other reads: the drain queue keeps order,
                # so the BAM holds the fast part, then the anchored part
                emit_aligned([AlignedRead(
                    read_name=p.name,
                    reference_name=rm.references[p.ref_id].name,
                    reference_aligned=a1, read_aligned=a2, quals=p.quals,
                    cigar=cigar, score=0.0 if report_zero_score else score,
                ) for p, (a1, a2, cigar, score) in out])
                stats.aligned += len(long_pending)
                n_anchored[0] += len(long_pending)
            if stats.aligned % 1_000_000 < len(pending) + len(long_pending):
                log.info("Time elapsed in aligning reads (%d) is: %.1fs",
                         stats.aligned, time.time() - start)

        pending: List[_Pending] = []
        merge_pending: List[Tuple[str, bytes, bytes, bytes, bytes]] = []
        exh_pending: List[Tuple[str, bytes, bytes, List[int]]] = []
        n_screened = [0]       # reads whose candidates the wavefront screen ranked
        route_pending: List[Tuple[str, bytes, bytes]] = []

        def flush_exhaustive():
            """Batched exhaustive search: every (candidate ref, read) pair of every
            queued read goes through ONE align_pairs call; per read the best score
            wins, Rust max_by keeping the LAST maximum on ties
            (exhaustive_alignment_search).

            On the wavefront engines every candidate is first screened by its
            penalty (wfa_screen_candidates, the score-only kernel), and only
            each read's winner (the last minimum) is aligned with traceback."""
            if not exh_pending:
                return
            refs: List[bytes] = []
            reads: List[bytes] = []
            spans: List[Tuple[int, int]] = []  # (start, count) into outs per read
            for _name, seq, _quals, cands in exh_pending:
                spans.append((len(refs), len(cands)))
                refs.extend(rm.references[i].sequence for i in cands)
                reads.extend([seq] * len(cands))

            if isinstance(aligner, WfaAligner):
                pens = wfa_screen_candidates(
                    refs, reads, x=aligner.x, o=aligner.o, e=aligner.e,
                    model=aligner.model, o2=aligner.o2, e2=aligner.e2,
                    device=aligner.device)
                n_screened[0] += len(exh_pending)
                winners = []
                for (_name, seq, _quals, _cands), (start, count) in zip(
                        exh_pending, spans):
                    best = 0
                    for i in range(count):
                        if pens[start + i] <= pens[start + best]:
                            best = i  # last minimum = last maximum of -penalty
                    winners.append(best)
                outs_w = aligner.align_pairs(
                    [refs[start + best] for (start, _c), best in
                     zip(spans, winners)], [e[1] for e in exh_pending])
                emit_aligned([AlignedRead(
                    read_name=name,
                    reference_name=rm.references[cands[best]].name,
                    reference_aligned=a1, read_aligned=a2, quals=quals,
                    cigar=cigar, score=score)
                    for (name, _seq, quals, cands), best, (a1, a2, cigar, score)
                    in zip(exh_pending, winners, outs_w)])
                stats.aligned += len(exh_pending)
                exh_pending.clear()
                return

            outs = aligner.align_pairs(refs, reads)
            aligned_out = []
            for (name, seq, quals, cands), (start, count) in zip(
                    exh_pending, spans):
                best = 0
                for i in range(count):
                    if outs[start + i][3] >= outs[start + best][3]:
                        best = i
                a1, a2, cigar, score = outs[start + best]
                aligned_out.append(AlignedRead(
                    read_name=name,
                    reference_name=rm.references[cands[best]].name,
                    reference_aligned=a1, read_aligned=a2,
                    quals=quals, cigar=cigar,
                    score=score))
            emit_aligned(aligned_out)
            stats.aligned += len(exh_pending)
            exh_pending.clear()

        # the route call in flight: (its reads, their sequences)
        route_inflight: List[Tuple[list, List[bytes]]] = []

        def flush_routes():
            """Launch the batched reads' route call, then collect the call
            before it: its forward pass ran while this thread parsed and
            prepared, and this call's runs while it picks and flushes."""
            if not route_pending:
                return
            seqs = [seq for _n, seq, _q in route_pending]
            hmm_router.launch(seqs)
            collect_routes()
            route_inflight.append((list(route_pending), seqs))
            route_pending.clear()

        def collect_routes():
            if not route_inflight:
                return
            batch, seqs = route_inflight.pop()
            routed = hmm_router.route(seqs)
            for (name, seq, quals), (ref_id, _ll) in zip(batch, routed):
                if ref_id < 0:
                    stats.failed += 1
                    continue
                pending.append(_Pending(name, seq, quals, ref_id))
            if len(pending) >= batch_size * flush_factor:
                flush(pending)
                pending.clear()

        def process_merged(name: str, seq: bytes, quals: bytes):
            if len(seq) >= max_read_size:
                log.warning(
                    "Dropped read %s as its length %d exceeds %dx the reference "
                    "length %d", name, len(seq), max_reference_multiplier,
                    rm.longest_ref)
                stats.dropped_length += 1
                return
            if len(seq) < min_read_length:
                # the reference parses --min-read-length (main.rs:183-185) but
                # binds it `_min_read_length` and never gates on it
                # (alignment_functions.rs:532) - we enforce the documented
                # intent and drop short reads
                log.warning(
                    "Dropped read %s as its length %d is below the minimum "
                    "read length %d", name, len(seq), min_read_length)
                stats.dropped_short += 1
                return
            if hmm_router is not None:
                route_pending.append((name, seq, quals))
                if len(route_pending) >= batch_size * 4:
                    flush_routes()
                return
            ref_id = _choose_reference(rm, layout, seq, quick_match_threshold)
            if ref_id is None:
                stats.failed += 1
                return
            if isinstance(ref_id, list):
                # exhaustive search: batched below - align against every candidate,
                # best score wins (see flush_exhaustive)
                exh_pending.append((name, seq, quals, ref_id))
                if sum(len(e[3]) for e in exh_pending) >= \
                        batch_size * flush_factor:
                    flush_exhaustive()
                return
            # orientation for single reference without known strand
            if single_ref and not layout.known_strand:
                ref = rm.references[ref_id]
                fwd, _f, _r = orient_by_longest_segment(
                    seq, ref.sequence, ref.index)
                if not fwd:
                    seq = reverse_complement(seq)
                    quals = quals[::-1]
            pending.append(_Pending(name, seq, quals, ref_id))
            # accumulate several device batches so align_pairs can keep multiple
            # dispatches in flight (overlapping transfer with compute)
            if len(pending) >= batch_size * flush_factor:
                flush(pending)
                pending.clear()

        def flush_merges():
            if not merge_pending:
                return
            r1s = [m[1] for m in merge_pending]
            r2s = [m[3] for m in merge_pending]
            out = merge_aligner.align_pairs(r1s, r2s)
            for (name, _r1, q1, _r2, q2), (a1, a2, _cigar, _score) in zip(
                    merge_pending, out):
                seq, quals = alignment_rate_and_consensus(a1, q1, a2, q2)
                process_merged(name, seq, quals)
            merge_pending.clear()

        # Fast path: with only a read1 stream, unify_read reduces to an
        # orientation passthrough unless the layout concatenates Read1 with
        # Spacers (merger.rs:278-294); for Forward orientation the container +
        # decision-tree hop per read is pure overhead, so feed the records
        # straight into process_merged. Semantics identical to the general
        # loop (quals are NOT reversed in the R1-only branch either way).
        declared_kinds = {p.kind for p in layout.reads if p.kind != "Spacer"}
        concat_single = (layout.merge in (MergeStrategy.CONCATENATE,
                                          MergeStrategy.CONCATENATE_BOTH_FORWARD)
                         and declared_kinds <= {"Read1"})
        r1_orientation = next(
            (p.orientation for p in layout.reads if p.kind == "Read1"),
            AlignedReadOrientation.FORWARD)

        def _shard_filter(it):
            """Yield only this rank's read chunks (see read_shard docstring)."""
            if read_shard is None:
                return it
            rank, world = read_shard

            def gen():
                for i, item in enumerate(it):
                    if (i // _SHARD_CHUNK) % world == rank:
                        yield item
            return gen()

        # the parse loop: its self time is the reader (parse, length gates,
        # batching), its children the route calls and the flushes
        with span("align.read"):
            if (reader.single_stream and "Read1" in declared_kinds
                    and not concat_single
                    and r1_orientation == AlignedReadOrientation.FORWARD):
                for rec in _shard_filter(reader.read_one_records()):
                    stats.total += 1
                    process_merged(rec.name, rec.seq, rec.qual)
            else:
                for rsc in _shard_filter(reader):
                    stats.total += 1
                    merged = unify_read(rsc, layout,
                                        defer_align_merge=needs_align_merge)
                    if merged.pending_pair is not None:
                        r1, q1, r2, q2 = merged.pending_pair
                        merge_pending.append((merged.name, r1, q1, r2, q2))
                        if len(merge_pending) >= batch_size * flush_factor:
                            flush_merges()
                    else:
                        process_merged(merged.name, merged.seq, merged.quals)

        with span("align.tail"):
            flush_merges()
            if hmm_router is not None:
                flush_routes()
                collect_routes()
            flush_exhaustive()
            flush(pending)
        with span("align.join"):
            # the drain thread forwards the None to the build thread, which
            # forwards it to the writer thread
            drain_queue.put(None)
            for t in threads:
                t.join()
            if sink_thread is not None:
                # the build thread has exited: every sink item is enqueued
                sink_queue.put(None)
                sink_thread.join()
                sink.seconds = recorder.seconds("align.sink")
            if writer_error:
                raise writer_error[0]
            writer.close()
        if hasattr(writer, "chunk_offsets"):
            # chunk-index sidecar: lets distributed collapse deal byte ranges
            # of this BAM (each process inflates only its share)
            from clique_tpu_torch.io.sam import write_cqi

            write_cqi(output_path, writer.chunk_offsets)
    if profiler is not None:
        _stop_profiler(profiler, profile_dir)
    elapsed = time.time() - start
    log.info("Aligned %d/%d reads in %.1fs", stats.aligned, stats.total,
             elapsed)
    if metrics_path:
        import json

        spans = recorder.tallies()
        inner = anchored_state[0].inner if anchored_state[0] else None
        with open(metrics_path, "w") as fh:
            json.dump({
                "engine": engine,
                "wfa_dp_fallbacks": aligner.fallbacks
                if isinstance(aligner, WfaAligner) else None,
                # pairs the wavefront engine finished on its bialign engine
                "wfa_bialign_pairs": aligner.bialign_pairs
                if isinstance(aligner, WfaAligner) else None,
                "total_reads": stats.total,
                "aligned": stats.aligned,
                "dropped_length": stats.dropped_length,
                "dropped_short": stats.dropped_short,
                "failed": stats.failed,
                "elapsed_s": round(elapsed, 3),
                "reads_per_s": round(stats.aligned / elapsed, 1)
                if elapsed else None,
                # a host clock of the main aligner's dispatches and event
                # waits, not device time (the card's time is the
                # profiler's)
                "device_seconds": round(aligner.device_seconds, 3),
                "host_post_seconds": round(aligner.post_seconds, 3),
                # views of the spans below (_PHASE_SPANS)
                "phase_walls": _phase_walls(spans),
                # per span name: count, seconds, self seconds
                "spans": spans,
                # views of the wavefront engine's spans (_WFA_PHASE_SPANS)
                "wfa_phase_seconds": {
                    key: round(spans[name]["s"], 3) if name in spans else 0.0
                    for key, name in _WFA_PHASE_SPANS}
                if isinstance(aligner, WfaAligner) else None,
                # reads of the exhaustive search that the wavefront screen
                # ranked (the score-only kernel's reads)
                "wfa_screened_reads": n_screened[0],
                "pairs_aligned": aligner.pairs_aligned,
                "dp_cells_filled": aligner.cells_filled,
                "device": torch.cuda.get_device_name(aligner.device)
                if aligner.device.type == "cuda" else "cpu",
                "bam_codec": bam_codec(),
                # group dispatches of both aligners, and the kernel
                # launches of this run (0 on a CPU device, where the plain
                # PyTorch versions run)
                "dispatches": aligner.dispatches + merge_aligner.dispatches
                + (inner.dispatches if inner else 0)
                + (dp_fallback.dispatches if dp_fallback else 0),
                "kernel_launches": {
                    "dp_align": dp_kernels.align_launches - launches0[0],
                    "dp_fill_modes": {
                        k: v - launches0[1][k] for k, v in
                        dp_kernels.fill_mode_launches.items()},
                    "hmm_forward": hmm.hmm_forward_launches - launches0[2],
                    "wfa_align": wfa_kernels.wfa_align_launches
                    - launches0[3],
                    "wfa_score": wfa_kernels.wfa_score_launches
                    - launches0[4],
                    "wfa_mid": wfa_kernels.wfa_mid_launches
                    - launches0[5]},
                "router": "hmm" if hmm_router is not None else "kmer",
                # the router's forward passes, and those launched while the
                # call before was still in flight
                "route_calls": hmm_router.calls if hmm_router else 0,
                "route_calls_overlapped": hmm_router.calls_overlapped
                if hmm_router else 0,
                # the wavefront engine's lanes launched on its rung ladder
                # and those of them censored, the bialign engine's split
                # levels and the segments it sent to leaf chunks, and the
                # CIGARs of its wfa_align lanes built on the card or by the
                # plain host replay
                **{f"wfa_{k}": getattr(aligner, k)
                   if isinstance(aligner, WfaAligner) else None
                   for k in ("rung_lanes", "rung_lanes_censored",
                             "mid_levels", "leaf_pairs", "cigars_from_card",
                             "cigars_replayed")},
                "bandwidth": bandwidth,
                # the anchored path: its reads, their inter-anchor sub-DPs,
                # the DP cells those filled and its aligner's device wait
                "anchored": {
                    "reads": n_anchored[0],
                    "sub_dps": inner.pairs_aligned if inner else 0,
                    "dp_cells_filled": inner.cells_filled if inner else 0,
                    "dispatches": inner.dispatches if inner else 0,
                    "device_seconds": round(inner.device_seconds, 3)
                    if inner else 0.0},
            }, fh, indent=2)
    return stats


# the metrics JSON's phase walls as views of the run's spans: (key, span,
# self time). reader_wall: the parse loop with its nested route calls and
# flushes; flush_wall: inside flush(); drain_wall: waits for room in the
# drain queue; tail/join: the post-loop flushes and the threads' join;
# *_busy: each thread's items (build_busy without its waits for room in
# the sink queue), present when the thread had any
_PHASE_SPANS = (("reader_wall", "align.read", False),
                ("flush_wall", "align.flush", False),
                ("drain_wall", "align.drain_put", False),
                ("tail_wall", "align.tail", False),
                ("join_wall", "align.join", False),
                ("drain_busy", "align.drain", False),
                ("build_busy", "align.build", True),
                ("write_busy", "align.write", False),
                ("sink_busy", "align.sink", False))


# wfa_phase_seconds' keys and the spans they read: dispatch = host prep and
# kernel enqueue; score_sync = waits for a chunk's results; window_pull =
# skeleton decode; host_walk = CIGAR replay on the host; bialign = the
# bialign engine's runs, splits and leaves
_WFA_PHASE_SPANS = (("dispatch", "wfa.round"), ("score_sync", "wfa.wait"),
                    ("window_pull", "wfa.decode"),
                    ("host_walk", "wfa.replay"), ("bialign", "wfa.bialign"))


def _phase_walls(spans: Dict[str, Dict[str, float]]) -> Dict[str, float]:
    """The metrics JSON's `phase_walls` from its `spans`."""
    out = {}
    for key, name, self_time in _PHASE_SPANS:
        t = spans.get(name)
        if t is not None or key.endswith("_wall"):
            out[key] = round(t["self_s" if self_time else "s"], 3) \
                if t is not None else 0.0
    return out


def _start_profiler(profile_dir: Optional[str], device: torch.device):
    """A running torch.profiler over the CPU of every thread and, on a CUDA
    device, the card (the JAX package's jax.profiler.trace span), or None.
    A torch without the all-threads option traces the starting thread
    alone, and the pipeline threads' spans are missing from the trace."""
    if not profile_dir:
        return None
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(profile_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities,
                   experimental_config=all_threads_config())
    prof.start()
    return prof


@functools.lru_cache(maxsize=1)
def all_threads_config():
    """The profiler's config that records every thread's ranges, or None
    (logged once) where this torch has no such option."""
    try:
        return torch._C._profiler._ExperimentalConfig(
            profile_all_threads=True)
    except (AttributeError, TypeError):
        log.warning("this torch cannot profile every thread: traces miss "
                    "the drain, build, write and sink spans")
        return None


def _stop_profiler(prof, profile_dir: str) -> None:
    """Stop the profiler and write its Chrome trace into profile_dir."""
    prof.stop()
    path = os.path.join(profile_dir, f"align.{os.getpid()}.pt.trace.json")
    prof.export_chrome_trace(path)
    log.info("wrote a torch.profiler trace to %s", path)


def _choose_reference(rm: ReferenceManager, layout: SequenceLayout,
                      seq: bytes, threshold: float):
    """Reference routing (align_to_reference_choices / quick_alignment_search).

    Returns an int ref id, a list of candidate ids (exhaustive search), or
    None when no reference exists."""
    n = len(rm.references)
    if n == 0:
        return None
    if n == 1:
        return next(iter(rm.references))
    votes = rm.vote_references(seq)
    total = sum(votes.values())
    if total == 0:
        return list(rm.references.keys())
    ref, count = votes.most_common(1)[0]
    if count / total > threshold:
        return ref
    return list(votes.keys())


def _fill_records_from_raw(raw, pending: List[_Pending], records: List,
                           layout: SequenceLayout, rm: ReferenceManager,
                           report_zero_score: bool,
                           out_caps: Optional[List] = None) -> None:
    """Build SamRecords for one align_pairs_raw group with batch-level
    numpy (rates, gap-strips, digit-tag captures and cigars computed over
    the whole [G, T] matrices at once). Semantics identical to
    _make_record + AlignedRead.to_sam_record. `out_caps` receives the
    group's digit-capture arrays {symbol: (cnt, flat, bounds)}, which the
    CollapseSink reuses."""
    group, a_ref, a_read, valid, ops, n_ops, scores = raw

    # alignment rate over letter columns (consensus_builders.rs:288-307)
    from clique_tpu_torch.extract.extractor import alignment_rates_rows

    rates = alignment_rates_rows(a_ref, a_read).tolist()

    # gap-stripped read sequences (to_sam_record strips gaps, qual 'H')
    keep = valid & (a_read != GAP)
    seq_bounds = np.concatenate(
        ([0], np.cumsum(keep.sum(axis=1)))).tolist()
    seq_flat = a_read[keep]

    cigars = dbatch.cigars_from_ops_batch(ops, n_ops)

    # digit-wildcard captures, one flat mask pass per symbol present in any
    # row's reference (a digit byte only occurs in the owning reference's
    # aligned row, so the union mask is exact per row)
    union_syms: set = set()
    for rid in {pending[k].ref_id for k in group}:
        ref_cfg = layout.references.get(rm.references[rid].name)
        if ref_cfg is not None:
            union_syms.update(u.symbol
                              for u in ref_cfg.umi_configurations.values()
                              if u.symbol.isdigit())
    union_digit = sorted(union_syms)
    digit_hits = {}
    caps_np = {}
    for sym in union_digit:
        mask = (a_ref == ord(sym)) & valid
        cnt = mask.sum(axis=1)
        flat = a_read[mask]
        bounds = np.concatenate(([0], np.cumsum(cnt)))
        digit_hits[sym] = (cnt.tolist(), flat, bounds.tolist())
        caps_np[sym] = (cnt, flat, bounds)
    if out_caps is not None:
        out_caps.append(caps_np)

    scores_l = scores.tolist()
    for j, k in enumerate(group):
        p = pending[k]
        ref = rm.references[p.ref_id]
        ref_cfg = layout.references.get(ref.name)
        tags: Dict[str, str] = {}
        if ref_cfg is not None:
            for u in ref_cfg.umi_configurations.values():
                sym = u.symbol
                if sym.isdigit():
                    cnt, flat, bounds = digit_hits[sym]
                    if cnt[j]:
                        tags[f"e{sym}"] = \
                            flat[bounds[j]:bounds[j + 1]].tobytes().decode()
                else:
                    n = int(n_ops[j])
                    extracted = extract_tagged_sequences(
                        a_read[j, :n].tobytes(), a_ref[j, :n].tobytes())
                    hit = extracted.get(ord(sym))
                    if hit is not None:
                        tags[f"e{sym}"] = hit
        tags["rc"] = "1"
        tags["ar"] = p.name
        tags["rm"] = _fmt(rates[j])
        score = 0.0 if report_zero_score else float(scores_l[j])
        tags["rs"] = _fmt(score)
        tags["as"] = _fmt(score)
        seq = seq_flat[seq_bounds[j]:seq_bounds[j + 1]].tobytes()
        records[k] = SamRecord(
            name=p.name, flag=0, reference_name=ref.name, pos=1, mapq=255,
            cigar=cigars[j], seq=seq, qual=b"H" * len(seq), tags=tags)


def _flush_fastpath_syms(pend, layout: SequenceLayout,
                         rm: ReferenceManager):
    """Fast-path eligibility for a flush: every reference present must
    share ONE ordered, all-digit UMI symbol tuple (or have no config).
    Returns that tuple, or None when ineligible (mixed orders or
    extractor-zone symbols need the per-record python path)."""
    syms_tuple = None
    for rid in {p.ref_id for p in pend}:
        cfg = layout.references.get(rm.references[rid].name)
        if cfg is None:
            continue
        t = tuple(u.symbol for u in cfg.umi_configurations.values())
        if any(not s.isdigit() for s in t):
            return None
        if syms_tuple is None:
            syms_tuple = t
        elif t != syms_tuple:
            return None
    return syms_tuple or ()


def _encode_flush_fastpath(raws, pend, layout: SequenceLayout,
                           rm: ReferenceManager, report_zero_score: bool,
                           bam_ref_idx: Dict[int, int], syms,
                           for_sink: bool = False):
    """Assemble a whole flush's BAM record-stream bytes through the native
    fast-path encoder (encode_fastpath_records in native/bamcodec.c): no
    SamRecord objects, no tags dicts, no per-record encode loop — the
    byte output is identical to _fill_records_from_raw +
    encode_records_bytes (pinned by the golden tests).

    Returns (encoded bytes, digit captures per group, cigar per read, gap-
    stripped length per read): with `for_sink` the last three are filled
    for the CollapseSink, since no SamRecord exists on this path. Returns
    None when the native lib is unavailable (callers fall back to the
    python record path)."""
    import ctypes

    from clique_tpu_torch.native import get_lib

    lib = get_lib()
    if lib is None:
        return None
    syms_b = "".join(syms).encode()
    n_total = len(pend)
    bufs = []                    # per group: (group, buffer, rec_off)
    caps_by_group = []
    cigars_by_k: List = [None] * n_total
    seq_len_by_k = [0] * n_total
    for raw in raws:
        group, a_ref, a_read, valid, ops, n_ops, scores = raw
        g = len(group)

        from clique_tpu_torch.extract.extractor import alignment_rates_rows

        rates = alignment_rates_rows(a_ref, a_read).tolist()

        keep = valid & (a_read != GAP)
        seq_lens = keep.sum(axis=1)
        seq_off = np.zeros(g + 1, dtype=np.int64)
        np.cumsum(seq_lens, out=seq_off[1:])
        seq_flat = np.ascontiguousarray(a_read[keep])

        counts, opcodes, cbounds = dbatch.cigar_runs_from_ops_batch(
            ops, n_ops)
        if for_sink:
            for j, (k, cig) in enumerate(zip(group, dbatch.cigars_from_runs(
                    counts, opcodes, cbounds))):
                cigars_by_k[k] = cig
                seq_len_by_k[k] = int(seq_lens[j])

        caps_np = {}
        cap_parts = []
        cap_base = np.zeros(max(len(syms), 1), dtype=np.int64)
        cap_bounds = np.zeros((max(len(syms), 1), g + 1), dtype=np.int64)
        base = 0
        for si, sym in enumerate(syms):
            mask = (a_ref == ord(sym)) & valid
            cnt = mask.sum(axis=1)
            flat = np.ascontiguousarray(a_read[mask])
            bounds = np.zeros(g + 1, dtype=np.int64)
            np.cumsum(cnt, out=bounds[1:])
            cap_parts.append(flat)
            cap_base[si] = base
            cap_bounds[si] = bounds
            base += len(flat)
            caps_np[sym] = (cnt, flat, bounds)
        caps_by_group.append(caps_np)
        cap_blob = (b"".join(p.tobytes() for p in cap_parts)
                    if cap_parts else b"")

        names = [pend[k].name for k in group]
        name_blob = "".join(names).encode()
        name_off = np.zeros(g + 1, dtype=np.int64)
        np.cumsum([len(nm) for nm in names], out=name_off[1:])

        rm_strs = [_fmt(r) for r in rates]
        rm_blob = "".join(rm_strs).encode()
        rm_off = np.zeros(g + 1, dtype=np.int64)
        np.cumsum([len(s) for s in rm_strs], out=rm_off[1:])
        if report_zero_score:
            sc_strs = ["0"] * g
        else:
            sc_strs = [_fmt(float(s)) for s in scores.tolist()]
        sc_blob = "".join(sc_strs).encode()
        sc_off = np.zeros(g + 1, dtype=np.int64)
        np.cumsum([len(s) for s in sc_strs], out=sc_off[1:])

        ref_ids = np.array([bam_ref_idx[pend[k].ref_id] for k in group],
                           dtype=np.int32)

        cap = int(48 * g + 2 * len(name_blob) + 4 * len(counts)
                  + 2 * int(seq_off[-1]) + len(cap_blob) + len(rm_blob)
                  + 2 * len(sc_blob) + (4 * len(syms) + 30) * g + 64)
        out = ctypes.create_string_buffer(cap)
        rec_off = np.zeros(g + 1, dtype=np.int64)
        written = lib.encode_fastpath_records(
            g, ref_ids.ctypes.data,
            name_blob, name_off.ctypes.data,
            counts.ctypes.data, opcodes.ctypes.data, cbounds.ctypes.data,
            seq_flat.ctypes.data_as(ctypes.c_char_p), seq_off.ctypes.data,
            len(syms), syms_b,
            cap_blob, cap_base.ctypes.data, cap_bounds.ctypes.data,
            rm_blob, rm_off.ctypes.data,
            sc_blob, sc_off.ctypes.data,
            out, cap, rec_off.ctypes.data)
        if written < 0:
            raise RuntimeError("fastpath encode capacity underestimated")
        bufs.append((group, out.raw[:written], rec_off))

    # assemble in pend (BAM write) order; groups are usually contiguous
    # ascending (uniform-shape flushes), where a straight join suffices
    order = np.concatenate([np.asarray(g_, dtype=np.int64)
                            for g_, _b, _o in bufs])
    if np.array_equal(order, np.arange(n_total, dtype=np.int64)):
        data = b"".join(b for _g, b, _o in bufs)
    else:
        where = {}
        for gi, (group, _b, _o) in enumerate(bufs):
            for j, k in enumerate(group):
                where[k] = (gi, j)
        views = [memoryview(b) for _g, b, _o in bufs]
        parts = []
        for k in range(n_total):
            gi, j = where[k]
            off = bufs[gi][2]
            parts.append(views[gi][int(off[j]):int(off[j + 1])])
        data = b"".join(parts)
    return data, caps_by_group, cigars_by_k, seq_len_by_k


def _make_record(aligned: AlignedRead, layout: SequenceLayout) -> SamRecord:
    ref_cfg = layout.references.get(aligned.reference_name)
    tags: Dict[str, str] = {}
    if ref_cfg is not None:
        symbols = [u.symbol for u in ref_cfg.umi_configurations.values()]
        digit_syms = [s for s in symbols if s.isdigit()]
        extracted_fast = extract_digit_tags_fast(
            aligned.read_aligned, aligned.reference_aligned, digit_syms)
        for sym in digit_syms:
            hit = extracted_fast.get(sym)
            if hit is not None:
                tags[f"e{sym}"] = hit
        non_digit = [s for s in symbols if not s.isdigit()]
        if non_digit:
            extracted = extract_tagged_sequences(
                aligned.read_aligned, aligned.reference_aligned)
            for sym in non_digit:
                hit = extracted.get(ord(sym))
                if hit is not None:
                    tags[f"e{sym}"] = hit
    tags["rc"] = "1"
    tags["ar"] = aligned.read_name
    return aligned.to_sam_record(tags)
