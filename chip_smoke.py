#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (clique_tpu_torch) on one GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from clique_tpu_torch/csrc/, checks
each against its plain PyTorch version on the card, and drives the port's
paths on the card, each with the kernels' launch counts set to 0 just
before and read just after:

- golden: align -> collapse -> call on tests/data/golden{,_pe,_ml}
  reproduces the pinned BAMs and allele tables, and the fused run_chain
  gives the same bytes; golden aligned with --engine wfa and convex
  reproduces tests/data/golden/aligned_{wfa,convex}.bam;
- hifi: bench_extra.py's config 2, 200 cells x 40 reads of a ~342 bp
  amplicon at 0.5% substitutions through --mode hifi --engine wfa
  (wfa_align), then collapse; every written CIGAR's penalty equals its
  score, and the first 64 reads' BAM is the same on the card as on the
  CPU; every wfa_align launch of the run is held against its plain
  version, and the largest timed (the kernels line's wfa_align);
- convex: bench_extra.py's structural-variant config, 6,000 reads, every
  other one with a 30-80 bp dropout, through --engine convex: the share
  of dropouts kept as one D run, every CIGAR's dual-affine penalty, the
  64-read head against the CPU; every wfa_align launch against its plain
  version;
- screen: 4,000 reads over two amplicons whose unique-kmer vote splits,
  --engine wfa: every read takes the exhaustive search, wfa_score
  screens its candidates (one warp a pair), and it routes to its true
  reference; every wfa_score launch of the run is held against its plain
  version on its own pairs, and the largest timed (the kernels line's
  wfa_score);
- ont-raw: 1,000 reads of the long-read phases' 4 kb reference at ONT
  raw-read error rates (5% substitutions, 2.5% each of 1-3 bp deletions
  and insertions) through --engine wfa at batch 1,024: censored at the
  1,024 and 2,048 rungs, every read finishes on the bialign engine
  (wfa_mid splits, wfa_align leaves); every CIGAR's penalty equals its
  score, the first 8 reads' BAM is the same on the card as on the CPU,
  every wfa_mid launch is held against its plain version and the level-0
  top-rung launch timed (the kernels line's wfa_mid); one wfa_align
  launch of each shape (a chunk of each censored rung, a bialign leaf
  chunk) held, timed and bounded, and the bialign wall split into its
  kernels' time (CUDA events) and the host's;
- known list: the bench-shaped reads collapsed against a 737,280-entry
  allowlist (KnownTag Hamming at the size of 10x Chromium v2's list): one
  match_hits launch for the level's one hamming_hits call, the collapse
  wall split into allowlist read, upload, packing, kernel and host hit
  assembly, and the kernel timed on that call's own tags;
- device Levenshtein: one DegenerateTag group with 3.66M ratio-filtered
  pairs and one of 80-byte tags: correct_degenerate_groups sends the
  first to the edit-hits kernel and the second to the edit-distance
  kernel, in turns with the route before edit hits (host preparation and
  edit_distance), both maps equal to the host Myers code's;
- threshold: correct_degenerate_groups's host route (pair preparation and
  Myers) and its edit-hits route in turns on batches of 10^3 to 4 x 10^6
  candidate pairs and on the bench chain's two degenerate levels, the
  measurements that set EDIT_HITS_MIN_PAIRS;
- bench: the fused chain (align -> collapse -> call) over 80,000
  bench-shaped reads (the generator of bench.py, seed 2026), timed as
  bench.py times it;
- banded: the bench's first 2,048 reads aligned with a band of half-width
  32, the same BAM on the card as on the CPU;
- long reads: 1,000 reads of a 4 kb amplicon with ONT-like errors through
  the anchored seed-and-extend path, the first 64 reads' BAM the same on
  the card as on the CPU;
- inversion: inversion_alignment_batch over 512 reads of a 1 kb
  reference (the local screen, the keep-last fill); at the path's shape
  the kernels' rows equal the plain versions', the first 64 reads' rows
  are the same on the card as on the CPU, and a sample of the results
  equals the host inversion_alignment;
- panel: align --router hmm over a 180-reference panel (a seeded stand-in
  for the JAX package's config-5 CRISPR library: one backbone, a 20 bp
  guide apart), 7,200 reads: hmm_forward scores every read against every
  reference, dp_align aligns the routed reads; routing accuracy, and the
  first 64 reads' BAM the same on the card as on the CPU apart from
  routes tied within the card-CPU tolerance of the LLs;
- workers: collapse --threads N on the bench's aligned BAM in turns with
  one process (and once out of core): the same records, no worker with a
  CUDA context; golden and golden_ml with two workers give their pins;
- profile: align --profile-dir on golden writes a torch.profiler trace
  that holds dp_align's kernel events;
- wfa-linear: wavefront.py's wfa_edit_batch (smax 102) and
  wfa_linear_batch (x 4, e 2, an smax that censors no pair) over
  bench_extra.py's bench_wfa pairs (B = 256, L = 512, 5% substitutions,
  seed 0): each one wfa_score launch under the gap-linear model (the
  kernel's G = 0), held against its plain version, timed and bounded;
- distributed: `align` then `collapse` with --distributed-world 2, two
  rank subprocesses of `python3 -m clique_tpu_torch.cli` on the card over
  a shared work dir, at the bench's full width: align over the bench's
  80,000 reads, collapse over the bench's aligned BAM. The merged aligned
  BAM's records equal the bench's single-process BAM's, the collapsed
  records the single-process collapse's of the same BAM (the workers
  phase's one-process run); each rank prints its device, backend,
  launches, reads and walls, rank 0 its merge wall; a rank that exits
  non-zero, or launched no kernel on a CUDA device, fails the run; each
  collapse rank's all_reduce of a level's bucket histogram is timed.
  parallel/mesh.py's sharded_align_step on [cuda:0] equals one dp_align
  call on the same batch and is timed with its dp_align launch, and a
  rank's bucket count (torch.bincount) at a level's size;
- length-sharded: parallel/mesh.py's length_sharded_align, one
  alignment's DP rows split into parts on their own streams (a
  segment_fill launch a part and column tile, the row above handed down,
  the part's bands on a thread-block cluster by segment_plan; a
  segment_walk launch a part, climbing from the corner's part, its
  windows fetched ahead; the kernels' ptxas lines and each plan): the
  JAX test's inputs (B=2, LR=512, LD=480) over [cuda:0] * 8 with an
  uneven split equal the plain versions over [cpu] * 8, part by part;
  then B=2 reads of 16,384 bases against their 16,384-base references
  over [cuda:0] * k, k = 1, 2, 4, in turns with one dp_align call: equal
  results, each part's traceback equal to dp_align's bands of its rows,
  the walls beside dp_align's; one launch of each kernel at that width
  held against its plain version on the card and timed.

The kernel phases hold every kernel against its plain version (for the
fused global fill + walk, dp_align, its fused rows and its traceback laid
out as the plain fill's, in every global mode, with ragged and marked rows,
at the bench, inversion and anchored shapes and at 6,600 rows; wfa_align
and wfa_score in both penalty models at bench_extra.py's bench_wfa shape
and at the hifi, convex and screen launches, penalties, op-store rows,
skeletons and end rows; hmm_forward exactly, at a launch of each strip
height and at the panel's launch shape; edit_distance at the widths where
its words change, over every byte value, and at 2M pairs of 32, 80 and
300-byte rows), time each
in turns with its plain version at the main path's shape, time a PyTorch
library call that computes the same function where there is one, and
work out each kernel's bound from the timed inputs (hmm_forward's from
the MUFU and FP32-pipe instructions of a cell in its SASS, the wavefront
kernels' from the integer instructions of the recurrence of a cell and of
four extension bytes in theirs, for the cells of the diagonals a pair's
penalty reaches at each of its steps, edit_distance's from those of a
column step of its bit-vector recurrence).

The CPU runs of the long-read, inversion, panel, hifi and convex phases go
to a pool of
spawned processes and run beside the card's; a script that imports these
phases needs an `if __name__ == "__main__":` guard. Each phase prints its
wall as `[wall] NAME S s`, and a `[walls]` line gathers them.

It imports no jax. Every failure raises and the script exits non-zero;
the last line of a run that passed is

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}

and the line before it is a JSON object with one entry per kernel (its
"ms" the wrapper's time by CUDA events; edit_distance's entry also holds
"kernel_ms", its kernel alone; wfa_score_linear's times are those of the
call its "timed" names).
"""

import contextlib
import functools
import json
import multiprocessing
import os
import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ProcessPoolExecutor

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN_DIRS = {
    "golden": ("reads.fastq.gz", None),
    "golden_pe": ("reads1.fastq.gz", "reads2.fastq.gz"),
    "golden_ml": ("reads1.fastq.gz", "reads2.fastq.gz"),
}
N_BENCH_READS = 80_000
BENCH_BATCH = 1024
N_CPU_CHECK = 2048
# 10x Chromium v2's public 737K-august-2016.txt holds this many 16 bp
# barcodes; the known-list phase draws a seeded list of that size
N_ALLOWLIST = 737_280
BAND = 32
N_LONG_READS = 1000
N_LONG_CPU = 64
LONG_REF = 4000
N_INV_READS = 512
N_INV_BLOCKS = 10          # ~2% of the reads carry an inverted block
N_INV_SAMPLE = 16
N_INV_CPU = 64
INV_REF = 1000
# the pool that runs the CPU comparisons of the long-read and inversion
# phases beside the card's runs: five workers of two torch threads each
CPU_WORKERS = 5
CPU_WORKER_THREADS = 2
# the panel phase: a stand-in for the JAX package's config-5 panel
# (bench_extra.py:368-476: 180 guides of one CRISPR library, 40 reads a
# reference at SCALE 1, 5% substitutions, batch_size 512)
N_PANEL_REFS = 180
PANEL_PER_REF = 40
PANEL_BACKBONE = 230
PANEL_GUIDE = (80, 100)           # the 20 bp guide's span in the backbone
PANEL_BATCH = 512
N_PANEL_CPU = 64
# the wavefront phases: bench_extra.py's bench_wfa shapes (5%-substituted
# pairs at L = 512, smax 192), its config 2 (HiFi through --engine wfa)
# and structural-variant config (--engine convex), and an exhaustive
# search panel whose kmer vote stays ambiguous (the wfa_score screen)
WFA_L = 512
WFA_SMAX = 192
WFA_ALIGN_B = 512
WFA_SCORE_B = 1024
# the wfa-linear phase: bench_wfa's pairs at B = 256, edit distance censored
# at 0.2 L, the gap-linear penalties x 4, e 2 under an smax that censors no
# pair at 5% substitutions
WFA_LINEAR_B = 256
WFA_EDIT_SMAX = 102
WFA_LINEAR_SMAX = 256
WFA_LINEAR_PEN = dict(x=4, e=2)
# the distributed phase: ranks, the seconds a rank may run, and each rank's
# timeout at a rendezvous or barrier
# the length-sharded phase: the JAX test's shape (tests/test_parallel.py)
# split unevenly over 8 parts of the one card, its tile width; the full
# width (a long read against a long amplicon) and its numbers of parts
LS_JAX_SHAPE = (2, 512, 480)
LS_BOUNDS = (1, 3, 10, 40, 60, 70, 80, 90, 513)
LS_TILE = 160
LS_LONG = 16_384
LS_PARTS = (1, 2, 4)
N_DIST_RANKS = 2
DIST_RANK_TIMEOUT = 300
DIST_BARRIER_TIMEOUT = 120
# walls of earlier phases that the distributed phase prints beside its own
WALLS = {}
WFA_PEN = dict(x=4, o=6, e=2, o2=24, e2=1)
HIFI_CELLS = 200
HIFI_PER_CELL = 40
N_CONVEX_READS = 6000
N_SCREEN_READS = 4000
WFA_BATCH = 512
N_WFA_CPU = 64
# the ONT-raw phase: the long-read phase's reference, 1,000 reads at ONT
# raw-read error rates (5% substitutions, 2.5% deletions and 2.5%
# insertions of 1-3 bp) through --engine wfa at batch 1,024: every read
# passes the 2,048 rung, whose 32-lane op store is the last under the
# 512 MiB budget, and finishes on the bialign engine (wfa_mid)
N_ONT_WFA_READS = 1000
N_ONT_WFA_CPU = 8
ONT_RAW = dict(sub=0.05, dele=0.025, ins=0.025)
# device memory a plain midpoint fill may take for its run table: the
# path's launches are held against it a slice of lanes at a time (its
# steps are launch-bound, so the fewer slices the faster)
MID_PLAIN_BYTES = 30e9
# SASS opcodes that are not operations of a wavefront cell: memory,
# control flow, barriers, special-register and constant reads, moves
WFA_NON_OPS = ("LDG", "STG", "LDS", "STS", "LDC", "ULDC", "LD", "ST", "BRA",
               "EXIT", "RET", "NOP", "BAR", "S2R", "CS2R", "S2UR", "BSSY",
               "BSYNC", "WARPSYNC", "CALL", "MOV", "UMOV")


# the tolerance between the pair-HMM LLs of the card and of the CPU (the
# panel head's ties): both take the same f32 terms and order of
# operations, but CUDA's precise expf / logf are within 1-2 ulp of the
# CPU's, accumulated over a pair's cells. On the card the kernel equals
# its plain version exactly.
HMM_RTOL, HMM_ATOL = 1e-5, 1e-3
# an H100 SM's throughput a clock: MUFU (ex2, lg2) and FP32 lanes (NVIDIA's
# arithmetic-instruction throughput table, compute capability 9.0)
MUFU_PER_SM_CLOCK = 16
FP32_PER_SM_CLOCK = 128
SMS = 132
FP32_OPCODES = ("FADD", "FMUL", "FFMA", "FMNMX", "FSEL", "FSETP", "FSET",
                "FRND", "FCHK")
KERNELS = ("dp_align", "match_hits", "edit_distance", "dp_align_local",
           "edit_hits", "hmm_forward", "wfa_align", "wfa_score", "wfa_mid",
           "wfa_score_linear", "segment_fill", "segment_walk")
SOURCES = {"dp_align": "dp_align.cu",
           "match_hits": "tag_distance.cu",
           "edit_distance": "tag_distance.cu",
           "dp_align_local": "dp_align_local.cu",
           "edit_hits": "tag_distance.cu",
           "hmm_forward": "hmm_forward.cu",
           "wfa_align": "wfa_align.cu",
           "wfa_score": "wfa_align.cu",
           "wfa_mid": "wfa_align.cu",
           "wfa_score_linear": "wfa_align.cu",
           "segment_fill": "dp_align_split.cu",
           "segment_walk": "dp_align_split.cu"}
REPLACES = {"dp_align": "clique_tpu/align/pallas_kernel.py:55",
            "match_hits": "clique_tpu/collapse/distance.py:240",
            "edit_distance": "clique_tpu/collapse/distance.py:36",
            "dp_align_local": "clique_tpu/align/batch.py:363 and :450",
            "edit_hits": "clique_tpu/collapse/distance.py:36 and "
                         "clique_tpu/collapse/correct.py:273",
            "hmm_forward": "clique_tpu/align/hmm.py:39",
            "wfa_align": "clique_tpu/align/wavefront.py:726, :878 and :1156",
            "wfa_score": "clique_tpu/align/wavefront.py:319 and :615",
            "wfa_mid": "clique_tpu/align/wavefront.py:442",
            "wfa_score_linear": "clique_tpu/align/wavefront.py:166 and "
                                ":232",
            "segment_fill": "clique_tpu/parallel/mesh.py:38",
            "segment_walk": "clique_tpu/parallel/mesh.py:38"}
# the card's peak rates for the bounds (NVIDIA's H100 SXM data sheet, at
# its full 700 W): HBM bytes/s; scalar lane operations/s (67 TFLOP/s of
# float32 outside the tensor cores counts an FMA as two, so one lane
# instruction a lane a clock); int8 tensor-core operations/s
PEAK_BYTES = 3.35e12
PEAK_LANE_OPS = 67e12 / 2
PEAK_INT8_OPS = 1979e12
# 32-bit integer lane operations/s: an SM issues 64 a clock against 128
# float32 (NVIDIA's arithmetic-instruction throughput table, compute
# capability 9.0)
PEAK_INT32_OPS = PEAK_LANE_OPS / 2
# lane operations a DP cell needs: the three candidate sums of each plane,
# their compares and selects, the special and terminal-gap selects, the
# byte pack (global); the zero fields and the running argmax besides
# (local); a Levenshtein cell's three candidates, their minimum and the
# match test (edit_distance's DP kernel before its Myers/Hyyro redesign:
# the old bound, printed beside the new one)
OPS_GLOBAL_CELL = 30
OPS_LOCAL_CELL = 36
OPS_EDIT_CELL = 8
# edit_distance's widths beside collapse's 32-byte rows: the 80-byte tags
# of the device-Levenshtein phase's wide group and rows past the kernel's
# 256-byte register band, full rows (la = lb = L)
EDIT_WIDE = ((2_097_152, 80), (262_144, 300))
# integer lane operations match_hits spends on a pair of one-word rows:
# XOR, the shift of the fold, the lop3 of fold and live mask, popc and
# the budget compare
OPS_HIT_PAIR = 5
# lane operations of one column step of the Myers/Hyyro recurrence in one
# 32-bit word (edit_hits, tags of up to 32 bytes): the Peq load, the four
# of D0, HP and HN, the score's two tests and two adds, the two shifts,
# the new VP and VN, the byte's extraction
OPS_MYERS_COL = 17
# the device-Levenshtein group's radius and ratio (a 16 bp DegenerateTag
# at max_distance 2, the default minimum_collapsing_difference)
LEV_D = 2
LEV_RATIO = 5.0
# the known-list phase's radius (cell_id's max_distance)
KNOWN_D = 1
# ptxas's register and spill lines of each kernel, read from the build log
PTXAS = {}
# the wavefront kernels' gap classes G (a template argument) by model
WFA_MODEL_OF_G = {"0": "linear", "1": "affine", "2": "affine2p"}


def bound(nbytes, ops, op_rate=PEAK_LANE_OPS):
    """(bound_ms, bound_by): the larger of the bytes the function must move
    over the memory rate and its operations over the peak rate."""
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = ops / op_rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _timing(kernel_ms, plain_ms, bound_pair, library_ms=None):
    return {"ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_pair[0],
            "bound_by": bound_pair[1], "library_ms": library_ms}


def check(cond, msg):
    if not cond:
        raise SystemExit(f"chip_smoke FAILED: {msg}")


def say(msg):
    print(msg, flush=True)


# each phase's wall (s), and each head check's (the wait for the pool's
# CPU runs), for the [walls] line
PHASE_WALLS = {}


def _walled(fn):
    """fn, its wall added to PHASE_WALLS and printed when it returns."""
    @functools.wraps(fn)
    def run(*args):
        t0 = time.time()
        try:
            return fn(*args)
        finally:
            dt = time.time() - t0
            name = fn.__name__.removeprefix("phase_")
            PHASE_WALLS[name] = round(PHASE_WALLS.get(name, 0.0) + dt, 3)
            say(f"[wall] {name} {dt:.3f} s")
    return run


@_walled
def phase_card():
    import torch

    check(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    check(os.path.isdir(os.path.join(HERE, "clique_tpu_torch", "csrc")),
          f"no clique_tpu_torch/csrc beside {__file__}")
    sys.path.insert(0, HERE)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    say(card)
    try:
        import yaml  # noqa: F401
        has_yaml = True
    except ImportError:
        has_yaml = False
    from clique_tpu_torch.align.pipeline import bam_codec

    codec = bam_codec()
    say(f"[card] torch {torch.__version__} CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} device(s), "
        f"{torch.cuda.get_device_name(0)}; yaml "
        f"{'loaded' if has_yaml else 'MISSING'}; BAM codec {codec}")
    check(has_yaml, "PyYAML is needed to read the layouts")
    return card


@_walled
def phase_build():
    import clique_tpu_torch
    from clique_tpu_torch import _build

    check(os.path.dirname(os.path.abspath(clique_tpu_torch.__file__))
          == os.path.join(HERE, "clique_tpu_torch"),
          "clique_tpu_torch was not imported from this checkout")
    t0 = time.time()
    _build.load()
    info = _build.build_info()
    say(f"[build] {info.path}: nvcc {info.seconds:.2f} s "
        f"({'built' if info.seconds else 'reused'}), load "
        f"{time.time() - t0:.2f} s")
    kernel = None
    for line in info.log.splitlines():
        if "Compiling entry function" in line:
            kernel = next((k for k in ("split_fill_kernel",
                                       "split_walk_kernel",
                                       "hmm_forward_kernel",
                                       "clique_hmm_cell_probe",
                                       "clique_hmm_cell_floor_probe",
                                       "clique_wfa_cell_probe_affine2p",
                                       "clique_wfa_cell_probe_affine",
                                       "clique_wfa_score_probe_linear",
                                       "clique_wfa_word_probe",
                                       "align_local_kernel", "align_kernel",
                                       "match_hits_wide", "match_hits",
                                       "edit_hits_group", "edit_hits_pairs",
                                       "edit_distance_bands",
                                       "clique_edit_column_probe16",
                                       "clique_edit_column_probe")
                           if k in line), line.strip())
            kernel = {"align_local_kernel": "dp_align_local",
                      "split_fill_kernel": "segment_fill",
                      "split_walk_kernel": "segment_walk"}.get(kernel, kernel)
            # the template flags from the mangled name: dp_align's
            # keep-last ties and band
            flags = re.search(r"align_kernelILb(\d)ELb(\d)E", line)
            if flags:
                kernel = "dp_align<tie_last={0},banded={1}>".format(
                    *flags.groups())
            # the pair-HMM kernel's strip height
            flags = re.search(r"hmm_forward_kernelILi(\d+)E", line)
            if flags:
                kernel = "hmm_forward<rows={0}>".format(*flags.groups())
            # the wavefront kernel's gap classes, op store and midpoint
            flags = re.search(r"wfa_kernelILi(\d)ELb(\d)ELb(\d)E", line)
            if flags:
                kernel = "wfa_{0}<{1}>".format(
                    "align" if flags.group(2) == "1" else
                    "mid" if flags.group(3) == "1" else "score",
                    WFA_MODEL_OF_G[flags.group(1)])
            # wfa_score's warp path: gap classes and steps a barrier
            flags = re.search(r"wfa_score_warp_kernelILi(\d)ELi(\d)E", line)
            if flags:
                kernel = "wfa_score_warp<{0},steps={1}>".format(
                    WFA_MODEL_OF_G[flags.group(1)], flags.group(2))
            # the Levenshtein kernel's bit-vector word and words a pattern
            flags = re.search(r"edit_distance_kernelI([jy])Li(\d)E", line)
            if flags:
                kernel = "edit_distance<{0} bits,words={1}>".format(
                    32 if flags.group(1) == "j" else 64, flags.group(2))
            # the fused Hamming search's code width and row words
            flags = re.search(r"match_hits_kernelILi(\d)ELi(\d)E", line)
            if flags:
                kernel = "match_hits<bits={0},words={1}>".format(
                    *flags.groups())
            flags = re.search(r"match_hits_wide_kernelILi(\d)E", line)
            if flags:
                kernel = "match_hits_wide<bits={0}>".format(*flags.groups())
            # the edit-hit search's bit-vector word and code-row words
            flags = re.search(r"edit_hits_(group|pairs)_kernelI([jy])Li(\d+)E",
                              line)
            if flags:
                mode, word, words = flags.groups()
                kernel = "edit_hits_{0}<{1} bits,words={2}>".format(
                    mode, 32 if word == "j" else 64, words)
        elif kernel and ("registers" in line or "spill" in line):
            say(f"[build] {kernel}: {line.strip()}")
            PTXAS.setdefault(kernel, []).append(line.strip())
    lib = _build.load()
    say(f"[build] dp_align: dynamic shared memory "
        f"{lib.clique_dp_align_smem_bytes(384, 384)} B per CTA of 4 warps at "
        f"n1=n2=384, {lib.clique_dp_align_smem_bytes(6600, 1024)} B at "
        f"n1=6600, n2=1024; traceback {lib.clique_dp_align_tb_bytes(384, 384)}"
        f" B an alignment at n1=n2=384 (the old layout: {767 * 384} B); "
        f"row-band scratch {lib.clique_dp_align_scratch_floats(6600, 1024)} "
        f"floats an alignment at n1=6600. dp_align_local: "
        f"{lib.clique_dp_align_local_warps(3328)} warps a CTA and "
        f"{lib.clique_dp_align_local_smem_bytes(3328, 3328)} B of dynamic "
        f"shared memory at n1=n2=3328, "
        f"{lib.clique_dp_align_local_warps(1001)} warps at n1=1001, "
        f"{lib.clique_dp_align_local_warps(6600)} at n1=6600; hand-off "
        f"scratch {lib.clique_dp_align_local_scratch_floats(3328, 3328)} "
        f"floats an alignment at n1=n2=3328 (the old layout's traceback "
        f"and zero flags: {2 * 6655 * 3328} B an alignment, now "
        f"{lib.clique_dp_align_tb_bytes(3328, 3328)} B)")


def _random_batch(rng, B, n1, n2, uniform, ragged):
    import numpy as np

    alphabet = np.frombuffer(b"ACGTACGTN0123", dtype=np.uint8)
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    R = 1 if uniform else B
    refs = np.zeros((R, n1 - 1), np.uint8)
    reads = np.zeros((B, n2 - 1), np.uint8)
    if ragged:
        ref_lens = rng.integers(1, n1, B).astype(np.int32)
        read_lens = rng.integers(1, n2, B).astype(np.int32)
        ref_lens[0], read_lens[0] = 1, n2 - 1
        ref_lens[-1], read_lens[-1] = n1 - 1, 1
    else:
        ref_lens = np.full(B, 342, np.int32)
        read_lens = np.full(B, 342, np.int32)
    if uniform:
        ref_lens[:] = ref_lens[0]
    letters = alphabet if ragged else acgt
    for i in range(R):
        refs[i, :ref_lens[i]] = rng.choice(letters, ref_lens[i])
    for i in range(B):
        reads[i, :read_lens[i]] = rng.choice(letters, read_lens[i])
    return refs, reads, ref_lens, read_lens


def _time_ms(fn, reps, warm=True):
    import torch

    if warm:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _turns(label, kern, plain, reps, plain_reps=1):
    """A kernel and its plain version timed in turns (plain, kernel,
    kernel, plain); returns (kernel ms, plain ms), each the mean of its two
    turns."""
    p1 = _time_ms(plain, plain_reps)
    k1 = _time_ms(kern, reps)
    k2 = _time_ms(kern, reps)
    p2 = _time_ms(plain, plain_reps)
    say(f"{label}: kernel {k1:.4f} / {k2:.4f} ms, plain {p1:.3f} / "
        f"{p2:.3f} ms per call")
    return (k1 + k2) / 2, (p1 + p2) / 2


def _timed(fn):
    """fn() and its time in ms (one call, CUDA events)."""
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def _kernel_turns(label, kern, reps, plain_ms):
    """For plain versions that take seconds a call: the kernel timed in two
    turns beside the plain version's one comparison call; returns (kernel
    ms, plain ms)."""
    k1 = _time_ms(kern, reps)
    k2 = _time_ms(kern, reps)
    say(f"{label}: kernel {k1:.4f} / {k2:.4f} ms, plain {plain_ms:.3f} ms "
        f"(its comparison call) per call")
    return (k1 + k2) / 2, plain_ms


def _interior_cells(ref_lens, read_lens):
    """Interior DP cells of the rows whose lengths lie in the bucket."""
    import numpy as np

    return int(np.sum(np.asarray(ref_lens, np.int64)
                      * np.asarray(read_lens, np.int64)))


def _band_cells(ref_lens, read_lens, bw, centers):
    """Interior cells inside the band: row x of an alignment computes
    columns [max(1, c - bw), min(l2 + 1, c + bw)), c its band center."""
    import numpy as np

    n1 = centers.shape[1]
    x = np.arange(n1)[None, :]
    c = centers.astype(np.int64)
    w = np.asarray(bw, np.int64)[:, None]
    lo = np.maximum(1, c - w)
    hi = np.minimum(np.asarray(read_lens, np.int64)[:, None] + 1, c + w)
    rows = (x >= 1) & (x <= np.asarray(ref_lens, np.int64)[:, None])
    return int(np.sum(np.where(rows, np.maximum(hi - lo, 0), 0)))


def _align_bound(host, n1, n2, cells=None):
    """dp_align's bound on these inputs: it reads refs, reads, lens and
    params once and writes one fused row an alignment (the traceback is its
    own scratch); OPS_GLOBAL_CELL lane operations a cell it must compute
    (every interior cell, or `cells`, those inside a band)."""
    refs, reads, ref_lens, read_lens = host[:4]
    B = reads.shape[0]
    nbytes = (refs.nbytes + reads.nbytes + 8 * B + 24
              + B * (8 + -(-(n1 + n2) // 4)))
    if cells is None:
        cells = _interior_cells(ref_lens, read_lens)
    return bound(nbytes, OPS_GLOBAL_CELL * cells)


def _hold_align(label, args, params, err, **kw):
    """dp_align on the card against walk_reference(fill_reference(...)):
    the fused rows, and the kernel's traceback laid out as the plain
    fill's (interior cells from the kernel, fresh elsewhere), byte for
    byte. Rows marked for lengths outside the bucket are held to n_ops -1,
    a NaN score and no ops; the plain versions run on the other rows.
    Returns the plain call's time in ms."""
    import numpy as np
    import torch

    from clique_tpu_torch.align import batch as tbatch
    from clique_tpu_torch.align import dp_kernels

    n1, n2 = kw["n1"], kw["n2"]
    fused_k, strips = dp_kernels.dp_align(*args, params, return_traceback=True,
                                          **kw)
    torch.cuda.synchronize()
    ref_lens, read_lens = args[2], args[3]
    ok = ((ref_lens >= 0) & (ref_lens <= n1 - 1) & (read_lens >= 0)
          & (read_lens <= n2 - 1))
    rows = torch.nonzero(ok)[:, 0]
    sub = [t if t.shape[0] == 1 else t[rows].contiguous()
           for t in args]
    band = {k: v[rows].contiguous() for k, v in kw.items()
            if k in ("bandwidth", "band_centers")}
    rest = {k: v for k, v in kw.items() if k not in band}
    def plain():
        tb, corner = tbatch.fill_reference(*sub, params, **band, **rest)
        return tb, tbatch.walk_reference(tb, corner, sub[2], sub[3], n1=n1,
                                         n2=n2)[1]

    (tb_p, fused_p), plain_ms = _timed(plain)
    relaid = tbatch.wavefront_to_tb(strips, ref_lens, read_lens, n1=n1, n2=n2)
    torch.cuda.synchronize()
    e_fused = (fused_k[rows].int() - fused_p.int()).abs().max().item()
    e_tb = (relaid[rows].int() - tb_p.int()).abs().max().item()
    same = torch.equal(fused_k[rows], fused_p) and torch.equal(relaid[rows],
                                                               tb_p)
    marked = torch.nonzero(~ok)[:, 0]
    if len(marked):
        m = fused_k[marked].cpu().numpy()
        n_ops = tbatch.unfuse_result(m)[1]
        same = same and bool((n_ops == -1).all()
                             and np.isnan(tbatch.unfuse_result(m)[2]).all()
                             and (m[:, 8:] == 0xFF).all()
                             and (relaid[marked] == tbatch._TB_FRESH).all())
    err["dp_align"] = max(err["dp_align"], e_fused, e_tb)
    say(f"[kernels] dp_align {label}: fused rows and relaid traceback "
        f"{'byte-equal' if same else 'DIFFER'} (max abs err fused {e_fused}, "
        f"traceback {e_tb}; {len(marked)} marked rows)")
    check(same, f"dp_align {label}: kernel and plain version disagree")
    del strips, relaid, tb_p
    return plain_ms


@_walled
def phase_kernels():
    """dp_align against its plain versions on the card in the full band,
    then timed in turns with them at the bench shape."""
    import numpy as np
    import torch

    from clique_tpu_torch.align import batch as tbatch
    from clique_tpu_torch.align import dp_kernels
    from clique_tpu_torch.align.pipeline import (MERGE_SCORING,
                                                 RUST_BIO_COMPAT)

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(2026)
    err = {"dp_align": 0.0}

    def run_case(B, n1, n2, mode, scoring, uniform, ragged, marked=False):
        host = _random_batch(rng, B, n1, n2, uniform, ragged)
        if marked:                  # lengths outside the bucket
            host[2][2], host[3][3], host[2][4] = n1, n2, -1
        args = [torch.from_numpy(a).to(dev) for a in host]
        params = tbatch.scoring_to_params(scoring, dev)
        label = (f"B={B} n1={n1} n2={n2} {mode} "
                 f"{'uniform' if uniform else 'per-row'} ref")
        _hold_align(label, args, params, err, n1=n1, n2=n2,
                    special_mode=mode)
        return host, args, params

    run_case(24, 128, 256, "both", MERGE_SCORING, False, True)
    run_case(24, 256, 128, "ref_n_only", RUST_BIO_COMPAT, False, True)
    run_case(16, 128, 128, "both", MERGE_SCORING, True, True)
    run_case(24, 200, 150, "both", MERGE_SCORING, False, True, marked=True)
    n = 384
    host, args, params = run_case(1024, n, n, "ref_n_only", RUST_BIO_COMPAT,
                                  True, False)

    # timing at the bench shape, in turns: plain, kernel, kernel, plain
    def align_k():
        return dp_kernels.dp_align(*args, params, n1=n, n2=n,
                                   special_mode="ref_n_only")

    def align_p():
        tb, corner = tbatch.fill_reference(*args, params, n1=n, n2=n,
                                           special_mode="ref_n_only")
        return tbatch.walk_reference(tb, corner, args[2], args[3], n1=n,
                                     n2=n)

    k_ms, p_ms = _turns(f"[kernels] dp_align at B=1024 n1=n2={n}", align_k,
                        align_p, 20)
    b = _align_bound(host, n, n)
    say(f"[kernels] dp_align bound at B=1024 n1=n2={n} "
        f"(l1=l2=342): {b[0]:.4f} ms, by {b[1]}; the kernel at "
        f"{b[0] / k_ms:.3f} of it")
    return err, {"dp_align": _timing(k_ms, p_ms, b)}


def _mode_batch(rng, B, n1, n2):
    """One reference of n1 - 1 bases (a single row, as the inversion path
    sends it) and B reads cut from it with 5% substitutions, of lengths 0
    (the first read) to n2 - 1 (the last)."""
    import numpy as np

    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    ref = rng.choice(acgt, n1 - 1)
    reads = np.zeros((B, n2 - 1), np.uint8)
    read_lens = rng.integers(1, n2, B).astype(np.int32)
    read_lens[0], read_lens[-1] = 0, n2 - 1
    for i, n in enumerate(read_lens):
        start = int(rng.integers(0, n1 - 1))
        piece = np.concatenate([ref[start:], ref])[:n]
        subs = rng.random(n) < 0.05
        piece[subs] = rng.choice(acgt, int(subs.sum()))
        reads[i, :n] = piece
    return ref[None, :], reads, np.full(B, n1 - 1, np.int32), read_lens


@_walled
def phase_mode_kernels():
    """dp_align's other modes and shapes, and the local kernels, against
    their plain PyTorch versions on the card, byte for byte, then timed
    beside the plain version's comparison call (seconds a call at these
    shapes): a band of half-width 32 at the bench shape (and a ragged
    banded case); keep-last ties with special_mode "none" (the inversion
    fill) at B=64, n1=n2=3328 (the size of tests/data/big_inversion_ref.txt)
    and at the inversion path's B=502, n1=n2=1001; the anchored path's long,
    thin buckets (128 x 3968 both ways); 6,600 rows, which take 18 row
    bands; and the fused local kernel (the inversion screen) at B=64,
    n1=n2=3328, on the inversion phase's own screen inputs (B=512,
    n1=n2=1001) and at 6,600 rows."""
    import numpy as np
    import torch

    from clique_tpu_torch.align import batch as tbatch
    from clique_tpu_torch.align import dp_kernels
    from clique_tpu_torch.align.inversion import inversion_params
    from clique_tpu_torch.align.pipeline import RUST_BIO_COMPAT
    from clique_tpu_torch.align.scoring import (AffineScoring,
                                                InversionScoring)

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(2028)
    err = dict.fromkeys(("dp_align", "dp_align_local"), 0.0)
    times = {}

    def global_case(label, host, params, reps, width=None, **kw):
        """dp_align held against the plain fill + walk (fused rows and the
        relaid traceback), then timed beside one plain call."""
        args = [torch.from_numpy(a).to(dev) for a in host]
        n1, n2 = host[0].shape[1] + 1, host[1].shape[1] + 1
        kw.update(n1=n1, n2=n2)
        cells = None
        if width is not None:
            bw = np.minimum(np.maximum(host[2], np.maximum(host[3], 1)),
                            np.int32(width)).astype(np.int32)
            centers = tbatch.band_centers_f64(host[2], host[3], n1)
            cells = _band_cells(host[2], host[3], bw, centers)
            kw.update(bandwidth=torch.from_numpy(bw).to(dev),
                      band_centers=torch.from_numpy(centers).to(dev))
        plain_ms = _hold_align(label, args, params, err, **kw)
        if reps:
            k_ms, _p = _kernel_turns(
                f"[mode kernels] dp_align {label}",
                lambda: dp_kernels.dp_align(*args, params, **kw), reps,
                plain_ms)
            b = _align_bound(host, n1, n2, cells)
            say(f"[mode kernels] dp_align {label} bound {b[0]:.4f} ms, by "
                f"{b[1]}; the kernel at {b[0] / k_ms:.3f} of it")

    rust = tbatch.scoring_to_params(RUST_BIO_COMPAT, dev)
    aligner = tbatch.scoring_to_params(AffineScoring.aligner_default(), dev)
    keep_last = inversion_params(InversionScoring(), dev)
    global_case("banded (half-width 16) B=24 n1=128 n2=256 ragged",
                _random_batch(rng, 24, 128, 256, False, True), rust, 0,
                width=16, special_mode="ref_n_only")
    global_case(f"banded (half-width {BAND}) B=1024 n1=n2=384",
                _random_batch(rng, 1024, 384, 384, True, False), rust, 20,
                width=BAND, special_mode="ref_n_only")
    global_case("banded keep-last, special none, B=24 n1=200 n2=256 ragged",
                _random_batch(rng, 24, 200, 256, False, True), keep_last, 0,
                width=12, special_mode="none", tie_order="last")
    n = 3328
    host = _mode_batch(rng, 64, n, n)
    global_case(f"keep-last, special none, B=64 n1=n2={n}", host,
                keep_last, 5, special_mode="none", tie_order="last")
    global_case(f"keep-last, special none, B=502 n1=n2={INV_REF + 1} "
                "(the inversion path)",
                _mode_batch(rng, 502, INV_REF + 1, INV_REF + 1), keep_last, 5,
                special_mode="none", tie_order="last")
    for n1, n2 in ((128, 3968), (3968, 128)):
        global_case(f"anchored bucket B=64 n1={n1} n2={n2}",
                    _random_batch(rng, 64, n1, n2, False, True), aligner, 5,
                    special_mode="both")
    bands = dp_kernels.fill_mode_launches["row_bands"]
    host6600 = _mode_batch(rng, 32, 6600, 1024)
    global_case("n1=6600 n2=1024 B=32 (row bands)", host6600, aligner, 3,
                special_mode="both")
    check(dp_kernels.fill_mode_launches["row_bands"] > bands,
          "the 6,600-row case did not take the row bands")

    # the fused local kernel (the inversion screen) under the screen's
    # scoring: on the keep-last case's inputs (the table's shape), on the
    # inversion phase's screen inputs, and at 6,600 rows (bands 10-17 wrap)
    hifi = tbatch.scoring_to_params(AffineScoring.hifi_default(), dev)
    for label, lhost, reps in (
            (f"B=64 n1=n2={n}", host, 5),
            (f"B={N_INV_READS} n1=n2={INV_REF + 1} (the inversion screen's "
             "own inputs)", _screen_host(*_inversion_data()[:2]), 5),
            ("B=32 n1=6600 n2=1024", host6600, 0)):
        timing = _local_case(label, lhost, hifi, reps, err)
        if timing is not None:
            # the JSON line carries the main path's shape (B=512)
            times["dp_align_local"] = timing
    return err, times


def _local_bound(host, n1, n2):
    """dp_align_local's bound on these inputs, as dp_align's: it reads
    refs, reads, lens and params once, writes one traceback byte an
    interior cell and one fused row an alignment; OPS_LOCAL_CELL lane
    operations an interior cell. Also the old layout's bytes bound (the
    traceback and zero flags of every cell of [B, n1 + n2 - 1, n1])."""
    refs, reads, ref_lens, read_lens = host[:4]
    B = reads.shape[0]
    cells = _interior_cells(ref_lens, read_lens)
    rows = B * (24 + -(-(n1 + n2) // 4))
    inputs = refs.nbytes + reads.nbytes + 8 * B + 24
    old = (inputs + 2 * B * (n1 + n2 - 1) * n1 + rows) / PEAK_BYTES * 1e3
    return bound(inputs + cells + rows, OPS_LOCAL_CELL * cells), cells, old


def _local_case(label, host, params, reps, err):
    """dp_align_local on the card against walk_local_reference(
    fill_local_reference(...)): the fused rows, and the traceback bytes of
    every interior cell against the plain fill's traceback and zero flags
    in the one-byte encoding, byte for byte; then (reps > 0) timed beside
    the plain version's comparison call. Returns its timing entry."""
    import torch

    from clique_tpu_torch import _build
    from clique_tpu_torch.align import batch as tbatch
    from clique_tpu_torch.align import dp_kernels

    args = [torch.from_numpy(a).to(params.device) for a in host]
    n1, n2 = host[0].shape[1] + 1, host[1].shape[1] + 1
    kw = dict(n1=n1, n2=n2)
    lib = _build.load()
    warps = lib.clique_dp_align_local_warps(n1)
    bands = dp_kernels.fill_mode_launches["local_row_bands"]
    fused_k, wave = dp_kernels.dp_align_local(*args, params,
                                              return_traceback=True, **kw)
    torch.cuda.synchronize()
    check(dp_kernels.fill_mode_launches["local_row_bands"] - bands
          == int(warps > 1), f"dp_align_local {label}: W = {warps} warps, "
          "but the row-band count disagrees")

    def plain():
        tb, zf, best, xd = tbatch.fill_local_reference(*args, params, **kw)
        return tb, zf, tbatch.walk_local_reference(tb, zf, best, xd, **kw)[1]

    (tb_p, zf_p, fused_p), plain_ms = _timed(plain)
    wave_p = tbatch.local_tb_to_wavefront(tb_p, zf_p, args[2], args[3], **kw)
    del tb_p, zf_p
    bi, _x, _y, off = tbatch._wavefront_index(args[2], args[3], n1, n2)
    pairs = [(fused_k, fused_p), (wave[bi, off], wave_p[bi, off])]
    del wave, wave_p, bi, off
    e = max((k.double() - p.double()).abs().max().item() for k, p in pairs)
    same = all(torch.equal(k, p) for k, p in pairs)
    err["dp_align_local"] = max(err.get("dp_align_local", 0.0), e)
    say(f"[mode kernels] dp_align_local {label}: fused rows and interior "
        f"traceback bytes {'byte-equal' if same else 'DIFFER'} (max abs err "
        f"{e}); W = {warps} warps a CTA; "
        f"ptxas: {'; '.join(PTXAS.get('dp_align_local', ['not read']))}")
    check(same, f"dp_align_local {label}: kernel and plain version disagree")
    del pairs
    if not reps:
        return None
    k_ms, _p = _kernel_turns(
        f"[mode kernels] dp_align_local {label}",
        lambda: dp_kernels.dp_align_local(*args, params, **kw), reps,
        plain_ms)
    b, cells, old = _local_bound(host, n1, n2)
    say(f"[mode kernels] dp_align_local {label} bound {b[0]:.4f} ms, by "
        f"{b[1]} ({cells} interior cells); the kernel at "
        f"{b[0] / k_ms:.3f} of it; the old layout's bytes {old:.4f} ms")
    return _timing(k_ms, plain_ms, b)


def _hit_inputs(rng, U, K, L, d, letters, noise):
    """Seeded tags u8 [U, L] and allowlist u8 [K, L] from `letters`: every
    other tag is an allowlist row with about (d + 1) / 2 substitutions
    from `noise`, so some pairs lie inside the radius and some just past
    it."""
    import numpy as np

    letters = np.frombuffer(letters, np.uint8)
    allow = rng.choice(letters, (K, L))
    tags = rng.choice(letters, (U, L))
    tags[::2] = allow[rng.integers(0, K, len(tags[::2]))]
    sub = rng.random(tags.shape) < (d + 1) / (2 * L)
    sub[1::2] = False
    tags[sub] = rng.choice(np.frombuffer(noise, np.uint8), int(sub.sum()))
    return tags, allow


def _hold_hits(label, t, a, d):
    """match_hits on the card against match_hits_reference on the same
    tensors: one launch (none where L - d > 255) and the same pairs.
    Returns the size of the two hit sets' symmetric difference and the
    hit count."""
    import torch

    from clique_tpu_torch.collapse import distance as tdist

    n = tdist.match_hits_launches
    u, k = tdist.match_hits(t, a, d)
    torch.cuda.synchronize()
    launches = tdist.match_hits_launches - n
    want_u, want_k = tdist.match_hits_reference(t, a, d)
    K = a.shape[0]
    got = set((u * K + k).tolist())
    want = set((want_u * K + want_k).tolist())
    e = len(got ^ want)
    L = t.shape[1]
    say(f"{label} d={d}: {len(got)} hits, {launches} launch(es); "
        f"{'equal' if e == 0 else 'DIFFER'} to the plain version "
        f"({e} pairs differ)")
    check(e == 0, f"{label}: match_hits and its plain version disagree")
    check(launches == (0 if L - d > 255 else 1),
          f"{label}: {launches} launches, expected one a call")
    return e, len(got)


def _hit_kernel_call(t, a, d):
    """A call of the fused kernel alone on packed inputs (for timing: the
    wrapper's packing, count read-back and sort are left out, and the
    launch is not counted)."""
    import torch

    from clique_tpu_torch import _build
    from clique_tpu_torch.collapse import distance as tdist

    lib = _build.load()
    tw, tm, budgets, aw, bits = tdist.pack_hit_inputs(t, a, d)
    U, K = t.shape[0], a.shape[0]
    count = torch.zeros(1, dtype=torch.int64, device=t.device)
    cap = max(4 * U, 1 << 16)
    out = torch.empty((cap, 2), dtype=torch.int32, device=t.device)
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        # count is not reset between timed calls: hits past the buffer
        # are counted and not written, a few bytes out of the work
        err = lib.clique_match_hits(
            tw.data_ptr(), tm.data_ptr(), budgets.data_ptr(), aw.data_ptr(),
            U, K, tw.shape[1], bits, count.data_ptr(), out.data_ptr(), cap,
            stream)
        check(err == 0, f"match_hits launch failed with CUDA error {err}")
    return call, bits, tw.shape[1]


def _hit_bound(U, K, L, hits):
    """match_hits's bound as the table counts it (both tag sets read once,
    8 bytes a hit written; U*K*L byte comparisons at the int8 tensor-core
    rate, the one-hot product the JAX kernel runs) and the design's own
    integer-pipe time (OPS_HIT_PAIR a pair of one-word rows)."""
    return (bound(U * L + K * L + 8 * hits, U * K * L, PEAK_INT8_OPS),
            OPS_HIT_PAIR * U * K / PEAK_INT32_OPS * 1e3)


_EDIT_OPS = {}


def _edit_column_ops():
    """Operations of one column step of edit_distance's 32-bit kernel (a
    text byte's eight replicated bits, the mismatch mask from the pattern's
    planes, the recurrence), from the SASS of clique_edit_column_probe,
    and of its path for patterns of at most 16 bytes (two planes a word)
    from clique_edit_column_probe16: four steps each, their loads and
    stores left out. {32: ops, 16: ops}."""
    if not _EDIT_OPS:
        probes = {32: "clique_edit_column_probe",
                  16: "clique_edit_column_probe16"}
        sass = _sass_ops(tuple(probes.values()))
        for rows, fn in probes.items():
            _EDIT_OPS[rows] = _wfa_ops_per(sass[fn]) / 4
            say(f"[tag kernels] {fn}: {_EDIT_OPS[rows]} operations a column "
                f"step ({json.dumps(dict(sorted(sass[fn].items())))} for "
                f"four)")
    return _EDIT_OPS


def _edit_bound(host):
    """The least time of edit_distance on these rows: both rows and
    lengths read once and a byte out a pair over the memory rate, and over
    the int32 rate the column steps the recurrence needs: lb of them a pair,
    each at the 16-row path's operations where la <= 16, else at the 32-bit
    word's for each 32 pattern rows (a 64-bit word counts as two)."""
    import numpy as np

    a, _b, la, lb = host
    P, L = a.shape
    ops = _edit_column_ops()
    la64, lb64 = la.astype(np.int64), lb.astype(np.int64)
    per_col = np.where(la64 <= 16, ops[16], ops[32] * -(-la64 // 32))
    total = float(np.sum(np.where(la64 > 0, lb64 * per_col, 0)))
    return bound(2 * P * L + 8 * P + P, total, PEAK_INT32_OPS)


def _edit_kernel_call(args):
    """edit_distance's kernel alone on these card tensors: no length check
    and no allocation a call (the wrapper's), the output made once."""
    import torch

    from clique_tpu_torch import _build

    lib = _build.load()
    a, b, la, lb = args
    P, L = a.shape
    out = torch.empty(P, dtype=torch.uint8, device=a.device)

    def run():
        err = lib.clique_edit_distance(
            a.data_ptr(), b.data_ptr(), la.data_ptr(), lb.data_ptr(),
            out.data_ptr(), P, L, torch.cuda.current_stream().cuda_stream)
        check(err == 0, f"clique_edit_distance returned {err}")
        return out
    return run


@_walled
def phase_tag_kernels():
    """match_hits and edit_distance against their plain PyTorch versions
    on the card, then timed in turns (plain, kernel, kernel, plain) at the
    JAX chunk shape (2048 tags x 16384 entries) and at 2M bench-shaped
    pairs, beside torch.cdist(p=0) and the host Myers code on the same
    inputs; edit_distance also at EDIT_WIDE's rows, with its bound."""
    import numpy as np
    import torch

    from clique_tpu_torch.collapse import distance as tdist

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(2027)
    alphabet = np.frombuffer(b"ACGTN-", dtype=np.uint8)
    err = {"match_hits": 0, "edit_distance": 0}
    six, acgt, many = b"ACGTN-", b"ACGT", b"ACGTNRYKMSWBDHVacgtn"

    for U, K, L, d, letters, noise in (
            (37, 91, 16, 1, six, six), (2047, 16383, 16, 1, acgt, b"ACGTN"),
            (300, 1001, 12, 2, six, six), (129, 515, 255, 30, six, six),
            (200, 1001, 300, 50, six, six), (200, 1001, 300, 20, six, six),
            (2048, 16384, 16, 2, acgt, b"N-"), (500, 4001, 16, 2, many, many),
            (300, 2001, 24, 3, many, many), (300, 1001, 20, 2, acgt, acgt),
            (300, 1001, 64, 3, acgt, acgt), (130, 777, 129, 4, acgt, b"ACGTN")):
        tags, allow = _hit_inputs(rng, U, K, L, d, letters, noise)
        e, _n = _hold_hits(
            f"[tag kernels] match_hits U={U} K={K} L={L} "
            f"{len(set(allow.ravel().tolist()))} classes",
            torch.from_numpy(tags).to(dev), torch.from_numpy(allow).to(dev),
            d)
        err["match_hits"] = max(err["match_hits"], e)

    def edit_case(P, L, la_val=None):
        a = rng.choice(alphabet, (P, L))
        b = a.copy()
        b[rng.random((P, L)) < 0.1] = ord("A")
        b[::7] = rng.choice(alphabet, b[::7].shape)
        if la_val is None:
            la = rng.integers(0, L + 1, P).astype(np.int32)
            lb = np.clip(la + rng.integers(-3, 4, P), 0, L).astype(np.int32)
            la[0], lb[1], la[2], lb[2], la[3], lb[3] = 0, 0, 0, 0, L, L
        else:
            la = np.full(P, la_val, np.int32)
            lb = la.copy()
        host = (a, b, la, lb)
        args = [torch.from_numpy(x).to(dev) for x in host]
        got = tdist.edit_distance(*args)
        torch.cuda.synchronize()
        want = tdist.edit_distance_reference(*args)
        e = (got.int() - want.int()).abs().max().item()
        err["edit_distance"] = max(err["edit_distance"], e)
        say(f"[tag kernels] edit_distance P={P} L={L}: "
            f"{'equal' if e == 0 else 'DIFFER'} (max abs err {e})")
        check(e == 0, "edit_distance and its plain version disagree")
        return host, args

    for P, L in ((3001, 16), (3001, 32), (3001, 64), (3001, 100),
                 (3001, 256), (3001, 300), (3001, 1000)):
        edit_case(P, L)
    # every byte value, at each width the kernel switches at
    for L in (32, 33, 64, 65, 256, 257):
        a = rng.integers(0, 256, (3001, L), dtype=np.uint8)
        a.reshape(-1)[:256] = np.arange(256, dtype=np.uint8)
        b = a.copy()
        b[rng.random(a.shape) < 0.1] = 0
        b[::5] = rng.integers(0, 256, b[::5].shape, dtype=np.uint8)
        la = rng.integers(0, L + 1, 3001).astype(np.int32)
        lb = np.clip(la + rng.integers(-3, 4, 3001), 0, L).astype(np.int32)
        args = [torch.from_numpy(x).to(dev) for x in (a, b, la, lb)]
        e = (tdist.edit_distance(*args).int()
             - tdist.edit_distance_reference(*args).int()).abs().max().item()
        err["edit_distance"] = max(err["edit_distance"], e)
        say(f"[tag kernels] edit_distance P=3001 L={L}, bytes 0-255: "
            f"{'equal' if e == 0 else 'DIFFER'} (max abs err {e})")
        check(e == 0, "edit_distance and its plain version disagree")
    pairs = tdist.edit_distance_pairs([b"A" * 300, b"ACGT" * 70],
                                      [b"C" * 300, b"ACGA" * 70],
                                      device="cuda")
    say(f"[tag kernels] edit_distance_pairs of 300-byte rows on the card: "
        f"{pairs.tolist()} (the JAX package gives [255, 70])")
    check(pairs.tolist() == [255, 70], "edit_distance_pairs at L=300")
    host, args = edit_case(2_097_152, 32, la_val=16)

    # the block shape of the matrix formulation (hamming_hits's chunk_u x
    # chunk_k defaults): an ACGT list, tags one or two
    # substitutions off it, the known-list radius
    tags, allow = _hit_inputs(rng, 2048, 16384, 16, KNOWN_D, acgt, acgt)
    t = torch.from_numpy(tags).to(dev)
    a = torch.from_numpy(allow).to(dev)
    _e, hits = _hold_hits("[tag kernels] match_hits U=2048 K=16384 L=16",
                          t, a, KNOWN_D)
    kernel, bits, words = _hit_kernel_call(t, a, KNOWN_D)
    mc = _turns(f"[tag kernels] match_hits kernel (bits={bits}, "
                f"words={words}) at U=2048 K=16384 L=16",
                kernel, lambda: tdist.match_hits_reference(t, a, KNOWN_D),
                50, 2)
    wrap_ms = _time_ms(lambda: tdist.match_hits(t, a, KNOWN_D), 20)
    say(f"[tag kernels] match_hits wrapper (packing, launch, count "
        f"read-back, sort) at U=2048 K=16384 L=16: {wrap_ms:.4f} ms per "
        f"call")
    # the library yardstick: torch.cdist with p=0 counts the differing
    # columns of every tag against every allowlist row (the distance
    # matrix only; the radius test and the hits are not in it)
    lib_d = torch.cdist(t.float(), a.float(), p=0)
    uu, kk = torch.nonzero(lib_d.round() <= KNOWN_D, as_tuple=True)
    want_u, want_k = tdist.match_hits_reference(t, a, KNOWN_D)
    check(torch.equal(uu, want_u) and torch.equal(kk, want_k),
          "torch.cdist(p=0) and match_hits disagree")
    lib_ms = _time_ms(lambda: torch.cdist(t.float(), a.float(), p=0), 20)
    say(f"[tag kernels] library yardstick torch.cdist(p=0) at U=2048 "
        f"K=16384 L=16: {lib_ms:.4f} ms per call (its matrix thresholded "
        f"gives match_hits's pairs)")
    del lib_d
    U, K, L = t.shape[0], a.shape[0], t.shape[1]
    b_hits, int_ms = _hit_bound(U, K, L, hits)
    say(f"[tag kernels] match_hits integer-pipe time at U=2048 K=16384: "
        f"{int_ms:.4f} ms ({OPS_HIT_PAIR} lane operations a pair)")
    # the kernels line's ms: the wrapper (the launch, the length check read
    # back), as it was timed before the kernel's redesign; the kernel alone
    # beside it as kernel_ms
    ed = _turns("[tag kernels] edit_distance at P=2097152 L=32 la=lb=16",
                lambda: tdist.edit_distance(*args),
                lambda: tdist.edit_distance_reference(*args), 20, 2)
    check(torch.equal(_edit_kernel_call(args)(),
                      tdist.edit_distance(*args)),
          "edit_distance's kernel call and its wrapper disagree")
    k1 = _time_ms(_edit_kernel_call(args), 20)
    k2 = _time_ms(_edit_kernel_call(args), 20)
    say(f"[tag kernels] edit_distance kernel alone (no length check, the "
        f"output made once) at P=2097152 L=32: {k1:.4f} / {k2:.4f} ms per "
        f"call")
    P, Le = host[0].shape
    old_b = bound(2 * P * Le + 8 * P + P,
                  OPS_EDIT_CELL * _interior_cells(host[2], host[3]))
    say(f"[tag kernels] edit_distance old bound (the DP's {OPS_EDIT_CELL} "
        f"lane operations a cell over "
        f"{_interior_cells(host[2], host[3])} cells): {old_b[0]:.4f} ms")
    times = {"match_hits": _timing(*mc, b_hits, lib_ms),
             "edit_distance": {**_timing(*ed, _edit_bound(host)),
                               "kernel_ms": (k1 + k2) / 2}}
    for name in ("match_hits", "edit_distance"):
        say(f"[tag kernels] {name} bound {times[name]['bound_ms']:.4f} ms, "
            f"by {times[name]['bound_by']}")
    del args
    torch.cuda.empty_cache()
    for P, L in EDIT_WIDE:
        wide = edit_case(P, L, la_val=L)
        wt = _turns(f"[tag kernels] edit_distance kernel at P={P} L={L} "
                    f"la=lb={L}", _edit_kernel_call(wide[1]),
                    lambda: tdist.edit_distance_reference(*wide[1]), 10)
        wb = _edit_bound(wide[0])
        say(f"[tag kernels] edit_distance bound at P={P} L={L}: "
            f"{wb[0]:.4f} ms by {wb[1]}; the kernel at {wb[0] / wt[0]:.4f} "
            f"of it")
        del wide
        torch.cuda.empty_cache()
    args = [torch.from_numpy(x).to(dev) for x in host]
    t0 = time.time()
    myers = tdist._edit_distance_myers_host(*host)
    myers_ms = (time.time() - t0) * 1e3
    check(np.array_equal(myers, tdist.edit_distance(*args).cpu().numpy()),
          "edit_distance and the host Myers code disagree")
    say(f"[tag kernels] host Myers at P=2097152 L=32 la=lb=16: "
        f"{myers_ms:.1f} ms (equal to the kernel)")
    return err, times, myers_ms


def _lev_group():
    """The device-Levenshtein group: 2,000 random 16 bp tags of count 10
    and up to 2,000 of count 1, each 1-4 substitutions from a count-10
    tag (seed 4000)."""
    from collections import Counter

    import numpy as np

    rng = np.random.default_rng(4000)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    hi = [r.tobytes() for r in rng.choice(bases, (2000, 16))]
    lo = []
    for i in range(2000):
        t = bytearray(hi[i % 2000])
        for _ in range(1 + i % 4):          # 1-4 edits: some absorb
            t[rng.integers(16)] = int(rng.choice(bases))
        lo.append(bytes(t))
    counts = Counter({t: 10 for t in hi})
    for t in lo:
        if t not in counts:
            counts[t] = 1
    return counts


def _hit_groups(rng, sizes, w, letters=b"ACGT", noise=b"ACGTN-",
                narrow_every=3):
    """Seeded edit_hits inputs (numpy): groups of `sizes` tags drawn from
    64 base tags of w bytes with 8% substitutions from `noise`; one tag in
    ten of count 5-59, the rest 1-4; every `narrow_every`-th group 3 bytes
    narrower than w."""
    import numpy as np

    letters = np.frombuffer(letters, np.uint8)
    T = int(sum(sizes))
    base = rng.choice(letters, (64, w))
    tags = base[rng.integers(0, 64, T)]
    sub = rng.random((T, w)) < 0.08
    tags[sub] = rng.choice(np.frombuffer(noise, np.uint8), int(sub.sum()))
    cnt = np.where(rng.random(T) < 0.1, rng.integers(5, 60, T),
                   rng.integers(1, 5, T)).astype(np.int64)
    offs = np.concatenate(([0], np.cumsum(sizes))).astype(np.int32)
    widths = np.full(len(sizes), w, np.int32)
    widths[1::narrow_every] = w - 3
    return tags, cnt, offs, widths


def _counts_matrix(counts):
    """One group's Counter as edit_hits's numpy inputs."""
    import numpy as np

    tags = list(counts)
    w = len(tags[0])
    mat = np.frombuffer(b"".join(tags), np.uint8).reshape(-1, w).copy()
    return (mat, np.array([counts[t] for t in tags], np.int64),
            np.array([0, len(tags)], np.int32), np.array([w], np.int32))


def _hold_edit_hits(label, host, d, ratio, pairs=None, launches=1):
    """edit_hits on the card against edit_hits_reference on the same
    tensors: equal hit lists and `launches` launches. Returns the size of
    the two hit sets' symmetric difference, the hit count and the
    tensors."""
    import torch

    from clique_tpu_torch.collapse import distance as tdist

    dev = torch.device("cuda", 0)
    args = [torch.from_numpy(x).to(dev) for x in host]
    pr = torch.from_numpy(pairs).to(dev) if pairs is not None else None
    n = tdist.edit_hits_launches
    h, j = tdist.edit_hits(*args, d, ratio, pr)
    torch.cuda.synchronize()
    got_launches = tdist.edit_hits_launches - n
    want_h, want_j = tdist.edit_hits_reference(*args, d, ratio, pr)
    T = args[0].shape[0]
    got = set((h * T + j).tolist())
    want = set((want_h * T + want_j).tolist())
    e = len(got ^ want)
    say(f"{label}: {len(got)} hits, {got_launches} launch(es); "
        f"{'equal' if e == 0 else 'DIFFER'} to the plain version "
        f"({e} pairs differ)")
    check(e == 0 and torch.equal(h, want_h) and torch.equal(j, want_j),
          f"{label}: edit_hits and its plain version disagree")
    check(got_launches == launches,
          f"{label}: {got_launches} launches, expected {launches}")
    return e, len(got), args


def _myers_columns(a, b, w, d):
    """The column steps each pair (rows a, b u8 [P, w] on the card, w <=
    62) needs before its fate is known, as edit_hits's recurrence runs
    it: the first column c with score + c > d + w, else w; and each
    pair's distance. Torch int64 bit vectors, one column a step."""
    import torch

    full = (1 << w) - 1
    eq = torch.zeros(a.shape, dtype=torch.int64, device=a.device)
    for i in range(w):
        eq |= (a[:, i:i + 1] == b).long() << i
    P = a.shape[0]
    vp = torch.full((P,), full, dtype=torch.int64, device=a.device)
    vn = torch.zeros_like(vp)
    score = torch.full_like(vp, w)
    need = torch.full_like(vp, w)
    for c in range(w):
        pm = eq[:, c]
        d0 = ((((pm & vp) + vp) & full) ^ vp) | pm | vn
        hp = vn | (~(d0 | vp) & full)
        hn = vp & d0
        score += ((hp >> (w - 1)) & 1) - ((hn >> (w - 1)) & 1)
        hp = ((hp << 1) | 1) & full
        hn = (hn << 1) & full
        vp = hn | (~(d0 | hp) & full)
        vn = hp & d0
        need = torch.where((need == w) & (score + c + 1 > d + w),
                           torch.full_like(need, c + 1), need)
    return need, score


def _edit_hits_kernel_call(args, d, ratio, reps):
    """A call of the group kernel alone on prepared inputs (for timing:
    the wrapper's sort, encoding, count read-back and hit sort are left
    out, and the launch is not counted). The hit buffer holds every
    timed call's hits, so no call skips a store."""
    import torch

    from clique_tpu_torch import _build
    from clique_tpu_torch.collapse import distance as tdist

    lib = _build.load()
    tags, counts, offsets, widths = args
    codes, cnt, high, bstart, _perm, K = tdist.edit_hit_groups(
        tags, counts, offsets, ratio, int(widths.max()),
        lib.clique_edit_hits_warps())
    G = widths.shape[0]
    h, _j = tdist.edit_hits(*args, d, ratio)
    count = torch.zeros(1, dtype=torch.int64, device=tags.device)
    cap = (reps + 4) * max(len(h), 1)
    out = torch.empty((cap, 2), dtype=torch.int32, device=tags.device)
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        err = lib.clique_edit_hits(
            codes.data_ptr(), cnt.data_ptr(), offsets.data_ptr(), G,
            widths.data_ptr(), high.data_ptr(), bstart.data_ptr(),
            bstart.numel() - 1, None, 0, codes.shape[1], K, d, ratio,
            count.data_ptr(), out.data_ptr(), cap, stream)
        check(err == 0, f"edit_hits launch failed with CUDA error {err}")
    return call, codes.shape[1], K, high.numel()


@_walled
def phase_edit_hits():
    """edit_hits against its plain PyTorch version on the card (group mode
    at the widths and radii of the tests, many groups, tiles of a 4,000-tag
    group, many byte classes; pairs mode on pigeonhole candidates; a hit
    buffer overflow), then timed in turns with its plain version on the
    device-Levenshtein group, beside edit_distance on that group's
    ratio-filtered pairs gathered into rows. Bound: the recurrence's
    operations for the column steps this run's pairs need."""
    import numpy as np
    import torch

    from clique_tpu_torch.collapse import distance as tdist

    rng = np.random.default_rng(2028)
    err = 0
    many = b"ACGTNRYKMSWBDHVacgtn"
    for sizes, w, d, ratio, letters in (
            ([4000] + rng.integers(2, 21, 300).tolist(), 16, 2, 5.0, b"ACGT"),
            (rng.integers(20, 150, 500).tolist(), 12, 2, 5.0, b"ACGT"),
            ([3000, 40, 700], 33, 3, 5.0, b"ACGT"),
            ([2500, 90, 600], 64, 3, 2.5, b"ACGT"),
            ([1500, 30], 20, 2, 5.0, many)):
        host = _hit_groups(rng, sizes, w, letters,
                           letters if letters == many else b"ACGTN-")
        e, _n, _a = _hold_edit_hits(
            f"[edit hits] group mode {len(sizes)} groups, {sum(sizes)} "
            f"tags, w={w} d={d} ratio={ratio}", host, d, ratio)
        err = max(err, e)
    for T, w, d in ((5000, 16, 2), (4500, 64, 3)):
        tags, cnt, offs, widths = _hit_groups(rng, [T], w, narrow_every=2)
        cand = tdist.candidate_pairs_array(
            [r.tobytes() for r in tags], d, counts=cnt, ratio=5.0)
        e, _n, _a = _hold_edit_hits(
            f"[edit hits] pairs mode, {len(cand)} pigeonhole candidates of "
            f"{T} tags, w={w} d={d}", (tags, cnt, offs, widths), d, 5.0,
            cand.astype(np.int32))
        err = max(err, e)
    tags = rng.choice(np.frombuffer(b"ACGT", np.uint8), (1200, 16))
    e, n, _a = _hold_edit_hits(
        "[edit hits] 360,000 hits past the first buffer", (
            tags, np.array([10] * 600 + [1] * 600, np.int64),
            np.array([0, 1200], np.int32), np.array([16], np.int32)),
        16, 5.0, launches=2)
    check(n == 360_000, "the overflow case lost hits")
    err = max(err, e)

    counts = _lev_group()
    e, hits, args = _hold_edit_hits(
        f"[edit hits] the device-Levenshtein group ({len(counts)} tags)",
        _counts_matrix(counts), LEV_D, LEV_RATIO)
    err = max(err, e)
    tags_d, cnt_d = args[0], args[1]
    T, w = tags_d.shape
    ii, jj = torch.triu_indices(T, T, 1, device=tags_d.device)
    keep = tdist._ratio_pass(cnt_d[ii], cnt_d[jj], LEV_RATIO)
    ii, jj = ii[keep], jj[keep]
    P = ii.numel()
    up = cnt_d[ii] > cnt_d[jj]
    hh, lo = torch.where(up, ii, jj), torch.where(up, jj, ii)
    need, dist = _myers_columns(tags_d[hh], tags_d[lo], w, LEV_D)
    check(int((dist <= LEV_D).sum()) == hits,
          "the bound's recurrence and edit_hits disagree")
    cols = int(need.sum())
    del ii, jj, keep, up, need, dist
    reps = 50
    kern, words, K, n_high = _edit_hits_kernel_call(args, LEV_D, LEV_RATIO,
                                                     reps)
    k_ms, p_ms = _turns(
        f"[edit hits] kernel (words={words}, {K} classes, {n_high} patterns)"
        f" on the device-Levenshtein group, {P} ratio-filtered pairs",
        kern, lambda: tdist.edit_hits_reference(*args, LEV_D, LEV_RATIO),
        reps, 2)
    wrap_ms = _time_ms(lambda: tdist.edit_hits(*args, LEV_D, LEV_RATIO), 20)
    say(f"[edit hits] wrapper (count sort, encoding, launch, count "
        f"read-back, hit sort) on that group: {wrap_ms:.4f} ms per call")
    b = bound(T * w + 8 * T + 8 * hits, OPS_MYERS_COL * cols)
    all_ms = OPS_MYERS_COL * w * P / PEAK_LANE_OPS * 1e3
    say(f"[edit hits] bound {b[0]:.4f} ms, by {b[1]} (the recurrence's "
        f"{OPS_MYERS_COL} lane operations for each of the {cols} column "
        f"steps its pairs need, {cols / max(P, 1):.2f} a pair of {w}; all "
        f"{w} columns would be {all_ms:.4f} ms); the kernel at "
        f"{b[0] / k_ms:.3f} of it")
    # today's kernel on the same pairs: rows gathered as the host route
    # gathers them (32 bytes a row, la = lb = 16)
    a = torch.zeros((P, 32), dtype=torch.uint8, device=tags_d.device)
    bb = torch.zeros_like(a)
    a[:, :w] = tags_d[hh]
    bb[:, :w] = tags_d[lo]
    la = torch.full((P,), w, dtype=torch.int32, device=tags_d.device)
    ed = tdist.edit_distance(a, bb, la, la)
    check(int((ed.int() <= LEV_D).sum()) == hits,
          "edit_distance and edit_hits disagree on the group")
    ed_ms = _time_ms(lambda: tdist.edit_distance(a, bb, la, la), 20)
    ek_ms = _time_ms(_edit_kernel_call((a, bb, la, la)), 20)
    say(f"[edit hits] edit_distance on the same {P} pairs in 32-byte rows: "
        f"{ed_ms:.4f} ms per call, its kernel alone {ek_ms:.4f} ms (its "
        f"rows gathered beforehand)")
    del a, bb, la, ed, hh, lo
    return err, _timing(k_ms, p_ms, b)


def _inflate_bgzf(path):
    """Decompressed payload of every BGZF block of a BAM."""
    import gzip
    import struct

    with open(path, "rb") as fh:
        raw = fh.read()
    out, p = [], 0
    while p < len(raw):
        check(raw[p:p + 4] == b"\x1f\x8b\x08\x04", f"{path}: not BGZF")
        xlen = struct.unpack_from("<H", raw, p + 10)[0]
        xp, bsize = p + 12, None
        while xp < p + 12 + xlen:
            si1, si2, slen = struct.unpack_from("<BBH", raw, xp)
            if si1 == 66 and si2 == 67:
                bsize = struct.unpack_from("<H", raw, xp + 4)[0] + 1
            xp += 4 + slen
        out.append(gzip.decompress(raw[p:p + bsize]))
        p += bsize
    return b"".join(out)


def _layout_from_text(text, workdir):
    from clique_tpu_torch.align.pipeline import (ReferenceManager,
                                                 SequenceLayout)

    path = os.path.join(workdir, "layout.yaml")
    with open(path, "w") as fh:
        fh.write(text)
    layout = SequenceLayout.from_yaml(path)
    return layout, ReferenceManager.from_layout(layout)


def _golden_layout(name, workdir):
    """tests/data/<name> with its layout's @ALLOWLIST@ filled in, under a
    new directory workdir: (data directory, layout, reference manager)."""
    gd = os.path.join(HERE, "tests", "data", name)
    with open(os.path.join(gd, "layout.yaml.in")) as fh:
        text = fh.read().replace("@ALLOWLIST@",
                                 os.path.join(gd, "allowlist.txt"))
    os.makedirs(workdir)
    return (gd, *_layout_from_text(text, workdir))


def _reset_counts():
    from clique_tpu_torch.align import dp_kernels, hmm, wfa_kernels
    from clique_tpu_torch.collapse import distance

    dp_kernels.reset_counts()
    distance.reset_counts()
    hmm.reset_counts()
    wfa_kernels.reset_counts()


def _counts():
    from clique_tpu_torch.align import dp_kernels, hmm, wfa_kernels
    from clique_tpu_torch.collapse import distance

    return {"dp_align": dp_kernels.align_launches,
            "match_hits": distance.match_hits_launches,
            "edit_distance": distance.edit_distance_launches,
            "dp_align_local": dp_kernels.align_local_launches,
            "edit_hits": distance.edit_hits_launches,
            "hmm_forward": hmm.hmm_forward_launches,
            "wfa_align": wfa_kernels.wfa_align_launches,
            "wfa_score": wfa_kernels.wfa_score_launches,
            "wfa_mid": wfa_kernels.wfa_mid_launches,
            "wfa_score_linear": wfa_kernels.wfa_linear_launches,
            "segment_fill": dp_kernels.fill_mode_launches["row_split"],
            "segment_walk": dp_kernels.fill_mode_launches["row_split_walk"]}


def _read(path):
    with open(path) as fh:
        return fh.read()


@_walled
def phase_golden(workdir):
    """align -> collapse -> call and the fused run_chain on the card,
    against the pins. Returns the kernel launches of the collapse runs."""
    from clique_tpu_torch.align.pipeline import align_reads
    from clique_tpu_torch.caller.events import call_events_from_bam
    from clique_tpu_torch.chain import run_chain
    from clique_tpu_torch.collapse.pipeline import collapse

    launches = dict.fromkeys(KERNELS, 0)
    for name, (r1, r2) in GOLDEN_DIRS.items():
        wd = os.path.join(workdir, name)
        gd, layout, rm = _golden_layout(name, wd)
        reads = dict(read1=os.path.join(gd, r1),
                     read2=os.path.join(gd, r2) if r2 else None)
        pin_alleles = os.path.join(gd, "alleles.tsv")
        has_alleles = os.path.exists(pin_alleles)
        aligned = os.path.join(wd, "aligned.bam")
        stats = align_reads(layout, rm, aligned, batch_size=16,
                            device="cuda", **reads)
        same = _inflate_bgzf(aligned) == _inflate_bgzf(
            os.path.join(gd, "aligned.bam"))
        say(f"[golden] {name}: {stats.aligned}/{stats.total} aligned on "
            f"the card, BAM payload {'equals' if same else 'DIFFERS from'} "
            f"tests/data/{name}/aligned.bam")
        check(same, f"{name} aligned BAM differs from its pin")

        collapsed = os.path.join(wd, "collapsed.bam")
        _reset_counts()
        cstats = collapse(collapsed, layout, aligned, device="cuda")
        n = _counts()
        for k in ("match_hits", "edit_distance", "edit_hits"):
            launches[k] += n[k]
        same = _inflate_bgzf(collapsed) == _inflate_bgzf(
            os.path.join(gd, "collapsed.bam"))
        say(f"[golden] {name}: collapse on the card, {cstats.passing} "
            f"passing reads, launches match_hits {n['match_hits']} "
            f"edit_distance {n['edit_distance']}; collapsed BAM payload "
            f"{'equals' if same else 'DIFFERS from'} its pin")
        check(same, f"{name} collapsed BAM differs from its pin")
        if name in ("golden", "golden_pe"):
            check(n["match_hits"] > 0,
                  f"{name}: the KnownTag level launched no match_hits")
        alleles = os.path.join(wd, "alleles.tsv")
        if has_alleles:
            call_events_from_bam(layout, collapsed, alleles,
                                 min_read_count=1)
            same = _read(alleles) == _read(pin_alleles)
            say(f"[golden] {name}: alleles.tsv "
                f"{'equals' if same else 'DIFFERS from'} its pin")
            check(same, f"{name} alleles differ from the pin")

        f_aligned = os.path.join(wd, "fused_aligned.bam")
        f_collapsed = os.path.join(wd, "fused_collapsed.bam")
        f_alleles = os.path.join(wd, "fused_alleles.tsv") \
            if has_alleles else None
        _reset_counts()
        _astats, fstats = run_chain(layout, rm, f_aligned, f_collapsed,
                                    batch_size=16, alleles_path=f_alleles,
                                    device="cuda", **reads)
        n = _counts()
        for k in ("match_hits", "edit_distance", "edit_hits"):
            launches[k] += n[k]
        same = (_inflate_bgzf(f_aligned) == _inflate_bgzf(aligned)
                and _inflate_bgzf(f_collapsed) == _inflate_bgzf(collapsed)
                and (not has_alleles or _read(f_alleles) == _read(alleles))
                and fstats == cstats)
        say(f"[golden] {name}: fused run_chain on the card "
            f"{'gives the same bytes and stats' if same else 'DIFFERS'} "
            f"(launches {n})")
        check(same, f"{name}: the fused chain differs from the two-stage")
    return launches


def _bench_dataset(workdir, n_reads):
    """The dataset of bench.py:52-110 (seed 2026): a ~340 bp GESTALT-style
    amplicon with ten Cas9 targets, 500 cells x 4 UMIs, 5% substitutions."""
    import numpy as np

    rng = np.random.default_rng(2026)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    a5 = "TTCAGACGTGTGCTCTTCCGATCT"
    a3 = "AGATCGGAAGAGCACACGTCTGAA"
    targets = [rng.choice(bases, 20).tobytes().decode() + "TGG"
               for _ in range(10)]
    target_block = "GAAA".join(targets)
    ref_seq = f"{a5}{'0' * 16}{'1' * 12}{target_block}{a3}"
    target_list = ", ".join(f'"{t}"' for t in targets)
    type_list = ", ".join('"Cas9WT"' for _ in targets)
    layout_text = f"""
known_strand: true
reads:
  - !Read1
    orientation: Forward
references:
  amplicon1:
    sequence: "{ref_seq}"
    targets: [{target_list}]
    target_types: [{type_list}]
    umi_configurations:
      cell_id: {{symbol: '0', sort_type: "DegenerateTag", length: 16, order: 0, max_distance: 2}}
      cell_umi: {{symbol: '1', sort_type: "DegenerateTag", length: 12, order: 1, max_distance: 2}}
"""
    base_read = np.frombuffer(
        (a5 + "N" * 28 + target_block + a3).encode(), dtype=np.uint8)
    L = len(base_read)
    n_cells = 500
    cells = rng.choice(bases, (n_cells, 16))
    umis = rng.choice(bases, (n_cells, 4, 12))
    lines = []
    for i in range(n_reads):
        c = i % n_cells
        read = base_read.copy()
        read[24:40] = cells[c]
        read[40:52] = umis[c, (i // n_cells) % 4]
        subs = rng.random(L) < 0.05
        read[subs] = rng.choice(bases, int(subs.sum()))
        lines.append(f"@r{i}\n{read.tobytes().decode()}\n+\n{'I' * L}\n")
    fq = os.path.join(workdir, "reads.fastq")
    with open(fq, "w") as fh:
        fh.writelines(lines)
    head = os.path.join(workdir, "head.fastq")
    with open(head, "w") as fh:
        fh.writelines(lines[:N_CPU_CHECK])
    return layout_text, fq, head, cells


@_walled
def phase_bench(workdir):
    """The fused chain over the 80,000 bench-shaped reads, as
    bench.py:126-181 times it: a warm-up run, then align (with the sink),
    collapse_from_reads and the fused call, each on the host clock; chain
    reads/s = aligned reads / (align + collapse + call)."""
    from clique_tpu_torch.align.pipeline import align_reads
    from clique_tpu_torch.caller.events import call_events_from_records
    from clique_tpu_torch.chain import (CollapseSink, collapse_from_reads,
                                        run_chain)

    t0 = time.time()
    layout_text, fq, head, cells = _bench_dataset(workdir, N_BENCH_READS)
    layout, rm = _layout_from_text(layout_text, workdir)
    say(f"[bench] {N_BENCH_READS} reads written in {time.time() - t0:.2f} s")

    warm = CollapseSink(layout, rm)
    align_reads(layout, rm, os.path.join(workdir, "warm.bam"), read1=head,
                batch_size=BENCH_BATCH, sink=warm, device="cuda")
    collapse_from_reads(os.path.join(workdir, "warm_collapsed.bam"), layout,
                        rm, warm.finish(), warm.stats, device="cuda")

    metrics_path = os.path.join(workdir, "metrics.json")
    aligned = os.path.join(workdir, "bench.bam")
    collapsed = os.path.join(workdir, "bench_collapsed.bam")
    from clique_tpu_torch.collapse import correct as tcorrect
    from clique_tpu_torch.collapse import distance as tdist

    # each degenerate level's correct_degenerate_groups call: its batch,
    # wall and edit_hits launches
    levels = []
    real_correct = tcorrect.correct_degenerate_groups

    def recorded(group_counts, d, length, ratio, device):
        n = tdist.edit_hits_launches
        t0 = time.time()
        out = real_correct(group_counts, d, length, ratio, device=device)
        levels.append(((group_counts, d, length, ratio), time.time() - t0,
                       tdist.edit_hits_launches - n))
        return out

    tcorrect.correct_degenerate_groups = recorded
    _reset_counts()
    t0 = time.time()
    sink = CollapseSink(layout, rm)
    stats = align_reads(layout, rm, aligned, read1=fq,
                        batch_size=BENCH_BATCH, device="cuda",
                        metrics_path=metrics_path, sink=sink)
    align_s = time.time() - t0
    t0 = time.time()
    tap = []
    cstats = collapse_from_reads(collapsed, layout, rm, sink.finish(),
                                 sink.stats, n_passing=sink.n_passing,
                                 ingest_seconds=sink.seconds,
                                 record_tap=tap, device="cuda")
    collapse_s = time.time() - t0
    tcorrect.correct_degenerate_groups = real_correct
    t0 = time.time()
    n_rows = call_events_from_records(layout, tap,
                                      os.path.join(workdir, "alleles.tsv"),
                                      min_read_count=1)
    call_s = time.time() - t0
    launches = _counts()
    chain_s = align_s + collapse_s + call_s
    with open(metrics_path) as fh:
        m = json.load(fh)
    with open(collapsed + ".collapse_metrics.json") as fh:
        cm = json.load(fh)
    say(f"[bench] chain of {stats.total} reads on {m['device']}: align "
        f"{align_s:.3f} s + collapse {collapse_s:.3f} s + call "
        f"{call_s:.3f} s = {chain_s:.3f} s -> "
        f"{stats.aligned / chain_s:.1f} chain reads/s (align alone "
        f"{stats.aligned / align_s:.1f} reads/s); {cstats.passing} passing, "
        f"{cm['references']['amplicon1']['output_records']} consensus "
        f"records, {n_rows} allele rows; launches {launches}")
    say(f"[bench] align: device_seconds {m['device_seconds']}, "
        f"host_post_seconds {m['host_post_seconds']}, dispatches "
        f"{m['dispatches']}, phase walls {json.dumps(m['phase_walls'])}")
    say(f"[bench] collapse: ingest {cm['ingest_s']} s (inside the align "
        f"wall), levels {cm['levels_s']} s, outputs {cm['outputs_s']} s, "
        f"levels {json.dumps(cm['references']['amplicon1']['levels'])}")
    level_batches = []
    for k, (batch, secs, n) in enumerate(levels):
        pairs = tcorrect.candidate_pair_count(*batch)
        say(f"[bench] degenerate level {k} (length {batch[2]}): "
            f"{len(batch[0])} groups, {sum(map(len, batch[0]))} tags, "
            f"{pairs} candidate pairs: correct_degenerate_groups "
            f"{secs:.4f} s, edit_hits launches {n}")
        level_batches.append((f"bench level {k}", batch))
        check(n > 0 or pairs < tcorrect.EDIT_HITS_MIN_PAIRS,
              f"bench level {k} launched no edit_hits")
    check(len(levels) == 2, f"{len(levels)} degenerate levels, expected 2")
    check(stats.aligned == N_BENCH_READS, "not every read was aligned")
    check(launches["dp_align"] > 0, "the main path launched no kernel")
    check(launches["dp_align"] == m["dispatches"],
          "launch counts differ from the number of dispatches")
    check(cstats.passing > 0.9 * N_BENCH_READS and n_rows > 0,
          "the chain lost its reads")

    outs = {}
    for device in ("cuda", "cpu"):
        a = os.path.join(workdir, f"head_{device}.bam")
        c = os.path.join(workdir, f"head_{device}_collapsed.bam")
        t = os.path.join(workdir, f"head_{device}_alleles.tsv")
        t0 = time.time()
        run_chain(layout, rm, a, c, read1=head, batch_size=BENCH_BATCH,
                  alleles_path=t, device=device)
        outs[device] = (_inflate_bgzf(a), _inflate_bgzf(c), _read(t))
        say(f"[bench] fused chain of the first {N_CPU_CHECK} reads on "
            f"{device}: {time.time() - t0:.2f} s")
    check(outs["cuda"] == outs["cpu"],
          f"the {N_CPU_CHECK}-read aligned BAM, collapsed BAM or alleles "
          "differ between cuda and cpu")
    say(f"[bench] first {N_CPU_CHECK} reads: cuda and cpu aligned BAMs, "
        "collapsed BAMs and allele tables identical")
    WALLS["bench align"] = align_s
    return launches, (layout_text, aligned, cells, stats.aligned / chain_s,
                      head, level_batches)


@_walled
def phase_banded(workdir, bench):
    """The bench's first 2,048 reads through align_reads with a band of
    half-width 32: every group a banded dp_align on the card, and the same
    BAM as the plain versions give on the CPU."""
    from clique_tpu_torch.align import dp_kernels
    from clique_tpu_torch.align.pipeline import align_reads

    layout_text, _aligned, _cells, _rate, head, _levels = bench
    wd = os.path.join(workdir, "banded")
    os.makedirs(wd)
    layout, rm = _layout_from_text(layout_text, wd)
    outs = {}
    for device in ("cuda", "cpu"):
        out = os.path.join(wd, f"{device}.bam")
        _reset_counts()
        t0 = time.time()
        stats = align_reads(layout, rm, out, read1=head,
                            batch_size=BENCH_BATCH, bandwidth=BAND,
                            device=device)
        seconds = time.time() - t0
        if device == "cuda":
            launches = _counts()
            banded = dp_kernels.fill_mode_launches["banded"]
        outs[device] = _inflate_bgzf(out)
        say(f"[banded] {stats.aligned}/{stats.total} reads, half-width "
            f"{BAND}, on {device}: {seconds:.3f} s")
    same = outs["cuda"] == outs["cpu"]
    full = outs["cuda"] == _inflate_bgzf(os.path.join(workdir,
                                                      "head_cuda.bam"))
    say(f"[banded] cuda and cpu aligned BAMs "
        f"{'identical' if same else 'DIFFER'}; the banded BAM "
        f"{'equals' if full else 'differs from'} the full-band one; "
        f"launches {launches}, {banded} banded")
    check(stats.aligned == N_CPU_CHECK, "not every read was aligned")
    check(launches["dp_align"] > 0 and banded == launches["dp_align"],
          "the banded path launched no banded fill")
    check(same, "the banded BAMs differ between cuda and cpu")
    return launches


def _ont_read(rng, ref, bases, sub=0.03, dele=0.01, ins=0.01):
    """An ONT-like read of ref: a random base drawn at a `sub` share of
    the positions, a deletion of 1-3 bp at `dele` and an insertion of 1-3
    bp at `ins` (by default 3%, 1% and 1%)."""
    n = len(ref)
    u = rng.random(n)
    draw = rng.choice(bases, (n, 4))
    span = rng.integers(1, 4, n)
    out = bytearray()
    i = 0
    while i < n:
        if u[i] < sub:
            out.append(draw[i, 0])
        elif u[i] < sub + dele:
            i += int(span[i])
            continue
        elif u[i] < sub + dele + ins:
            out += draw[i, 1:1 + span[i]].tobytes()
            out.append(ref[i])
        else:
            out.append(ref[i])
        i += 1
    return bytes(out)


def _cpu_worker_init():
    # the workers share the host's cores with the main process, whose
    # card runs (and their host-bound walls) go on beside them
    import torch

    torch.set_num_threads(CPU_WORKER_THREADS)


def _align_on_cpu(layout_text, fastq, workdir, batch_size=BENCH_BATCH,
                  router="kmer"):
    """align_reads with the plain versions on the CPU (run in the pool):
    the inflated BAM payload and the seconds it took."""
    from clique_tpu_torch.align.pipeline import align_reads

    os.makedirs(workdir)
    layout, rm = _layout_from_text(layout_text, workdir)
    out = os.path.join(workdir, "cpu.bam")
    t0 = time.time()
    align_reads(layout, rm, out, read1=fastq, batch_size=batch_size,
                router=router, device="cpu")
    return _inflate_bgzf(out), time.time() - t0


def _long_reference():
    """The long-read phases' seeded 4 kb reference and its layout: (the
    generator, left where the reference was drawn; the bases; the
    reference; the layout text)."""
    import numpy as np

    rng = np.random.default_rng(4000)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    ref = rng.choice(bases, LONG_REF).tobytes()
    layout_text = f"""
known_strand: true
reads:
  - !Read1
    orientation: Forward
references:
  longamp:
    sequence: "{ref.decode()}"
"""
    return rng, bases, ref, layout_text


@_walled
def phase_long_reads(workdir, pool):
    """1,000 reads of a seeded 4 kb amplicon with ONT-like errors through
    align_reads at the default anchored_min_length (2048): every read takes
    the anchored seed-and-extend path, its inter-anchor sub-DPs batched
    through dp_align. The first 64 reads' BAM on the CPU is
    computed in the pool after the card's runs; long_reads_head_check
    holds it against the card's."""
    from clique_tpu_torch.align.pipeline import align_reads

    rng, bases, ref, layout_text = _long_reference()
    wd = os.path.join(workdir, "long")
    os.makedirs(wd)
    layout, rm = _layout_from_text(layout_text, wd)
    lines = []
    for i in range(N_LONG_READS):
        r = _ont_read(rng, ref, bases).decode()
        lines.append(f"@long{i}\n{r}\n+\n{'I' * len(r)}\n")
    fq, head = os.path.join(wd, "long.fastq"), os.path.join(wd, "head.fastq")
    for path, part in ((fq, lines), (head, lines[:N_LONG_CPU])):
        with open(path, "w") as fh:
            fh.writelines(part)

    out = os.path.join(wd, "head_cuda.bam")
    t0 = time.time()
    align_reads(layout, rm, out, read1=head, batch_size=BENCH_BATCH,
                device="cuda")
    head_cuda = _inflate_bgzf(out)
    say(f"[long reads] first {N_LONG_CPU} reads on cuda: "
        f"{time.time() - t0:.2f} s")

    out = os.path.join(wd, "long.bam")
    metrics_path = os.path.join(wd, "metrics.json")
    _reset_counts()
    t0 = time.time()
    stats = align_reads(layout, rm, out, read1=fq, batch_size=BENCH_BATCH,
                        device="cuda", metrics_path=metrics_path)
    seconds = time.time() - t0
    launches = _counts()
    with open(metrics_path) as fh:
        m = json.load(fh)
    a = m["anchored"]
    cells = a["dp_cells_filled"]
    full = sum((LONG_REF + 1) * (len(line.split("\n")[1]) + 1)
               for line in lines)
    say(f"[long reads] {stats.aligned}/{stats.total} reads of ~{LONG_REF} "
        f"bp on the card: {seconds:.3f} s, {stats.aligned / seconds:.1f} "
        f"reads/s; {a['reads']} anchored, {a['sub_dps']} sub-DPs, {cells} "
        f"DP cells filled ({cells / full:.4f} of the full DP), "
        f"{a['dispatches']} dispatches, device_seconds "
        f"{a['device_seconds']}; launches {launches}")
    check(stats.aligned == N_LONG_READS, "not every long read was aligned")
    check(a["reads"] == N_LONG_READS, "a long read missed the anchored path")
    check(launches["dp_align"] == m["dispatches"] > 0,
          "launch counts differ from the number of dispatches")
    head_cpu = pool.submit(_align_on_cpu, layout_text, head,
                           os.path.join(wd, "cpu"))
    return launches, stats.aligned / seconds, (head_cuda, head_cpu)


@_walled
def long_reads_head_check(pending):
    head_cuda, future = pending
    head_cpu, seconds = future.result()
    same = head_cuda == head_cpu
    say(f"[long reads] first {N_LONG_CPU} reads on cpu (in the pool): "
        f"{seconds:.2f} s; cuda and cpu aligned BAMs "
        f"{'identical' if same else 'DIFFER'}")
    check(same, "the long reads' BAMs differ between cuda and cpu")


def _inversion_rows(ref, reads, inv, aff, device):
    """The inversion path's device rows on `device`: the screen's fused
    local rows, and the keep-last rows of its negatives."""
    from clique_tpu_torch.align import batch as tbatch
    from clique_tpu_torch.align.inversion import (keep_last_rows,
                                                  local_screen_rows)

    screen = local_screen_rows(ref, reads, aff, device)
    n_ops = tbatch.unfuse_result(screen, local=True)[1]
    negatives = [r for r, n in zip(reads, n_ops)
                 if n < inv.min_inversion_length]
    return screen, keep_last_rows(ref, negatives, inv, device)


def _screen_host(ref, reads):
    """The inversion screen's kernel inputs, as inversion._fused_rows
    builds them, in host arrays: the reference row, the reverse
    complements of the reads padded to the longest, and both lengths."""
    import numpy as np

    from clique_tpu_torch.align import batch as tbatch
    from clique_tpu_torch.utils.seq import reverse_complement

    arr, lens = tbatch.pad_batch([reverse_complement(r) for r in reads])
    return (np.frombuffer(ref, np.uint8)[None].copy(), arr,
            np.full(len(reads), len(ref), np.int32), lens)


def _screen_args(ref, reads, aff):
    """_screen_host's arrays on the card, and the affine scoring."""
    import torch

    from clique_tpu_torch.align import batch as tbatch

    dev = torch.device("cuda", 0)
    return (*(torch.from_numpy(a).to(dev) for a in _screen_host(ref, reads)),
            tbatch.scoring_to_params(aff, dev))


def _plain_rows(ref, seqs, params, local):
    """The plain PyTorch fill and walk on the card over `ref` against
    `seqs`, padded as the inversion path pads them: the fused rows."""
    import numpy as np
    import torch

    from clique_tpu_torch.align import batch as tbatch

    dev = params.device
    arr, lens = tbatch.pad_batch(seqs)
    n1, n2 = len(ref) + 1, arr.shape[1] + 1
    read_lens = torch.from_numpy(lens).to(dev)
    ref_lens = torch.full_like(read_lens, len(ref))
    args = (torch.from_numpy(np.frombuffer(ref, np.uint8)[None].copy())
            .to(dev), torch.from_numpy(arr).to(dev), ref_lens, read_lens,
            params)
    if local:
        out = tbatch.fill_local_reference(*args, n1=n1, n2=n2)
        fused = tbatch.walk_local_reference(*out, n1=n1, n2=n2)[1]
    else:
        tb, corner = tbatch.fill_reference(*args, n1=n1, n2=n2,
                                           special_mode="none",
                                           tie_order="last")
        fused = tbatch.walk_reference(tb, corner, ref_lens, read_lens,
                                      n1=n1, n2=n2)[1]
    return fused.cpu().numpy()


def _inversion_data():
    """The inversion phase's seeded data: a 1 kb reference, 512 reads of
    it with 1% substitutions, 10 of them with an inverted block of 40-100
    bp, the set of those 10, and the generator, to draw on."""
    import numpy as np

    from clique_tpu_torch.utils.seq import reverse_complement

    rng = np.random.default_rng(1000)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    ref = rng.choice(bases, INV_REF)
    inverted = set(rng.choice(N_INV_READS, N_INV_BLOCKS,
                              replace=False).tolist())
    reads = []
    for i in range(N_INV_READS):
        r = ref.copy()
        subs = rng.random(INV_REF) < 0.01
        r[subs] = rng.choice(bases, int(subs.sum()))
        r = r.tobytes()
        if i in inverted:
            n = int(rng.integers(40, 101))
            p = int(rng.integers(50, INV_REF - n - 50))
            r = r[:p] + reverse_complement(r[p:p + n]) + r[p + n:]
        reads.append(r)
    return ref.tobytes(), reads, inverted, rng


@_walled
def phase_inversion(pool):
    """inversion_alignment_batch over 512 reads of a seeded 1 kb reference
    with 1% substitutions, 10 of them (~2%) with an inverted block of
    40-100 bp, under the default InversionScoring and the HiFi affine
    scoring (its local screen keeps hits of random sequence short): the
    screen and the keep-last fill on the card, the screen positives on
    the host one after another. At the path's shape the kernels' rows
    equal the plain versions' on the card; the first 64 reads' rows on
    the card equal those on the CPU (in the pool); a 16-read sample of the
    results equals the host inversion_alignment (in the pool)."""
    import numpy as np
    import torch

    from clique_tpu_torch.align import batch as tbatch
    from clique_tpu_torch.align import dp_kernels
    from clique_tpu_torch.align.inversion import (inversion_alignment,
                                                  inversion_alignment_batch,
                                                  inversion_params)
    from clique_tpu_torch.align.scoring import (AffineScoring,
                                                InversionScoring)
    from clique_tpu_torch.utils.seq import reverse_complement

    ref, reads, inverted, rng = _inversion_data()
    names = [f"inv{i}" for i in range(N_INV_READS)]
    inv, aff = InversionScoring(), AffineScoring.hifi_default()
    sample = sorted(rng.choice(N_INV_READS, N_INV_SAMPLE,
                               replace=False).tolist())
    head_cpu = pool.submit(_inversion_rows, ref, reads[:N_INV_CPU], inv, aff,
                           "cpu")
    host = [pool.submit(inversion_alignment, ref, reads[i], "inv_ref",
                        names[i], inv, aff, False) for i in sample]

    _reset_counts()
    t0 = time.time()
    got = inversion_alignment_batch(ref, reads, "inv_ref", names, inv, aff,
                                    device="cuda")
    cuda_s = time.time() - t0
    launches = _counts()
    modes = dict(dp_kernels.fill_mode_launches)
    marked = sorted(i for i, res in enumerate(got)
                    if any(op == "<" for _c, op in res.cigar))
    say(f"[inversion] {N_INV_READS} reads of a {INV_REF} bp reference on "
        f"the card: {cuda_s:.2f} s (the screen positives one after another "
        f"on the host); {len(marked)} reads carry an inversion block "
        f"({len(inverted)} were given one); launches {launches}, fill "
        f"modes {modes}")
    check(set(marked) == inverted, "the inversion blocks were not found")
    # one dp_align_local launch a screen split (inversion._fused_rows)
    screen_args = _screen_args(ref, reads, aff)
    n1, n2 = len(ref) + 1, screen_args[1].shape[1] + 1
    rows = max(1, tbatch.MAX_TRACEBACK_BYTES
               // tbatch.local_traceback_bytes(n1, n2, "cuda"))
    splits = -(-N_INV_READS // rows)
    check(launches["dp_align_local"] == splits,
          f"the inversion screen made {launches['dp_align_local']} "
          f"dp_align_local launches for {splits} split(s)")
    screen_ms = _time_ms(lambda: dp_kernels.dp_align_local(
        *screen_args, n1=n1, n2=n2), 5)
    say(f"[inversion] the screen's device time: {screen_ms:.4f} ms a "
        f"dp_align_local launch over its {N_INV_READS} rows (n1={n1}, "
        f"n2={n2}), {splits} launch(es) a call")
    check(launches["dp_align"] > 0 and modes["tie_last"] > 0
          and modes["special_none"] > 0,
          "the inversion path launched no keep-last fill")

    # the kernels' rows against the plain versions' at the path's shape
    dev = torch.device("cuda", 0)
    t0 = time.time()
    screen, last = _inversion_rows(ref, reads, inv, aff, "cuda")
    kern_s = time.time() - t0
    n_neg = last.shape[0]
    negatives = [r for r, n in zip(reads,
                                   tbatch.unfuse_result(screen, True)[1])
                 if n < inv.min_inversion_length]
    t0 = time.time()
    screen_p = _plain_rows(ref, [reverse_complement(r) for r in reads],
                           tbatch.scoring_to_params(aff, dev), True)
    last_p = _plain_rows(ref, negatives, inversion_params(inv, dev), False)
    plain_s = time.time() - t0
    same_path = (np.array_equal(screen, screen_p)
                 and np.array_equal(last, last_p))
    say(f"[inversion] screen rows (B={N_INV_READS}, n1={INV_REF + 1}) and "
        f"keep-last rows ({n_neg} negatives): kernels {kern_s:.3f} s, plain "
        f"versions on the card {plain_s:.3f} s; "
        f"{'byte-equal' if same_path else 'DIFFER'}")
    check(same_path, "the inversion path's kernel rows differ from the "
          "plain versions'")

    head_k = _inversion_rows(ref, reads[:N_INV_CPU], inv, aff, "cuda")
    head_p = head_cpu.result()
    same_head = all(np.array_equal(k, p) for k, p in zip(head_k, head_p))
    host = [f.result() for f in host]
    sample_same = all(
        (got[i].score, got[i].reference_aligned, got[i].read_aligned,
         got[i].cigar) == (h.score, h.reference_aligned, h.read_aligned,
                           h.cigar) for i, h in zip(sample, host))
    say(f"[inversion] first {N_INV_CPU} reads' screen and keep-last rows: "
        f"cuda and cpu {'identical' if same_head else 'DIFFER'}; the "
        f"{N_INV_SAMPLE}-read sample "
        f"{'equals' if sample_same else 'DIFFERS from'} the host "
        f"inversion_alignment")
    check(same_head, "the inversion rows differ between cuda and cpu")
    check(sample_same, "the inversion batch differs from the host")
    return launches


class _CallTimer:
    """Wall seconds and calls of module functions, wrapped for the length
    of a with-block (each call ends in torch.cuda.synchronize(), so its
    device work is inside it); `args` keeps each label's last arguments."""

    def __init__(self, targets):
        self.targets = targets            # (module, function name, label)
        self.seconds = {label: 0.0 for _m, _f, label in targets}
        self.calls = {label: 0 for _m, _f, label in targets}
        self.args = {}
        self._saved = []

    def __enter__(self):
        import torch

        for mod, name, label in self.targets:
            orig = getattr(mod, name)

            def timed(*args, _orig=orig, _label=label, **kw):
                t0 = time.perf_counter()
                out = _orig(*args, **kw)
                torch.cuda.synchronize()
                self.seconds[_label] += time.perf_counter() - t0
                self.calls[_label] += 1
                self.args[_label] = args
                return out
            self._saved.append((mod, name, orig))
            setattr(mod, name, timed)
        return self

    def __exit__(self, *exc):
        for mod, name, orig in reversed(self._saved):
            setattr(mod, name, orig)


@_walled
def phase_known_list(workdir, bench):
    """The bench-shaped reads collapsed with cell_id as KnownTag Hamming
    (max_distance 1) against a seeded 737,280-entry 16 bp allowlist that
    holds the bench's 500 cell barcodes: one match_hits launch for the
    level's one hamming_hits call, the collapse wall split into its parts,
    and the fused kernel held against its plain version and timed on that
    call's own tags."""
    import numpy as np
    import torch

    from clique_tpu_torch.collapse import correct as tcorrect
    from clique_tpu_torch.collapse import distance as tdist
    from clique_tpu_torch.collapse import pipeline as tpipeline
    from clique_tpu_torch.collapse.correct import correct_known_hamming
    from clique_tpu_torch.collapse.pipeline import collapse

    layout_text, aligned, cells, _rate, _head, _levels = bench
    rng = np.random.default_rng(737280)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    allow = rng.choice(bases, (N_ALLOWLIST, 16))
    slots = rng.choice(N_ALLOWLIST, len(cells), replace=False)
    allow[slots] = cells
    allow_path = os.path.join(workdir, "allowlist_737k.txt")
    with open(allow_path, "wb") as fh:
        fh.write(b"\n".join(r.tobytes() for r in allow) + b"\n")
    old = ("cell_id: {symbol: '0', sort_type: \"DegenerateTag\", length: 16, "
           "order: 0, max_distance: 2}")
    new = (f"cell_id: {{symbol: '0', sort_type: \"KnownTag\", file: "
           f"\"{allow_path}\", length: 16, order: 0, max_distance: "
           f"{KNOWN_D}, levenshtein_distance: false}}")
    check(old in layout_text, "bench layout changed shape")
    wd = os.path.join(workdir, "known")
    os.makedirs(wd)
    layout, _rm = _layout_from_text(layout_text.replace(old, new), wd)

    out = os.path.join(wd, "collapsed.bam")
    timer = _CallTimer([
        (tpipeline, "load_known_lists", "allowlist read"),
        (tcorrect, "correct_known_hamming", "known level correction"),
        (tcorrect, "hamming_hits", "hamming_hits"),
        (tdist, "upload_rows", "upload"),
        (tdist, "match_hits", "match_hits"),
        (tdist, "pack_hit_inputs", "packing")])
    _reset_counts()
    t0 = time.time()
    with timer:
        cstats = collapse(out, layout, aligned, device="cuda")
    seconds = time.time() - t0
    launches = _counts()
    with open(out + ".collapse_metrics.json") as fh:
        metrics = json.load(fh)
    levels = metrics["references"]["amplicon1"]["levels"]
    say(f"[known list] collapse of {cstats.total_reads} reads against "
        f"{N_ALLOWLIST} entries on the card: {seconds:.3f} s, "
        f"{cstats.passing} passing, levels {json.dumps(levels)}, "
        f"launches {launches}")
    sec, calls = timer.seconds, timer.calls
    check(calls["hamming_hits"] >= 1, "the known-list level ran no "
          "hamming_hits")
    check(launches["match_hits"] == calls["hamming_hits"],
          f"{launches['match_hits']} match_hits launches for "
          f"{calls['hamming_hits']} hamming_hits calls: expected one each")
    check(levels[0]["reads_out"] > 0.5 * levels[0]["reads_in"],
          "the known-list level corrected almost nothing")
    split = {
        "allowlist read": sec["allowlist read"],
        "upload": sec["upload"],
        "packing": sec["packing"],
        "kernel, count read-back and sort": sec["match_hits"]
        - sec["packing"],
        "host hit assembly": sec["hamming_hits"] - sec["upload"]
        - sec["match_hits"],
        "correction map": sec["known level correction"]
        - sec["hamming_hits"],
        "rest of collapse": seconds - sec["allowlist read"]
        - sec["known level correction"]}
    say("[known list] collapse wall split (s): " + json.dumps(
        {k: round(v, 4) for k, v in split.items()})
        + f"; collapse metrics ingest_s {metrics.get('ingest_s')} "
        f"levels_s {metrics.get('levels_s')} outputs_s "
        f"{metrics.get('outputs_s')}")

    # the fused kernel on the level's own tags and the whole allowlist
    tags_k, allow_k, d = timer.args["hamming_hits"][:3]
    dev = torch.device("cuda", 0)
    t = tdist.upload_rows(tags_k, 16, dev)
    a = tdist.upload_rows(allow_k, 16, dev)
    U, K = t.shape[0], a.shape[0]
    _e, hits = _hold_hits(f"[known list] match_hits U={U} K={K} L=16", t, a,
                          d)
    kernel, bits, words = _hit_kernel_call(t, a, d)
    k_ms, p_ms = _turns(f"[known list] match_hits kernel (bits={bits}, "
                        f"words={words}) at U={U} K={K} L=16", kernel,
                        lambda: tdist.match_hits_reference(t, a, d), 10, 1)
    wrap_ms = _time_ms(lambda: tdist.match_hits(t, a, d), 5)
    hh_ms = _time_ms(lambda: tdist.hamming_hits(tags_k, allow_k, d,
                                                device="cuda"), 3)
    (b_ms, b_by), int_ms = _hit_bound(U, K, 16, hits)
    say(f"[known list] match_hits at U={U} K={K}: kernel {k_ms:.4f} ms, "
        f"wrapper {wrap_ms:.4f} ms, hamming_hits {hh_ms:.4f} ms per call; "
        f"plain {p_ms:.3f} ms; bound {b_ms:.4f} ms (by {b_by}), "
        f"integer-pipe time {int_ms:.4f} ms ({OPS_HIT_PAIR} lane operations "
        f"a pair); {hits} hits")

    from clique_tpu_torch.io.sam import BamReader

    observed = {}
    with BamReader(aligned) as reader:
        for rec in reader:
            tag = rec.tags.get("e0")
            if tag is not None:
                observed[tag.encode()] = observed.get(tag.encode(), 0) + 1
    keys = sorted(observed)
    pick = rng.choice(len(keys), 256, replace=False)
    sample = {keys[i]: observed[keys[i]] for i in pick}
    allow_list = [r.tobytes() for r in allow]
    n = tdist.match_hits_launches
    t0 = time.time()
    got = correct_known_hamming(sample, allow_list, KNOWN_D, 16,
                                device="cuda")
    cuda_s = time.time() - t0
    t0 = time.time()
    want = correct_known_hamming(sample, allow_list, KNOWN_D, 16,
                                 device="cpu")
    cpu_s = time.time() - t0
    say(f"[known list] correction map of {len(sample)} observed tags of "
        f"{len(keys)}: cuda ({cuda_s:.2f} s) "
        f"{'equals' if got == want else 'DIFFERS from'} the plain version "
        f"on the cpu ({cpu_s:.2f} s); {len(got)} tags corrected")
    check(got == want, "known-list correction maps differ")
    check(tdist.match_hits_launches == n + 1,
          "the sample check did not launch the kernel once")
    return launches


class _Routes:
    """Context of correct_degenerate_groups's routing: `hits` sets
    EDIT_HITS_MIN_PAIRS to 0 (the edit-hits route), `rows` to above any
    call (the host route, edit_distance on the card), `myers` as well and
    puts the host Myers code in place of edit_distance_rows; None keeps
    them."""

    def __init__(self, route):
        self.route = route

    def __enter__(self):
        from clique_tpu_torch.collapse import correct as tcorrect
        from clique_tpu_torch.collapse import distance as tdist

        self.saved = (tcorrect.EDIT_HITS_MIN_PAIRS,
                      tcorrect.edit_distance_rows, tdist.edit_distance_rows)
        if self.route == "hits":
            tcorrect.EDIT_HITS_MIN_PAIRS = 0
        elif self.route in ("rows", "myers"):
            tcorrect.EDIT_HITS_MIN_PAIRS = 1 << 62
        if self.route == "myers":
            rows = self.saved[2]

            def myers(a, b, la, lb, device="cuda"):
                if a.shape[1] > tdist.MYERS_MAX_LEN:
                    return rows(a, b, la, lb, device=device)
                return tdist._edit_distance_myers_host(a, b, la, lb)
            tcorrect.edit_distance_rows = tdist.edit_distance_rows = myers

    def __exit__(self, *exc):
        from clique_tpu_torch.collapse import correct as tcorrect
        from clique_tpu_torch.collapse import distance as tdist

        (tcorrect.EDIT_HITS_MIN_PAIRS, tcorrect.edit_distance_rows,
         tdist.edit_distance_rows) = self.saved


def _correct_wall(batch, route=None):
    """correct_degenerate_groups over batch = (group_counts, d, length,
    ratio) on the card with the given route; (maps, seconds)."""
    from clique_tpu_torch.collapse.correct import correct_degenerate_groups

    groups, d, length, ratio = batch
    with _Routes(route):
        t0 = time.time()
        got = correct_degenerate_groups(groups, d, length, ratio,
                                        device="cuda")
        return got, time.time() - t0


def _wide_lev_group():
    """A DegenerateTag group of 80-byte tags (they keep their length past
    the configured 16): 8 of count 10, 40 of count 1 one to three
    substitutions from them. Its pairs go to edit_distance."""
    from collections import Counter

    import numpy as np

    rng = np.random.default_rng(80)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    hi = [r.tobytes() for r in rng.choice(bases, (8, 80))]
    counts = Counter({t: 10 for t in hi})
    while len(counts) < 48:
        t = bytearray(hi[int(rng.integers(8))])
        for _ in range(int(rng.integers(1, 4))):
            t[rng.integers(80)] = int(rng.choice(bases))
        counts.setdefault(bytes(t), 1)
    return counts


@_walled
def phase_device_levenshtein():
    """The device-Levenshtein group (2,000 tags of count 10, ~2,000 of
    count 1: 3,656,000 ratio-filtered pairs) and a group of 80-byte tags
    in one correct_degenerate_groups call, the path run: edit_hits for the
    first, edit_distance for the second. Then the 16 bp group alone: the
    edit-hits route in turns with the route before it (host pair
    preparation and edit_distance, A B B A), the edit-hits route's wall
    split into the edit_hits calls, the absorption and the rest, and the
    host Myers route. The 16 bp group's maps must equal the host Myers
    map, the 80-byte group's the plain version's on the CPU."""
    import torch

    from clique_tpu_torch.collapse import correct as tcorrect
    from clique_tpu_torch.collapse import distance as tdist

    counts, wide = _lev_group(), _wide_lev_group()
    path = ([counts, wide], LEV_D, 16, LEV_RATIO)
    alone = ([counts], LEV_D, 16, LEV_RATIO)
    n_pairs = tcorrect.candidate_pair_count(*alone)
    _reset_counts()
    got, path_s = _correct_wall(path)
    launches = _counts()
    hits, hits_s = _correct_wall(alone)
    rows, rows_s = _correct_wall(alone, "rows")
    rows2, rows2_s = _correct_wall(alone, "rows")
    spent = {"edit_hits": 0.0, "degenerate_finish": 0.0}
    real = {k: getattr(tcorrect, k) for k in spent}

    def timed(name):
        def run(*a, **k):
            t0 = time.time()
            out = real[name](*a, **k)
            if name == "edit_hits":
                torch.cuda.synchronize()
            spent[name] += time.time() - t0
            return out
        return run

    for k in spent:
        setattr(tcorrect, k, timed(k))
    try:
        hits2, hits2_s = _correct_wall(alone)
    finally:
        for k, f in real.items():
            setattr(tcorrect, k, f)
    want, myers_s = _correct_wall(alone, "myers")
    want_wide = tcorrect.correct_degenerate_groups(
        [wide], LEV_D, 16, LEV_RATIO, device="cpu")[0]
    absorbed = sum(1 for k, v in got[0].items() if k != v)
    same = (got[0] == want[0] and hits == hits2 == rows == rows2 == want
            and got[1] == want_wide)
    say(f"[device levenshtein] {len(counts)} tags ({n_pairs} candidate "
        f"pairs) and 48 of 80 bytes: correct_degenerate_groups on the card "
        f"{path_s:.3f} s (launches {launches}); the 16 bp group alone with "
        f"edit_hits {hits_s:.4f} / {hits2_s:.4f} s, before it (host "
        f"preparation, edit_distance) {rows_s:.3f} / {rows2_s:.3f} s, with "
        f"host Myers {myers_s:.3f} s; maps {'equal' if same else 'DIFFER'}"
        f", {absorbed} tags absorbed")
    say(f"[device levenshtein] split of the second edit-hits run: edit_hits "
        f"{spent['edit_hits']:.4f} s, degenerate_finish "
        f"{spent['degenerate_finish']:.4f} s, the rest (normalization, "
        f"matrix, upload) "
        f"{hits2_s - spent['edit_hits'] - spent['degenerate_finish']:.4f} s")
    check(n_pairs >= tcorrect.EDIT_HITS_MIN_PAIRS,
          "too few pairs for the edit-hits route")
    check(launches["edit_hits"] >= 1,
          "correct_degenerate_groups launched no edit_hits")
    check(launches["edit_distance"] >= 1,
          "the 80-byte group launched no edit_distance")
    check(same, "edit-hits, edit-distance and host Myers (or, for the "
          "80-byte group, CPU) correction maps differ")
    check(absorbed > 0, "no tag was absorbed")
    return launches


def _umi_batch(n_groups, seed):
    """n_groups groups of 12 bp UMIs as the bench chain's second level
    has them: 8 tags of count 10 and 56 of count 1, one to three
    substitutions from one of the 8 (512 candidate pairs a group)."""
    from collections import Counter

    import numpy as np

    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    groups = []
    for _ in range(n_groups):
        hi = [r.tobytes() for r in rng.choice(bases, (8, 12))]
        g = Counter({t: 10 for t in hi})
        while len(g) < 64:
            t = bytearray(hi[int(rng.integers(8))])
            for _ in range(int(rng.integers(1, 4))):
                t[rng.integers(12)] = int(rng.choice(bases))
            g.setdefault(bytes(t), 1)
        groups.append(g)
    return groups


@_walled
def phase_threshold(level_batches):
    """correct_degenerate_groups's host route (pair preparation and host
    Myers) and its edit-hits route in turns (host, card, card, host) on
    batches of 2 to 8,192 UMI groups (1,024 to 4,194,304 candidate pairs)
    and on the bench chain's degenerate level batches; the maps must be
    equal. Prints each batch's walls and where the card's route starts to
    win (the place for EDIT_HITS_MIN_PAIRS)."""
    from clique_tpu_torch.collapse import correct as tcorrect

    batches = [(f"{g} UMI groups", (_umi_batch(g, g), 2, 12, 5.0))
               for g in (2, 4, 8, 16, 32, 128, 512, 2048, 8192)]
    batches += level_batches
    rows = []
    for label, batch in batches:
        n = tcorrect.candidate_pair_count(*batch)
        want, h1 = _correct_wall(batch, "myers")
        got, c1 = _correct_wall(batch, "hits")
        got2, c2 = _correct_wall(batch, "hits")
        want2, h2 = _correct_wall(batch, "myers")
        check(got == want == got2 == want2,
              f"threshold {label}: the routes' maps differ")
        rows.append((n, h1, h2, c1, c2))
        say(f"[threshold] {label}: {n} candidate pairs, host route "
            f"{h1 * 1e3:.1f} / {h2 * 1e3:.1f} ms, edit-hits route "
            f"{c1 * 1e3:.1f} / {c2 * 1e3:.1f} ms (maps equal)")
    wins = sorted((n, max(c1, c2) < min(h1, h2))
                  for n, h1, h2, c1, c2 in rows)
    first = next((n for k, (n, _w) in enumerate(wins)
                  if all(w for _n, w in wins[k:])), None)
    last_loss = max((n for n, w in wins if not w), default=None)
    say(f"[threshold] the edit-hits route wins from {first} candidate pairs "
        f"on (last host win {last_loss}); EDIT_HITS_MIN_PAIRS = "
        f"{tcorrect.EDIT_HITS_MIN_PAIRS}")
    return rows


def _sass_ops(functions):
    """{function: {opcode: count}} of the named functions in the built
    library's SASS (cuobjdump). An IMAD.MOV is a move and counts as MOV."""
    from clique_tpu_torch import _build

    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    res = subprocess.run([cuobjdump, "-sass", _build.build_info().path],
                         capture_output=True, text=True)
    check(res.returncode == 0, f"cuobjdump failed: {res.stderr[-500:]}")
    out, cur = {f: {} for f in functions}, None
    for line in res.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = m.group(1)
            continue
        m = re.match(r"\s+/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)",
                     line)
        if m and cur in out:
            name = m.group(1)
            op = "MOV" if name.startswith("IMAD.MOV") else name.split(".")[0]
            out[cur][op] = out[cur].get(op, 0) + 1
    for f in functions:
        check(out[f], f"no {f} in the SASS")
    return out


def _sass_cell_counts():
    """{probe: (MUFU, FP32-pipe instructions, opcodes)} of one pair-HMM
    cell in the built library's SASS (csrc/hmm_forward.cu, besides the
    probes' loads and stores): clique_hmm_cell_probe, the kernel's cell,
    and clique_hmm_cell_floor_probe, the cell without the compares and
    selects that pick the slot of each LSE's maximum."""
    probes = ("clique_hmm_cell_probe", "clique_hmm_cell_floor_probe")
    out = {}
    for name, ops in _sass_ops(probes).items():
        mufu = ops.get("MUFU", 0)
        fp32 = sum(ops.get(o, 0) for o in FP32_OPCODES)
        check(mufu > 0 and fp32 > 0, f"no {name} in the SASS: {ops}")
        out[name] = (mufu, fp32, ops)
    return out


def _ctas_per_sm(ptxas_lines, threads):
    """CTAs of `threads` threads that fit on an SM (sm_90: 64 K registers
    allocated 256 a warp at a time, 64 warps, 32 CTAs) at the registers
    ptxas gave the kernel; None if the build log did not say."""
    m = re.search(r"Used (\d+) registers", " ".join(ptxas_lines))
    if not m:
        return None
    warps = threads // 32
    per_warp = -(-int(m.group(1)) * 32 // 256) * 256
    return min(65536 // (per_warp * warps), 64 // warps, 32)


def _sm_clock_hz():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    return float(smi.stdout.split()[0]) * 1e6


def _hmm_batch(rng, n_refs, n_reads, width):
    """Every (read, reference) pair of n_reads reads against n_refs
    references of ~width bases: reference bytes with N and digit
    wildcards, reads from their reference with 8% substitutions (N among
    them) and a 5-base deletion in every other one; ragged lengths."""
    import numpy as np

    bases = np.frombuffer(b"ACGT", np.uint8)
    letters = np.frombuffer(b"ACGTACGTACGTACGTN0123", np.uint8)
    refs = [rng.choice(letters, int(rng.integers(width - 30, width + 1)))
            for _ in range(n_refs)]
    reads = []
    for q in range(n_reads):
        src = refs[q % n_refs].copy()
        src[src < 58] = rng.choice(bases, int((src < 58).sum()))
        if q % 2:
            cut = int(rng.integers(0, len(src) - 5))
            src = np.concatenate([src[:cut], src[cut + 5:]])
        sub = rng.random(len(src)) < 0.08
        src[sub] = rng.choice(np.frombuffer(b"ACGTN", np.uint8),
                              int(sub.sum()))
        reads.append(src)
    B = n_refs * n_reads
    R = np.zeros((B, width), np.uint8)
    Q = np.zeros((B, width), np.uint8)
    l1 = np.zeros(B, np.int32)
    l2 = np.zeros(B, np.int32)
    for q, read in enumerate(reads):
        for r, ref in enumerate(refs):
            i = q * n_refs + r
            R[i, :len(ref)], Q[i, :len(read)] = ref, read
            l1[i], l2[i] = len(ref), len(read)
    return R, Q, l1, l2


def _hold_ll(label, got, want):
    """The kernel's LLs against the plain version's: finite and equal (both
    take the same f32 terms, the JAX package's order in every LSE and the
    card's expf / logf). Returns the largest absolute difference."""
    import torch

    check(bool(torch.isfinite(got).all()), f"{label}: a non-finite LL")
    err = float((got - want).abs().max())
    say(f"[hmm] {label}: max |kernel - plain| {err:.3g}")
    check(torch.equal(got, want), f"{label}: hmm_forward differs from its "
          "plain version")
    return err


@_walled
def phase_hmm_kernel():
    """hmm_forward against its plain version on the card, exactly, at one
    launch of each strip height (the panel's shape, 1,024 pairs of ~250 x
    ~250: 32 reads against 32 references, whose routes must agree, at 8
    rows a lane; 1,024 pairs of ~350 x ~350 at 12), on pairs of 6,600
    and 5,000 rows (row bands) and at the panel's launch shape (B=368,640,
    the first batch 360 times over, where a warp streams many pairs); its
    registers, spills and CTAs an SM; timed in turns with the plain
    version at B=1,024 and alone at B=368,640; its bounds from the MUFU and
    FP32-pipe instructions of a cell in the SASS, with and without the
    selection of each LSE's maximum."""
    import numpy as np
    import torch

    from clique_tpu_torch import _build
    from clique_tpu_torch.align import hmm

    lib = _build.load()
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(39)
    p = torch.from_numpy(hmm.default_hmm_params()).to(dev)

    def rows(batch):
        return lib.clique_hmm_forward_strip_rows(batch[0].shape[1] + 1)

    n_q = n_r = 32
    host = _hmm_batch(rng, n_r, n_q, 250)
    args = [torch.from_numpy(a).to(dev) for a in host]
    got = hmm.hmm_forward_batch(*args, p)
    want = hmm.hmm_forward_batch_reference(*args, p)
    err = _hold_ll(f"B=1024, 32 reads x 32 references of 220-250 bases "
                   f"({rows(args)} rows a lane)", got, want)
    g = got.view(n_q, n_r)
    check(int((g.argmax(1).cpu() == torch.arange(n_q) % n_r).sum()) >= 24,
          "hmm_forward does not route the reads to their references")

    # a read of 250 bases against references of 6,600 and 5,000 rows
    letters = np.frombuffer(b"ACGTACGTACGTACGTN0123", np.uint8)
    lrefs = np.zeros((2, 6600), np.uint8)
    lrefs[0] = rng.choice(letters, 6600)
    lrefs[1, :5000] = rng.choice(letters, 5000)
    lreads = np.repeat(lrefs[:1, 3000:3250], 2, axis=0)
    lreads[lreads < 58] = ord("A")
    long = (lrefs, lreads, np.array([6600, 5000], np.int32),
            np.array([250, 250], np.int32))
    largs = [torch.from_numpy(a).to(dev) for a in long]
    err = max(err, _hold_ll(f"pairs of 6,600 and 5,000 reference rows "
                            f"({rows(largs)} rows a lane, row bands)",
                            hmm.hmm_forward_batch(*largs, p),
                            hmm.hmm_forward_batch_reference(*largs, p)))
    # the other strip height: references of 320-350 rows
    wide = [torch.from_numpy(a).to(dev)
            for a in _hmm_batch(rng, n_r, n_q, 350)]
    err = max(err, _hold_ll(f"B=1024, 32 reads x 32 references of 320-350 "
                            f"bases ({rows(wide)} rows a lane)",
                            hmm.hmm_forward_batch(*wide, p),
                            hmm.hmm_forward_batch_reference(*wide, p)))
    for n1 in (251, 351):
        r = lib.clique_hmm_forward_strip_rows(n1)
        lines = PTXAS.get(f"hmm_forward<rows={r}>", ["not read"])
        ctas = _ctas_per_sm(lines, 128)
        say(f"[hmm] hmm_forward<rows={r}> (n1={n1}): {'; '.join(lines)}; "
            + (f"{ctas} CTAs ({4 * ctas} warps) an SM by its registers"
               if ctas else "CTAs an SM not read"))

    k_ms, p_ms = _turns("[hmm] hmm_forward at B=1024, ~250 x ~250",
                        lambda: hmm.hmm_forward_batch(*args, p),
                        lambda: hmm.hmm_forward_batch_reference(*args, p),
                        20)
    counts = _sass_cell_counts()
    clock = _sm_clock_hz()

    def hmm_bound(cells, probe):
        mufu, fp32, _ = counts[probe]
        t_mufu = mufu * cells / (MUFU_PER_SM_CLOCK * SMS * clock) * 1e3
        t_fp32 = fp32 * cells / (FP32_PER_SM_CLOCK * SMS * clock) * 1e3
        return max(t_mufu, t_fp32), t_mufu, t_fp32

    # the kernels line takes the floor's bound (no slot selection), the
    # least the function needs; the kernel cell's is printed beside it
    floor, full = "clique_hmm_cell_floor_probe", "clique_hmm_cell_probe"
    cells = int((host[2].astype(np.int64) * host[3]).sum())
    for probe in (full, floor):
        mufu, fp32, ops = counts[probe]
        bound_ms, t_mufu, t_fp32 = hmm_bound(cells, probe)
        say(f"[hmm] a cell's SASS ({probe}): {mufu} MUFU, {fp32} "
            f"FP32-pipe instructions ({json.dumps(dict(sorted(ops.items())))})"
            f"; {cells} cells at the SM clock nvidia-smi reports "
            f"({clock / 1e6:.0f} MHz): MUFU {t_mufu:.4f} ms, FP32 pipe "
            f"{t_fp32:.4f} ms; bound {bound_ms:.4f} ms, the kernel at "
            f"{bound_ms / k_ms:.3f} of it; {cells / k_ms / 1e6:.3f} G cells/s")
    b = (hmm_bound(cells, floor)[0], "operations")
    # the panel's launch shape: a route call of 2,048 reads against 180
    # references is 368,640 pairs (this batch 360 times over): a warp
    # streams many pairs, held against the plain version's LLs 360 times
    big = [a.repeat(360, *([1] * (a.dim() - 1))).contiguous() for a in args]
    big_ll = hmm.hmm_forward_batch(*big, p)
    check(torch.equal(big_ll, want.repeat(360)), "hmm_forward at B=368,640 "
          "differs from its plain version at B=1,024, repeated")
    say("[hmm] B=368,640 (the B=1,024 batch 360 times over): equal to the "
        "plain version's LLs 360 times over")
    big_ms = _time_ms(lambda: hmm.hmm_forward_batch(*big, p), 3)
    for probe in (full, floor):
        big_bound = hmm_bound(360 * cells, probe)[0]
        say(f"[hmm] hmm_forward at B=368,640 (the panel's launch shape): "
            f"{big_ms:.3f} ms, bound ({probe}) {big_bound:.3f} ms, the "
            f"kernel at {big_bound / big_ms:.3f} of it; "
            f"{360 * cells / big_ms / 1e6:.3f} G cells/s")
    return err, _timing(k_ms, p_ms, b)


def _panel_dataset(workdir):
    """The stand-in for config 5's 180-guide panel: one seeded backbone,
    180 references differing only in a seeded 20 bp guide, 40 reads a
    reference with 5% substitutions (bench_extra.py's _make_reads), in a
    seeded order. Read e<k> comes from reference k // 40."""
    import numpy as np

    rng = np.random.default_rng(13)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    backbone = rng.choice(bases, PANEL_BACKBONE)
    g0, g1 = PANEL_GUIDE
    refs = []
    for _ in range(N_PANEL_REFS):
        r = backbone.copy()
        r[g0:g1] = rng.choice(bases, g1 - g0)
        refs.append(r)
    layout_text = ("known_strand: true\nreads:\n  - !Read1\n"
                   "    orientation: Forward\nreferences:\n" + "".join(
                       f"  guide{k:03d}:\n    sequence: "
                       f"\"{r.tobytes().decode()}\"\n"
                       for k, r in enumerate(refs)))
    lines = []
    for k, ref in enumerate(refs):
        for i in range(PANEL_PER_REF):
            read = ref.copy()
            subs = rng.random(len(read)) < 0.05
            read[subs] = rng.choice(bases, int(subs.sum()))
            lines.append(f"@e{k * PANEL_PER_REF + i}\n"
                         f"{read.tobytes().decode()}\n+\n"
                         f"{'I' * len(read)}\n")
    lines = [lines[i] for i in rng.permutation(len(lines))]
    wd = os.path.join(workdir, "panel")
    os.makedirs(wd)
    fq, head = os.path.join(wd, "panel.fastq"), os.path.join(wd, "head.fastq")
    for path, part in ((fq, lines), (head, lines[:N_PANEL_CPU])):
        with open(path, "w") as fh:
            fh.writelines(part)
    return wd, layout_text, fq, head


@_walled
def phase_panel(workdir, pool):
    """align --router hmm over the 180-reference panel on the card: every
    read against every reference through hmm_forward, the routed reads
    through dp_align. The first 64 reads' BAM on the CPU is computed in
    the pool; panel_head_check holds it against the card's."""
    from clique_tpu_torch.align.pipeline import align_reads
    from clique_tpu_torch.io.sam import BamReader

    wd, layout_text, fq, head = _panel_dataset(workdir)
    layout, rm = _layout_from_text(layout_text, wd)
    head_cpu = pool.submit(_align_on_cpu, layout_text, head,
                           os.path.join(wd, "cpu"), PANEL_BATCH, "hmm")
    out_head = os.path.join(wd, "head_cuda.bam")
    align_reads(layout, rm, out_head, read1=head, batch_size=PANEL_BATCH,
                router="hmm", device="cuda")

    out = os.path.join(wd, "panel.bam")
    metrics_path = os.path.join(wd, "metrics.json")
    _reset_counts()
    t0 = time.time()
    stats = align_reads(layout, rm, out, read1=fq, batch_size=PANEL_BATCH,
                        router="hmm", device="cuda",
                        metrics_path=metrics_path)
    seconds = time.time() - t0
    launches = _counts()
    with open(metrics_path) as fh:
        m = json.load(fh)
    with BamReader(out, parse_tags=False) as reader:
        routed = [(rec.name, rec.reference_name) for rec in reader]
    right = sum(ref == f"guide{int(name[1:]) // PANEL_PER_REF:03d}"
                for name, ref in routed)
    n_reads = N_PANEL_REFS * PANEL_PER_REF
    pairs = n_reads * N_PANEL_REFS
    say(f"[panel] {stats.aligned}/{stats.total} reads over {N_PANEL_REFS} "
        f"references ({pairs} read-reference pairs, ~{pairs * 231 ** 2:.3g} "
        f"forward cells) with --router hmm on the card: {seconds:.3f} s, "
        f"{stats.aligned / seconds:.1f} reads/s; routing accuracy "
        f"{right}/{len(routed)} = {right / len(routed):.4f}; launches "
        f"hmm_forward {launches['hmm_forward']}, dp_align "
        f"{launches['dp_align']}; device_seconds {m['device_seconds']}, "
        f"phase walls {json.dumps(m['phase_walls'])}")
    check(stats.aligned == n_reads, "not every panel read was aligned")
    check(launches["hmm_forward"] > 0 and launches["dp_align"] > 0,
          f"the panel did not launch both kernels: {launches}")
    check(m["kernel_launches"]["hmm_forward"] == launches["hmm_forward"],
          "the align metrics miscount hmm_forward")
    check(right >= 0.9 * len(routed), "the panel's routing accuracy is "
          "below 0.9")
    return launches, (rm, head, out_head, head_cpu)


def _route_ties(rm, head, cpu_bam, cuda_bam):
    """Where the head's CUDA and CPU BAMs differ: each read whose route
    differs must be a tie within the tolerance on the CPU's LLs, and every
    other read's record must be the same. Returns the number of ties."""
    import torch

    from clique_tpu_torch.align import hmm
    from clique_tpu_torch.io.fastq import ReadIterator
    from clique_tpu_torch.io.sam import BamReader

    reads = [rec.seq for rec in ReadIterator(head).read_one_records()]
    refs = [r.sequence for r in rm.references.values()]
    lls = {device: torch.from_numpy(
        hmm.HmmRouter(refs, device=device).pair_lls(reads)[2]).view(
            len(reads), -1) for device in ("cuda", "cpu")}
    top = lls["cpu"].topk(2, dim=1).values
    tie = (top[:, 0] - top[:, 1]) <= HMM_ATOL + HMM_RTOL * top[:, 0].abs()
    moved = lls["cuda"].argmax(1) != lls["cpu"].argmax(1)
    check(bool(tie[moved].all()), "a panel read routes elsewhere on the "
          "card than on the CPU, and not at a tie")

    def records(path):
        with BamReader(path) as reader:
            return {r.name: r.to_sam_line() for r in reader}

    names = [rec.name for rec in ReadIterator(head).read_one_records()]
    a, b = records(cuda_bam), records(cpu_bam)
    skip = {names[i] for i in range(len(names)) if bool(moved[i])}
    check(all(a.get(n) == b.get(n) for n in names if n not in skip),
          "the head's records differ between cuda and cpu off the ties")
    return int(moved.sum())


@_walled
def panel_head_check(pending):
    rm, head, out_head, future = pending
    head_cpu, seconds = future.result()
    same = _inflate_bgzf(out_head) == head_cpu
    ties = 0
    if not same:
        cpu_bam = os.path.join(os.path.dirname(out_head), "cpu", "cpu.bam")
        ties = _route_ties(rm, head, cpu_bam, out_head)
    say(f"[panel] first {N_PANEL_CPU} reads on cpu (in the pool): "
        f"{seconds:.2f} s; cuda and cpu aligned BAMs "
        f"{'identical' if same else 'equal apart from the ties'}; routes "
        f"that differ at a tie within the tolerance: {ties}")


def _record_multiset(path):
    from clique_tpu_torch.io.sam import BamReader

    with BamReader(path) as reader:
        return sorted((r.name, r.seq, r.qual, r.cigar_string,
                       tuple(sorted(r.tags.items()))) for r in reader)


@_walled
def phase_workers(workdir, bench):
    """collapse --threads N on the bench phase's aligned 80,000-read BAM on
    the card, in turns: one process, N workers, N workers, one process,
    then N workers out of core. The five give the same records, the two
    in-RAM N-worker runs the same bytes; every worker reports no CUDA
    context. Then golden (in-RAM) and golden_ml (maximum_subsequences:
    the spill path) with two workers give their pinned records."""
    from clique_tpu_torch.collapse.pipeline import collapse

    layout_text, aligned = bench[0], bench[1]
    wd = os.path.join(workdir, "workers")
    os.makedirs(wd)
    layout, _rm = _layout_from_text(layout_text, wd)
    n = min(8, (os.cpu_count() or 2) - 1)
    say(f"[workers] N = min(8, cpu_count - 1) = {n} "
        f"(cpu_count {os.cpu_count()})")
    # what a worker pays to import its modules, in a fresh interpreter,
    # against importing torch besides
    for label, mods in (("worker modules", "clique_tpu_torch.collapse."
                         "pipeline, clique_tpu_torch.io.sam"),
                        ("torch", "torch")):
        res = subprocess.run(
            [sys.executable, "-c", f"import sys, time; sys.path.insert(0, "
             f"{HERE!r}); t = time.time(); import {mods}; "
             f"print(time.time() - t, 'torch' in sys.modules)"],
            capture_output=True, text=True, cwd=wd)
        check(res.returncode == 0, f"import of {mods} failed: "
              f"{res.stderr[-500:]}")
        secs, has_torch = res.stdout.split()
        say(f"[workers] import of {label} in a fresh interpreter: "
            f"{float(secs):.3f} s (torch loaded: {has_torch})")
    from clique_tpu_torch.collapse.workers import make_pool, warmup_task

    t0 = time.time()
    pool = make_pool(n)
    try:
        pool.map(warmup_task, range(n), chunksize=1)
    finally:
        pool.close()
        pool.join()
    say(f"[workers] a pool of {n} started, every worker's modules imported "
        f"and the pool joined: {time.time() - t0:.3f} s; the aligned BAM "
        f"is {os.path.getsize(aligned)} bytes (ingest runs in the main "
        f"process below CLIQUE_PAR_INGEST_MIN, 8 MiB by default)")
    launches = dict.fromkeys(KERNELS, 0)
    sets, payloads = [], []
    for i, (nw, ooc) in enumerate([(1, False), (n, False), (n, False),
                                   (1, False), (n, True)]):
        out = os.path.join(wd, f"run{i}.bam")
        _reset_counts()
        t0 = time.time()
        stats = collapse(out, layout, aligned, temp_dir=wd, n_workers=nw,
                         out_of_core=ooc, device="cuda")
        wall = time.time() - t0
        if nw == 1 and not ooc:
            WALLS.setdefault("one-process collapse", []).append(wall)
        counts = _counts()
        for k in KERNELS:
            launches[k] += counts[k]
        with open(out + ".collapse_metrics.json") as fh:
            m = json.load(fh)
        workers = m.get("workers", [])
        no_cuda = all(not w["cuda_initialized"] for w in workers)
        say(f"[workers] run {i}: n_workers {nw}"
            f"{', out of core' if ooc else ''}: {wall:.3f} s (ingest "
            f"{m.get('ingest_s')} s, levels {m.get('levels_s')} s, outputs "
            f"{m.get('outputs_s')} s), {stats.passing} passing, edit_hits "
            f"launches {counts['edit_hits']}; {len(workers)} workers "
            f"reported, torch.cuda.is_initialized() "
            f"{sorted({w['cuda_initialized'] for w in workers})}, torch "
            f"imported {sorted({w['torch'] for w in workers})}, jax or JAX-"
            f"package modules {sorted({m_ for w in workers for m_ in w['forbidden']})}")
        check(counts["edit_hits"] > 0, f"workers run {i} launched no "
              "edit_hits")
        check(nw == 1 or (workers and no_cuda), f"workers run {i}: a "
              "worker made a CUDA context, or none reported")
        check(not any(w["forbidden"] for w in workers),
              f"workers run {i}: a worker loaded jax or the JAX package")
        sets.append(_record_multiset(out))
        payloads.append(_inflate_bgzf(out))
    check(all(s == sets[0] for s in sets), "the worker runs' records differ")
    check(payloads[1] == payloads[2], "the two N-worker runs' bytes differ")
    say(f"[workers] the five runs give the same {len(sets[0])} records; the "
        f"two in-RAM {n}-worker runs the same bytes")
    for name in ("golden", "golden_ml"):
        gwd = os.path.join(wd, name)
        gd, glayout, _grm = _golden_layout(name, gwd)
        out = os.path.join(gwd, "collapsed.bam")
        collapse(out, glayout, os.path.join(gd, "aligned.bam"),
                 temp_dir=gwd, n_workers=2, device="cuda")
        with open(out + ".collapse_metrics.json") as fh:
            m = json.load(fh)
        same = _record_multiset(out) == _record_multiset(
            os.path.join(gd, "collapsed.bam"))
        say(f"[workers] {name} with --threads 2 on the card "
            f"({'spill path' if m.get('out_of_core') else 'in RAM'}): "
            f"records {'equal' if same else 'DIFFER from'} the pinned "
            f"collapsed.bam's")
        check(same, f"{name} with two workers differs from its pin")
        check(m["workers"] and not any(w["cuda_initialized"]
                                       for w in m["workers"]),
              f"{name}: a worker made a CUDA context")
    return launches


def _wfa_ops_per(ops):
    """Operations in a probe's SASS: every instruction but WFA_NON_OPS."""
    return sum(n for op, n in ops.items() if op not in WFA_NON_OPS)


_WFA_OPS = {}


def _wfa_op_counts():
    """Operations of the recurrence from the probes' SASS, once: a cell
    with its op byte ("align", wfa_align) and without ("score",
    wfa_score) for each model, wfa_mid's affine cell with its payload work
    ("mid"), and four extension bytes ("word")."""
    if _WFA_OPS:
        return _WFA_OPS
    probes = {("align", "affine"): "clique_wfa_cell_probe_affine",
              ("align", "affine2p"): "clique_wfa_cell_probe_affine2p",
              ("score", "affine"): "clique_wfa_score_probe_affine",
              ("score", "affine2p"): "clique_wfa_score_probe_affine2p",
              ("score", "linear"): "clique_wfa_score_probe_linear",
              ("mid", "affine"): "clique_wfa_mid_probe",
              "word": "clique_wfa_word_probe"}
    sass = _sass_ops(tuple(probes.values()))
    for key, fn in probes.items():
        _WFA_OPS[key] = _wfa_ops_per(sass[fn])
        say(f"[wfa] {fn}: {_WFA_OPS[key]} operations "
            f"({json.dumps(dict(sorted(sass[fn].items())))})")
    return _WFA_OPS


def _wfa_pairs(rng, B):
    """bench_wfa's pairs: B random references of WFA_L bases, reads with
    5% substitutions."""
    import numpy as np

    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    refs = rng.choice(bases, (B, WFA_L)).astype(np.uint8)
    reads = refs.copy()
    subs = rng.random((B, WFA_L)) < 0.05
    reads[subs] = rng.choice(bases, int(subs.sum()))
    lens = np.full(B, WFA_L, dtype=np.int32)
    return refs, reads, lens, lens.copy()


def _wfa_cells(pen, l1, l2, smax, kmax, model, o, e, o2, e2):
    """The (score step, diagonal) cells the fills of these pairs need:
    for each pair and each step s = 1 .. its steps (its penalty, or smax
    if censored), the diagonals k with |k| <= min(s, kmax, reach(s)) and
    -l2 <= k <= l1, where reach(s) is the widest |k| a penalty of s pays
    for (one gap of (s - o) // e bases; under affine2p of either class).
    Every other diagonal is NEG at that step."""
    import numpy as np

    s = np.arange(1, smax + 1, dtype=np.int64)
    reach = np.maximum(0, (s - o) // e)
    if model == "affine2p":
        reach = np.maximum(reach, np.maximum(0, (s - o2) // e2))
    r = np.minimum(np.minimum(s, kmax), reach)[None]
    width = (np.minimum(r, l2.astype(np.int64)[:, None])
             + np.minimum(r, l1.astype(np.int64)[:, None]) + 1)
    steps = np.minimum(pen.astype(np.int64), smax)
    return int((width * (s[None] <= steps[:, None])).sum())


def _wfa_bound(host, pen, kw, traceback, kind=None):
    """The least time of a wavefront fill on these inputs: the bytes it
    must move (both sequences and lengths in; penalties out, and with
    traceback the op-store rows up to each pair's penalty, the skeleton
    rows and end rows; for wfa_mid, kind "mid", the payloads) over the
    memory rate, and its integer operations over the int32 rate: the
    recurrence's operations (the probes' SASS) for each cell _wfa_cells
    counts, and four extension bytes' for each four read bytes (the least
    extension an alignment compares). Returns (bound pair, cells)."""
    import numpy as np

    from clique_tpu_torch.align import wfa_kernels as wk

    refs, reads, l1, l2 = host
    B, smax, model = len(l1), kw["smax"], kw.get("model", "affine")
    pens = {k: kw.get(k, d) for k, d in
            (("o", 6), ("e", 2), ("o2", 24), ("e2", 1))}
    if model == "linear":
        pens["o"] = 0      # no gap open: reach(s) = s // e
    kmax = wk.kmax_of(model, refs.shape[1], reads.shape[1], smax,
                      pens["o"], pens["e"], pens["o2"], pens["e2"],
                      kw.get("kband"))
    ops_per = _wfa_op_counts()
    cells = _wfa_cells(pen, l1, l2, smax, kmax, model, **pens)
    kind = kind or ("align" if traceback else "score")
    nbytes = refs.nbytes + reads.nbytes + 8 * B + 4 * B
    if kind == "mid":
        nbytes += 4 * B
    if traceback:
        steps = np.minimum(pen.astype(np.int64), smax)
        nbytes += int(np.sum(steps + 1)) * (2 * kmax + 1) + \
            B * (smax + 1) + 4 * B
    ops = cells * ops_per[(kind, model)] + \
        int(np.sum(-(-l2.astype(np.int64) // 4))) * ops_per["word"]
    return bound(nbytes, ops, PEAK_INT32_OPS), cells


def _plan_line(args, kw, kind):
    """wfa_kernels.wfa_plan's layout of a launch, as a line."""
    from clique_tpu_torch.align import wfa_kernels as wk

    (B, n1), n2 = args[0].shape, args[1].shape[1]
    model = kw.get("model", "affine")
    pen = {k: kw.get(k, d) for k, d in WFA_PEN.items()}
    if model == "affine":
        pen.update(o2=0, e2=0)
    elif model == "linear":
        pen.update(o=0, o2=0, e2=0)
    kmax = wk.kmax_of(model, n1, n2, kw["smax"], pen["o"], pen["e"],
                      pen["o2"], pen["e2"], kw.get("kband"))
    plan = wk.wfa_plan(kind, model, n1, n2, B, kw["smax"], kmax, **pen,
                       adaptive=kw.get("adaptive") is not None)
    rings = "the global workspace" if plan.ring_global else "shared memory"
    where = (f"a persistent grid of <= {plan.grid} CTAs, rings in {rings}"
             if plan.grid else
             f"the warp path, one warp a pair, {plan.wp} pairs a CTA"
             if plan.wp else f"a cluster of {plan.C} CTA(s) a pair")
    return (f"plan C={plan.C} ({where}), {plan.steps} step(s) a barrier, "
            f"ring rows {plan.heights} of {plan.value_bytes} B, {plan.cw} "
            f"diagonals and {plan.threads} threads a CTA, {plan.smem} B of "
            f"shared memory")


def _wfa_check(label, args, kw, traceback, reps=20):
    """wfa_align (traceback) or wfa_score on these card tensors against
    its plain version on the same inputs (penalties; with traceback also
    the op-store rows up to each pair's penalty, skeletons and end rows),
    then timed in turns with it, beside its bound. Returns (max abs err,
    timing)."""
    import torch

    from clique_tpu_torch.align import wfa_kernels as wk

    B, n1 = args[0].shape
    model = kw.get("model", "affine")
    if traceback:
        pen, ops, fwd, fin, runs = wk.wfa_align(*args, **kw)
        p_pen, p_ops = wk.wfa_fill_reference(*args, **kw)
        walk_kw = {k: kw[k] for k in ("model", "x", "o", "e", "o2", "e2")
                   if k in kw}
        p_fwd, p_fin = wk.wfa_walk_reference(p_ops, p_pen, args[2] - args[3],
                                             **walk_kw)
        p_runs = wk.wfa_runs_reference(
            *args, p_fwd, p_fin, width=runs.shape[1],
            wildcards=kw.get("wildcards", False))
        # each walked lane's words up to its 0; the rest are not defined
        upto = torch.arange(runs.shape[1], device=runs.device)[None, :] <= \
            torch.where(p_fin[:, None] == -1,
                        (p_runs == 0).int().argmax(1, keepdim=True), 0)
        rows = torch.arange(kw["smax"] + 1,
                            device=pen.device)[:, None] <= p_pen[None]
        same = (torch.equal(pen, p_pen) and torch.equal(fwd, p_fwd)
                and torch.equal(fin, p_fin)
                and bool(((runs == p_runs) | ~upto).all())
                and bool(((ops == p_ops) | ~rows[:, :, None]).all()))
        err = max(int((pen - p_pen).abs().max()),
                  int((fwd.int() - p_fwd.int()).abs().max()),
                  int((fin - p_fin).abs().max()))
        del ops, p_ops

        def kern():
            return wk.wfa_align(*args, **kw)

        def plain():
            pp, po = wk.wfa_fill_reference(*args, **kw)
            pf, pn = wk.wfa_walk_reference(po, pp, args[2] - args[3],
                                           **walk_kw)
            return wk.wfa_runs_reference(
                *args, pf, pn, width=runs.shape[1],
                wildcards=kw.get("wildcards", False))
        what = "penalties, op-store rows, skeletons, end rows and runs"
    else:
        pen = wk.wfa_score(*args, **kw)
        p_pen = wk.wfa_fill_reference(*args, traceback=False, **kw)[0]
        err = int((pen - p_pen).abs().max())
        same = err == 0

        def kern():
            return wk.wfa_score(*args, **kw)

        def plain():
            return wk.wfa_fill_reference(*args, traceback=False, **kw)
        what = "penalties"
    name = f"{'wfa_align' if traceback else 'wfa_score'}<{model}>"
    say(f"[{label}] {name} B={B} L={n1} smax={kw['smax']}: {what} "
        f"{'equal' if same else 'DIFFER'} (max abs err {err}); penalties "
        f"{int(p_pen.min())}-{int(p_pen.max())}, "
        f"{int((p_pen > kw['smax']).sum())} censored")
    check(same, f"{label}: {name} disagrees with its plain version")
    if reps == 0:
        return err, None
    kind = "align" if traceback else "score"
    say(f"[{label}] {name} B={B}: {_plan_line(args, kw, kind)}")
    k_ms, p_ms = _turns(f"[{label}] {name} B={B}", kern, plain, reps)
    host = [a.cpu().numpy() for a in args]
    b, cells = _wfa_bound(host, p_pen.cpu().numpy(), kw, traceback)
    say(f"[{label}] {name} bound {b[0]:.5f} ms by {b[1]} ({cells} cells, "
        f"{cells / B:.1f} a pair); the kernel at {b[0] / k_ms:.4f} of it")
    return err, _timing(k_ms, p_ms, b)


@_walled
def phase_wfa_kernels():
    """wfa_align (B = 512) and wfa_score (B = 1,024) of both penalty
    models on bench_wfa's pairs against their plain versions on the card,
    timed in turns with them beside their bounds. A secondary shape: the
    kernels line carries the main path's launches (_wfa_main_launches)."""
    import numpy as np
    import torch

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(3)
    errs = {"wfa_align": 0, "wfa_score": 0}
    for model in ("affine", "affine2p"):
        kw = dict(smax=WFA_SMAX, model=model, **WFA_PEN)
        for name, B in (("wfa_align", WFA_ALIGN_B),
                        ("wfa_score", WFA_SCORE_B)):
            args = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                    for a in _wfa_pairs(rng, B)]
            err, _t = _wfa_check("wfa bench_wfa", args, kw,
                                 name == "wfa_align")
            errs[name] = max(errs[name], err)
    return errs


@contextlib.contextmanager
def _recorded(name, events=None):
    """Every launch of wfa_kernels.<name> while the block runs, recorded:
    the main path calls the wrapper as before (its count included) and a
    copy of each launch's card tensors is taken on the launch's stream.
    Yields the list of (tensors, keywords). With `events` (a list), CUDA
    events on the launch's stream around each call go into it as (start,
    end, keywords, whether the call named a stream)."""
    import torch

    from clique_tpu_torch.align import wfa_kernels as wk

    orig, seen = getattr(wk, name), []

    def rec(*args, **kw):
        stream = kw.get("stream") or torch.cuda.current_stream()
        if events is not None and args[0].is_cuda:
            pair = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            pair[0].record(stream)
        out = orig(*args, **kw)
        named = kw.pop("stream", None) is not None
        if args[0].is_cuda:
            if events is not None:
                pair[1].record(stream)
                events.append((*pair, kw, named))
            with torch.cuda.stream(stream):
                seen.append(([a.clone() for a in args], kw))
        return out

    setattr(wk, name, rec)
    try:
        yield seen
    finally:
        setattr(wk, name, orig)
        torch.cuda.synchronize()


def _wfa_main_launches(label, seen, traceback):
    """The main path's recorded launches: each held against its plain
    version on the card, the first with the most pairs timed and bounded.
    Returns (max abs err, its timing)."""
    check(seen, f"{label}: no launch was recorded")
    top = max(range(len(seen)), key=lambda i: (seen[i][0][0].shape[0], -i))
    err, timing = 0, None
    for i, (args, kw) in enumerate(seen):
        e, t = _wfa_check(label, args, kw, traceback,
                          reps=20 if i == top else 0)
        err = max(err, e)
        timing = t or timing
    say(f"[{label}] {len(seen)} launches held against the plain version, "
        f"max abs err {err}")
    return err, timing


def _wfa_amplicon(rng, bases):
    """bench_extra.py's _amplicon: adapters, a 16 bp cell and a 12 bp UMI
    zone, ten 23 bp Cas9 targets joined by GAAA."""
    targets = [rng.choice(bases, 20).tobytes().decode() + "TGG"
               for _ in range(10)]
    a5 = "TTCAGACGTGTGCTCTTCCGATCT"
    a3 = "AGATCGGAAGAGCACACGTCTGAA"
    return f"{a5}{'0' * 16}{'1' * 12}{'GAAA'.join(targets)}{a3}"


def _wfa_layout_text(refs):
    """bench_extra.py's _write_layout: every reference with the cell_id
    and cell_umi DegenerateTag zones."""
    text = ("known_strand: true\nreads:\n  - !Read1\n"
            "    orientation: Forward\nreferences:\n")
    for name, seq in refs:
        text += (f"  {name}:\n    sequence: \"{seq}\"\n"
                 "    umi_configurations:\n"
                 "      cell_id: {symbol: '0', sort_type: \"DegenerateTag\", "
                 "length: 16, order: 0, max_distance: 2}\n"
                 "      cell_umi: {symbol: '1', sort_type: \"DegenerateTag\", "
                 "length: 12, order: 1, max_distance: 2}\n")
    return text


def _align_engine_on_cpu(layout_text, fastq, workdir, engine, mode,
                         batch=WFA_BATCH):
    """align_reads under a wavefront engine with the plain versions on the
    CPU (run in the pool): the inflated BAM payload and its seconds."""
    from clique_tpu_torch.align.pipeline import align_reads

    os.makedirs(workdir)
    layout, rm = _layout_from_text(layout_text, workdir)
    out = os.path.join(workdir, "cpu.bam")
    t0 = time.time()
    align_reads(layout, rm, out, read1=fastq, batch_size=batch,
                engine=engine, mode=mode, device="cpu")
    return _inflate_bgzf(out), time.time() - t0


def _check_wfa_penalties(path, ref, model):
    """Every written record's CIGAR penalty (wildcards on) against its
    score: the as tag is the negated penalty. Returns the records."""
    from clique_tpu_torch.align.wavefront import (cigar_penalty,
                                                  cigar_penalty_2p)
    from clique_tpu_torch.io.sam import BamReader

    n = 0
    with BamReader(path) as reader:
        for rec in reader:
            if model == "affine2p":
                pen = cigar_penalty_2p(rec.cigar, ref, rec.seq, x=4, o1=6,
                                       e1=2, o2=24, e2=1, wildcards=True)
            else:
                pen = cigar_penalty(rec.cigar, ref, rec.seq, x=4, o=6, e=2,
                                    wildcards=True)
            check(pen == -float(rec.tags["as"]),
                  f"{rec.name}: CIGAR penalty {pen} != as "
                  f"{rec.tags['as']}")
            n += 1
    return n


def _wfa_engine_run(label, workdir, layout_text, lines, engine, mode,
                    pool, n_cpu=N_WFA_CPU, batch=WFA_BATCH):
    """align_reads(engine=...) on the card over the reads, the first n_cpu
    of them on the CPU in the pool; returns (stats, seconds, metrics,
    launches, out path, layout, head check)."""
    from clique_tpu_torch.align.pipeline import align_reads

    wd = os.path.join(workdir, label)
    os.makedirs(wd)
    layout, rm = _layout_from_text(layout_text, wd)
    fq, head = os.path.join(wd, "reads.fastq"), os.path.join(wd, "head.fastq")
    for path, part in ((fq, lines), (head, lines[:n_cpu])):
        with open(path, "w") as fh:
            fh.writelines(part)
    head_cpu = pool.submit(_align_engine_on_cpu, layout_text, head,
                           os.path.join(wd, "cpu"), engine, mode, batch)
    out_head = os.path.join(wd, "head_cuda.bam")
    align_reads(layout, rm, out_head, read1=head, batch_size=batch,
                engine=engine, mode=mode, device="cuda")
    out = os.path.join(wd, "aligned.bam")
    metrics_path = os.path.join(wd, "metrics.json")
    _reset_counts()
    t0 = time.time()
    stats = align_reads(layout, rm, out, read1=fq, batch_size=batch,
                        engine=engine, mode=mode, device="cuda",
                        metrics_path=metrics_path)
    seconds = time.time() - t0
    launches = _counts()
    with open(metrics_path) as fh:
        m = json.load(fh)
    check(m["kernel_launches"]["wfa_align"] == launches["wfa_align"] > 0,
          f"{label}: wfa_align launches {launches['wfa_align']}, metrics "
          f"{m['kernel_launches']}")
    return stats, seconds, m, launches, out, layout, (label, out_head,
                                                      head_cpu, n_cpu)


@_walled
def wfa_head_check(pending):
    label, out_head, future, n_cpu = pending
    head_cpu, seconds = future.result()
    same = _inflate_bgzf(out_head) == head_cpu
    say(f"[{label}] first {n_cpu} reads on cpu (in the pool): "
        f"{seconds:.2f} s; cuda and cpu aligned BAMs "
        f"{'identical' if same else 'DIFFER'}")
    check(same, f"{label}: the head's BAMs differ between cuda and cpu")


@_walled
def phase_hifi(workdir, pool):
    """bench_extra.py's config 2 (bench_hifi): 200 cells x 40 reads of a
    ~342 bp amplicon with 0.5% substitutions, align --mode hifi --engine
    wfa at batch 512 on the card, then collapse; every written CIGAR's
    penalty against its score."""
    import numpy as np

    from clique_tpu_torch.collapse.pipeline import collapse

    rng = np.random.default_rng(7)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    ref_seq = _wfa_amplicon(rng, bases)
    n_reads = HIFI_CELLS * HIFI_PER_CELL
    cells = rng.choice(bases, (HIFI_CELLS, 16))
    umis = rng.choice(bases, (HIFI_CELLS, 4, 12))
    base = np.frombuffer(ref_seq.replace("0", "N").replace("1", "N")
                         .encode(), dtype=np.uint8)
    L = len(base)
    lines = []
    for i in range(n_reads):
        c = i % HIFI_CELLS
        read = base.copy()
        read[24:40] = cells[c]
        read[40:52] = umis[c, (i // HIFI_CELLS) % 4]
        subs = rng.random(L) < 0.005
        read[subs] = rng.choice(bases, int(subs.sum()))
        lines.append(f"@e{i}\n{read.tobytes().decode()}\n+\n{'I' * L}\n")
    text = _wfa_layout_text([("amplicon1", ref_seq)])
    with _recorded("wfa_align") as seen:
        stats, seconds, m, launches, out, layout, head = _wfa_engine_run(
            "hifi", workdir, text, lines, "wfa", "hifi", pool)
    checked = _check_wfa_penalties(out, ref_seq.encode(), "affine")
    collapsed = os.path.join(workdir, "hifi", "collapsed.bam")
    _reset_counts()
    t0 = time.time()
    cstats = collapse(collapsed, layout, out, device="cuda")
    c_seconds = time.time() - t0
    c_launches = _counts()
    say(f"[hifi] {stats.aligned}/{stats.total} reads of {L} bp, --mode "
        f"hifi --engine wfa on the card: {seconds:.3f} s, "
        f"{stats.aligned / seconds:.1f} align reads/s; wfa_phase_seconds "
        f"{json.dumps(m['wfa_phase_seconds'])}, wfa_dp_fallbacks "
        f"{m['wfa_dp_fallbacks']}, launches wfa_align "
        f"{launches['wfa_align']} dp_align {launches['dp_align']}; "
        f"{checked} CIGAR penalties equal their scores; collapse "
        f"{c_seconds:.3f} s ({cstats.passing} passing, launches "
        f"{c_launches}), chain {stats.aligned / (seconds + c_seconds):.1f} "
        f"reads/s")
    check(stats.aligned == n_reads and checked == n_reads,
          "not every hifi read was aligned and checked")
    return launches, head, _wfa_main_launches("hifi", seen, True)


@_walled
def phase_convex(workdir, pool):
    """bench_extra.py's structural-variant config (bench_convex): 6,000
    reads of the amplicon at 0.5% substitutions, every other one with a
    30-80 bp dropout, align --engine convex on the card."""
    import numpy as np

    from clique_tpu_torch.io.sam import BamReader

    rng = np.random.default_rng(23)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    ref_seq = _wfa_amplicon(rng, bases)
    base = np.frombuffer(ref_seq.replace("0", "N").replace("1", "N")
                         .encode(), dtype=np.uint8)
    L = len(base)
    wild = (base < 58) | (base == ord("N"))
    lines = []
    for i in range(N_CONVEX_READS):
        read = base.copy()
        read[wild] = rng.choice(bases, int(wild.sum()))
        subs = rng.random(L) < 0.005
        read[subs] = rng.choice(bases, int(subs.sum()))
        if i % 2:
            dlen = int(rng.integers(30, 81))
            start = int(rng.integers(64, L - 40 - dlen))
            read = np.concatenate([read[:start], read[start + dlen:]])
        lines.append(f"@e{i}\n{read.tobytes().decode()}\n+\n"
                     f"{'I' * len(read)}\n")
    text = _wfa_layout_text([("amplicon1", ref_seq)])
    with _recorded("wfa_align") as seen:
        stats, seconds, m, launches, out, _layout, head = _wfa_engine_run(
            "convex", workdir, text, lines, "convex", "ont", pool)
    checked = _check_wfa_penalties(out, ref_seq.encode(), "affine2p")
    single = sv = 0
    with BamReader(out, parse_tags=False) as reader:
        for rec in reader:
            if int(rec.name[1:]) % 2:
                sv += 1
                single += len([n for n, op in rec.cigar
                               if op == "D" and n >= 30]) == 1
    say(f"[convex] {stats.aligned}/{stats.total} reads, --engine convex on "
        f"the card: {seconds:.3f} s, {stats.aligned / seconds:.1f} reads/s; "
        f"dropouts kept as one D run {single}/{sv} = {single / sv:.4f}; "
        f"{checked} affine2p CIGAR penalties equal their scores; "
        f"wfa_phase_seconds {json.dumps(m['wfa_phase_seconds'])}, "
        f"wfa_dp_fallbacks {m['wfa_dp_fallbacks']}, launches wfa_align "
        f"{launches['wfa_align']}")
    check(stats.aligned == N_CONVEX_READS and checked == N_CONVEX_READS,
          "not every convex read was aligned and checked")
    check(single >= 0.9 * sv, "fewer than 0.9 of the dropouts are one D run")
    return launches, head, _wfa_main_launches("convex", seen, True)


def _mid_plain(args, kw):
    """wfa_mid_reference over one launch's card tensors, a slice of lanes
    at a time so that its run table ([lanes, K, L + 1] i32) stays within
    MID_PLAIN_BYTES; returns (penalties, payloads)."""
    import torch

    from clique_tpu_torch.align import wfa_kernels as wk

    B, n1 = args[0].shape
    kmax = wk.kmax_of("affine", n1, args[1].shape[1], kw["smax"],
                      kw.get("o", 6), kw.get("e", 2), 0, 0)
    step = max(1, int(MID_PLAIN_BYTES // ((2 * kmax + 1) * (n1 + 1) * 4)))
    outs = [wk.wfa_mid_reference(*(a[i:i + step] for a in args), **kw)
            for i in range(0, B, step)]
    return torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs])


def _mid_main_launches(label, seen):
    """The path's recorded wfa_mid launches, each held against its plain
    version on the card (penalties and split payloads); the level-0
    top-rung launch (the widest rows at the highest ceiling, the most
    pairs) timed in two turns beside its plain version's comparison call,
    and bounded. Returns (max abs err, its timing)."""
    import torch

    from clique_tpu_torch.align import wfa_kernels as wk

    check(seen, f"{label}: no wfa_mid launch was recorded")
    top = max(range(len(seen)), key=lambda i: (
        seen[i][0][0].shape[1], seen[i][1]["smax"], seen[i][0][0].shape[0]))
    err, timing = 0, None
    for i, (args, kw) in enumerate(seen):
        pen, pay = wk.wfa_mid(*args, **kw)
        (p_pen, p_pay), p_ms = _timed(lambda: _mid_plain(args, kw))
        same = torch.equal(pen, p_pen) and torch.equal(pay, p_pay)
        e = max(int((pen - p_pen).abs().max()),
                int((pay - p_pay).abs().max()))
        B, n1 = args[0].shape
        say(f"[{label}] wfa_mid B={B} L={n1} smax={kw['smax']}: penalties "
            f"and payloads {'equal' if same else 'DIFFER'} (max abs err "
            f"{e}); penalties {int(p_pen.min())}-{int(p_pen.max())}, "
            f"{int((p_pen > kw['smax']).sum())} censored; plain "
            f"{p_ms:.1f} ms")
        check(same, f"{label}: wfa_mid disagrees with its plain version")
        err = max(err, e)
        if i != top:
            continue
        say(f"[{label}] wfa_mid B={B}: {_plan_line(args, kw, 'mid')}")
        k_ms, p_ms = _kernel_turns(f"[{label}] wfa_mid B={B}",
                                   lambda: wk.wfa_mid(*args, **kw), 3, p_ms)
        host = [a.cpu().numpy() for a in args]
        b, cells = _wfa_bound(host, p_pen.cpu().numpy(), kw, False, "mid")
        say(f"[{label}] wfa_mid bound {b[0]:.5f} ms by {b[1]} ({cells} "
            f"cells, {cells / B:.1f} a pair); the kernel at "
            f"{b[0] / k_ms:.4f} of it")
        timing = _timing(k_ms, p_ms, b)
    say(f"[{label}] {len(seen)} wfa_mid launches held against the plain "
        f"version, max abs err {err}")
    return err, timing


@_walled
def phase_ont_wfa(workdir, pool):
    """ONT raw reads through --engine wfa: 1,000 reads of the long-read
    phases' 4 kb reference at ONT raw-read error rates (ONT_RAW), at batch
    1,024. Each is censored at the 1,024 and 2,048 rungs of wfa_align and
    finishes on the bialign engine: wfa_mid splits it level by level,
    wfa_align aligns its leaves. Every CIGAR's penalty against its score,
    the first 8 reads' BAM against the CPU's (in the pool), every wfa_mid
    launch of the run against its plain version."""
    from clique_tpu_torch.io.sam import BamReader

    rng, bases, ref, layout_text = _long_reference()
    lines = []
    for i in range(N_ONT_WFA_READS):
        r = _ont_read(rng, ref, bases, **ONT_RAW).decode()
        lines.append(f"@ont{i}\n{r}\n+\n{'I' * len(r)}\n")
    mid_ev, align_ev = [], []
    with _recorded("wfa_mid", mid_ev) as seen, \
            _recorded("wfa_align", align_ev) as seen_align:
        stats, seconds, m, launches, out, _layout, head = _wfa_engine_run(
            "ont-raw", workdir, layout_text, lines, "wfa", "ont", pool,
            n_cpu=N_ONT_WFA_CPU, batch=BENCH_BATCH)
    checked = _check_wfa_penalties(out, ref, "affine")
    with BamReader(out) as reader:
        pens = sorted(-float(rec.tags["as"]) for rec in reader)
    bialign = m["wfa_bialign_pairs"]
    say(f"[ont-raw] {stats.aligned}/{stats.total} reads of ~{LONG_REF} bp "
        f"(5% substitutions, 2.5% deletions, 2.5% insertions) with "
        f"--engine wfa on the card: {seconds:.3f} s, "
        f"{stats.aligned / seconds:.1f} align reads/s; {bialign} to the "
        f"bialign engine; penalties {pens[0]:.0f} / {pens[len(pens) // 2]:.0f}"
        f" / {pens[-1]:.0f} (min / median / max); wfa_phase_seconds "
        f"{json.dumps(m['wfa_phase_seconds'])}, wfa_dp_fallbacks "
        f"{m['wfa_dp_fallbacks']}; launches wfa_align "
        f"{launches['wfa_align']} wfa_mid {launches['wfa_mid']} dp_align "
        f"{launches['dp_align']}; {checked} CIGAR penalties equal their "
        f"scores")
    check(stats.aligned == N_ONT_WFA_READS and checked == N_ONT_WFA_READS,
          "not every ONT-raw read was aligned and checked")
    check(launches["wfa_mid"] > 0 and m["kernel_launches"]["wfa_mid"]
          == launches["wfa_mid"], f"the ONT-raw path launched no wfa_mid: "
          f"{launches}, metrics {m['kernel_launches']}")
    check(bialign > 0, "no ONT-raw read went to the bialign engine")
    # the run's own launches: the last ones recorded (the 8-read head on
    # the card ran first)
    check(len(seen) >= launches["wfa_mid"], "a wfa_mid launch went "
          "unrecorded")
    check(len(seen_align) >= launches["wfa_align"], "a wfa_align launch "
          "went unrecorded")
    n_align = launches["wfa_align"]
    run_align = list(zip(seen_align[-n_align:], align_ev[-n_align:]))
    # the bialign wall split: its wfa_mid launches and its leaf wfa_align
    # launches (the calls that name no stream) on the card, the rest host
    mid_ms = sum(a.elapsed_time(b) for a, b, _kw, _n in
                 mid_ev[-launches["wfa_mid"]:])
    leaf_ms = sum(ev[0].elapsed_time(ev[1]) for _r, ev in run_align
                  if not ev[3])
    rung_ms = sum(ev[0].elapsed_time(ev[1]) for _r, ev in run_align
                  if ev[3])
    n_leaf = sum(not ev[3] for _r, ev in run_align)
    wall = m["wfa_phase_seconds"]["bialign"]
    say(f"[ont-raw] bialign wall {wall:.3f} s: {launches['wfa_mid']} "
        f"wfa_mid launches {mid_ms / 1e3:.4f} s and {n_leaf} leaf wfa_align "
        f"launches {leaf_ms / 1e3:.4f} s on the card (CUDA events), the "
        f"host and copies {wall - (mid_ms + leaf_ms) / 1e3:.4f} s; the "
        f"censored rungs' {n_align - n_leaf} wfa_align launches "
        f"{rung_ms / 1e3:.4f} s")
    align_err = _ont_align_shapes(run_align)
    return (launches, head,
            _mid_main_launches("ont-raw", seen[-launches["wfa_mid"]:]),
            stats.aligned / seconds, align_err)


def _ont_align_shapes(run_align):
    """One wfa_align launch of each ont-raw shape (a censored chunk at the
    1,024 rung, at the 2,048 rung of an L = 4,096 bucket and at the 2,112
    rung of L = 4,224, and the first bialign leaf chunk), held against its
    plain version on the card, timed in turns with it and bounded; each
    with its launch plan."""
    shapes = {}
    for (args, kw), ev in run_align:
        L, smax = args[0].shape[1], kw["smax"]
        what = "leaf chunk" if not ev[3] else f"rung {smax} L={L}"
        shapes.setdefault(what, (args, kw))
    want = {"rung 1024 L=4096", "rung 2048 L=4096", "rung 2112 L=4224",
            "leaf chunk"}
    check(want <= set(shapes), f"ont-raw wfa_align shapes: {sorted(shapes)}")
    err = 0
    for what in sorted(want):
        args, kw = shapes[what]
        err = max(err, _wfa_check(f"ont-raw {what}", args, kw, True,
                                  reps=10)[0])
    return err


@_walled
def phase_screen(workdir):
    """An exhaustive-search panel under --engine wfa: two amplicons 12 bp
    (block A) and 6 bp (block B) apart; each read takes block A of its
    reference and block B of the other, so the unique-kmer vote splits,
    every read goes to the exhaustive search, and wfa_score's screen must
    route it to the reference of its block A. Each screen launch is held
    against the plain version on its own pairs, and the largest timed."""
    import numpy as np

    from clique_tpu_torch.align import wfa_kernels
    from clique_tpu_torch.align.pipeline import align_reads
    from clique_tpu_torch.io.sam import BamReader

    rng = np.random.default_rng(31337)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)

    def seq(n):
        return rng.choice(bases, n).tobytes().decode()

    a1, a2, b1, b2, spacer = seq(12), seq(12), seq(6), seq(6), seq(20)
    a5 = "TTCAGACGTGTGCTCTTCCGATCT"
    a3 = "AGATCGGAAGAGCACACGTCTGAA"

    def amp(a, b, cell="0" * 16, umi="1" * 12):
        return a5 + cell + umi + a + spacer + b + a3

    text = _wfa_layout_text([("amp1", amp(a1, b1)), ("amp2", amp(a2, b2))])
    wd = os.path.join(workdir, "screen")
    os.makedirs(wd)
    layout, rm = _layout_from_text(text, wd)
    fq = os.path.join(wd, "reads.fastq")
    with open(fq, "w") as fh:
        for i in range(N_SCREEN_READS):
            r = amp(a1, b2, seq(16), seq(12)) if i % 2 == 0 else \
                amp(a2, b1, seq(16), seq(12))
            fh.write(f"@t{i % 2}_{i}\n{r}\n+\n{'I' * len(r)}\n")
    out = os.path.join(wd, "aligned.bam")
    metrics_path = os.path.join(wd, "metrics.json")
    with _recorded("wfa_score") as seen:
        _reset_counts()
        t0 = time.time()
        stats = align_reads(layout, rm, out, read1=fq, batch_size=WFA_BATCH,
                            engine="wfa", device="cuda",
                            metrics_path=metrics_path)
        seconds = time.time() - t0
        launches = _counts()
        warp_launches = wfa_kernels.wfa_score_warp_launches
    with open(metrics_path) as fh:
        m = json.load(fh)
    with BamReader(out, parse_tags=False) as reader:
        routed = [(rec.name, rec.reference_name) for rec in reader]
    right = sum(ref == ("amp1" if name.startswith("t0") else "amp2")
                for name, ref in routed)
    say(f"[screen] {stats.aligned}/{stats.total} reads over 2 amplicons with "
        f"--engine wfa on the card: {seconds:.3f} s, "
        f"{stats.aligned / seconds:.1f} reads/s; {m['wfa_screened_reads']} "
        f"reads took the exhaustive path; routed to their true reference "
        f"{right}/{len(routed)}; launches wfa_score {launches['wfa_score']} "
        f"wfa_align {launches['wfa_align']}")
    check(launches["wfa_score"] > 0 and m["kernel_launches"]["wfa_score"]
          == launches["wfa_score"], "the screen launched no wfa_score")
    say(f"[screen] wfa_score launches on the warp path: {warp_launches} of "
        f"{launches['wfa_score']}")
    check(warp_launches == launches["wfa_score"],
          "a screen launch left the warp path")
    check(m["wfa_screened_reads"] == N_SCREEN_READS,
          "a screen read missed the exhaustive path")
    check(right == len(routed) == N_SCREEN_READS,
          "a screen read routed to the wrong reference")
    return launches, _wfa_main_launches("screen", seen, False)


@_walled
def phase_golden_engines(workdir):
    """golden aligned with engine="wfa" and "convex" on the card against
    tests/data/golden/aligned_wfa.bam and aligned_convex.bam."""
    from clique_tpu_torch.align.pipeline import align_reads

    launches = dict.fromkeys(KERNELS, 0)
    for engine in ("wfa", "convex"):
        wd = os.path.join(workdir, f"golden_{engine}")
        gd, layout, rm = _golden_layout("golden", wd)
        out = os.path.join(wd, "aligned.bam")
        _reset_counts()
        stats = align_reads(layout, rm, out,
                            read1=os.path.join(gd, "reads.fastq.gz"),
                            batch_size=16, engine=engine, device="cuda")
        n = _counts()
        launches["wfa_align"] += n["wfa_align"]
        same = _inflate_bgzf(out) == _inflate_bgzf(
            os.path.join(gd, f"aligned_{engine}.bam"))
        say(f"[golden] {engine}: {stats.aligned}/{stats.total} aligned on "
            f"the card ({n['wfa_align']} wfa_align launches), BAM payload "
            f"{'equals' if same else 'DIFFERS from'} "
            f"tests/data/golden/aligned_{engine}.bam")
        check(same, f"the golden {engine} BAM differs from its pin")
        check(n["wfa_align"] > 0, f"golden {engine} launched no wfa_align")
    return launches


@_walled
def phase_profile(workdir):
    """align --profile-dir on golden on the card: a torch.profiler Chrome
    trace appears and holds dp_align's kernel events."""
    from clique_tpu_torch.align.pipeline import align_reads

    wd = os.path.join(workdir, "profile")
    gd, layout, rm = _golden_layout("golden", wd)
    trace = os.path.join(wd, "trace")
    out = os.path.join(wd, "aligned.bam")
    align_reads(layout, rm, out, read1=os.path.join(gd, "reads.fastq.gz"),
                batch_size=16, device="cuda", profile_dir=trace)
    files = [f for f in os.listdir(trace) if f.endswith(".pt.trace.json")]
    check(len(files) == 1, f"--profile-dir wrote {files}")
    with open(os.path.join(trace, files[0])) as fh:
        events = json.load(fh)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    dp = [e for e in kernels if "align_kernel" in e.get("name", "")]
    say(f"[profile] --profile-dir on golden: {files[0]}, {len(events)} "
        f"events, {len(kernels)} device kernel events, {len(dp)} of "
        f"dp_align ({sum(e.get('dur', 0) for e in dp):.1f} us)")
    check(dp, "the trace holds no dp_align kernel event")
    check(_inflate_bgzf(out) == _inflate_bgzf(os.path.join(gd,
                                                           "aligned.bam")),
          "the profiled golden align differs from its pin")


@_walled
def phase_wfa_linear():
    """wavefront.py's wfa_edit_batch (smax WFA_EDIT_SMAX) and
    wfa_linear_batch (WFA_LINEAR_PEN under WFA_LINEAR_SMAX, which must
    censor no pair) through their entry points on bench_wfa's pairs (B =
    WFA_LINEAR_B, L = WFA_L, 5% substitutions, seed 0), the counts set to 0
    just before and read just after: each one wfa_score launch under the
    gap-linear model (the kernel's G = 0). Each result is held against the
    plain version (wfa_linear_reference) on the card, and each call timed
    in turns with it by CUDA events beside its bound. Returns (launches,
    max abs err, the wfa_linear_batch call's timing)."""
    import numpy as np
    import torch

    from clique_tpu_torch.align import wavefront as wf
    from clique_tpu_torch.align import wfa_kernels as wk

    dev = torch.device("cuda", 0)
    host = _wfa_pairs(np.random.default_rng(0), WFA_LINEAR_B)
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in host]
    calls = {
        "wfa_edit_batch": (
            lambda: wf.wfa_edit_batch(*args, n1=WFA_L, n2=WFA_L,
                                      smax=WFA_EDIT_SMAX, device=dev),
            dict(smax=WFA_EDIT_SMAX, x=1, e=1)),
        "wfa_linear_batch": (
            lambda: wf.wfa_linear_batch(*args, n1=WFA_L, n2=WFA_L,
                                        smax=WFA_LINEAR_SMAX, device=dev,
                                        **WFA_LINEAR_PEN),
            dict(smax=WFA_LINEAR_SMAX, **WFA_LINEAR_PEN))}
    _reset_counts()
    pens = {name: call() for name, (call, _kw) in calls.items()}
    torch.cuda.synchronize()
    launches = _counts()
    say(f"[wfa-linear] B={WFA_LINEAR_B} L={WFA_L}: wfa_edit_batch and "
        f"wfa_linear_batch through the port's entry points; launches "
        f"{launches}")
    check(launches["wfa_score_linear"] == 2 and sum(launches.values()) == 2,
          "the wfa-linear path did not launch wfa_score's linear case once "
          "a call")
    err, timing = 0, None
    for name, (call, kw) in calls.items():
        kw = dict(kw, kband=2 * WFA_L)

        def plain(kw=kw):
            return wk.wfa_linear_reference(*args, **kw)
        want = plain()
        e = int((pens[name] - want).abs().max())
        err = max(err, e)
        censored = int((want > kw["smax"]).sum())
        say(f"[wfa-linear] {name} x={kw['x']} e={kw['e']} smax={kw['smax']}: "
            f"penalties {'equal' if e == 0 else 'DIFFER'} (max abs err {e}) "
            f"to the plain version's on the card; penalties "
            f"{int(want.min())}-{int(want.max())}, {censored} censored; "
            f"{_plan_line(args, dict(kw, model='linear'), 'score')}")
        check(e == 0, f"wfa-linear: {name} disagrees with its plain version")
        if name == "wfa_linear_batch":
            check(censored == 0, f"wfa-linear: smax {kw['smax']} censors "
                  f"{censored} pairs")
        k_ms, p_ms = _turns(f"[wfa-linear] {name}", call, plain, 20)
        b, cells = _wfa_bound(host, want.cpu().numpy(),
                              dict(kw, model="linear"), False)
        say(f"[wfa-linear] {name} bound {b[0]:.5f} ms by {b[1]} ({cells} "
            f"cells, {cells / WFA_LINEAR_B:.1f} a pair); the kernel at "
            f"{b[0] / k_ms:.4f} of it; library: none (no PyTorch call "
            f"computes a WFA penalty)")
        if name == "wfa_linear_batch":
            # the kernels line's times are the gap-linear call's
            timing = dict(_timing(k_ms, p_ms, b), timed=name)
    return launches, err, timing


def _run_ranks(label, argv, workdir):
    """`python3 -m clique_tpu_torch.cli` + argv as N_DIST_RANKS ranks on the
    card, each a fresh interpreter with this checkout on its PYTHONPATH,
    joined at a free localhost port. Every rank must exit 0 within
    DIST_RANK_TIMEOUT seconds (the ones still running then are killed and
    the run fails). Returns each rank's summary (its JSON log line) with
    its wall from start to exit."""
    import socket

    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    path = os.environ.get("PYTHONPATH")
    env = dict(os.environ, PYTHONPATH=HERE + (os.pathsep + path if path
                                              else ""),
               CLIQUE_TPU_DIST_TIMEOUT=str(DIST_BARRIER_TIMEOUT))
    procs = []
    for r in range(N_DIST_RANKS):
        log = open(os.path.join(workdir, f"{label}.rank{r}.log"), "w+")
        procs.append((subprocess.Popen(
            [sys.executable, "-m", "clique_tpu_torch.cli", *argv,
             "--device", "cuda", "--distributed-world", str(N_DIST_RANKS),
             "--distributed-rank", str(r), "--distributed-coordinator",
             f"localhost:{port}"],
            cwd=workdir, env=env, stdout=log, stderr=subprocess.STDOUT),
            log, time.time()))
    walls = [None] * N_DIST_RANKS
    deadline = time.time() + DIST_RANK_TIMEOUT
    try:
        while None in walls and time.time() < deadline:
            for r, (proc, _log, t0) in enumerate(procs):
                if walls[r] is None and proc.poll() is not None:
                    walls[r] = time.time() - t0
            time.sleep(0.05)
    finally:
        for proc, _log, _t0 in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    out = []
    for r, (proc, log, _t0) in enumerate(procs):
        log.seek(0)
        text = log.read()
        log.close()
        check(walls[r] is not None and proc.returncode == 0,
              f"{label}: rank {r} exited {proc.returncode} (wall "
              f"{walls[r]}): {text[-3000:]}")
        m = re.search(r"distributed \w+ summary (\{.*\})", text)
        check(m is not None, f"{label}: rank {r} printed no summary")
        out.append(dict(json.loads(m.group(1)), process_wall_s=walls[r]))
    return out


@_walled
def phase_distributed(workdir, bench):
    """align then collapse with --distributed-world N_DIST_RANKS on the
    card over a shared work dir, at the bench's full width: align over the
    bench's 80,000 reads at batch BENCH_BATCH (merged BAM against the
    bench's single-process bench.bam), collapse over bench.bam (merged BAM
    against the workers phase's one-process collapse of it, run0.bam). Each
    rank's device, backend, launches, reads and walls are printed, and
    rank 0's merge wall; each align rank must have launched dp_align on a
    CUDA device, each collapse rank a tag-distance kernel; each collapse
    rank's psum_histogram seconds a level are printed. Then
    parallel/mesh.py's sharded_align_step on [cuda:0] against one dp_align
    call on the same batch, timed with its dp_align launch alone, and a
    rank's bucket_histogram count (torch.bincount) at a level's size."""
    import numpy as np
    import torch

    from clique_tpu_torch.align import batch as tbatch
    from clique_tpu_torch.align import dp_kernels
    from clique_tpu_torch.align.scoring import AffineScoring
    from clique_tpu_torch.parallel import make_mesh, sharded_align_step

    layout_text, aligned = bench[0], bench[1]
    wd = os.path.join(workdir, "distributed")
    os.makedirs(wd)
    layout = os.path.join(wd, "layout.yaml")
    with open(layout, "w") as fh:
        fh.write(layout_text)
    fq = os.path.join(workdir, "reads.fastq")
    t0 = time.time()
    out_a = os.path.join(wd, "aligned.bam")
    ranks = _run_ranks("align", [
        "align", "--read-structure", layout, "--read1", fq,
        "--output-bam-file", out_a, "--batch-size", str(BENCH_BATCH),
        "--work-dir", os.path.join(wd, "align_work")], wd)
    align_wall = time.time() - t0
    for r in ranks:
        say(f"[distributed] align rank {r['rank']}/{r['world']}: device "
            f"{r['device']}, backend {r['backend']}, dp_align launches "
            f"{r['launches']['dp_align']}, reads {r['reads']} ({r['aligned']} "
            f"aligned), align {r['align_s']:.3f} s, in the function "
            f"{r['wall_s']:.3f} s, process {r['process_wall_s']:.3f} s"
            + (f", merge {r['merge_s']:.3f} s" if r["merge_s"] is not None
               else ""))
        check(r["device"].startswith("cuda") and
              r["launches"]["dp_align"] > 0,
              f"align rank {r['rank']} launched no dp_align on the card")
    check(sum(r["reads"] for r in ranks) == N_BENCH_READS,
          "the align ranks' stripes do not cover the reads")
    same_a = _record_multiset(out_a) == _record_multiset(aligned)
    say(f"[distributed] align of {N_BENCH_READS} reads on "
        f"{N_DIST_RANKS} ranks: {align_wall:.3f} s for the ranks (the "
        f"single-process bench align {WALLS.get('bench align', 0):.3f} s); "
        f"merged records {'equal' if same_a else 'DIFFER from'} the "
        f"single-process BAM's")
    check(same_a, "the distributed align differs from the single-process "
          "align")

    t0 = time.time()
    out_c = os.path.join(wd, "collapsed.bam")
    ranks = _run_ranks("collapse", [
        "collapse", "--read-structure", layout, "--input-bam-file", aligned,
        "--output-bam-file", out_c,
        "--work-dir", os.path.join(wd, "collapse_work")], wd)
    collapse_wall = time.time() - t0
    for r in ranks:
        say(f"[distributed] collapse rank {r['rank']}/{r['world']}: device "
            f"{r['device']}, backend {r['backend']}, launches "
            f"{r['launches']}, reads {r['reads']}, records {r['records']}, "
            f"ingest and levels {r['ingest_levels_s']:.3f} s, in the "
            f"function "
            f"{r['wall_s']:.3f} s, process {r['process_wall_s']:.3f} s"
            + (f", merge {r['merge_s']:.3f} s" if r["merge_s"] is not None
               else "") + ", psum_histogram (the all_reduce of a level's "
            "256 bucket counts) " + " / ".join(
                f"{1e3 * t:.3f}" for t in r["psum_s"]) + " ms")
        check(r["device"].startswith("cuda") and
              sum(r["launches"].values()) > 0,
              f"collapse rank {r['rank']} launched no tag-distance kernel "
              "on the card")
    one = os.path.join(workdir, "workers", "run0.bam")
    same_c = _record_multiset(out_c) == _record_multiset(one)
    say(f"[distributed] collapse of the bench BAM on {N_DIST_RANKS} ranks: "
        f"{collapse_wall:.3f} s for the ranks (one process: "
        f"{WALLS.get('one-process collapse')} s); merged records "
        f"{'equal' if same_c else 'DIFFER from'} the one-process "
        f"collapse's")
    check(same_c, "the distributed collapse differs from the one-process "
          "collapse")
    check(sum(r["reads"] for r in ranks) == N_BENCH_READS,
          "the collapse ranks' slices do not cover the reads")

    # sharded_align_step over [cuda:0] against one dp_align call
    rng = np.random.default_rng(5)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    B, L = 256, 342
    refs = rng.choice(bases, (B, L)).astype(np.uint8)
    reads = refs.copy()
    subs = rng.random(reads.shape) < 0.05
    reads[subs] = rng.choice(bases, int(subs.sum()))
    lens = np.full(B, L, dtype=np.int32)
    params = tbatch.scoring_to_params(AffineScoring.aligner_default(), "cpu")
    scores, ops, n_ops = sharded_align_step(
        make_mesh(1), refs, reads, lens, lens, params, n1=L + 1, n2=L + 1)
    dev = torch.device("cuda", 0)
    fused, _tb = dp_kernels.dp_align(
        *(torch.from_numpy(a).to(dev) for a in (refs, reads, lens, lens)),
        params.to(dev), n1=L + 1, n2=L + 1, special_mode="both")
    packed, one_n, one_score = tbatch.unfuse_result(fused.cpu().numpy())
    same = (np.array_equal(scores.numpy(), one_score)
            and np.array_equal(n_ops.numpy(), one_n)
            and np.array_equal(ops.numpy(), tbatch.unpack_ops(
                np.ascontiguousarray(packed), 2 * L + 2)))
    say(f"[distributed] sharded_align_step on [cuda:0], B={B} n1=n2={L + 1}: "
        f"scores, ops and n_ops {'equal' if same else 'DIFFER from'} one "
        f"dp_align call's")
    check(same, "sharded_align_step differs from dp_align")
    step_ms = _time_ms(lambda: sharded_align_step(
        make_mesh(1), refs, reads, lens, lens, params, n1=L + 1, n2=L + 1), 5)
    args = [torch.from_numpy(a).to(dev) for a in (refs, reads, lens, lens)]
    launch_ms = _time_ms(lambda: dp_kernels.dp_align(
        *args, params.to(dev), n1=L + 1, n2=L + 1, special_mode="both"), 20)
    b = _align_bound((refs, reads, lens, lens), L + 1, L + 1)
    say(f"[distributed] sharded_align_step on [cuda:0], B={B} n1=n2={L + 1}: "
        f"the step {step_ms:.4f} ms (CUDA events, host copies and unpacking "
        f"included), its dp_align launch {launch_ms:.4f} ms; bound "
        f"{b[0]:.5f} ms by {b[1]}, the launch at {b[0] / launch_ms:.3f} of it")

    # a rank's bucket histogram of a collapse level on the card: one
    # torch.bincount of its reads' buckets into 256 (bucket_histogram's
    # count; the all_reduce is the ranks' psum_s above)
    buckets = torch.from_numpy(rng.integers(
        0, 256, N_BENCH_READS // N_DIST_RANKS)).to(dev)
    count_ms = _time_ms(lambda: torch.bincount(buckets, minlength=256), 50)
    b = bound(buckets.nbytes + 256 * 8, buckets.numel())
    say(f"[distributed] bucket_histogram's torch.bincount of "
        f"{buckets.numel()} int64 buckets into 256 on the card: "
        f"{count_ms:.4f} ms (CUDA events); bound {b[0]:.6f} ms by {b[1]} "
        f"(each bucket read once, the counts written once), the call at "
        f"{b[0] / count_ms:.4f} of it; its all_reduce moves 2,048 bytes a "
        f"rank (gloo on the host: latency, not bytes)")


def _ls_batch(seed, B, LR, LD):
    """tests/test_parallel.py's inputs for length_sharded_align: B random
    ACGT references of LR bases and reads that are their first LD bases
    with 5% substitutions."""
    import numpy as np

    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    refs = rng.choice(bases, size=(B, LR)).astype(np.uint8)
    reads = np.empty((B, LD), dtype=np.uint8)
    for b in range(B):
        r = refs[b, :LD].copy()
        subs = rng.random(LD) < 0.05
        r[subs] = rng.choice(bases, int(subs.sum()))
        reads[b] = r
    return (refs, reads, np.full(B, LR, dtype=np.int32),
            np.full(B, LD, dtype=np.int32))


def _band_valid(n2, nl, l2, rows, device):
    """The bytes a full-length fill writes in one band of the wavefront
    layout: [n2 - 2 + nl steps, row bytes] bool, lane k's byte r of step t
    valid where column t - k + 1 lies in 1..l2 and the band's row 12k + r
    is below `rows` (its rows of the alignment)."""
    import torch

    rb = (nl * 12 + 15) // 16 * 16
    t = torch.arange(n2 - 2 + nl, device=device)[:, None]
    c = torch.arange(rb, device=device)[None, :]
    y = t - c // 12 + 1
    return (c < 12 * nl) & (y >= 1) & (y <= l2) & (c < rows)


def _same_bands(part_tb, full_tb, j0, n_rows, n1, n2, l1, l2):
    """A part's traceback (rows 1 + 384 j0 .. of n_rows rows) against
    dp_align's bands from j0 on, on the bytes a fill writes (both are
    full-length alignments: l1 = n1 - 1, l2 = n2 - 1)."""
    from clique_tpu_torch.align import batch as tbatch

    band = tbatch.BAND_STRIPS * tbatch.STRIP_ROWS
    full_band = (n2 + 30) * band
    strips = -(-(n1 - 1) // tbatch.STRIP_ROWS)
    same = True
    for jj in range(-(-n_rows // band)):
        j = j0 + jj
        nl = min(32, strips - 32 * j)
        size = (n2 - 2 + nl) * ((nl * 12 + 15) // 16 * 16)
        rows = min(band, l1 - band * j)
        mask = _band_valid(n2, nl, l2, rows, part_tb.device)
        a = part_tb[:, jj * full_band:jj * full_band + size]
        b = full_tb[:, j * full_band:j * full_band + size]
        a = a.reshape(a.shape[0], *mask.shape)
        b = b.reshape(b.shape[0], *mask.shape)
        same = same and bool((a[:, mask] == b[:, mask]).all())
    return same


@_walled
def phase_length_sharded():
    """parallel/mesh.py::length_sharded_align on the card: one alignment's
    DP rows split into parts, a part's column tile a segment_fill launch
    with the row above handed down, the walk a segment_walk launch a part.

    1. The JAX test's inputs (tests/test_parallel.py: B=2, LR=512, LD=480,
       seed 12, 5% substitutions) over [cuda:0] * 8 with an uneven split
       (LS_BOUNDS, the last part two bands) and LS_TILE columns a tile,
       against the plain versions over [cpu] * 8 on CPU copies of the same
       inputs: scores, n_ops and ops, and each part's traceback (relaid as
       the plain fill's), byte for byte; and against one dp_align call.
    2. The main path at full width: B=2 reads of LS_LONG bases against
       their LS_LONG-base references (5% substitutions), n1 = n2 = LS_LONG
       + 1, over [cuda:0] * k for k in LS_PARTS with the default split
       (dp_align's band boundaries) and tile, each call with the counts set
       to 0 just before and read just after, in turns with one dp_align
       call (dp_align, k = 1, 2, 4, 4, 2, 1, dp_align): scores, n_ops and
       ops equal dp_align's, each part's traceback equal to dp_align's
       bands of its rows, each part holding only its rows' traceback.
    3. One segment_fill launch (an inner part's second tile at k = 4,
       with its launch plan; also timed cut to 512 columns, the first
       port's tile) and one segment_walk launch (the corner's part) of that
       run recorded, re-launched and timed by CUDA events, and held against
       their plain versions on the card on the same inputs, timed once.
    Returns (launches, max abs errs, the kernels line's timings)."""
    import numpy as np
    import torch

    from clique_tpu_torch.align import batch as tbatch
    from clique_tpu_torch.align import dp_kernels
    from clique_tpu_torch.align.scoring import AffineScoring
    from clique_tpu_torch.parallel import length_sharded_align
    from clique_tpu_torch.parallel import mesh as tmesh

    dev = torch.device("cuda", 0)
    params = tbatch.scoring_to_params(AffineScoring.aligner_default(), "cpu")
    err = {"segment_fill": 0, "segment_walk": 0}
    say(f"[length-sharded] ptxas: {_segment_ptxas()}")

    # 1. the JAX test's shape, uneven, against the plain versions
    B, LR, LD = LS_JAX_SHAPE
    host = _ls_batch(12, B, LR, LD)
    n1, n2 = LR + 1, LD + 1
    kw = dict(n1=n1, n2=n2, bounds=LS_BOUNDS, tile=LS_TILE,
              return_parts=True)
    k = len(LS_BOUNDS) - 1
    got = length_sharded_align([dev] * k, *host, params, **kw)
    t0 = time.perf_counter()
    want = length_sharded_align(["cpu"] * k, *host, params, **kw)
    plain_s = time.perf_counter() - t0
    e_walk = max(int((got[1].int() - want[1].int()).abs().max()),
                 int((got[2] - want[2]).abs().max()),
                 float((got[0] - want[0]).abs().max()))
    lens = [torch.from_numpy(a).to(dev) for a in host[2:]]
    e_fill = 0
    for g, w in zip(got[3], want[3]):
        lo, hi = g["rows"]
        relaid = tbatch.segment_wavefront_to_rows(
            g["traceback"], *lens, row0=lo, n=hi - lo, n1=n1, n2=n2).cpu()
        e_fill = max(e_fill, int((relaid.int()
                                  - w["traceback"].int()).abs().max()))
    fused, _tb = dp_kernels.dp_align(
        *(torch.from_numpy(a).to(dev) for a in host), params.to(dev), n1=n1,
        n2=n2, special_mode="both")
    packed, one_n, one_score = tbatch.unfuse_result(fused.cpu().numpy())
    one = (np.array_equal(got[0].numpy(), one_score)
           and np.array_equal(got[2].numpy(), one_n)
           and np.array_equal(got[1].numpy(), tbatch.unpack_ops(
               np.ascontiguousarray(packed), n1 + n2)))
    err["segment_fill"], err["segment_walk"] = e_fill, e_walk
    say(f"[length-sharded] B={B} LR={LR} LD={LD} over [cuda:0] * {k}, rows "
        f"split at {list(LS_BOUNDS)}, tiles of {LS_TILE}: scores, ops and "
        f"n_ops {'equal' if e_walk == 0 else 'DIFFER from'} the plain "
        f"versions' over [cpu] * {k} (max abs err {e_walk}; plain "
        f"{plain_s:.3f} s on the host), every part's traceback "
        f"{'equal' if e_fill == 0 else 'DIFFERS'} (max abs err {e_fill}); "
        f"{'equal to' if one else 'DIFFER from'} one dp_align call's; "
        f"scores {got[0].tolist()}, n_ops {got[2].tolist()}; card fill "
        f"{got[4]['fill_ms']:.3f} ms, walk {got[4]['walk_ms']:.3f} ms")
    check(e_fill == 0 and e_walk == 0 and one,
          "length_sharded_align on the card differs from its plain versions "
          "or from dp_align")
    del got, want, fused, _tb

    # 2. the main path at full width, in turns with one dp_align call
    L = LS_LONG
    n1 = n2 = L + 1
    rng = np.random.default_rng(16)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    refs = rng.choice(bases, (2, L)).astype(np.uint8)
    reads = refs.copy()
    subs = rng.random(reads.shape) < 0.05
    reads[subs] = rng.choice(bases, int(subs.sum()))
    lens = np.full(2, L, dtype=np.int32)
    host = (refs, reads, lens, lens)
    args = [torch.from_numpy(a).to(dev) for a in host]
    p_dev = params.to(dev)
    fused, full_tb = dp_kernels.dp_align(*args, p_dev, n1=n1, n2=n2,
                                         special_mode="both",
                                         return_traceback=True)
    packed, one_n, one_score = tbatch.unfuse_result(fused.cpu().numpy())
    one_ops = tbatch.unpack_ops(np.ascontiguousarray(packed), n1 + n2)
    align_bound = _align_bound(host, n1, n2)
    tb_one = tbatch.traceback_bytes(n1, n2)
    launches = dict.fromkeys(KERNELS, 0)
    walls = {k: [] for k in LS_PARTS}
    dp_ms = []
    recorded = {}

    def dp_turn():
        dp_ms.append(_timed(lambda: dp_kernels.dp_align(
            *args, p_dev, n1=n1, n2=n2, special_mode="both"))[1])

    def ls_turn(k, check_parts):
        rec = k == max(LS_PARTS) and not recorded
        _reset_counts()
        with _recorded_segments(recorded if rec else None, n1, n2):
            out, ms = _timed(lambda: length_sharded_align(
                [dev] * k, *host, params, n1=n1, n2=n2, return_parts=True))
        torch.cuda.synchronize()
        n = _counts()
        for name in KERNELS:
            launches[name] += n[name]
        walls[k].append((ms, out[4]))
        same = (np.array_equal(out[0].numpy(), one_score)
                and np.array_equal(out[2].numpy(), one_n)
                and np.array_equal(out[1].numpy(), one_ops))
        check(same, f"length_sharded_align at k={k}, n1=n2={n1} differs "
              "from dp_align")
        check(n["segment_fill"] == sum(p["fills"] for p in out[3])
              and n["segment_walk"] == k and sum(n.values())
              == n["segment_fill"] + k,
              f"length_sharded_align at k={k}: its launches {n} are not "
              "its parts' segment_fill and segment_walk launches")
        if not check_parts:
            return
        band = tbatch.BAND_STRIPS * tbatch.STRIP_ROWS
        lines = []
        for p in out[3]:
            lo, hi = p["rows"]
            check((lo - 1) % band == 0, f"k={k}: part rows {p['rows']} do "
                  "not start on a dp_align band")
            want_bytes = 2 * tbatch.traceback_bytes(hi - lo + 1, n2)
            same_tb = _same_bands(p["traceback"], full_tb, (lo - 1) // band,
                                  hi - lo, n1, n2, L, L)
            check(same_tb and p["traceback_bytes"] == want_bytes,
                  f"k={k}: part {p['rows']}'s traceback differs from "
                  "dp_align's bands of its rows")
            pl = p["plan"]
            lines.append(f"rows {lo}..{hi - 1}: {p['fills']} fills, plan "
                         f"C={pl.C} W={pl.W} R={pl.R} ({pl.bands} bands, "
                         f"{pl.smem} B of shared memory a CTA), "
                         f"traceback {p['traceback_bytes']} B "
                         f"({p['traceback_bytes'] / (2 * tb_one):.3f} of "
                         f"dp_align's), halo {p['halo_bytes']} B handed "
                         f"in{' (copied)' if p['copied'] else ''}")
        tile = out[3][0]["tile"]
        tallest = max(p["rows"][1] - p["rows"][0] for p in out[3])
        say(f"[length-sharded] k={k} over [cuda:0] * {k}, tiles of "
            f"{tile} ({-(-(n2 - 1) // tile)} a part; split_tile "
            f"{tmesh.split_tile(n2, tallest, k)}), segment_fill "
            f"{dp_kernels.segment_fill_regs()} registers a thread: scores, "
            f"n_ops and ops equal dp_align's; launches "
            f"{n['segment_fill']} segment_fill + {n['segment_walk']} "
            f"segment_walk; " + "; ".join(lines) + "; each part's traceback "
            "equals dp_align's bands of its rows")

    dp_turn()
    for k in LS_PARTS:
        ls_turn(k, True)
    for k in LS_PARTS[::-1]:
        ls_turn(k, False)
    dp_turn()
    del full_tb
    dp_mean = sum(dp_ms) / len(dp_ms)
    for k in LS_PARTS:
        w = walls[k]
        say(f"[length-sharded] B=2 n1=n2={n1}, k={k}: wall "
            f"{w[0][0]:.3f} / {w[1][0]:.3f} ms (CUDA events around the call), "
            f"fill {w[0][1]['fill_ms']:.3f} / {w[1][1]['fill_ms']:.3f} ms, "
            f"walk {w[0][1]['walk_ms']:.3f} / {w[1][1]['walk_ms']:.3f} ms; "
            f"dp_align {dp_ms[0]:.3f} / {dp_ms[1]:.3f} ms in turns "
            f"({dp_mean / ((w[0][0] + w[1][0]) / 2):.3f}x of the wall); bound "
            f"{align_bound[0]:.4f} ms by {align_bound[1]} (the wall at "
            f"{align_bound[0] * 2 / (w[0][0] + w[1][0]):.5f} of it)")
    check(launches["segment_fill"] > 0 and launches["segment_walk"] > 0,
          "the length-sharded path launched no segment kernel")

    # 3. one launch of each kernel at full width against its plain version
    times = {}
    fill_in, fill_kw, fill_out = recorded["fill"]
    again = [t.clone() if torch.is_tensor(t) else t for t in fill_in[:6]]
    again_bufs = dp_kernels.SegmentBuffers(*(t.clone() for t in fill_in[6]))
    k_ms = _time_ms(lambda: dp_kernels.fill_segment(*again, again_bufs,
                                                    **fill_kw), 3)
    row0, y0, y1 = fill_kw["row0"], fill_kw["y0"], fill_kw["y1"]
    # the same launch cut to 512 columns: the first port's shape (its
    # halo in is the recorded one's first 513 entries)
    cut = dict(fill_kw, y1=y0 + 512)
    again[5] = again[5][:, :513].contiguous()
    cut_ms = _time_ms(lambda: dp_kernels.fill_segment(*again, again_bufs,
                                                      **cut), 3)
    cut_plan = dp_kernels.segment_plan(again_bufs.carry.shape[1], 512,
                                       dp_kernels.segment_fill_regs())
    del again, again_bufs
    n = fill_in[6].carry.shape[1]
    rows_tb = torch.full((2, n, n2 - 1), tbatch._TB_FRESH, dtype=torch.uint8,
                         device=dev)
    carry_p, corner_p = fill_in[6].carry.clone(), fill_in[6].corner.clone()
    halo_p, p_ms = _timed(lambda: tbatch.fill_segment_reference(
        *fill_in[:6], rows_tb, carry_p, corner_p, row0=row0, n1=n1, n2=n2,
        y0=y0, y1=y1))
    relaid = tbatch.segment_wavefront_to_rows(
        fill_out["tb"], *args[2:], row0=row0, n=n, n1=n1, n2=n2,
        cols=(y0, y1))
    e = max(int((relaid.int() - rows_tb[:, :, y0 - 1:y1 - 1].int()).abs()
                .max()),
            float((fill_out["carry"] - carry_p).abs().max()),
            float((fill_out["halo"] - halo_p).abs().max()))
    err["segment_fill"] = max(err["segment_fill"], e)
    cells = 2 * n * (y1 - y0)
    # the part's reference bytes and the tile's read bytes, lens, params,
    # the halo in and out, the carry in and out, the tile's traceback
    nbytes = (2 * n + 2 * (y1 - y0) + 16 + 24 + 2 * 2 * (y1 - y0 + 1) * 12
              + 2 * 2 * n * 12 + cells)
    b = bound(nbytes, OPS_GLOBAL_CELL * cells)
    b512 = bound(nbytes * 512 // (y1 - y0), OPS_GLOBAL_CELL * 2 * n * 512)
    pl = dp_kernels.segment_plan(n, y1 - y0, dp_kernels.segment_fill_regs())
    say(f"[length-sharded] segment_fill at k=4, rows {row0}..{row0 + n - 1}, "
        f"columns {y0}..{y1 - 1} (B=2, plan C={pl.C} W={pl.W} R={pl.R}, "
        f"{pl.bands} bands): tile traceback, carry and halo "
        f"{'equal' if e == 0 else 'DIFFER from'} the plain version's on the "
        f"card (max abs err {e}); kernel {k_ms:.4f} ms, plain {p_ms:.3f} ms; "
        f"bound {b[0]:.5f} ms by {b[1]} ({cells} cells), the kernel at "
        f"{b[0] / k_ms:.4f} of it; the same launch at 512 columns (plan "
        f"C={cut_plan.C} W={cut_plan.W} R={cut_plan.R}) {cut_ms:.4f} ms, "
        f"bound {b512[0]:.5f} ms ({b512[0] / cut_ms:.4f} of it)")
    check(e == 0, "segment_fill differs from its plain version")
    times["segment_fill"] = _timing(k_ms, p_ms, b)
    del rows_tb, relaid

    walk_args, walk_kw, walk_out = recorded["walk"]
    st, ops = walk_args[4].clone(), walk_args[5].clone()
    # each call starts again from the corner this part owns
    k_ms = _time_ms(lambda: dp_kernels.walk_segment(*walk_args[:4], st, ops,
                                                    **walk_kw), 3)
    bufs = walk_args[0]
    row0 = walk_kw["row0"]
    n = bufs.carry.shape[1]
    rows_tb = tbatch.segment_wavefront_to_rows(bufs.tb, *args[2:], row0=row0,
                                               n=n, n1=n1, n2=n2)
    st_p, ops_p = walk_args[4].clone(), walk_args[5].clone()
    _r, p_ms = _timed(lambda: tbatch.walk_segment_reference(
        rows_tb, bufs.corner, *walk_args[1:4], st_p, ops_p, row0=row0, n1=n1,
        n2=n2))
    e = max(int((walk_out["state"] - st_p).abs().max()),
            int((walk_out["ops"].int() - ops_p.int()).abs().max()))
    err["segment_walk"] = max(err["segment_walk"], e)
    steps = int((ops_p != tbatch.OP_DONE).sum())
    b = bound(2 * steps + 2 * 16 + 24 + 8, 10 * steps)
    say(f"[length-sharded] segment_walk at k=4, rows {row0}..{row0 + n - 1} "
        f"(the corner's part, {steps} steps over both alignments): state and "
        f"ops {'equal' if e == 0 else 'DIFFER from'} the plain version's on "
        f"the card (max abs err {e}); kernel {k_ms:.4f} ms, plain "
        f"{p_ms:.3f} ms; bound {b[0]:.6f} ms by {b[1]} (a byte and ~10 "
        f"lane operations a step), the kernel at {b[0] / k_ms:.6f} of it")
    check(e == 0, "segment_walk differs from its plain version")
    times["segment_walk"] = _timing(k_ms, p_ms, b)
    return launches, err, times


def _segment_ptxas():
    """The segment kernels' ptxas lines (registers, stack, spills) from the
    build's log."""
    from clique_tpu_torch import _build

    lines = _build.build_info().log.splitlines()
    out = {}
    for i, line in enumerate(lines):
        for entry, name in (("split_fill_kernel", "segment_fill"),
                            ("split_walk_kernel", "segment_walk")):
            if "Compiling entry function" in line and entry in line:
                out[name] = "; ".join(
                    x.strip().removeprefix("ptxas info    : ")
                    for x in lines[i + 2:i + 4])
    return out


@contextlib.contextmanager
def _recorded_segments(into, n1, n2):
    """With `into` a dict, one fill launch with a halo in and out and a
    carry in, and the first walk launch (the corner's part) while the
    block runs: their inputs copied before the launch and their outputs
    after, on the launch's stream (the main path runs as before, its counts
    included)."""
    import torch

    from clique_tpu_torch.align import dp_kernels

    if into is None:
        yield
        return
    fill, walk = dp_kernels.fill_segment, dp_kernels.walk_segment

    def snap(args, stream):
        with torch.cuda.stream(stream):
            return [dp_kernels.SegmentBuffers(*(t.clone() for t in a))
                    if isinstance(a, dp_kernels.SegmentBuffers)
                    else a.clone() if torch.is_tensor(a) else a
                    for a in args]

    def rec_fill(*args, **kw):
        # a launch with a halo in and out and a carry in
        take = (kw["hand_on"] and args[5] is not None and kw["y0"] > 1
                and "fill" not in into)
        copy = snap(args, kw["stream"]) if take else None
        out = fill(*args, **kw)
        if take:
            with torch.cuda.stream(kw["stream"]):
                into["fill"] = (copy, dict(kw, stream=None), dict(
                    tb=args[6].tb, carry=args[6].carry.clone(),
                    halo=out.clone()))
        return out

    def rec_walk(*args, **kw):
        take = "walk" not in into        # the first: the corner's part
        copy = snap(args, kw["stream"]) if take else None
        walk(*args, **kw)
        if take:
            with torch.cuda.stream(kw["stream"]):
                into["walk"] = (copy, dict(kw, stream=None), dict(
                    state=args[4].clone(), ops=args[5].clone()))

    dp_kernels.fill_segment, dp_kernels.walk_segment = rec_fill, rec_walk
    try:
        yield
    finally:
        dp_kernels.fill_segment, dp_kernels.walk_segment = fill, walk
        torch.cuda.synchronize()


def main():
    t_start = time.time()
    phase_card()
    import torch

    phase_build()
    err, times = phase_kernels()
    mode_err, mode_times = phase_mode_kernels()
    for k, v in mode_err.items():
        err[k] = max(err.get(k, 0.0), v)
    times.update(mode_times)
    tag_err, tag_times, myers_ms = phase_tag_kernels()
    err.update(tag_err)
    times.update(tag_times)
    err["edit_hits"], times["edit_hits"] = phase_edit_hits()
    err["hmm_forward"], times["hmm_forward"] = phase_hmm_kernel()
    err.update(phase_wfa_kernels())
    linear_launches, err["wfa_score_linear"], times["wfa_score_linear"] = \
        phase_wfa_linear()
    split_launches, split_err, split_times = phase_length_sharded()
    err.update(split_err)
    times.update(split_times)
    launches = dict.fromkeys(KERNELS, 0)
    with tempfile.TemporaryDirectory() as workdir, ProcessPoolExecutor(
            CPU_WORKERS, mp_context=multiprocessing.get_context("spawn"),
            initializer=_cpu_worker_init) as pool:
        path_launches = [phase_golden(workdir),
                         phase_golden_engines(workdir), linear_launches,
                         split_launches]
        phase_profile(workdir)
        hifi_launches, hifi_head, hifi_wfa = phase_hifi(workdir, pool)
        convex_launches, convex_head, convex_wfa = phase_convex(workdir,
                                                                pool)
        screen_launches, screen_wfa = phase_screen(workdir)
        ont_launches, ont_head, ont_mid, ont_rate, ont_err = phase_ont_wfa(
            workdir, pool)
        path_launches += [hifi_launches, convex_launches, screen_launches,
                          ont_launches]
        # the kernels line: wfa_mid at the ONT-raw path's level-0 top rung
        err["wfa_mid"], times["wfa_mid"] = ont_mid
        # the kernels line: wfa_align at the hifi path's launch, wfa_score
        # at the screen's
        err["wfa_align"] = max(err["wfa_align"], hifi_wfa[0], convex_wfa[0],
                               ont_err)
        times["wfa_align"] = hifi_wfa[1]
        err["wfa_score"] = max(err["wfa_score"], screen_wfa[0])
        times["wfa_score"] = screen_wfa[1]
        panel_launches, panel = phase_panel(workdir, pool)
        bench_launches, bench = phase_bench(workdir)
        path_launches += [panel_launches, bench_launches,
                          phase_workers(workdir, bench),
                          phase_banded(workdir, bench),
                          phase_known_list(workdir, bench)]
        phase_distributed(workdir, bench)
        path_launches.append(phase_device_levenshtein())
        phase_threshold(bench[5])
        long_launches, long_rate, long_head = phase_long_reads(workdir, pool)
        path_launches += [long_launches, phase_inversion(pool)]
        long_reads_head_check(long_head)
        panel_head_check(panel)
        wfa_head_check(hifi_head)
        wfa_head_check(convex_head)
        wfa_head_check(ont_head)
    for n in path_launches:
        for k in KERNELS:
            launches[k] += n[k]
    loaded = sorted(m for m, mod in sys.modules.items()
                    if mod is not None and m.split(".")[0] in
                    ("jax", "jaxlib", "clique_tpu"))
    check(not loaded, f"jax or JAX-package modules were loaded: "
          f"{loaded[:5]}")
    say("[jax] no jax module and no module of the JAX package loaded")
    check(all(launches[k] > 0 for k in KERNELS),
          f"a kernel was never launched on a path: {launches}")
    say(f"[summary] chain {bench[3]:.1f} reads/s over {N_BENCH_READS} "
        f"bench-shaped reads; long reads {long_rate:.1f} reads/s over "
        f"{N_LONG_READS}; ONT-raw reads under --engine wfa {ont_rate:.1f} "
        f"reads/s over {N_ONT_WFA_READS}; host Myers at 2M pairs "
        f"{myers_ms:.1f} ms; "
        f"script {time.time() - t_start:.1f} s")
    say(f"[walls] {json.dumps(PHASE_WALLS)}")
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda",
         "source": f"clique_tpu_torch/csrc/{SOURCES[name]}",
         "replaces": REPLACES[name], "launches": launches[name],
         "max_abs_err": err[name], **times[name]}
        for name in KERNELS]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
