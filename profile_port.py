#!/usr/bin/env python3
"""Time one workload of the port on one GPU, for one checkout or several
in turns.

    python3 profile_port.py align [--runs 3] [--reads 80000] [ROOT ...]
    python3 profile_port.py hamming [--tags 25000] [--reps 3] [ROOT ...]
    python3 profile_port.py local [--reps 5] [ROOT ...]
    python3 profile_port.py hmm [--reps 5] [ROOT ...]
    python3 profile_port.py wfa [--reps 5] [--shapes WORD,...] [ROOT ...]
    python3 profile_port.py edit [--reps 5] [ROOT ...]
    python3 profile_port.py dp [--reps 5] [ROOT ...]
    python3 profile_port.py split [--reps 5] [ROOT ...]

Each ROOT (default: this checkout) is the root of a checkout of the repo;
its clique_tpu_torch is imported and its kernels built in a process of its
own. With several roots the runs go in turns, the list and then the list
reversed (A B B A for two), so that a comparison lies inside one call on
one card. It prints the card's name and power limit, each run's lines and
one JSON line per run, then every timing side by side by root; the runs'
results must agree between roots. Imports no jax. The workloads:

- align: the bench-shaped dataset of the root's chip_smoke.py (the
  generator of bench.py, seed 2026). Aligns its first 2,048 reads once to
  warm up, then all of it `--runs` times without the profiler (wall,
  reads/s and the metrics JSON's phase walls per run), then once under
  torch.profiler. From the profiled run it prints the device activities
  only (kernels and memory copies/sets, as the CUDA tracer records them on
  the card) with their total device time and count, and the device busy
  share: the union of those activities' intervals over the run's wall.
  Rows of the host side (aten ops, CUDA runtime calls) are not device
  time and are left out, so a copy is counted once, as its Memcpy
  activity.
- hamming: the known-list Hamming search at 10x scale. A 737,280-entry
  16 bp ACGT allowlist (the size of 10x Chromium v2's
  737K-august-2016.txt) and `--tags` observed tags (40% allowlist entries,
  40% one substitution off one, 10% with an N, 10% random);
  hamming_hits(tags, allowlist, 1, device="cuda") once to warm up, then
  `--reps` times, each on the host clock (the call ends with host lists).
- local: the local (Waterman-Eggert) DP of one length bucket,
  batch.align_batch_local, whatever kernels it launches, at B=64,
  n1=n2=3328 and B=512, n1=n2=1001 (one reference row, reads cut from it
  with 5% substitutions, of 0 to n2 - 1 bases, as chip_smoke.py's
  _mode_batch makes them), under AffineScoring.hifi_default(), the
  inversion screen's scoring. CUDA events around `--reps` calls after one
  warm-up call.
- hmm: hmm_forward_batch on the root's chip_smoke.py batch (_hmm_batch,
  seed 39: 32 reads against 32 references of 220-250 bases, B=1,024), on
  it 360 times over (B=368,640, a panel route call's launch), on 32
  reads against 32 references of 320-350 bases (seed 40) once and 36
  times over, and on 32 against 32 of 1,070-1,100 bases (seed 41) 4
  times over, CUDA events around `--reps` calls after one warm-up
  call; then align
  --router hmm over the root's panel (_panel_dataset: 180 references,
  7,200 reads), its 64-read head once to warm up and the whole once timed
  (wall, reads/s, reader_wall). The LLs and the routed BAM must agree.
- wfa: the wavefront kernels at the launch shapes of `align --engine wfa`
  (wildcards on, x 4, o 6, e 2), CUDA events around `--reps` calls after
  one warm-up call. ONT raw reads of the root's chip_smoke.py
  (_long_reference, _ont_read at ONT_RAW, its ONT-raw phase's first 1,000
  reads), each bucketed as WfaAligner buckets it (L a multiple of 128):
  wfa_align at the 1,024 rung (B=64, L=4,096), at the 2,048 rung (B=32,
  L=4,096) and at the 2,112 rung (B=32, L=4,224), and wfa_mid at the
  bialign engine's top rung (the first 991 reads, L=4,224, smax 4,096);
  a bialign leaf chunk (B=64 windows of 300-512 bases of the reference
  against their ONT reads, L=512, smax 10 + 2L); the hifi launch (B=512,
  L=384, smax 96: a 342 bp reference at 0.5% substitutions), the
  screen's wfa_score (B=4,096, L=114, smax 64: the warp path) and
  wfa_score at chip_smoke.py's bench_wfa shape in both penalty models
  (B=1,024, L=512, smax 192, no wildcards: the CTA path). Each shape also
  by its kernel's device time under torch.profiler over as many calls.
  `--shapes` keeps the shapes whose names hold one of its comma-separated
  words ("wfa_score", "rung" ...). Penalties, skeletons, end rows and
  payloads must agree.
- edit: edit_distance (collapse's Levenshtein kernel) at P=2,097,152 rows
  of L=32 with la=lb=16 (16 bp tags in 32-byte rows, ACGTN- with 10%
  substitutions), P=2,097,152 of L=80 and P=262,144 of L=300 (full rows):
  the wrapper (its length check included) by CUDA events around `--reps`
  calls after one warm-up call, and the kernel alone by its device time
  under torch.profiler over as many calls; then the two
  routes of edit_distance_rows at L=32, la=lb=16, P from 1 to 2,097,152:
  the host Myers code against the card's route with its transfers
  (rows up, distances back), host clock, in turns (host, card, card,
  host): why every call on a CUDA device takes the card. Distances must agree
  between the routes and the roots.
- dp: dp_align (the fused global fill + walk) at the bench shape (B=1,024,
  n1=n2=384, special mode ref_n_only) and keep-last with special mode
  none at B=64, n1=n2=3328 (the inversion path's fill), each on one
  reference row and reads cut from it with 5% substitutions of 0 to
  n2 - 1 bases (local's inputs), CUDA events around `--reps` calls after
  one warm-up call. The fused rows must agree.
- split: parallel/mesh.py's length_sharded_align at B=2, n1=n2=16,385
  (chip_smoke.py's full-width inputs: 16,384-base references, reads with
  5% substitutions, seed 16) over [cuda:0] * k for k = 1, 2, 4 and 8
  parts and tiles of 512 to 16,384 columns and the default
  (mesh.split_tile): the call's wall by CUDA events and its fill and walk
  times (the function's own events), each the mean of `--reps` calls after
  one warm-up call, and each part's launch plan (segment_plan: C, W, ring
  entries, shared memory, bands, registers) where the root has one; a
  width a root refuses (the first port's shared memory) is reported and
  skipped; the results must agree across tiles, parts and roots.
"""

import argparse
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
N_ALLOWLIST = 737_280
LOCAL_SHAPES = ((64, 3328), (512, 1001))


def device_activities(prof):
    """(name, start_us, end_us) of every activity that ran on the card."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            out.append((e.name, e.time_range.start, e.time_range.end))
    if not out:
        # versions that attach device activities to their host op only
        for k in prof.profiler.kineto_results.events():
            if k.device_type() == DeviceType.CUDA:
                s = k.start_ns() / 1e3
                out.append((k.name(), s, s + k.duration_ns() / 1e3))
    return out


def union_us(intervals):
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def run_align(root, args):
    """The bench-shaped align: warm walls, then the device breakdown."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from clique_tpu_torch.align.pipeline import align_reads

    walls = []
    with tempfile.TemporaryDirectory() as wd:
        text, fq, head, _cells = cs._bench_dataset(wd, args.reads)
        layout, rm = cs._layout_from_text(text, wd)
        kw = dict(batch_size=cs.BENCH_BATCH, device="cuda")
        align_reads(layout, rm, os.path.join(wd, "warm.bam"), read1=head,
                    **kw)
        for i in range(args.runs):
            mpath = os.path.join(wd, f"m{i}.json")
            t0 = time.time()
            st = align_reads(layout, rm, os.path.join(wd, "o.bam"),
                             read1=fq, metrics_path=mpath, **kw)
            walls.append(time.time() - t0)
            with open(mpath) as fh:
                m = json.load(fh)
            print(f"run {i}: wall {walls[-1]} s, {st.aligned / walls[-1]} "
                  f"reads/s, device_seconds {m['device_seconds']}, "
                  f"host_post_seconds {m['host_post_seconds']}, phase walls "
                  f"{json.dumps(m['phase_walls'])}", flush=True)

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.time()
            st = align_reads(layout, rm, os.path.join(wd, "p.bam"),
                             read1=fq, **kw)
            torch.cuda.synchronize()
            wall = time.time() - t0
    acts = device_activities(prof)
    if not acts:
        raise SystemExit("the profiler recorded no device activity; time "
                         "with CUDA events instead")
    by_name = {}
    for name, s, e in acts:
        tot, n = by_name.get(name, (0.0, 0))
        by_name[name] = (tot + (e - s), n + 1)
    print(f"profiled run: wall {wall} s, {st.aligned} reads")
    for name, (tot, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0]):
        print(f"  device {tot / 1e3} ms  x{n}  {name[:100]}")
    device_ms = sum(t for t, _n in by_name.values()) / 1e3
    busy = union_us([(s, e) for _n, s, e in acts])
    print(f"device activity: {device_ms} ms summed, {busy / 1e3} ms as a "
          f"union of intervals; busy share of the wall {busy / 1e6 / wall}")
    return {"times": {"align wall s": walls, "device ms": [device_ms],
                      "busy share": [busy / 1e6 / wall]},
            "check": st.aligned}


def _hamming_inputs(n_tags):
    import numpy as np

    rng = np.random.default_rng(737280)
    bases = np.frombuffer(b"ACGT", np.uint8)
    allow = rng.choice(bases, (N_ALLOWLIST, 16))
    tags = allow[rng.integers(0, N_ALLOWLIST, n_tags)]
    kind = rng.random(n_tags)
    rows = np.arange(n_tags)
    cols = rng.integers(0, 16, n_tags)
    one_off = (kind >= 0.4) & (kind < 0.8)
    tags[rows[one_off], cols[one_off]] = rng.choice(bases, int(one_off.sum()))
    with_n = (kind >= 0.8) & (kind < 0.9)
    tags[rows[with_n], cols[with_n]] = ord("N")
    rand = kind >= 0.9
    tags[rand] = rng.choice(bases, (int(rand.sum()), 16))
    return ([r.tobytes() for r in tags], [r.tobytes() for r in allow])


def run_hamming(root, args):
    """hamming_hits at 10x scale, on the host clock."""
    import torch

    from clique_tpu_torch.collapse import distance

    tags, allow = _hamming_inputs(args.tags)
    hits = distance.hamming_hits(tags, allow, 1, device="cuda")
    seconds = []
    for _ in range(args.reps):
        n0 = distance.match_hits_launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hits = distance.hamming_hits(tags, allow, 1, device="cuda")
        seconds.append(time.perf_counter() - t0)
        launches = distance.match_hits_launches - n0
    print(f"{args.tags} tags x {len(allow)} allowlist entries: "
          f"{sum(map(len, hits))} hits, {launches} launches a call")
    digest = sum((u + 1) * sum(h) + len(h) for u, h in enumerate(hits))
    return {"times": {"hamming_hits s": seconds}, "check": digest}


def _local_inputs(B, n):
    import numpy as np

    rng = np.random.default_rng(n)
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    ref = rng.choice(acgt, n - 1)
    reads = np.zeros((B, n - 1), np.uint8)
    read_lens = rng.integers(1, n, B).astype(np.int32)
    read_lens[0], read_lens[-1] = 0, n - 1
    for i, m in enumerate(read_lens):
        start = int(rng.integers(0, n - 1))
        piece = np.concatenate([ref[start:], ref])[:m]
        subs = rng.random(m) < 0.05
        piece[subs] = rng.choice(acgt, int(subs.sum()))
        reads[i, :m] = piece
    return ref[None, :], reads, np.full(B, n - 1, np.int32), read_lens


def _event_ms(fn, reps):
    import torch

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


def run_local(root, args):
    """align_batch_local at both shapes, CUDA events."""
    import torch

    from clique_tpu_torch.align import batch as tbatch
    from clique_tpu_torch.align.scoring import AffineScoring

    dev = torch.device("cuda", 0)
    params = tbatch.scoring_to_params(AffineScoring.hifi_default(), dev)
    times, digests = {}, []
    for B, n in LOCAL_SHAPES:
        inputs = [torch.from_numpy(a).to(dev) for a in _local_inputs(B, n)]

        def call():
            return tbatch.align_batch_local(*inputs, params, n1=n, n2=n)

        key = f"B={B} n1=n2={n} ms"
        times[key] = [_event_ms(call, args.reps)]
        fused = call().cpu().numpy()
        digests.append(hashlib.sha256(fused.tobytes()).hexdigest()[:16])
        print(f"{key}: {times[key][0]}, fused rows {digests[-1]}")
        del inputs
        torch.cuda.empty_cache()
    return {"times": times, "check": digests}


def run_dp(root, args):
    """dp_align at the bench shape and at the keep-last shape, CUDA
    events."""
    import torch

    from clique_tpu_torch.align import dp_kernels
    from clique_tpu_torch.align.batch import scoring_to_params
    from clique_tpu_torch.align.scoring import AffineScoring

    dev = torch.device("cuda", 0)
    params = scoring_to_params(AffineScoring.aligner_default(), dev)
    times, digests = {}, []
    for B, n, kw in ((1024, 384, dict(special_mode="ref_n_only")),
                     (64, 3328, dict(special_mode="none",
                                     tie_order="last"))):
        inputs = [torch.from_numpy(a).to(dev) for a in _local_inputs(B, n)]

        def call():
            return dp_kernels.dp_align(*inputs, params, n1=n, n2=n, **kw)[0]

        key = f"B={B} n1=n2={n} {kw} ms"
        times[key] = [_event_ms(call, args.reps)]
        fused = call().cpu().numpy()
        digests.append(hashlib.sha256(fused.tobytes()).hexdigest()[:16])
        print(f"{key}: {times[key][0]}, fused rows {digests[-1]}")
        del inputs
        torch.cuda.empty_cache()
    return {"times": times, "check": digests}


def run_split(root, args):
    """length_sharded_align's tile widths and part counts, CUDA events."""
    import numpy as np
    import torch

    from clique_tpu_torch.align import dp_kernels
    from clique_tpu_torch.align.batch import scoring_to_params
    from clique_tpu_torch.align.scoring import AffineScoring
    from clique_tpu_torch.parallel import length_sharded_align

    dev = torch.device("cuda", 0)
    params = scoring_to_params(AffineScoring.aligner_default(), "cpu")
    L = 16_384
    rng = np.random.default_rng(16)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    refs = rng.choice(bases, (2, L)).astype(np.uint8)
    reads = refs.copy()
    subs = rng.random(reads.shape) < 0.05
    reads[subs] = rng.choice(bases, int(subs.sum()))
    lens = np.full(2, L, dtype=np.int32)
    planned = hasattr(dp_kernels, "segment_plan")   # the cluster fill's roots
    if planned:
        print(f"segment_fill: {dp_kernels.segment_fill_regs()} registers "
              "a thread", flush=True)
    times, digests = {}, set()
    for k in (1, 2, 4, 8):
        for tile in (512, 1024, 2048, 4096, 8192, 16384, None):
            kw = {} if tile is None else {"tile": tile}

            def call():
                return length_sharded_align(
                    [dev] * k, refs, reads, lens, lens, params, n1=L + 1,
                    n2=L + 1, return_parts=True, **kw)

            try:
                out = call()
            except ValueError as e:       # a width the root refuses
                print(f"k {k} tile {tile}: refused ({e})", flush=True)
                continue
            width = out[3][0].get("tile", tile)
            plans = sorted({tuple(p["plan"]) for p in out[3]
                            if p.get("plan") is not None})
            del out
            walls, fills, walks = [], [], []
            for _ in range(args.reps):
                out, ms = _event_ms_one(call)
                walls.append(ms)
                fills.append(out[4]["fill_ms"])
                walks.append(out[4]["walk_ms"])
                digests.add(hashlib.sha256(b"".join(
                    t.numpy().tobytes() for t in out[:3])).hexdigest()[:16])
                del out
            name = f"k={k} tile={'default' if tile is None else tile}"
            for what, v in (("wall", walls), ("fill", fills),
                            ("walk", walks)):
                times[f"{name} {what} ms"] = [sum(v) / len(v)]
            print(f"{name} (width {width}): wall "
                  f"{sum(walls) / len(walls):.3f} ms, fill "
                  f"{sum(fills) / len(fills):.3f} ms, walk "
                  f"{sum(walks) / len(walks):.3f} ms"
                  + (f"; plans (C, W, R, smem, bands, regs) {plans}"
                     if planned else ""), flush=True)
    if len(digests) != 1:
        raise SystemExit(f"length_sharded_align's results differ between "
                         f"tiles and parts: {digests}")
    return {"times": times, "check": sorted(digests)}


def _event_ms_one(fn):
    """fn() and its time in ms, by CUDA events around the one call."""
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def run_hmm(root, args):
    """hmm_forward at both launch shapes (CUDA events), then the panel."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from clique_tpu_torch.align import hmm
    from clique_tpu_torch.align.pipeline import align_reads

    dev = torch.device("cuda", 0)
    p = torch.from_numpy(hmm.default_hmm_params()).to(dev)
    host = cs._hmm_batch(np.random.default_rng(39), 32, 32, 250)
    wide = cs._hmm_batch(np.random.default_rng(40), 32, 32, 350)
    long = cs._hmm_batch(np.random.default_rng(41), 32, 32, 1100)
    times, digests = {}, []
    for arrays, times_over, name in ((host, 1, ""), (host, 360, ""),
                                     (wide, 1, " (320-350 rows)"),
                                     (wide, 36, " (320-350 rows)"),
                                     (long, 4, " (1,070-1,100 rows)")):
        batch = [torch.from_numpy(np.concatenate([a] * times_over)).to(dev)
                 for a in arrays]

        def call():
            return hmm.hmm_forward_batch(*batch, p)

        key = f"B={len(arrays[2]) * times_over}{name} ms"
        times[key] = [_event_ms(call, args.reps)]
        ll = call().cpu().numpy()
        digests.append(hashlib.sha256(ll.tobytes()).hexdigest()[:16])
        print(f"{key}: {times[key][0]}, LLs {digests[-1]}", flush=True)
        del batch
        torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as wd:
        pdir, text, fq, head = cs._panel_dataset(wd)
        layout, rm = cs._layout_from_text(text, pdir)
        kw = dict(batch_size=cs.PANEL_BATCH, router="hmm", device="cuda")
        align_reads(layout, rm, os.path.join(pdir, "warm.bam"), read1=head,
                    **kw)
        mpath, out = os.path.join(pdir, "m.json"), os.path.join(pdir,
                                                                "p.bam")
        t0 = time.time()
        st = align_reads(layout, rm, out, read1=fq, metrics_path=mpath, **kw)
        wall = time.time() - t0
        with open(mpath) as fh:
            m = json.load(fh)
        times["panel align s"] = [wall]
        times["panel reads/s"] = [st.aligned / wall]
        times["panel reader_wall s"] = [m["phase_walls"]["reader_wall"]]
        digests.append(hashlib.sha256(cs._inflate_bgzf(out)).hexdigest()[:16])
        print(f"panel: {st.aligned}/{st.total} reads, wall {wall} s, "
              f"{st.aligned / wall} reads/s, phase walls "
              f"{json.dumps(m['phase_walls'])}, BAM {digests[-1]}",
              flush=True)
    return {"times": times, "check": digests}


def _wfa_shapes():
    """[(name, kernel, host arrays, keywords)] of the wfa workload."""
    import numpy as np

    import chip_smoke as cs

    def pad(pairs, B, L):
        a = np.zeros((B, L), np.uint8)
        b = np.zeros((B, L), np.uint8)
        la = np.zeros(B, np.int32)
        lb = np.zeros(B, np.int32)
        for i, (s, t) in enumerate(pairs):
            a[i, :len(s)] = np.frombuffer(s, np.uint8)
            b[i, :len(t)] = np.frombuffer(t, np.uint8)
            la[i], lb[i] = len(s), len(t)
        return a, b, la, lb

    rng, bases, ref, _text = cs._long_reference()
    reads = [cs._ont_read(rng, ref, bases, **cs.ONT_RAW)
             for _ in range(cs.N_ONT_WFA_READS)]
    by_len = {}
    for r in reads:
        by_len.setdefault(-(-max(len(ref), len(r)) // 128) * 128,
                          []).append((ref, r))
    pen = dict(x=4, o=6, e=2, wildcards=True)
    shapes = [
        ("wfa_align rung 1,024 B=64 L=4,096", "align",
         pad(by_len[4096][:64], 64, 4096), dict(smax=1024, **pen)),
        ("wfa_align rung 2,048 B=32 L=4,096", "align",
         pad(by_len[4096][:32], 32, 4096), dict(smax=2048, **pen)),
        (f"wfa_align rung 2,112 B={len(by_len[4224][:32])} L=4,224",
         "align", pad(by_len[4224][:32], len(by_len[4224][:32]), 4224),
         dict(smax=2112, **pen))]
    top = [(ref, r) for r in reads[:991]]
    L = -(-max(len(r) for _a, r in top) // 128) * 128
    shapes.append((f"wfa_mid top rung B=991 L={L}", "mid", pad(top, 991, L),
                   dict(smax=4096, **pen)))
    leaves = []
    for i in range(64):
        n = int(rng.integers(300, 513))
        start = int(rng.integers(0, len(ref) - n))
        win = ref[start:start + n]
        leaves.append((win, cs._ont_read(rng, win, bases,
                                         **cs.ONT_RAW)[:512]))
    shapes.append(("wfa_align leaf chunk B=64 L=512", "align",
                   pad(leaves, 64, 512), dict(smax=10 + 2 * 512, **pen)))
    amp = rng.choice(bases, 342)
    hifi = []
    for _ in range(512):
        r = amp.copy()
        sub = rng.random(342) < 0.005
        r[sub] = rng.choice(bases, int(sub.sum()))
        hifi.append((amp.tobytes(), r.tobytes()))
    shapes.append(("wfa_align hifi B=512 L=384", "align",
                   pad(hifi, 512, 384), dict(smax=96, **pen)))
    screen = []
    for _ in range(4096):
        a = rng.choice(bases, 100)
        r = a.copy()
        sub = rng.random(100) < 0.05
        r[sub] = rng.choice(bases, int(sub.sum()))
        screen.append((a.tobytes(), r.tobytes()))
    shapes.append(("wfa_score screen B=4,096 L=114", "score",
                   pad(screen, 4096, 114), dict(smax=64, **pen)))
    bench = cs._wfa_pairs(np.random.default_rng(3), 1024)
    for model in ("affine", "affine2p"):
        shapes.append((f"wfa_score bench_wfa {model} B=1,024 L=512", "score",
                       bench, dict(smax=192, model=model, **cs.WFA_PEN)))
    return shapes


def run_wfa(root, args):
    """The wavefront kernels at the ONT-raw, leaf, hifi and screen launch
    shapes, CUDA events."""
    import torch

    from clique_tpu_torch.align import wfa_kernels as wk

    dev = torch.device("cuda", 0)
    times, digests = {}, []
    fns = {"align": wk.wfa_align, "score": wk.wfa_score, "mid": wk.wfa_mid}
    words = [w for w in args.shapes.split(",") if w]
    for name, kind, host, kw in _wfa_shapes():
        if words and not any(w in name for w in words):
            continue
        inputs = [torch.from_numpy(a).to(dev) for a in host]

        def call():
            return fns[kind](*inputs, **kw)

        key = f"{name} smax={kw['smax']} ms"
        times[key] = [_event_ms(call, args.reps)]
        dkey = f"{name} smax={kw['smax']} device ms"
        times[dkey] = [_device_ms(call, args.reps, "wfa_")]
        out = call()
        out = out if isinstance(out, tuple) else (out,)
        if kind == "align":
            out = (out[0], out[2], out[3])    # the op store's dead rows vary
        h = hashlib.sha256()
        for t in out:
            h.update(t.cpu().numpy().tobytes())
        digests.append(h.hexdigest()[:16])
        print(f"{key}: {times[key][0]} (on the card {times[dkey][0]}), "
              f"outputs {digests[-1]}", flush=True)
        del inputs, out
        torch.cuda.empty_cache()
    return {"times": times, "check": digests}


EDIT_SHAPES = ((2_097_152, 32, 16), (2_097_152, 80, 80), (262_144, 300, 300))
EDIT_ROUTE_PAIRS = (1, 4, 16, 64, 256, 1024, 4096, 16384, 65536, 262_144,
                    1_048_576, 2_097_152)


def _edit_rows(P, L, la, seed):
    """[P, L] rows a and b (ACGTN-, b with 10% substitutions and every
    seventh row redrawn) and la = lb = `la`."""
    import numpy as np

    rng = np.random.default_rng(seed)
    alphabet = np.frombuffer(b"ACGTN-", dtype=np.uint8)
    a = alphabet[rng.integers(0, 6, (P, L), dtype=np.uint8)]
    b = a.copy()
    b[rng.random((P, L), dtype=np.float32) < 0.1] = ord("A")
    b[::7] = alphabet[rng.integers(0, 6, b[::7].shape, dtype=np.uint8)]
    lens = np.full(P, la, np.int32)
    return a, b, lens, lens.copy()


def _device_ms(fn, reps, name):
    """Device time a call of the kernels whose names hold `name`, by
    torch.profiler over `reps` calls after one warm-up call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, "device_time_total", 0) or
             getattr(e, "cuda_time_total", 0)
             for e in prof.key_averages() if name in e.key)
    if not us:
        raise SystemExit(f"the profiler saw no {name} kernel")
    return us / reps / 1e3


def run_edit(root, args):
    """edit_distance at three widths (CUDA events), then the two routes
    of edit_distance_rows by P (host clock, in turns)."""
    import numpy as np
    import torch

    from clique_tpu_torch.collapse import distance as tdist

    dev = torch.device("cuda", 0)
    times, digests = {}, []
    for P, L, la in EDIT_SHAPES:
        host = _edit_rows(P, L, la, L)
        args_ = [torch.from_numpy(x).to(dev) for x in host]
        n0 = tdist.edit_distance_launches
        key = f"edit_distance P={P} L={L} ms"
        times[key] = [_event_ms(lambda: tdist.edit_distance(*args_),
                                args.reps)]
        kkey = f"edit_distance P={P} L={L} kernel ms"
        times[kkey] = [_device_ms(lambda: tdist.edit_distance(*args_),
                                  args.reps, "edit_distance")]
        out = tdist.edit_distance(*args_).cpu().numpy()
        digests.append(hashlib.sha256(out.tobytes()).hexdigest()[:16])
        print(f"{key}: {times[key][0]} (the kernel {times[kkey][0]}), "
              f"{tdist.edit_distance_launches - n0} launches, distances "
              f"{digests[-1]}", flush=True)
        del args_
        torch.cuda.empty_cache()
    saved = tdist.DEVICE_MIN_PAIRS
    tdist.DEVICE_MIN_PAIRS = 0        # older trees' CUDA route reads it
    for P in EDIT_ROUTE_PAIRS:
        host = _edit_rows(P, 32, 16, P)
        reps = max(1, min(50, (1 << 18) // P))

        def route(on_card):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                d = tdist.edit_distance_rows(*host, device="cuda") \
                    if on_card else tdist._edit_distance_myers_host(*host)
            return d, (time.perf_counter() - t0) / reps * 1e3

        route(True)                                   # warm the card path
        h1, host1 = route(False)
        c1, card1 = route(True)
        c2, card2 = route(True)
        h2, host2 = route(False)
        if not (np.array_equal(h1, c1) and np.array_equal(h1, c2)
                and np.array_equal(h1, h2)):
            raise SystemExit(f"the two routes disagree at P={P}")
        digests.append(hashlib.sha256(h1.tobytes()).hexdigest()[:16])
        times[f"rows route P={P} host ms"] = [host1, host2]
        times[f"rows route P={P} card ms"] = [card1, card2]
        print(f"edit_distance_rows P={P} L=32: host Myers {host1} / {host2} "
              f"ms, card with transfers {card1} / {card2} ms "
              f"({reps} calls a turn)", flush=True)
    tdist.DEVICE_MIN_PAIRS = saved
    return {"times": times, "check": digests}


WORKLOADS = {"align": run_align, "hamming": run_hamming, "local": run_local,
             "hmm": run_hmm, "wfa": run_wfa, "edit": run_edit, "dp": run_dp,
             "split": run_split}


def child(root, args):
    """One run: import `root`'s package, run the workload, print JSON."""
    sys.path.insert(0, root)
    import torch

    import clique_tpu_torch
    from clique_tpu_torch import _build

    got = os.path.dirname(os.path.dirname(clique_tpu_torch.__file__))
    if os.path.realpath(got) != os.path.realpath(root):
        raise SystemExit(f"imported the package of {got}, expected {root}")
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    _build.load()
    out = WORKLOADS[args.workload](root, args)
    print(json.dumps({"root": root, **out}), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("workload", choices=sorted(WORKLOADS))
    ap.add_argument("--runs", type=int, default=3, help="align: warm runs")
    ap.add_argument("--reads", type=int, default=80_000, help="align")
    ap.add_argument("--tags", type=int, default=25_000, help="hamming")
    ap.add_argument("--shapes", default="", help="wfa: words of the shapes "
                    "to run (comma-separated; default all)")
    ap.add_argument("--reps", type=int, default=None,
                    help="hamming (default 3), local, hmm, wfa, edit, dp "
                         "and split (default 5)")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("roots", nargs="*", default=[HERE])
    args = ap.parse_intermixed_args()
    if args.reps is None:
        args.reps = 3 if args.workload == "hamming" else 5
    roots = [os.path.abspath(r) for r in args.roots]
    if args.child:
        child(roots[0], args)
        return
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    if smi.returncode != 0:
        raise SystemExit(f"nvidia-smi failed: {smi.stderr}")
    print(smi.stdout.strip().splitlines()[0], flush=True)
    flags = [args.workload, "--child", "--runs", str(args.runs), "--reads",
             str(args.reads), "--tags", str(args.tags), "--shapes",
             args.shapes, "--reps", str(args.reps)]
    order = roots + roots[::-1] if len(roots) > 1 else roots
    runs = []
    for root in order:
        res = subprocess.run([sys.executable, os.path.abspath(__file__),
                              *flags, root], capture_output=True, text=True,
                             env={**os.environ, "PYTHONPATH": ""})
        if res.returncode != 0:
            raise SystemExit(f"{root} failed:\n{res.stderr[-3000:]}")
        print(f"== {root}\n{res.stdout.rstrip()}", flush=True)
        runs.append(json.loads(res.stdout.strip().splitlines()[-1]))
    checks = {json.dumps(r["check"]) for r in runs}
    if len(checks) != 1:
        raise SystemExit(f"the roots' results differ: {checks}")
    print(json.dumps({root: {k: [v for r in runs if r["root"] == root
                                 for v in r["times"][k]]
                             for k in runs[0]["times"]}
                      for root in roots}), flush=True)


if __name__ == "__main__":
    main()
