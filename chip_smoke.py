#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (clique_tpu_torch) on one GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from clique_tpu_torch/csrc/, checks
each against its plain PyTorch version on the card, and drives the port's
paths on the card, each with the kernels' launch counts set to 0 just
before and read just after:

- golden: align -> collapse -> call on tests/data/golden{,_pe,_ml}
  reproduces the pinned BAMs and allele tables, and the fused run_chain
  gives the same bytes;
- known list: the bench-shaped reads collapsed against a 737,280-entry
  allowlist (KnownTag Hamming at the size of 10x Chromium v2's list);
- device Levenshtein: one DegenerateTag group with 4M candidate pairs, so
  correct_degenerate_groups takes the edit-distance kernel;
- bench: the fused chain (align -> collapse -> call) over 80,000
  bench-shaped reads (the generator of bench.py, seed 2026), timed as
  bench.py times it.

It imports no jax. Every failure raises and the script exits non-zero;
the last line of a run that passed is

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}

and the line before it is a JSON object with one entry per kernel.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

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
KERNELS = ("dp_fill", "dp_walk", "match_count", "edit_distance")
SOURCES = {"dp_fill": "dp_fill.cu", "dp_walk": "dp_walk.cu",
           "match_count": "tag_distance.cu",
           "edit_distance": "tag_distance.cu"}
REPLACES = {"dp_fill": "clique_tpu/align/pallas_kernel.py:55",
            "dp_walk": "clique_tpu/align/batch.py:565",
            "match_count": "clique_tpu/collapse/distance.py:240",
            "edit_distance": "clique_tpu/collapse/distance.py:36"}


def check(cond, msg):
    if not cond:
        raise SystemExit(f"chip_smoke FAILED: {msg}")


def say(msg):
    print(msg, flush=True)


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
            kernel = next((k for k in ("dp_fill", "dp_walk", "match_count",
                                       "edit_distance_reg",
                                       "edit_distance_local")
                           if k in line), line.strip())
        elif kernel and ("registers" in line or "spill" in line):
            say(f"[build] {kernel}: {line.strip()}")
    # both kernels use no static shared memory; the fill's is dynamic
    say(f"[build] dp_fill: dynamic shared memory "
        f"{_build.load().clique_dp_fill_smem_bytes(384, 384)} B per CTA at "
        f"n1=n2=384; dp_walk: none")


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


def _time_ms(fn, reps):
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


def phase_kernels():
    """Each kernel against its plain PyTorch version on the card."""
    import numpy as np
    import torch

    from clique_tpu_torch.align import batch as tbatch
    from clique_tpu_torch.align import dp_kernels
    from clique_tpu_torch.align.pipeline import (MERGE_SCORING,
                                                 RUST_BIO_COMPAT)

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(2026)
    err = {"dp_fill": 0.0, "dp_walk": 0.0}

    def run_case(B, n1, n2, mode, scoring, uniform, ragged):
        host = _random_batch(rng, B, n1, n2, uniform, ragged)
        args = [torch.from_numpy(a).to(dev) for a in host]
        params = tbatch.scoring_to_params(scoring, dev)
        tb_k, corner_k = dp_kernels.dp_fill(*args, params, n1=n1, n2=n2,
                                            special_mode=mode)
        fused_k = dp_kernels.dp_walk(tb_k, corner_k, args[2], args[3],
                                     n1=n1, n2=n2)
        torch.cuda.synchronize()
        tb_p, corner_p = tbatch.fill_reference(*args, params, n1=n1, n2=n2,
                                               special_mode=mode)
        # the walk is held against the plain walk on the kernel's own fill
        _res, fused_p = tbatch.walk_reference(tb_k, corner_k, args[2],
                                              args[3], n1=n1, n2=n2)
        torch.cuda.synchronize()
        e_fill = max((tb_k.int() - tb_p.int()).abs().max().item(),
                     (corner_k - corner_p).abs().max().item())
        e_walk = (fused_k.int() - fused_p.int()).abs().max().item()
        err["dp_fill"] = max(err["dp_fill"], e_fill)
        err["dp_walk"] = max(err["dp_walk"], e_walk)
        same = (torch.equal(tb_k, tb_p) and torch.equal(corner_k, corner_p)
                and torch.equal(fused_k, fused_p))
        say(f"[kernels] B={B} n1={n1} n2={n2} {mode} "
            f"{'uniform' if uniform else 'per-row'} ref: tb, corner, fused "
            f"{'byte-equal' if same else 'DIFFER'} (max abs err fill "
            f"{e_fill}, walk {e_walk})")
        check(same, "kernel and plain version disagree")
        return args, params

    run_case(24, 128, 256, "both", MERGE_SCORING, False, True)
    run_case(24, 256, 128, "ref_n_only", RUST_BIO_COMPAT, False, True)
    run_case(16, 128, 128, "both", MERGE_SCORING, True, True)
    n = 384
    args, params = run_case(1024, n, n, "ref_n_only", RUST_BIO_COMPAT,
                            True, False)

    # timing at the bench shape, in turns: plain, kernel, kernel, plain
    def fill_k():
        return dp_kernels.dp_fill(*args, params, n1=n, n2=n,
                                  special_mode="ref_n_only")

    def fill_p():
        return tbatch.fill_reference(*args, params, n1=n, n2=n,
                                     special_mode="ref_n_only")

    tb, corner = fill_k()

    def walk_k():
        return dp_kernels.dp_walk(tb, corner, args[2], args[3], n1=n, n2=n)

    def walk_p():
        return tbatch.walk_reference(tb, corner, args[2], args[3], n1=n,
                                     n2=n)

    times = {}
    for name, kern, plain in (("dp_fill", fill_k, fill_p),
                              ("dp_walk", walk_k, walk_p)):
        p1 = _time_ms(plain, 1)
        k1 = _time_ms(kern, 20)
        k2 = _time_ms(kern, 20)
        p2 = _time_ms(plain, 1)
        times[name] = ((k1 + k2) / 2, (p1 + p2) / 2)
        say(f"[kernels] {name} at B=1024 n1=n2=384: kernel {k1:.4f} / "
            f"{k2:.4f} ms, plain {p1:.2f} / {p2:.2f} ms per call")
    return err, times


def phase_tag_kernels():
    """match_count and edit_distance against their plain PyTorch versions
    on the card, then timed in turns (plain, kernel, kernel, plain) at the
    JAX chunk shape and at 2M bench-shaped pairs, beside the host Myers
    code on the same pairs."""
    import numpy as np
    import torch

    from clique_tpu_torch.collapse import distance as tdist

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(2027)
    alphabet = np.frombuffer(b"ACGTN-", dtype=np.uint8)
    err = {"match_count": 0, "edit_distance": 0}

    def match_case(U, K, L):
        allow = rng.choice(alphabet, (K, L))
        tags = rng.choice(alphabet, (U, L))
        tags[::2] = allow[rng.integers(0, K, len(tags[::2]))]
        t = torch.from_numpy(tags).to(dev)
        a = torch.from_numpy(allow).to(dev)
        got = tdist.match_count(t, a)
        torch.cuda.synchronize()
        want = tdist.match_count_reference(t, a)
        e = (got.int() - want.int()).abs().max().item()
        err["match_count"] = max(err["match_count"], e)
        say(f"[tag kernels] match_count U={U} K={K} L={L}: "
            f"{'equal' if e == 0 else 'DIFFER'} (max abs err {e})")
        check(e == 0, "match_count and its plain version disagree")
        return t, a

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

    for U, K, L in ((37, 91, 16), (2047, 16383, 16), (300, 1001, 12),
                    (129, 515, 255)):
        match_case(U, K, L)
    for P, L in ((3001, 16), (3001, 32), (3001, 64), (3001, 100),
                 (3001, 256)):
        edit_case(P, L)
    t, a = match_case(2048, 16384, 16)
    host, args = edit_case(2_097_152, 32, la_val=16)

    times = {}
    for name, kern, plain in (
            ("match_count", lambda: tdist.match_count(t, a),
             lambda: tdist.match_count_reference(t, a)),
            ("edit_distance", lambda: tdist.edit_distance(*args),
             lambda: tdist.edit_distance_reference(*args))):
        p1 = _time_ms(plain, 2)
        k1 = _time_ms(kern, 20)
        k2 = _time_ms(kern, 20)
        p2 = _time_ms(plain, 2)
        times[name] = ((k1 + k2) / 2, (p1 + p2) / 2)
        shape = ("U=2048 K=16384 L=16" if name == "match_count"
                 else "P=2097152 L=32 la=lb=16")
        say(f"[tag kernels] {name} at {shape}: kernel {k1:.4f} / {k2:.4f} "
            f"ms, plain {p1:.3f} / {p2:.3f} ms per call")
    t0 = time.time()
    myers = tdist._edit_distance_myers_host(*host)
    myers_ms = (time.time() - t0) * 1e3
    check(np.array_equal(myers, tdist.edit_distance(*args).cpu().numpy()),
          "edit_distance and the host Myers code disagree")
    say(f"[tag kernels] host Myers at P=2097152 L=32 la=lb=16: "
        f"{myers_ms:.1f} ms (equal to the kernel)")
    return err, times, myers_ms


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


def _reset_counts():
    from clique_tpu_torch.align import dp_kernels
    from clique_tpu_torch.collapse import distance

    dp_kernels.reset_counts()
    distance.reset_counts()


def _counts():
    from clique_tpu_torch.align import dp_kernels
    from clique_tpu_torch.collapse import distance

    return {"dp_fill": dp_kernels.fill_launches,
            "dp_walk": dp_kernels.walk_launches,
            "match_count": distance.match_count_launches,
            "edit_distance": distance.edit_distance_launches}


def _read(path):
    with open(path) as fh:
        return fh.read()


def phase_golden(workdir):
    """align -> collapse -> call and the fused run_chain on the card,
    against the pins. Returns the kernel launches of the collapse runs."""
    from clique_tpu.caller.events import call_events_from_bam
    from clique_tpu_torch.align.pipeline import align_reads
    from clique_tpu_torch.chain import run_chain
    from clique_tpu_torch.collapse.pipeline import collapse

    launches = dict.fromkeys(KERNELS, 0)
    for name, (r1, r2) in GOLDEN_DIRS.items():
        gd = os.path.join(HERE, "tests", "data", name)
        with open(os.path.join(gd, "layout.yaml.in")) as fh:
            text = fh.read().replace("@ALLOWLIST@",
                                     os.path.join(gd, "allowlist.txt"))
        wd = os.path.join(workdir, name)
        os.makedirs(wd)
        layout, rm = _layout_from_text(text, wd)
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
        for k in ("match_count", "edit_distance"):
            launches[k] += n[k]
        same = _inflate_bgzf(collapsed) == _inflate_bgzf(
            os.path.join(gd, "collapsed.bam"))
        say(f"[golden] {name}: collapse on the card, {cstats.passing} "
            f"passing reads, launches match_count {n['match_count']} "
            f"edit_distance {n['edit_distance']}; collapsed BAM payload "
            f"{'equals' if same else 'DIFFERS from'} its pin")
        check(same, f"{name} collapsed BAM differs from its pin")
        if name in ("golden", "golden_pe"):
            check(n["match_count"] > 0,
                  f"{name}: the KnownTag level launched no match_count")
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
        for k in ("match_count", "edit_distance"):
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


def phase_bench(workdir):
    """The fused chain over the 80,000 bench-shaped reads, as
    bench.py:126-181 times it: a warm-up run, then align (with the sink),
    collapse_from_reads and the fused call, each on the host clock; chain
    reads/s = aligned reads / (align + collapse + call)."""
    from clique_tpu.caller.events import call_events_from_records
    from clique_tpu.chain import CollapseSink
    from clique_tpu_torch.align.pipeline import align_reads
    from clique_tpu_torch.chain import collapse_from_reads, run_chain

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
    check(stats.aligned == N_BENCH_READS, "not every read was aligned")
    check(launches["dp_fill"] > 0 and launches["dp_walk"] > 0,
          "the main path launched no kernel")
    check(launches["dp_fill"] == launches["dp_walk"] == m["dispatches"],
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
    return launches, (layout_text, aligned, cells, stats.aligned / chain_s)


def phase_known_list(workdir, bench):
    """The bench-shaped reads collapsed with cell_id as KnownTag Hamming
    (max_distance 1) against a seeded 737,280-entry 16 bp allowlist that
    holds the bench's 500 cell barcodes."""
    import numpy as np

    from clique_tpu.io.sam import BamReader
    from clique_tpu_torch.collapse import distance as tdist
    from clique_tpu_torch.collapse.correct import correct_known_hamming
    from clique_tpu_torch.collapse.pipeline import collapse

    layout_text, aligned, cells, _rate = bench
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
           f"\"{allow_path}\", length: 16, order: 0, max_distance: 1, "
           f"levenshtein_distance: false}}")
    check(old in layout_text, "bench layout changed shape")
    wd = os.path.join(workdir, "known")
    os.makedirs(wd)
    layout, _rm = _layout_from_text(layout_text.replace(old, new), wd)

    out = os.path.join(wd, "collapsed.bam")
    _reset_counts()
    t0 = time.time()
    cstats = collapse(out, layout, aligned, device="cuda")
    seconds = time.time() - t0
    launches = _counts()
    with open(out + ".collapse_metrics.json") as fh:
        levels = json.load(fh)["references"]["amplicon1"]["levels"]
    say(f"[known list] collapse of {cstats.total_reads} reads against "
        f"{N_ALLOWLIST} entries on the card: {seconds:.3f} s, "
        f"{cstats.passing} passing, levels {json.dumps(levels)}, "
        f"launches {launches}")
    check(launches["match_count"] > 0, "the known-list level launched no "
          "match_count")
    check(levels[0]["reads_out"] > 0.5 * levels[0]["reads_in"],
          "the known-list level corrected almost nothing")

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
    t0 = time.time()
    got = correct_known_hamming(sample, allow_list, 1, 16, device="cuda")
    cuda_s = time.time() - t0
    t0 = time.time()
    want = correct_known_hamming(sample, allow_list, 1, 16, device="cpu")
    cpu_s = time.time() - t0
    say(f"[known list] correction map of {len(sample)} observed tags of "
        f"{len(keys)}: cuda ({cuda_s:.2f} s) "
        f"{'equals' if got == want else 'DIFFERS from'} the plain version "
        f"on the cpu ({cpu_s:.2f} s); {len(got)} tags corrected")
    check(got == want, "known-list correction maps differ")
    check(tdist.match_count_launches > launches["match_count"],
          "the sample check launched no kernel")
    return launches


def phase_device_levenshtein():
    """One DegenerateTag group of 2,000 tags of count 10 and 2,000 of count
    1: the ratio filter leaves 4M pairs, so correct_degenerate_groups sends
    them to the edit-distance kernel; the map must equal the one computed
    from host Myers distances on the same rows."""
    from collections import Counter

    import numpy as np

    from clique_tpu_torch.collapse import distance as tdist
    from clique_tpu_torch.collapse.correct import correct_degenerate_groups

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
    _reset_counts()
    t0 = time.time()
    got = correct_degenerate_groups([counts], 2, 16, 5.0, device="cuda")[0]
    seconds = time.time() - t0
    launches = _counts()
    n_hi = sum(1 for c in counts.values() if c == 10)
    n_pairs = n_hi * (len(counts) - n_hi)
    min_pairs = tdist.DEVICE_MIN_PAIRS
    tdist.DEVICE_MIN_PAIRS = 1 << 62        # the host Myers code, once
    try:
        t0 = time.time()
        want = correct_degenerate_groups([counts], 2, 16, 5.0,
                                         device="cuda")[0]
        myers_s = time.time() - t0
    finally:
        tdist.DEVICE_MIN_PAIRS = min_pairs
    absorbed = sum(1 for k, v in got.items() if k != v)
    say(f"[device levenshtein] {len(counts)} tags, {n_pairs} ratio-filtered "
        f"pairs: correct_degenerate_groups on the card {seconds:.3f} s "
        f"(launches {launches}), with host Myers {myers_s:.3f} s; maps "
        f"{'equal' if got == want else 'DIFFER'}, {absorbed} tags absorbed")
    check(n_pairs >= tdist.DEVICE_MIN_PAIRS, "too few pairs for the kernel")
    check(launches["edit_distance"] > 0,
          "correct_degenerate_groups launched no edit_distance")
    check(got == want, "device and host Myers correction maps differ")
    check(absorbed > 0, "no tag was absorbed")
    return launches


def main():
    phase_card()
    import torch

    phase_build()
    err, times = phase_kernels()
    tag_err, tag_times, myers_ms = phase_tag_kernels()
    err.update(tag_err)
    times.update(tag_times)
    launches = dict.fromkeys(KERNELS, 0)
    with tempfile.TemporaryDirectory() as workdir:
        path_launches = [phase_golden(workdir)]
        bench_launches, bench = phase_bench(workdir)
        path_launches += [bench_launches, phase_known_list(workdir, bench),
                          phase_device_levenshtein()]
    for n in path_launches:
        for k in KERNELS:
            launches[k] += n[k]
    loaded = sorted(m for m, mod in sys.modules.items()
                    if mod is not None and (m == "jax" or m == "jaxlib"
                                            or m.startswith(("jax.",
                                                             "jaxlib."))))
    check(not loaded, f"jax modules were loaded: {loaded[:5]}")
    say("[jax] no jax module loaded")
    check(all(launches[k] > 0 for k in KERNELS),
          f"a kernel was never launched on a path: {launches}")
    say(f"[summary] chain {bench[3]:.1f} reads/s over {N_BENCH_READS} "
        f"bench-shaped reads; host Myers at 2M pairs {myers_ms:.1f} ms")
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda",
         "source": f"clique_tpu_torch/csrc/{SOURCES[name]}",
         "replaces": REPLACES[name], "launches": launches[name],
         "max_abs_err": err[name], "ms": times[name][0],
         "plain_ms": times[name][1]}
        for name in KERNELS]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
