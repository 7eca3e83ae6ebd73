#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (clique_tpu_torch) on one GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from clique_tpu_torch/csrc/, checks
each against its plain PyTorch version on the card, reproduces the golden
aligned BAMs on the card, and drives the `align` verb over an 80,000-read
bench-shaped dataset (the generator of bench.py, seed 2026). It imports
no jax. Every failure raises and the script exits non-zero; the last line
of a run that passed is

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
            kernel = "dp_fill" if "dp_fill" in line else (
                "dp_walk" if "dp_walk" in line else line)
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


def phase_golden(workdir):
    from clique_tpu_torch.align.pipeline import align_reads

    for name, (r1, r2) in GOLDEN_DIRS.items():
        gd = os.path.join(HERE, "tests", "data", name)
        with open(os.path.join(gd, "layout.yaml.in")) as fh:
            text = fh.read().replace("@ALLOWLIST@",
                                     os.path.join(gd, "allowlist.txt"))
        wd = os.path.join(workdir, name)
        os.makedirs(wd)
        layout, rm = _layout_from_text(text, wd)
        out = os.path.join(wd, "aligned.bam")
        stats = align_reads(layout, rm, out, read1=os.path.join(gd, r1),
                            read2=os.path.join(gd, r2) if r2 else None,
                            batch_size=16, device="cuda")
        same = _inflate_bgzf(out) == _inflate_bgzf(
            os.path.join(gd, "aligned.bam"))
        say(f"[golden] {name}: {stats.aligned}/{stats.total} aligned on "
            f"the card, BAM payload {'equals' if same else 'DIFFERS from'} "
            f"tests/data/{name}/aligned.bam")
        check(same, f"{name} aligned BAM differs from its pin")


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
    return layout_text, fq, head


def phase_bench(workdir):
    from clique_tpu_torch.align import dp_kernels
    from clique_tpu_torch.align.pipeline import align_reads

    t0 = time.time()
    layout_text, fq, head = _bench_dataset(workdir, N_BENCH_READS)
    layout, rm = _layout_from_text(layout_text, workdir)
    say(f"[bench] {N_BENCH_READS} reads written in {time.time() - t0:.2f} s")

    metrics_path = os.path.join(workdir, "metrics.json")
    dp_kernels.reset_counts()
    t0 = time.time()
    stats = align_reads(layout, rm, os.path.join(workdir, "bench.bam"),
                        read1=fq, batch_size=BENCH_BATCH, device="cuda",
                        metrics_path=metrics_path)
    wall = time.time() - t0
    launches = {"dp_fill": dp_kernels.fill_launches,
                "dp_walk": dp_kernels.walk_launches}
    with open(metrics_path) as fh:
        m = json.load(fh)
    say(f"[bench] align of {stats.total} reads on {m['device']}: "
        f"{stats.aligned} aligned in {wall:.3f} s wall = "
        f"{stats.aligned / wall:.1f} reads/s (align_reads' own clock "
        f"{m['reads_per_s']} reads/s); device_seconds "
        f"{m['device_seconds']}, host_post_seconds "
        f"{m['host_post_seconds']}, dispatches {m['dispatches']}, "
        f"launches {launches}")
    say(f"[bench] phase walls {json.dumps(m['phase_walls'])}")
    check(stats.aligned == N_BENCH_READS, "not every read was aligned")
    check(launches["dp_fill"] > 0 and launches["dp_walk"] > 0,
          "the main path launched no kernel")
    check(launches["dp_fill"] == launches["dp_walk"] == m["dispatches"],
          "launch counts differ from the number of dispatches")

    bams = {}
    for device in ("cuda", "cpu"):
        out = os.path.join(workdir, f"head_{device}.bam")
        t0 = time.time()
        align_reads(layout, rm, out, read1=head, batch_size=BENCH_BATCH,
                    device=device)
        bams[device] = _inflate_bgzf(out)
        say(f"[bench] first {N_CPU_CHECK} reads on {device}: "
            f"{time.time() - t0:.2f} s")
    check(bams["cuda"] == bams["cpu"],
          f"the {N_CPU_CHECK}-read BAM differs between cuda and cpu")
    say(f"[bench] first {N_CPU_CHECK} reads: cuda and cpu BAMs identical")
    return launches


def main():
    phase_card()
    import torch

    phase_build()
    err, times = phase_kernels()
    with tempfile.TemporaryDirectory() as workdir:
        phase_golden(workdir)
        launches = phase_bench(workdir)
    loaded = sorted(m for m, mod in sys.modules.items()
                    if mod is not None and (m == "jax" or m == "jaxlib"
                                            or m.startswith(("jax.",
                                                             "jaxlib."))))
    check(not loaded, f"jax modules were loaded: {loaded[:5]}")
    say("[jax] no jax module loaded")
    replaces = {"dp_fill": "clique_tpu/align/pallas_kernel.py:55",
                "dp_walk": "clique_tpu/align/batch.py:565"}
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda",
         "source": f"clique_tpu_torch/csrc/{name}.cu",
         "replaces": replaces[name], "launches": launches[name],
         "max_abs_err": err[name], "ms": times[name][0],
         "plain_ms": times[name][1]}
        for name in ("dp_fill", "dp_walk")]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
