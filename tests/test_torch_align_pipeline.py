"""The port's `align` verb (clique_tpu_torch.align.pipeline.align_reads and
its CLI) on the CPU, held against the golden pins and the JAX package.

The BAM bytes are deterministic and every DP decision is exact, so the
inflated BAM payloads, the tag dumps and the AlignStats must be identical.
"""

import dataclasses
import gzip
import importlib.util
import os
import struct

import numpy as np
import pytest

from clique_tpu.align.pipeline import align_reads as jax_align_reads
from clique_tpu.config.layout import SequenceLayout as JaxSequenceLayout
from clique_tpu.reference.manager import ReferenceManager as JaxReferenceManager
from clique_tpu_torch import cli
from clique_tpu_torch.align.pipeline import align_reads
from clique_tpu_torch.config.layout import SequenceLayout
from clique_tpu_torch.reference.manager import ReferenceManager

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = {
    "golden": ("reads.fastq.gz", None),
    "golden_pe": ("reads1.fastq.gz", "reads2.fastq.gz"),
    "golden_ml": ("reads1.fastq.gz", "reads2.fastq.gz"),
}


def _load_make_golden():
    spec = importlib.util.spec_from_file_location(
        "make_golden", os.path.join(ROOT, "tools", "make_golden.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _inflate_bgzf(path):
    """Concatenated decompressed payload of every BGZF block."""
    with open(path, "rb") as fh:
        raw = fh.read()
    out, p = [], 0
    while p < len(raw):
        assert raw[p:p + 4] == b"\x1f\x8b\x08\x04", "not a BGZF block"
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


def load_layout(path):
    """The port's (layout, ReferenceManager) from a layout YAML."""
    layout = SequenceLayout.from_yaml(str(path))
    return layout, ReferenceManager.from_layout(layout)


def load_jax_layout(path):
    """The JAX package's (layout, ReferenceManager) from the same YAML:
    each side builds its inputs from its own package."""
    layout = JaxSequenceLayout.from_yaml(str(path))
    return layout, JaxReferenceManager.from_layout(layout)


def _golden_inputs(mg, name, workdir):
    """The golden dataset's directory, the port's layout and reference
    manager (from workdir/layout.yaml, templated by make_golden) and the
    FASTQ paths."""
    gd = os.path.join(ROOT, "tests", "data", name)
    mg._load_layout(str(workdir), golden_dir=gd)
    layout, rm = load_layout(os.path.join(str(workdir), "layout.yaml"))
    r1, r2 = GOLDEN[name]
    return (gd, layout, rm, os.path.join(gd, r1),
            os.path.join(gd, r2) if r2 else None)


@pytest.fixture(scope="module")
def golden_runs(tmp_path_factory):
    """The port's align on each golden dataset, batch 16 as
    tools/make_golden.py runs it, on the CPU."""
    mg = _load_make_golden()
    runs = {}
    for name in GOLDEN:
        wd = tmp_path_factory.mktemp(name)
        gd, layout, rm, r1, r2 = _golden_inputs(mg, name, wd)
        out = str(wd / "aligned.bam")
        align_reads(layout, rm, out, read1=r1, read2=r2, batch_size=16,
                    device="cpu")
        runs[name] = (gd, out)
    return mg, runs


@pytest.mark.parametrize("name", list(GOLDEN))
def test_golden_bam_payload_pinned(golden_runs, name):
    _mg, runs = golden_runs
    gd, out = runs[name]
    assert _inflate_bgzf(out) == _inflate_bgzf(
        os.path.join(gd, "aligned.bam")), f"{name} aligned BAM drifted"


@pytest.mark.parametrize("name", list(GOLDEN))
def test_golden_tag_dump_pinned(golden_runs, name, tmp_path):
    mg, runs = golden_runs
    gd, out = runs[name]
    dump = tmp_path / "aligned.bam.tags.tsv"
    mg.dump_tags(out, str(dump))
    with open(os.path.join(gd, "aligned.bam.tags.tsv")) as fh:
        assert dump.read_text() == fh.read(), f"{name} tag dump drifted"


@pytest.mark.parametrize("flags", [[], ["--router", "hmm"]],
                         ids=["kmer", "router_hmm"])
def test_cli_align_golden(flags, tmp_path):
    """`align` on golden; `--router hmm` on its single reference routes
    nothing (as clique_tpu/align/pipeline.py:647-650) and gives the pin."""
    mg = _load_make_golden()
    gd, _layout, _rm, r1, _r2 = _golden_inputs(mg, "golden", tmp_path)
    out = tmp_path / "cli.bam"
    rc = cli.main(["align", "--read-structure", str(tmp_path / "layout.yaml"),
                   "--read1", r1, "--output-bam-file", str(out),
                   "--batch-size", "16", "--device", "cpu", *flags])
    assert rc == 0
    assert _inflate_bgzf(str(out)) == _inflate_bgzf(
        os.path.join(gd, "aligned.bam"))


def _bench_shaped(tmp_path, n_reads=256):
    """bench.py:52-110's generator (seed 2026) with a few indels, plus a
    second, shorter amplicon, some reads from it and some chimeras of the
    two so the kmer vote falls back to the exhaustive search."""
    rng = np.random.default_rng(2026)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    a5 = "TTCAGACGTGTGCTCTTCCGATCT"
    a3 = "AGATCGGAAGAGCACACGTCTGAA"
    targets = [rng.choice(bases, 20).tobytes().decode() + "TGG"
               for _ in range(10)]
    block = "GAAA".join(targets)
    ref1 = f"{a5}{'0' * 16}{'1' * 12}{block}{a3}"
    core2 = rng.choice(bases, 150).tobytes().decode()
    ref2 = f"{a5}{'0' * 16}{'1' * 12}{core2}{a3}"
    umi = """    umi_configurations:
      cell_id: {symbol: '0', sort_type: "DegenerateTag", length: 16, order: 0, max_distance: 2}
      cell_umi: {symbol: '1', sort_type: "DegenerateTag", length: 12, order: 1, max_distance: 2}"""
    layout_path = tmp_path / "layout.yaml"
    layout_path.write_text(f"""
known_strand: true
reads:
  - !Read1
    orientation: Forward
references:
  amplicon1:
    sequence: "{ref1}"
    targets: [{", ".join(f'"{t}"' for t in targets)}]
    target_types: [{", ".join('"Cas9WT"' for _ in targets)}]
{umi}
  amplicon2:
    sequence: "{ref2}"
    targets: []
    target_types: []
{umi}
""")
    templates = [np.frombuffer((a5 + "N" * 28 + body + a3).encode(),
                               dtype=np.uint8)
                 for body in (block, core2, block[:120] + core2[60:])]
    cells = rng.choice(bases, (16, 16))
    umis = rng.choice(bases, (16, 4, 12))
    fq = tmp_path / "reads.fastq"
    with open(fq, "w") as fh:
        for i in range(n_reads):
            kind = 0 if i % 8 < 6 else (1 if i % 8 == 6 else 2)
            read = templates[kind].copy()
            read[24:40] = cells[i % 16]
            read[40:52] = umis[i % 16, (i // 16) % 4]
            subs = rng.random(len(read)) < 0.05
            read[subs] = rng.choice(bases, int(subs.sum()))
            seq = read.tobytes().decode()
            if i % 5 == 0:                       # a deletion
                p = int(rng.integers(60, len(seq) - 40))
                seq = seq[:p] + seq[p + int(rng.integers(1, 6)):]
            if i % 7 == 0:                       # an insertion
                p = int(rng.integers(60, len(seq) - 40))
                ins = rng.choice(bases, int(rng.integers(1, 5)))
                seq = seq[:p] + ins.tobytes().decode() + seq[p:]
            fh.write(f"@s{i}\n{seq}\n+\n{'I' * len(seq)}\n")
    return (*load_layout(layout_path), str(fq))


def test_bench_shaped_two_reference_matches_jax(tmp_path):
    layout, rm, fq = _bench_shaped(tmp_path)
    out_t = str(tmp_path / "torch.bam")
    out_j = str(tmp_path / "jax.bam")
    stats_t = align_reads(layout, rm, out_t, read1=fq, batch_size=64,
                          device="cpu")
    stats_j = jax_align_reads(*load_jax_layout(tmp_path / "layout.yaml"),
                              out_j, read1=fq, batch_size=64)
    assert dataclasses.asdict(stats_t) == dataclasses.asdict(stats_j)
    assert stats_t.aligned > 0.9 * stats_t.total
    assert _inflate_bgzf(out_t) == _inflate_bgzf(out_j)


# options the port once refused and now runs: their parity with the JAX
# package on the golden reads (a narrow band; every read anchored; the
# wavefront engines)
PORTED = {
    "bandwidth": dict(bandwidth=8),
    "anchored_length": dict(anchored_min_length=100),
    "engine_wfa": dict(engine="wfa"),
    "engine_convex": dict(engine="convex"),
}


def record_multiset(bam_path):
    """The sorted (name, reference, sequence, tags) of a BAM's records."""
    from clique_tpu_torch.io.sam import BamReader

    with BamReader(bam_path) as reader:
        return sorted((r.name, r.reference_name, r.seq,
                       tuple(sorted(r.tags.items()))) for r in reader)


def run_cli_ranks(argv, n, tmp_path, timeout=180):
    """`python -m clique_tpu_torch.cli` + argv as n ranks of a gloo world
    (--distributed-world n, a distinct --distributed-rank, a free localhost
    port, --device cpu), each a fresh interpreter with the repo root on
    its PYTHONPATH, read chunks of 8 reads striped across ranks, and a
    60 s timeout at every rendezvous and barrier. Every rank must exit 0."""
    import socket
    import subprocess
    import sys

    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=ROOT, CLIQUE_TPU_SHARD_CHUNK="8",
               CLIQUE_TPU_DIST_TIMEOUT="60", OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "clique_tpu_torch.cli", *argv,
         "--device", "cpu", "--work-dir", str(tmp_path / "work"),
         "--distributed-world", str(n), "--distributed-rank", str(r),
         "--distributed-coordinator", f"localhost:{port}"],
        env=env, cwd=str(tmp_path), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for r in range(n)]
    outs = []
    try:
        for proc in procs:
            outs.append(proc.communicate(timeout=timeout)[0])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    for proc, out in zip(procs, outs):
        assert proc.returncode == 0, out.decode(errors="replace")[-4000:]
    return b"".join(outs).decode(errors="replace")


@pytest.mark.parametrize("option", ["read_shard"])
def test_unported_options_raise(option, tmp_path, monkeypatch):
    """read_shard, which the port refused before it ran align on several
    processes, now runs: with read chunks of 8, each of two stripes gives
    the JAX package's stats and BAM bytes for the same stripe, and the two
    stripes' records together are the whole run's."""
    import clique_tpu.align.pipeline as jax_pipeline
    import clique_tpu_torch.align.pipeline as port_pipeline

    monkeypatch.setattr(port_pipeline, "_SHARD_CHUNK", 8)
    monkeypatch.setattr(jax_pipeline, "_SHARD_CHUNK", 8)
    mg = _load_make_golden()
    gd, layout, rm, r1, _r2 = _golden_inputs(mg, "golden", tmp_path)
    joined = []
    for rank in range(2):
        out_t = str(tmp_path / f"t{rank}.bam")
        out_j = str(tmp_path / f"j{rank}.bam")
        stats_t = align_reads(layout, rm, out_t, read1=r1, batch_size=16,
                              device="cpu", read_shard=(rank, 2))
        stats_j = jax_align_reads(*load_jax_layout(tmp_path / "layout.yaml"),
                                  out_j, read1=r1, batch_size=16,
                                  read_shard=(rank, 2))
        assert dataclasses.asdict(stats_t) == dataclasses.asdict(stats_j)
        assert 0 < stats_t.total
        assert _inflate_bgzf(out_t) == _inflate_bgzf(out_j)
        joined += record_multiset(out_t)
    assert sorted(joined) == record_multiset(os.path.join(gd, "aligned.bam"))


@pytest.mark.parametrize("option", list(PORTED))
def test_ported_options_match_jax(option, tmp_path):
    mg = _load_make_golden()
    gd, layout, rm, r1, _r2 = _golden_inputs(mg, "golden", tmp_path)
    out_t, out_j = str(tmp_path / "t.bam"), str(tmp_path / "j.bam")
    stats_t = align_reads(layout, rm, out_t, read1=r1, batch_size=16,
                          device="cpu", **PORTED[option])
    stats_j = jax_align_reads(*load_jax_layout(tmp_path / "layout.yaml"),
                              out_j, read1=r1, batch_size=16,
                              **PORTED[option])
    assert dataclasses.asdict(stats_t) == dataclasses.asdict(stats_j)
    assert stats_t.aligned == stats_t.total > 0
    assert _inflate_bgzf(out_t) == _inflate_bgzf(out_j)
    assert _inflate_bgzf(out_t) != _inflate_bgzf(
        os.path.join(gd, "aligned.bam"))


def test_hmm_router_over_several_references_matches_jax(tmp_path):
    """router="hmm" over the two bench-shaped amplicons (chimeras
    included): the same stats and BAM bytes as the JAX package's."""
    layout, rm, fq = _bench_shaped(tmp_path, n_reads=48)
    out_t, out_j = str(tmp_path / "t.bam"), str(tmp_path / "j.bam")
    stats_t = align_reads(layout, rm, out_t, read1=fq, batch_size=8,
                          router="hmm", device="cpu")
    stats_j = jax_align_reads(*load_jax_layout(tmp_path / "layout.yaml"),
                              out_j, read1=fq, batch_size=8, router="hmm")
    assert dataclasses.asdict(stats_t) == dataclasses.asdict(stats_j)
    assert stats_t.aligned == stats_t.total == 48
    assert _inflate_bgzf(out_t) == _inflate_bgzf(out_j)


def _guide_panel(tmp_path, n_refs, n_reads, seed=2121):
    """A guide-library panel: n_refs references one 20 bp guide apart on a
    60 bp backbone, then a 10 bp UMI; n_reads reads dealt round the panel
    at 5% substitutions, every 16th cut to 40 bp (dropped as short)."""
    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    backbone = rng.choice(bases, 60)
    cores = []
    for _ in range(n_refs):
        core = backbone.copy()
        core[20:40] = rng.choice(bases, 20)
        cores.append(core)
    umi = """    umi_configurations:
      umi: {symbol: '0', sort_type: "DegenerateTag", length: 10, order: 0, max_distance: 2}"""
    refs_yaml = "\n".join(f"""  guide{i}:
    sequence: "{core.tobytes().decode()}{'0' * 10}"
    targets: []
    target_types: []
{umi}""" for i, core in enumerate(cores))
    layout_path = tmp_path / "panel.yaml"
    layout_path.write_text(f"""
known_strand: true
reads:
  - !Read1
    orientation: Forward
references:
{refs_yaml}
""")
    fq = tmp_path / "panel.fastq"
    with open(fq, "w") as fh:
        for i in range(n_reads):
            read = np.concatenate([cores[i % n_refs], rng.choice(bases, 10)])
            subs = rng.random(len(read)) < 0.05
            read[subs] = rng.choice(bases, int(subs.sum()))
            seq = read.tobytes().decode()[:40 if i % 16 == 15 else None]
            fh.write(f"@g{i}\n{seq}\n+\n{'I' * len(seq)}\n")
    return (*load_layout(layout_path), str(fq))


def test_hmm_route_calls_in_flight_equal_routing_each_read_alone(
        tmp_path, monkeypatch):
    """176 reads at batch 8 over five references: six route calls of 32
    reads (the last of 5), each launched before the one before it is
    picked. The same stats and SAM bytes as the kmer path with each read
    sent to the reference that HmmRouter.route picks for it alone."""
    from clique_tpu_torch.align import hmm, pipeline

    layout, rm, fq = _guide_panel(tmp_path, 5, 176)
    out = tmp_path / "inflight.sam"
    stats = align_reads(layout, rm, str(out), read1=fq, batch_size=8,
                        router="hmm", device="cpu")
    router = hmm.HmmRouter([r.sequence for r in rm.references.values()],
                           device="cpu")
    monkeypatch.setattr(pipeline, "_choose_reference",
                        lambda _rm, _layout, seq, _t:
                        router.route([seq])[0][0])
    alone = tmp_path / "alone.sam"
    stats_alone = align_reads(layout, rm, str(alone), read1=fq,
                              batch_size=8, device="cpu")
    assert router.calls == 165
    assert dataclasses.asdict(stats) == dataclasses.asdict(stats_alone)
    assert (stats.aligned, stats.dropped_short) == (165, 11)
    assert out.read_bytes() == alone.read_bytes()


@pytest.mark.parametrize("n_reads,calls", [(176, 6), (24, 1)])
def test_hmm_route_calls_pass_pair_lls_in_input_order(tmp_path, monkeypatch,
                                                      n_reads, calls):
    """A tap on HmmRouter.pair_lls with the benchmark's signature sees
    every routed read once, in input order, with an LL per reference; the
    metrics count the route calls, all but the first launched while the
    one before was in flight."""
    import json

    from clique_tpu_torch.align import hmm

    layout, rm, fq = _guide_panel(tmp_path, 5, n_reads)
    real = hmm.HmmRouter.pair_lls
    taps = []

    def tapped(self, reads, candidates=None):
        out = real(self, reads, candidates)
        taps.append((reads, candidates, out[2]))
        return out

    monkeypatch.setattr(hmm.HmmRouter, "pair_lls", tapped)
    mpath = tmp_path / "m.json"
    stats = align_reads(layout, rm, str(tmp_path / "t.sam"), read1=fq,
                        batch_size=8, router="hmm", device="cpu",
                        metrics_path=str(mpath))
    with open(fq) as fh:
        seqs = [ln.strip().encode() for k, ln in enumerate(fh) if k % 4 == 1]
    routed = [s for s in seqs if len(s) >= 50]
    assert [r for reads, _c, _ll in taps for r in reads] == routed
    assert all(c is None and np.asarray(ll).shape == (5 * len(reads),)
               for reads, c, ll in taps)
    assert len(taps) == calls and stats.aligned == len(routed)
    m = json.loads(mpath.read_text())
    assert (m["route_calls"], m["route_calls_overlapped"]) == \
        (calls, calls - 1)


class _FaultyEvent:
    def synchronize(self):
        raise RuntimeError("planted kernel fault")


@pytest.mark.parametrize("where", ["launch", "collect"])
def test_hmm_route_call_error_surfaces_from_align_reads(tmp_path,
                                                        monkeypatch, where):
    """The third of six route calls fails: as its launch raises, or as its
    forward pass fails while in flight and the wait on it raises (a
    kernel fault on the card). Either error leaves align_reads."""
    from clique_tpu_torch.align import hmm

    layout, rm, fq = _guide_panel(tmp_path, 5, 176)
    n = [0]
    if where == "launch":
        real = hmm.hmm_forward_batch

        def forward(*args, **kwargs):
            n[0] += 1
            if n[0] == 3:
                raise RuntimeError("planted launch fault")
            return real(*args, **kwargs)

        monkeypatch.setattr(hmm, "hmm_forward_batch", forward)
    else:
        real = hmm.HmmRouter._start

        def start(self, reads, candidates):
            n[0] += 1
            call = real(self, reads, candidates)
            return call[:3] + (_FaultyEvent(),) if n[0] == 3 else call

        monkeypatch.setattr(hmm.HmmRouter, "_start", start)
    with pytest.raises(RuntimeError, match=f"planted "):
        align_reads(layout, rm, str(tmp_path / "t.sam"), read1=fq,
                    batch_size=8, router="hmm", device="cpu")
    assert n[0] == 3 if where == "launch" else n[0] >= 3


def test_cli_align_router_hmm_two_references(tmp_path):
    """`align --router hmm` on a two-reference layout exits 0 and writes
    the library call's bytes."""
    layout, rm, fq = _bench_shaped(tmp_path, n_reads=16)
    out = tmp_path / "cli.bam"
    assert cli.main(["align", "--read-structure",
                     str(tmp_path / "layout.yaml"), "--read1", fq,
                     "--output-bam-file", str(out), "--batch-size", "8",
                     "--device", "cpu", "--router", "hmm"]) == 0
    lib = str(tmp_path / "lib.bam")
    align_reads(layout, rm, lib, read1=fq, batch_size=8, router="hmm",
                device="cpu")
    assert _inflate_bgzf(str(out)) == _inflate_bgzf(lib)


def _trace_files(d):
    return sorted(p for p in os.listdir(d) if p.endswith(".pt.trace.json"))


def test_profile_dir_writes_a_trace(tmp_path):
    """profile_dir: a torch.profiler Chrome trace of the run appears there
    (CPU activity on a CPU device), with the main thread's spans and,
    where torch profiles every thread, the pipeline threads' spans; the
    BAM still equals the pin."""
    import json

    from clique_tpu_torch.align.pipeline import all_threads_config

    mg = _load_make_golden()
    gd, layout, rm, r1, _r2 = _golden_inputs(mg, "golden", tmp_path)
    out, trace = str(tmp_path / "p.bam"), tmp_path / "trace"
    align_reads(layout, rm, out, read1=r1, batch_size=16, device="cpu",
                profile_dir=str(trace))
    files = _trace_files(trace)
    assert len(files) == 1
    with open(trace / files[0]) as fh:
        events = json.load(fh)["traceEvents"]
    assert any(e.get("ph") == "X" for e in events)
    names = {e.get("name") for e in events}
    assert {"align.run", "align.read", "align.flush"} <= names
    if all_threads_config() is not None:
        assert {"align.build", "align.write"} & names
    assert _inflate_bgzf(out) == _inflate_bgzf(os.path.join(gd, "aligned.bam"))


def test_cli_align_profile_dir(tmp_path):
    mg = _load_make_golden()
    _gd, _layout, _rm, r1, _r2 = _golden_inputs(mg, "golden", tmp_path)
    assert cli.main(["align", "--read-structure",
                     str(tmp_path / "layout.yaml"), "--read1", r1,
                     "--output-bam-file", str(tmp_path / "x.bam"),
                     "--batch-size", "16", "--device", "cpu",
                     "--profile-dir", str(tmp_path / "trace")]) == 0
    assert len(_trace_files(tmp_path / "trace")) == 1


@pytest.mark.parametrize("flags", [
    ["--distributed-world", "2"],
], ids=lambda f: f[0].lstrip("-"))
def test_cli_unported_flags_exit(flags, tmp_path):
    """`align --distributed-world 2`, which the port refused before it ran
    align on several processes, now runs: two ranks through cli.main on
    gloo with --device cpu each exit 0, and the merged BAM's records equal
    the JAX package's single-process align_reads on the golden reads."""
    mg = _load_make_golden()
    _gd, _layout, _rm, r1, _r2 = _golden_inputs(mg, "golden", tmp_path)
    layout = tmp_path / "layout.yaml"
    out = str(tmp_path / "x.bam")
    logs = run_cli_ranks(["align", "--read-structure", str(layout),
                          "--read1", r1, "--output-bam-file", out,
                          "--batch-size", "16"], int(flags[1]), tmp_path)
    assert logs.count("torch.distributed gloo backend") == 2
    out_j = str(tmp_path / "j.bam")
    jax_align_reads(*load_jax_layout(layout), out_j, read1=r1,
                    batch_size=16)
    assert record_multiset(out) == record_multiset(out_j)
    for p in range(2):
        assert record_multiset(str(tmp_path / "work" / f"part.p{p}.bam"))


def test_cli_bandwidth_matches_jax(tmp_path):
    """`--bandwidth` on the port's align: the BAM equals the JAX package's
    align_reads with the same band."""
    mg = _load_make_golden()
    _gd, _layout, _rm, r1, _r2 = _golden_inputs(mg, "golden", tmp_path)
    out = tmp_path / "cli.bam"
    rc = cli.main(["align", "--read-structure", str(tmp_path / "layout.yaml"),
                   "--read1", r1, "--output-bam-file", str(out),
                   "--batch-size", "16", "--device", "cpu",
                   "--bandwidth", "10"])
    assert rc == 0
    out_j = str(tmp_path / "j.bam")
    jax_align_reads(*load_jax_layout(tmp_path / "layout.yaml"), out_j,
                    read1=r1, batch_size=16, bandwidth=10)
    assert _inflate_bgzf(str(out)) == _inflate_bgzf(out_j)
