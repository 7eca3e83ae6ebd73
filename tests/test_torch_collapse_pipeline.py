"""The port's `collapse`, `call` and fused `run` (clique_tpu_torch.collapse
.pipeline, clique_tpu_torch.chain, cli) on the CPU, held against the golden
pins and the JAX package.

BAM bytes are deterministic and every correction is exact, so the inflated
BAM payloads, tag dumps, allele tables and CollapseStats must be identical.
"""

import dataclasses
import os

import numpy as np
import pytest

from clique_tpu.align.pipeline import align_reads as jax_align_reads
from clique_tpu.collapse.pipeline import collapse as jax_collapse
from clique_tpu_torch import cli
from clique_tpu_torch.align.pipeline import align_reads
from clique_tpu_torch.caller.events import call_events_from_bam
from clique_tpu_torch.chain import run_chain
from clique_tpu_torch.collapse import pipeline as tpipeline
from clique_tpu_torch.collapse.pipeline import collapse

from test_torch_align_pipeline import (GOLDEN, _bench_shaped,
                                       _golden_inputs, _inflate_bgzf,
                                       _load_make_golden, load_jax_layout,
                                       load_layout)


def _stats(s):
    return dataclasses.asdict(s)


@pytest.fixture(scope="module")
def golden_chains(tmp_path_factory):
    """Per golden dataset on the CPU: the two-stage chain (port align ->
    port collapse -> port call) and the fused run_chain."""
    mg = _load_make_golden()
    runs = {}
    for name in GOLDEN:
        wd = tmp_path_factory.mktemp(name)
        gd, layout, rm, r1, r2 = _golden_inputs(mg, name, wd)
        has_alleles = os.path.exists(os.path.join(gd, "alleles.tsv"))
        a2, c2 = str(wd / "two_aligned.bam"), str(wd / "two_collapsed.bam")
        t2 = str(wd / "two_alleles.tsv") if has_alleles else None
        align_reads(layout, rm, a2, read1=r1, read2=r2, batch_size=16,
                    device="cpu")
        s2 = collapse(c2, layout, a2, device="cpu")
        if t2:
            call_events_from_bam(layout, c2, t2, min_read_count=1)
        a1, c1 = str(wd / "fused_aligned.bam"), str(wd / "fused_collapsed.bam")
        t1 = str(wd / "fused_alleles.tsv") if has_alleles else None
        _astats, s1 = run_chain(layout, rm, a1, c1, read1=r1, read2=r2,
                                batch_size=16, alleles_path=t1,
                                device="cpu")
        runs[name] = dict(gd=gd, two=(a2, c2, t2, s2), fused=(a1, c1, t1, s1))
    return mg, runs


@pytest.mark.parametrize("name", list(GOLDEN))
def test_collapsed_bam_payload_pinned(golden_chains, name):
    _mg, runs = golden_chains
    run = runs[name]
    assert _inflate_bgzf(run["two"][1]) == _inflate_bgzf(
        os.path.join(run["gd"], "collapsed.bam")), \
        f"{name} collapsed BAM drifted"


@pytest.mark.parametrize("name", list(GOLDEN))
def test_collapsed_tag_dump_pinned(golden_chains, name, tmp_path):
    mg, runs = golden_chains
    run = runs[name]
    dump = tmp_path / "collapsed.bam.tags.tsv"
    mg.dump_tags(run["two"][1], str(dump))
    with open(os.path.join(run["gd"], "collapsed.bam.tags.tsv")) as fh:
        assert dump.read_text() == fh.read()


@pytest.mark.parametrize("name", ["golden", "golden_pe"])
def test_alleles_pinned(golden_chains, name):
    _mg, runs = golden_chains
    run = runs[name]
    with open(os.path.join(run["gd"], "alleles.tsv")) as fh:
        want = fh.read()
    for tsv in (run["two"][2], run["fused"][2]):
        with open(tsv) as fh:
            assert fh.read() == want


@pytest.mark.parametrize("name", list(GOLDEN))
def test_fused_run_equals_two_stage(golden_chains, name):
    _mg, runs = golden_chains
    a2, c2, _t2, s2 = runs[name]["two"]
    a1, c1, _t1, s1 = runs[name]["fused"]
    assert _inflate_bgzf(a1) == _inflate_bgzf(a2)
    assert _inflate_bgzf(c1) == _inflate_bgzf(c2)
    assert _stats(s1) == _stats(s2)


@pytest.mark.parametrize("name", list(GOLDEN))
def test_collapse_metrics_name_the_device(golden_chains, name):
    import json

    _mg, runs = golden_chains
    for c in (runs[name]["two"][1], runs[name]["fused"][1]):
        with open(c + ".collapse_metrics.json") as fh:
            m = json.load(fh)
        assert m["device"] == "cpu"
        assert m["kernel_launches"] == {"match_hits": 0,
                                        "edit_distance": 0,
                                        "edit_hits": 0}
        assert m["read_stats"]["passing"] > 0


@pytest.mark.parametrize("name", list(GOLDEN))
def test_out_of_core_matches_jax_out_of_core(name, tmp_path):
    """Out-of-core output follows the shards, not a global sort: hold it
    against the JAX package's out-of-core output on the pinned aligned
    BAM."""
    mg = _load_make_golden()
    gd, layout, _rm, _r1, _r2 = _golden_inputs(mg, name, tmp_path)
    aligned = os.path.join(gd, "aligned.bam")
    out_t, out_j = str(tmp_path / "t.bam"), str(tmp_path / "j.bam")
    s_t = collapse(out_t, layout, aligned, temp_dir=str(tmp_path),
                   out_of_core=True, device="cpu")
    s_j = jax_collapse(out_j, load_jax_layout(tmp_path / "layout.yaml")[0],
                       aligned, temp_dir=str(tmp_path), out_of_core=True)
    assert _inflate_bgzf(out_t) == _inflate_bgzf(out_j)
    assert _stats(s_t) == _stats(s_j)


def test_maximum_subsequences_switches_to_out_of_core(tmp_path, monkeypatch):
    """golden_ml's layout caps bins (maximum_subsequences); its pinned BAM
    has no chunk index proving the cap cannot bind, so collapse streams
    through the spill shards, as the JAX package does."""
    mg = _load_make_golden()
    gd, layout, _rm, _r1, _r2 = _golden_inputs(mg, "golden_ml", tmp_path)
    aligned = os.path.join(gd, "aligned.bam")
    calls = []
    real = tpipeline.sort_level_spill
    monkeypatch.setattr(tpipeline, "sort_level_spill",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    out_t, out_j = str(tmp_path / "t.bam"), str(tmp_path / "j.bam")
    collapse(out_t, layout, aligned, temp_dir=str(tmp_path), device="cpu")
    jax_collapse(out_j, load_jax_layout(tmp_path / "layout.yaml")[0],
                 aligned, temp_dir=str(tmp_path))
    assert len(calls) == 3
    assert _inflate_bgzf(out_t) == _inflate_bgzf(out_j)


def test_checkpoint_resume(tmp_path, monkeypatch):
    mg = _load_make_golden()
    gd, layout, _rm, _r1, _r2 = _golden_inputs(mg, "golden", tmp_path)
    aligned = os.path.join(gd, "aligned.bam")
    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    out1 = str(tmp_path / "c1.bam")
    collapse(out1, layout, aligned, temp_dir=str(ckpt), checkpoint=True,
             device="cpu")
    assert sorted(p.name for p in ckpt.glob("*.ckpt")) == [
        "collapse.amp1.level1.ckpt", "collapse.amp1.level2.ckpt"]
    assert _inflate_bgzf(out1) == _inflate_bgzf(
        os.path.join(gd, "collapsed.bam"))

    # every level checkpointed: the resumed run corrects nothing
    def no_level(*_a, **_k):
        raise AssertionError("a level ran on resume")

    monkeypatch.setattr(tpipeline, "sort_level", no_level)
    out2 = str(tmp_path / "c2.bam")
    collapse(out2, layout, aligned, temp_dir=str(ckpt), checkpoint=True,
             device="cpu")
    assert _inflate_bgzf(out2) == _inflate_bgzf(out1)
    monkeypatch.undo()

    # only level 1 on disk: the run resumes there and corrects level 2
    os.remove(ckpt / "collapse.amp1.level2.ckpt")
    out3 = str(tmp_path / "c3.bam")
    collapse(out3, layout, aligned, temp_dir=str(ckpt), checkpoint=True,
             device="cpu")
    assert _inflate_bgzf(out3) == _inflate_bgzf(out1)


def test_collapse_matches_jax_on_bench_shaped_reads(tmp_path):
    """Two references, indels and the exhaustive search (the sink's
    consume_aligned path in the fused run): collapse and the fused chain
    equal the JAX package's two-stage chain."""
    from test_torch_align_pipeline import _bench_shaped

    layout, rm, fq = _bench_shaped(tmp_path, n_reads=192)
    j_layout, j_rm = load_jax_layout(tmp_path / "layout.yaml")
    a_j, c_j = str(tmp_path / "aj.bam"), str(tmp_path / "cj.bam")
    jax_align_reads(j_layout, j_rm, a_j, read1=fq, batch_size=64)
    s_j = jax_collapse(c_j, j_layout, a_j)
    c_t = str(tmp_path / "ct.bam")
    s_t = collapse(c_t, layout, a_j, device="cpu")
    assert _inflate_bgzf(c_t) == _inflate_bgzf(c_j)
    assert _stats(s_t) == _stats(s_j)
    c_f = str(tmp_path / "cf.bam")
    _a, s_f = run_chain(layout, rm, str(tmp_path / "af.bam"), c_f,
                        read1=fq, batch_size=64, device="cpu")
    assert _inflate_bgzf(c_f) == _inflate_bgzf(c_j)
    assert (s_f.total_reads, s_f.invalid_tags, s_f.failed_filters,
            s_f.passing) == (s_j.total_reads, s_j.invalid_tags,
                             s_j.failed_filters, s_j.passing)


def test_fused_matches_two_stage_indels(tmp_path):
    """Indel-bearing reads exercise the non-gapless sink rows (the
    analogue of tests/test_chain_fused.py's indel case)."""
    rng = np.random.default_rng(44)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    a5 = "TTCAGACGTGTGCTCTTCCGATCT"
    a3 = "AGATCGGAAGAGCACACGTCTGAA"
    core = rng.choice(bases, 80).tobytes().decode()
    ref_seq = a5 + "0" * 12 + core + a3
    layout_path = tmp_path / "layout.yaml"
    layout_path.write_text(f"""known_strand: true
reads:
  - !Read1
    orientation: Forward
references:
  amp:
    sequence: "{ref_seq}"
    umi_configurations:
      umi: {{symbol: '0', sort_type: "DegenerateTag", length: 12,
            order: 0, max_distance: 2}}
""")
    layout, rm = load_layout(layout_path)
    umis = [rng.choice(bases, 12).tobytes().decode() for _ in range(4)]
    fq = tmp_path / "reads.fastq"
    with open(fq, "w") as fh:
        for i in range(24):
            arr = np.frombuffer(ref_seq.replace("0" * 12, umis[i % 4])
                                .encode(), np.uint8).copy()
            if i % 3 == 0:
                arr = np.delete(arr, [60, 61])
            elif i % 3 == 1:
                arr = np.insert(arr, 70, ord("A"))
            subs = rng.random(len(arr)) < 0.02
            arr[subs] = rng.choice(bases, int(subs.sum()))
            seq = arr.tobytes().decode()
            fh.write(f"@r{i}\n{seq}\n+\n{'I' * len(seq)}\n")
    a2, c2 = str(tmp_path / "a2.bam"), str(tmp_path / "c2.bam")
    align_reads(layout, rm, a2, read1=str(fq), batch_size=8, device="cpu")
    s2 = collapse(c2, layout, a2, device="cpu")
    a1, c1 = str(tmp_path / "a1.bam"), str(tmp_path / "c1.bam")
    _a, s1 = run_chain(layout, rm, a1, c1, read1=str(fq), batch_size=8,
                       device="cpu")
    assert _inflate_bgzf(a1) == _inflate_bgzf(a2)
    assert _inflate_bgzf(c1) == _inflate_bgzf(c2)
    assert _stats(s1) == _stats(s2)
    c_j = str(tmp_path / "cj.bam")
    jax_collapse(c_j, load_jax_layout(layout_path)[0], a2)
    assert _inflate_bgzf(c2) == _inflate_bgzf(c_j)


def test_fused_vcf_matches_bam_call(tmp_path):
    mg = _load_make_golden()
    gd, layout, rm, r1, _r2 = _golden_inputs(mg, "golden", tmp_path)
    c1 = str(tmp_path / "c1.bam")
    vcf = str(tmp_path / "fused.vcf")
    run_chain(layout, rm, str(tmp_path / "a1.bam"), c1, read1=r1,
              batch_size=16, vcf_path=vcf, device="cpu")
    want = str(tmp_path / "from_bam.vcf")
    call_events_from_bam(layout, c1, want, min_read_count=1)
    with open(vcf) as f1, open(want) as f2:
        assert f1.read() == f2.read()


def _cli_golden(tmp_path):
    mg = _load_make_golden()
    gd, _layout, _rm, r1, _r2 = _golden_inputs(mg, "golden", tmp_path)
    return gd, str(tmp_path / "layout.yaml"), r1


def test_cli_collapse_and_call_golden(tmp_path):
    gd, layout, _r1 = _cli_golden(tmp_path)
    out = str(tmp_path / "c.bam")
    assert cli.main(["collapse", "--read-structure", layout,
                     "--input-bam-file", os.path.join(gd, "aligned.bam"),
                     "--output-bam-file", out, "--device", "cpu"]) == 0
    assert _inflate_bgzf(out) == _inflate_bgzf(
        os.path.join(gd, "collapsed.bam"))
    tsv = str(tmp_path / "alleles.tsv")
    assert cli.main(["call", "--read-structure", layout, "--input-bam-file",
                     out, "--output", tsv]) == 0
    with open(tsv) as f1, open(os.path.join(gd, "alleles.tsv")) as f2:
        assert f1.read() == f2.read()


@pytest.mark.parametrize("flags", [[], ["--router", "hmm"]],
                         ids=["kmer", "router_hmm"])
def test_cli_run_golden(flags, tmp_path):
    """`run` on golden; `--router hmm` on its single reference routes
    nothing and gives the same pins."""
    gd, layout, r1 = _cli_golden(tmp_path)
    aligned, out = str(tmp_path / "a.bam"), str(tmp_path / "c.bam")
    tsv = str(tmp_path / "alleles.tsv")
    assert cli.main(["run", "--read-structure", layout, "--read1", r1,
                     "--aligned-bam-file", aligned, "--output-bam-file", out,
                     "--alleles", tsv, "--batch-size", "16",
                     "--device", "cpu", *flags]) == 0
    for got, pin in ((aligned, "aligned.bam"), (out, "collapsed.bam")):
        assert _inflate_bgzf(got) == _inflate_bgzf(os.path.join(gd, pin))
    with open(tsv) as f1, open(os.path.join(gd, "alleles.tsv")) as f2:
        assert f1.read() == f2.read()


@pytest.mark.parametrize("verb,flags,item", [
    ("collapse", ["--distributed-world", "2"], "item 11"),
], ids=["collapse_distributed"])
def test_cli_unported_flags_exit(verb, flags, item, tmp_path):
    """`collapse --distributed-world 2`, which the port refused before it
    ran ROADMAP.md's item 11 (parallel/), now runs: two ranks through
    cli.main on gloo with --device cpu each exit 0, and the merged BAM's
    records equal the JAX package's single-process collapse of the golden
    aligned BAM."""
    from clique_tpu.config.layout import SequenceLayout as JaxLayout

    from test_torch_align_pipeline import record_multiset, run_cli_ranks

    gd, layout, _r1 = _cli_golden(tmp_path)
    aligned = os.path.join(gd, "aligned.bam")
    out = str(tmp_path / "c.bam")
    logs = run_cli_ranks([verb, "--read-structure", layout,
                          "--input-bam-file", aligned, "--output-bam-file",
                          out], int(flags[1]), tmp_path)
    assert logs.count("torch.distributed gloo backend") == 2
    out_j = str(tmp_path / "j.bam")
    jax_collapse(out_j, JaxLayout.from_yaml(layout), aligned)
    assert record_multiset(out) == record_multiset(out_j)
    assert record_multiset(out) == record_multiset(
        os.path.join(gd, "collapsed.bam"))


def test_cli_run_wfa_over_budget_matches_jax_cli(tmp_path, monkeypatch):
    """`run --engine wfa` under a 64 KiB op-store budget, where every read
    goes to the bialign engine: the aligned BAM, collapsed BAM and allele
    table equal the JAX CLI's under the same budget, byte for byte."""
    import json

    from clique_tpu import cli as jax_cli

    monkeypatch.setenv("CLIQUE_WFA_MEM_BUDGET", str(1 << 16))
    _gd, layout, r1 = _cli_golden(tmp_path)
    argv = ["run", "--read-structure", layout, "--read1", r1,
            "--batch-size", "16", "--engine", "wfa"]
    out = {}
    for side, main, extra in (
            ("t", cli.main, ["--device", "cpu", "--metrics",
                             str(tmp_path / "m.json")]),
            ("j", jax_cli.main, [])):
        paths = [str(tmp_path / f"{side}{n}") for n in
                 ("a.bam", "c.bam", ".tsv")]
        assert main(argv + ["--aligned-bam-file", paths[0],
                            "--output-bam-file", paths[1], "--alleles",
                            paths[2], *extra]) == 0
        with open(paths[2]) as fh:
            out[side] = (_inflate_bgzf(paths[0]), _inflate_bgzf(paths[1]),
                         fh.read())
    assert out["t"] == out["j"]
    m = json.loads((tmp_path / "m.json").read_text())
    assert m["wfa_bialign_pairs"] == m["aligned"] > 0
    assert m["kernel_launches"]["wfa_align"] == 0


def test_collapse_worker_pool_gives_the_pin(tmp_path):
    """n_workers = 2 on golden: the worker pool's output is the pinned
    collapsed BAM, byte for byte (groups in the in-RAM path's order)."""
    mg = _load_make_golden()
    gd, layout, _rm, _r1, _r2 = _golden_inputs(mg, "golden", tmp_path)
    out = str(tmp_path / "c.bam")
    collapse(out, layout, os.path.join(gd, "aligned.bam"),
             temp_dir=str(tmp_path), n_workers=2, device="cpu")
    assert _inflate_bgzf(out) == _inflate_bgzf(
        os.path.join(gd, "collapsed.bam"))


def test_cli_collapse_threads_golden(tmp_path):
    """`collapse --threads 2` on golden: exit 0 and the pin."""
    gd, layout, _r1 = _cli_golden(tmp_path)
    out = str(tmp_path / "c.bam")
    assert cli.main(["collapse", "--read-structure", layout,
                     "--input-bam-file", os.path.join(gd, "aligned.bam"),
                     "--output-bam-file", out, "--threads", "2",
                     "--temp-dir", str(tmp_path), "--device", "cpu"]) == 0
    assert _inflate_bgzf(out) == _inflate_bgzf(
        os.path.join(gd, "collapsed.bam"))


def test_cli_run_router_hmm_two_references(tmp_path):
    """`run --router hmm` over two references: exit 0, its aligned BAM the
    HMM-routed align's and its collapsed BAM the two-stage chain's."""
    layout, rm, fq = _bench_shaped(tmp_path, n_reads=24)
    lpath = str(tmp_path / "layout.yaml")
    a, c = str(tmp_path / "a.bam"), str(tmp_path / "c.bam")
    assert cli.main(["run", "--read-structure", lpath, "--read1", fq,
                     "--aligned-bam-file", a, "--output-bam-file", c,
                     "--batch-size", "8", "--router", "hmm",
                     "--device", "cpu"]) == 0
    a2, c2 = str(tmp_path / "a2.bam"), str(tmp_path / "c2.bam")
    align_reads(layout, rm, a2, read1=fq, batch_size=8, router="hmm",
                device="cpu")
    collapse(c2, layout, a2, device="cpu")
    assert _inflate_bgzf(a) == _inflate_bgzf(a2)
    assert _inflate_bgzf(c) == _inflate_bgzf(c2)


def test_collapse_on_cuda_without_a_gpu_raises(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    mg = _load_make_golden()
    gd, layout, rm, r1, _r2 = _golden_inputs(mg, "golden", tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        collapse(str(tmp_path / "c.bam"), layout,
                 os.path.join(gd, "aligned.bam"), device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_chain(layout, rm, str(tmp_path / "a.bam"),
                  str(tmp_path / "c2.bam"), read1=r1, device="cuda")
