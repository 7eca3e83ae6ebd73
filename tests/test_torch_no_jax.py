"""The port runs without jax and without the JAX package: a fresh
interpreter with `jax`, `jaxlib` and `clique_tpu` blocked imports
clique_tpu_torch, aligns the golden reads on the CPU (full band, a partial
band, every read on the anchored path, the wavefront engines `--engine wfa`
and `--engine convex`, and the fused align + collapse + call), routes a two-amplicon panel with `--router hmm`, collapses golden
with `--threads 2` (the worker pool), reproduces the pinned outputs or the
JAX package's, and loads neither a jax module nor one of the JAX package.
The multi-process modules (parallel/) and the host modules no verb
reaches (collapse/graph.py, caller/views.py, cells.py, tenx.py,
utils/read_sim.py) import with the same blocks. An AST scan holds every
source of the port, chip_smoke.py and the profile scripts to importing
nothing of the JAX package, and the port's copy of the host
inversion_alignment is held equal to the JAX package's."""

import ast
import dataclasses
import glob
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "data", "golden")

SCRIPT = textwrap.dedent("""
    import gzip, os, sys
    sys.modules["jax"] = None        # any `import jax` now raises
    sys.modules["jaxlib"] = None
    sys.modules["clique_tpu"] = None     # and any import of the JAX package
    root, workdir = sys.argv[1], sys.argv[2]
    sys.path.insert(0, root)
    import clique_tpu_torch
    from clique_tpu_torch import cli
    from clique_tpu_torch.align import batch, dp_kernels, pipeline

    gd = os.path.join(root, "tests", "data", "golden")
    with open(os.path.join(gd, "layout.yaml.in")) as fh:
        text = fh.read().replace("@ALLOWLIST@",
                                 os.path.join(gd, "allowlist.txt"))
    layout = os.path.join(workdir, "layout.yaml")
    with open(layout, "w") as fh:
        fh.write(text)
    out = os.path.join(workdir, "aligned.bam")
    reads = ["--read1", os.path.join(gd, "reads.fastq.gz"),
             "--batch-size", "16"]
    verb = sys.argv[3]
    if verb == "align":
        argv = ["align", "--output-bam-file", out]
    elif verb == "align_panel":
        # a multi-reference layout and its reads, written by the test
        layout = os.path.join(workdir, "panel", "layout.yaml")
        reads = ["--read1", os.path.join(workdir, "panel", "reads.fastq"),
                 "--batch-size", "8"]
        argv = ["align", "--output-bam-file", out]
    elif verb == "collapse":
        reads = []
        argv = ["collapse", "--input-bam-file",
                os.path.join(gd, "aligned.bam"), "--output-bam-file",
                os.path.join(workdir, "collapsed.bam"), "--temp-dir",
                workdir]
    else:
        from clique_tpu_torch import chain
        from clique_tpu_torch.collapse import correct, distance
        from clique_tpu_torch.collapse import pipeline as cpipeline

        argv = ["run", "--aligned-bam-file", out, "--output-bam-file",
                os.path.join(workdir, "collapsed.bam"), "--alleles",
                os.path.join(workdir, "alleles.tsv")]
    rc = cli.main(argv + ["--read-structure", layout, *reads,
                          "--device", "cpu"] + sys.argv[4:])
    assert rc == 0
    loaded = sorted(m for m, mod in sys.modules.items()
                    if mod is not None and m.split(".")[0] in
                    ("jax", "jaxlib", "clique_tpu"))
    print("JAX_MODULES", loaded)
    print("PORT_MODULES", sorted(m for m in sys.modules
                                 if m.startswith("clique_tpu_torch")))
""")


def _run_without_jax(verb, tmp_path, *flags):
    res = subprocess.run(
        [sys.executable, "-c", SCRIPT, ROOT, str(tmp_path), verb, *flags],
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": ""})
    assert res.returncode == 0, res.stderr[-3000:]
    assert "JAX_MODULES []" in res.stdout, res.stdout
    return res.stdout


def test_align_golden_without_jax(tmp_path):
    out = _run_without_jax("align", tmp_path)
    assert "clique_tpu_torch.align.pipeline" in out
    from test_torch_align_pipeline import _inflate_bgzf

    assert _inflate_bgzf(str(tmp_path / "aligned.bam")) == _inflate_bgzf(
        os.path.join(GOLDEN, "aligned.bam"))


def test_run_golden_without_jax(tmp_path):
    """align + collapse + call, fused, with jax blocked: the collapsed BAM
    and the allele table equal the golden pins."""
    out = _run_without_jax("run", tmp_path)
    assert "clique_tpu_torch.collapse.distance" in out
    from test_torch_align_pipeline import _inflate_bgzf

    for name in ("aligned.bam", "collapsed.bam"):
        assert _inflate_bgzf(str(tmp_path / name)) == _inflate_bgzf(
            os.path.join(GOLDEN, name))
    with open(tmp_path / "alleles.tsv") as f1, \
            open(os.path.join(GOLDEN, "alleles.tsv")) as f2:
        assert f1.read() == f2.read()


@pytest.mark.parametrize("flags", [
    ("--bandwidth", "10"), ("--anchored-min-length", "100"),
], ids=["banded", "anchored"])
def test_align_modes_without_jax(flags, tmp_path):
    """The banded and the anchored `align` paths with jax blocked: the BAM
    equals the JAX package's align_reads with the same option, run here."""
    out = _run_without_jax("align", tmp_path, *flags)
    assert "clique_tpu_torch.align.pipeline" in out
    from test_torch_align_pipeline import (_golden_inputs, _inflate_bgzf,
                                           _load_make_golden,
                                           load_jax_layout)

    from clique_tpu.align.pipeline import align_reads as jax_align_reads

    wd = tmp_path / "jax"
    wd.mkdir()
    _gd, _layout, _rm, r1, _r2 = _golden_inputs(_load_make_golden(),
                                                "golden", wd)
    layout, rm = load_jax_layout(wd / "layout.yaml")
    out_j = str(wd / "aligned.bam")
    key = {"--bandwidth": "bandwidth",
           "--anchored-min-length": "anchored_min_length"}[flags[0]]
    jax_align_reads(layout, rm, out_j, read1=r1, batch_size=16,
                    **{key: int(flags[1])})
    assert _inflate_bgzf(str(tmp_path / "aligned.bam")) == _inflate_bgzf(
        out_j)


@pytest.mark.parametrize("engine", ["wfa", "convex"])
def test_align_engines_without_jax(engine, tmp_path):
    """`align --engine wfa|convex` with jax blocked: the wavefront modules
    run and the BAM equals tests/data/golden/aligned_<engine>.bam."""
    out = _run_without_jax("align", tmp_path, "--engine", engine)
    assert "clique_tpu_torch.align.wavefront" in out
    assert "clique_tpu_torch.align.wfa_kernels" in out
    from test_torch_align_pipeline import _inflate_bgzf

    assert _inflate_bgzf(str(tmp_path / "aligned.bam")) == _inflate_bgzf(
        os.path.join(GOLDEN, f"aligned_{engine}.bam"))


def test_run_wfa_bialign_without_jax(tmp_path, monkeypatch):
    """`run --engine wfa` under a 64 KiB op-store budget with jax blocked:
    every read goes to the bialign engine, and the aligned BAM equals
    tests/data/golden/aligned_wfa.bam."""
    import json

    from test_torch_align_pipeline import _inflate_bgzf

    monkeypatch.setenv("CLIQUE_WFA_MEM_BUDGET", str(1 << 16))
    metrics = tmp_path / "m.json"
    out = _run_without_jax("run", tmp_path, "--engine", "wfa", "--metrics",
                           str(metrics))
    assert "clique_tpu_torch.align.wfa_kernels" in out
    m = json.loads(metrics.read_text())
    assert m["wfa_bialign_pairs"] == m["aligned"] > 0
    assert _inflate_bgzf(str(tmp_path / "aligned.bam")) == _inflate_bgzf(
        os.path.join(GOLDEN, "aligned_wfa.bam"))


@pytest.mark.parametrize("verb", ["align", "run"])
def test_router_hmm_golden_without_jax(verb, tmp_path):
    """`--router hmm` on golden's single reference, with jax blocked: no
    routing happens and the outputs equal the pins."""
    _run_without_jax(verb, tmp_path, "--router", "hmm")
    from test_torch_align_pipeline import _inflate_bgzf

    names = ("aligned.bam",) if verb == "align" else ("aligned.bam",
                                                      "collapsed.bam")
    for name in names:
        assert _inflate_bgzf(str(tmp_path / name)) == _inflate_bgzf(
            os.path.join(GOLDEN, name))


def test_router_hmm_panel_without_jax(tmp_path):
    """`align --router hmm` over the two bench-shaped amplicons with jax
    blocked: the HMM router runs and the BAM equals the JAX package's."""
    from test_torch_align_pipeline import (_bench_shaped, _inflate_bgzf,
                                           load_jax_layout)

    from clique_tpu.align.pipeline import align_reads as jax_align_reads

    panel = tmp_path / "panel"
    panel.mkdir()
    _layout, _rm, fq = _bench_shaped(panel, n_reads=24)
    out = _run_without_jax("align_panel", tmp_path, "--router", "hmm")
    assert "clique_tpu_torch.align.hmm" in out
    out_j = str(tmp_path / "jax.bam")
    jax_align_reads(*load_jax_layout(panel / "layout.yaml"), out_j,
                    read1=fq, batch_size=8, router="hmm")
    assert _inflate_bgzf(str(tmp_path / "aligned.bam")) == _inflate_bgzf(
        out_j)


def test_collapse_threads_without_jax(tmp_path):
    """`collapse --threads 2` on golden with jax blocked: the worker pool
    runs and the collapsed BAM equals the pin."""
    import json

    out = _run_without_jax("collapse", tmp_path, "--threads", "2")
    assert "clique_tpu_torch.collapse.workers" in out
    from test_torch_align_pipeline import _inflate_bgzf

    collapsed = str(tmp_path / "collapsed.bam")
    assert _inflate_bgzf(collapsed) == _inflate_bgzf(
        os.path.join(GOLDEN, "collapsed.bam"))
    with open(collapsed + ".collapse_metrics.json") as fh:
        workers = json.load(fh)["workers"]
    assert workers and all(not w["cuda_initialized"] and not w["forbidden"]
                           for w in workers)


NEW_MODULES = ["clique_tpu_torch.parallel", "clique_tpu_torch.parallel.groupby",
               "clique_tpu_torch.parallel.mesh",
               "clique_tpu_torch.parallel.distributed",
               "clique_tpu_torch.collapse.graph",
               "clique_tpu_torch.caller.views",
               "clique_tpu_torch.caller.cells",
               "clique_tpu_torch.caller.tenx",
               "clique_tpu_torch.utils.read_sim"]


@pytest.mark.parametrize("module", NEW_MODULES)
def test_module_imports_without_jax(module):
    """The multi-process modules and the host modules no verb reaches
    import with jax, jaxlib and the JAX package blocked, and load none of
    them."""
    code = textwrap.dedent(f"""
        import sys
        sys.modules["jax"] = None
        sys.modules["jaxlib"] = None
        sys.modules["clique_tpu"] = None
        sys.path.insert(0, {ROOT!r})
        import importlib
        importlib.import_module({module!r})
        loaded = sorted(m for m, mod in sys.modules.items()
                        if mod is not None and m.split(".")[0] in
                        ("jax", "jaxlib", "clique_tpu"))
        print("JAX_MODULES", loaded)
    """)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": ""})
    assert res.returncode == 0, res.stderr[-3000:]
    assert "JAX_MODULES []" in res.stdout, res.stdout


SCANNED = sorted(
    os.path.relpath(p, ROOT) for p in
    glob.glob(os.path.join(ROOT, "clique_tpu_torch", "**", "*.py"),
              recursive=True)
    + [os.path.join(ROOT, "chip_smoke.py"),
       os.path.join(ROOT, "profile_port.py"),
       os.path.join(ROOT, "profile_wfa.py")])


def _imported_modules(tree):
    """Every module an `import` or `from ... import` names, at any depth
    (lazy imports inside functions included)."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", SCANNED)
def test_source_imports_nothing_of_the_jax_package(path):
    with open(os.path.join(ROOT, path)) as fh:
        tree = ast.parse(fh.read(), filename=path)
    bad = sorted(m for m in _imported_modules(tree)
                 if m.split(".")[0] in ("clique_tpu", "jax", "jaxlib"))
    assert not bad, f"{path} imports {bad}"


def test_scan_sees_the_port():
    assert "chip_smoke.py" in SCANNED and "profile_port.py" in SCANNED
    assert "profile_wfa.py" in SCANNED
    assert os.path.join("clique_tpu_torch", "align", "pipeline.py") in SCANNED
    assert os.path.join("clique_tpu_torch", "align", "hmm.py") in SCANNED
    assert os.path.join("clique_tpu_torch", "collapse",
                        "workers.py") in SCANNED
    for mod in NEW_MODULES:
        path = os.path.join(*mod.split("."))
        assert path + ".py" in SCANNED or \
            os.path.join(path, "__init__.py") in SCANNED, mod
    assert len(SCANNED) > 30


def _inversion_reads(seed, n):
    """Seeded reads of a 70 bp reference with a few substitutions, some
    with an inverted block (the reverse complement of a middle slice)."""
    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    ref = rng.choice(bases, 70).tobytes()
    comp = bytes.maketrans(b"ACGT", b"TGCA")
    reads = []
    for i in range(n):
        r = bytearray(ref)
        for _k in range(2):
            r[int(rng.integers(0, len(r)))] = int(rng.choice(bases))
        if i % 2 == 1:
            a = int(rng.integers(10, 30))
            b = a + int(rng.integers(14, 24))
            r[a:b] = bytes(r[a:b]).translate(comp)[::-1]
        reads.append(bytes(r))
    return ref, reads


@pytest.mark.parametrize("seed", [11, 12, 13])
def test_port_inversion_alignment_equals_jax(seed):
    """The port's copy of the host inversion_alignment (path zeroing,
    secondary extraction, the inversion-aware fill) gives the JAX
    package's result field for field; odd reads carry an inverted block."""
    from clique_tpu.align.inversion import \
        inversion_alignment as jax_inversion_alignment
    from clique_tpu.align.scoring import AffineScoring as JaxAffine
    from clique_tpu.align.scoring import InversionScoring as JaxInversion
    from clique_tpu_torch.align.inversion import inversion_alignment
    from clique_tpu_torch.align.scoring import (AffineScoring,
                                                InversionScoring)

    values = ((10.0, -11.0, 8.0, -15.0, -5.0, 1.0),
              (10.0, -11.0, -15.0, -5.0, -2.0, 8))
    ref, reads = _inversion_reads(seed, 4)
    blocks = 0
    for i, read in enumerate(reads):
        want = jax_inversion_alignment(ref, read, "ref", f"r{i}",
                                       JaxInversion(*values[1]),
                                       JaxAffine(*values[0]), False)
        got = inversion_alignment(ref, read, "ref", f"r{i}",
                                  InversionScoring(*values[1]),
                                  AffineScoring(*values[0]), False)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), i
        blocks += "<" in [op for _c, op in got.cigar]
    assert blocks >= 1
