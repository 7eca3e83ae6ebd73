"""The port runs with jax unavailable: a fresh interpreter with `jax` and
`jaxlib` blocked imports clique_tpu_torch, aligns the golden reads on the
CPU (full band, a partial band, every read on the anchored path, and the
fused align + collapse + call), reproduces the pinned outputs or the JAX
package's, and never loads a jax module."""

import os
import subprocess
import sys
import textwrap

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "data", "golden")

SCRIPT = textwrap.dedent("""
    import gzip, os, sys
    sys.modules["jax"] = None        # any `import jax` now raises
    sys.modules["jaxlib"] = None
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
    verb = sys.argv[3]
    if verb == "align":
        argv = ["align", "--output-bam-file", out]
    else:
        from clique_tpu_torch import chain
        from clique_tpu_torch.collapse import correct, distance
        from clique_tpu_torch.collapse import pipeline as cpipeline

        argv = ["run", "--aligned-bam-file", out, "--output-bam-file",
                os.path.join(workdir, "collapsed.bam"), "--alleles",
                os.path.join(workdir, "alleles.tsv")]
    rc = cli.main(argv + ["--read-structure", layout, "--read1",
                          os.path.join(gd, "reads.fastq.gz"),
                          "--batch-size", "16", "--device", "cpu"]
                  + sys.argv[4:])
    assert rc == 0
    loaded = sorted(m for m, mod in sys.modules.items()
                    if mod is not None and m.split(".")[0] in
                    ("jax", "jaxlib"))
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
                                           _load_make_golden)

    from clique_tpu.align.pipeline import align_reads as jax_align_reads

    wd = tmp_path / "jax"
    wd.mkdir()
    _gd, layout, rm, r1, _r2 = _golden_inputs(_load_make_golden(), "golden",
                                              wd)
    out_j = str(wd / "aligned.bam")
    key = {"--bandwidth": "bandwidth",
           "--anchored-min-length": "anchored_min_length"}[flags[0]]
    jax_align_reads(layout, rm, out_j, read1=r1, batch_size=16,
                    **{key: int(flags[1])})
    assert _inflate_bgzf(str(tmp_path / "aligned.bam")) == _inflate_bgzf(
        out_j)
