"""The port's host worker pool (clique_tpu_torch.collapse.workers, collapse
--threads N) on the CPU: the cases of tests/test_collapse_pipeline.py's
worker tests on the port, the port's pool against the JAX package's pool,
and what a worker process loads.

Every correction is exact and the BAM bytes deterministic, so records must
be identical: as a multiset against the in-RAM path (the spill path orders
groups by shard), and as inflated bytes against the JAX package's pool
with the same worker count (both put ingest results back in input order
and write outputs in task order).
"""

import gzip
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from clique_tpu.collapse.pipeline import collapse as jax_collapse
from clique_tpu_torch.align.pipeline import align_reads
from clique_tpu_torch.collapse.pipeline import collapse
from clique_tpu_torch.io.sam import BamReader, read_cqi

from test_torch_align_pipeline import (_golden_inputs, _inflate_bgzf,
                                       _load_make_golden, load_jax_layout,
                                       load_layout)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
A5 = "TTCAGACGTGTGCTCTTCCGATCT"
A3 = "AGATCGGAAGAGCACACGTCTGAA"
TARGET = "GGCACTGCGGCTGGAGGTGG"


def _layout_text(cap=None):
    cap_line = f"\n        maximum_subsequences: {cap}" if cap else ""
    return f"""
known_strand: true
reads:
  - !Read1
    orientation: Forward
references:
  amp1:
    sequence: "{A5}{'0' * 16}{'1' * 12}{TARGET}{A3}"
    targets: ["{TARGET}"]
    target_types: ["Cas9WT"]
    umi_configurations:
      cell_id:
        symbol: '0'
        sort_type: "DegenerateTag"
        length: 16
        order: 0
        max_distance: 2{cap_line}
      cell_umi:
        symbol: '1'
        sort_type: "DegenerateTag"
        length: 12
        order: 1
        max_distance: 2{cap_line}
"""


def _umi_dataset(tmp_path, n_cells=3, n_umis=3, reads_per=5, seed=77):
    """tests/test_collapse_pipeline.py's UMI dataset: cells x UMIs, each
    group's last read with a one-base UMI error; aligned by the port."""
    rng = np.random.default_rng(seed)
    cells = [rng.choice(BASES, 16).tobytes().decode() for _ in range(n_cells)]
    umis = [rng.choice(BASES, 12).tobytes().decode() for _ in range(n_umis)]
    (tmp_path / "layout.yaml").write_text(_layout_text())
    fq = tmp_path / "reads.fastq.gz"
    idx = 0
    with gzip.open(fq, "wt") as fh:
        for cell in cells:
            for umi in umis:
                for k in range(reads_per):
                    u = umi
                    if k == reads_per - 1:
                        u = ("A" if umi[0] != "A" else "C") + umi[1:]
                    read = A5 + cell + u + TARGET + A3
                    fh.write(f"@r{idx}\n{read}\n+\n{'I' * len(read)}\n")
                    idx += 1
    layout, rm = load_layout(tmp_path / "layout.yaml")
    aligned = str(tmp_path / "aligned.bam")
    align_reads(layout, rm, aligned, read1=str(fq), batch_size=8,
                device="cpu")
    return layout, aligned


def _snapshot(path):
    with BamReader(str(path)) as reader:
        return sorted(
            (r.name, r.seq, r.qual, r.cigar_string,
             tuple(sorted(r.tags.items())))
            for r in reader)


def _metrics(path):
    with open(str(path) + ".collapse_metrics.json") as fh:
        return json.load(fh)


def _check_workers(m, n=2):
    """Each reporting worker made no CUDA context and loaded neither
    torch nor jax nor the JAX package."""
    assert m["n_workers"] == n
    assert m["workers"], "no worker reported"
    for w in m["workers"]:
        assert w["cuda_initialized"] is False
        assert w["torch"] is False
        assert w["forbidden"] == []


def test_collapse_parallel_equivalent(tmp_path):
    """collapse_parallel: the same record multiset and stats as the
    single-process in-RAM path."""
    layout, aligned = _umi_dataset(tmp_path)
    ram, par = tmp_path / "ram.bam", tmp_path / "par.bam"
    s1 = collapse(str(ram), layout, aligned, device="cpu")
    s2 = collapse(str(par), layout, aligned, temp_dir=str(tmp_path),
                  n_workers=2, device="cpu")
    assert s1 == s2 and s1.passing > 0
    assert _snapshot(ram) == _snapshot(par)
    m = _metrics(par)
    assert m["read_stats"]["passing"] == s1.passing
    assert m["device"] == "cpu"
    assert m["kernel_launches"] == {"match_hits": 0, "edit_distance": 0,
                                    "edit_hits": 0}
    _check_workers(m)


def test_collapse_parallel_spill_equivalent(tmp_path):
    """out_of_core with workers: collapse_parallel_spill, records equal to
    the in-RAM path's."""
    layout, aligned = _umi_dataset(tmp_path)
    ram, par = tmp_path / "ram.bam", tmp_path / "par_spill.bam"
    s1 = collapse(str(ram), layout, aligned, device="cpu")
    s2 = collapse(str(par), layout, aligned, temp_dir=str(tmp_path),
                  n_workers=2, out_of_core=True, device="cpu")
    assert s1.passing == s2.passing
    assert _snapshot(ram) == _snapshot(par)
    m = _metrics(par)
    assert m["out_of_core"] is True
    _check_workers(m)


def test_collapse_parallel_fanout_range_ingest(tmp_path, monkeypatch):
    """CLIQUE_PAR_INGEST_MIN=0 (the JAX package's switch) forces the worker
    ingest on a small BAM: with the .cqi index the workers inflate their
    own byte ranges; records equal the single-process path's."""
    layout, aligned = _umi_dataset(tmp_path)
    assert read_cqi(aligned)
    monkeypatch.setenv("CLIQUE_PAR_INGEST_MIN", "0")
    ram, par = tmp_path / "ram.bam", tmp_path / "par_range.bam"
    s1 = collapse(str(ram), layout, aligned, device="cpu")
    s2 = collapse(str(par), layout, aligned, temp_dir=str(tmp_path),
                  n_workers=2, device="cpu")
    assert s1.passing == s2.passing
    assert _snapshot(ram) == _snapshot(par)


def test_collapse_parallel_chunk_ingest_without_index(tmp_path,
                                                      monkeypatch):
    """Without the .cqi index the main process cuts the record stream into
    chunks (iter_record_chunks) for the workers; same records."""
    layout, aligned = _umi_dataset(tmp_path)
    os.remove(aligned + ".cqi")
    monkeypatch.setenv("CLIQUE_PAR_INGEST_MIN", "0")
    ram, par = tmp_path / "ram.bam", tmp_path / "par_chunks.bam"
    s1 = collapse(str(ram), layout, aligned, device="cpu")
    s2 = collapse(str(par), layout, aligned, temp_dir=str(tmp_path),
                  n_workers=2, device="cpu")
    assert s1.passing == s2.passing
    assert _snapshot(ram) == _snapshot(par)


def test_collapse_caps_keep_workers(tmp_path):
    """maximum_subsequences with workers goes to collapse_parallel_spill,
    honors the cap (nothing dropped) and matches the in-RAM run."""
    layout, aligned = _umi_dataset(tmp_path, n_cells=2, n_umis=2,
                                   reads_per=7)
    capped = tmp_path / "capped.yaml"
    capped.write_text(_layout_text(cap=2))
    capped_layout, _rm = load_layout(capped)
    ram, cap = tmp_path / "ram.bam", tmp_path / "cap_workers.bam"
    s1 = collapse(str(ram), layout, aligned, device="cpu")
    s2 = collapse(str(cap), capped_layout, aligned, temp_dir=str(tmp_path),
                  n_workers=2, device="cpu")
    assert s1.passing == s2.passing
    assert _snapshot(ram) == _snapshot(cap)
    m = _metrics(cap)
    assert m["n_workers"] == 2 and m["out_of_core"] is True
    with BamReader(str(cap)) as reader:
        assert all(r.tags["rc"] == "7" for r in reader)


@pytest.mark.parametrize("out_of_core", [False, True],
                         ids=["in_ram", "spill"])
def test_workers_match_jax_workers(out_of_core, tmp_path, monkeypatch):
    """The port's pool against the JAX package's pool, n_workers = 2 on
    the same aligned BAM, the worker ingest forced: the same bytes."""
    monkeypatch.setenv("CLIQUE_PAR_INGEST_MIN", "0")
    layout, aligned = _umi_dataset(tmp_path, n_cells=4, n_umis=3)
    jlayout, _jrm = load_jax_layout(tmp_path / "layout.yaml")
    out_t, out_j = tmp_path / "t.bam", tmp_path / "j.bam"
    st = collapse(str(out_t), layout, aligned, temp_dir=str(tmp_path),
                  n_workers=2, out_of_core=out_of_core, device="cpu")
    sj = jax_collapse(str(out_j), jlayout, aligned, temp_dir=str(tmp_path),
                      n_workers=2, out_of_core=out_of_core)
    assert st.passing == sj.passing > 0
    assert _inflate_bgzf(out_t) == _inflate_bgzf(out_j)


@pytest.mark.parametrize("name", ["golden", "golden_ml"])
def test_golden_with_workers_matches_its_pin(name, tmp_path):
    """The golden collapse with two workers (golden_ml's
    maximum_subsequences takes the spill path) gives the pinned
    collapsed.bam's records."""
    mg = _load_make_golden()
    gd, layout, _rm, _r1, _r2 = _golden_inputs(mg, name, tmp_path)
    out = tmp_path / "c.bam"
    collapse(str(out), layout, os.path.join(gd, "aligned.bam"),
             temp_dir=str(tmp_path), n_workers=2, device="cpu")
    assert _snapshot(out) == _snapshot(os.path.join(gd, "collapsed.bam"))
    _check_workers(_metrics(out))


def test_workers_run_from_a_checkout_without_jax(tmp_path):
    """A process that imports the port from this checkout (not installed),
    with jax, jaxlib and the JAX package blocked, runs the pool: its
    spawned workers import the port from the same checkout and report no
    CUDA context, no torch and no JAX."""
    layout, aligned = _umi_dataset(tmp_path)
    script = tmp_path / "run.py"
    script.write_text(f"""
import sys
for name in ("jax", "jaxlib", "clique_tpu"):
    sys.modules[name] = None
sys.path.insert(0, {ROOT!r})
from clique_tpu_torch.collapse.pipeline import collapse
from clique_tpu_torch.config.layout import SequenceLayout

if __name__ == "__main__":
    collapse({str(tmp_path / 'w.bam')!r},
             SequenceLayout.from_yaml({str(tmp_path / 'layout.yaml')!r}),
             {aligned!r}, n_workers=2, device="cpu")
""")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, str(script)], cwd=str(tmp_path),
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    m = _metrics(tmp_path / "w.bam")
    _check_workers(m)
    assert m["read_stats"]["passing"] > 0
