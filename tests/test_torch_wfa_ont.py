"""Raw ONT reads of one amplicon through `align_reads(engine="wfa")` on the
CPU, held against the benchmark's plain gap-affine optimum
(benchmark/reference/gap_affine.py, loaded by path), and that optimum
against a brute-force DP.

The reads follow the benchmark's ONT read model (the `error_model` of
benchmark/configs/ont_raw_4kb.json, drawn by
benchmark/generators/ont_amplicon.py) on a 1,000 bp amplicon. The
op-store budget is lowered, as CLIQUE_WFA_MEM_BUDGET lets a deployment
do, so that each read is censored at two rungs of the ladder and then
finished on the bialign engine: the route the configuration's reads take
at the default budget.
"""

import importlib.util
import json
import os

import numpy as np
import pytest

from clique_tpu_torch.align.pipeline import align_reads
from clique_tpu_torch.config.layout import SequenceLayout
from clique_tpu_torch.io.sam import BamReader
from clique_tpu_torch.reference.manager import ReferenceManager

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
X, O, E = 4, 6, 2
# rows of 1,024 bytes: the 256 and 512 rungs' 32-lane op stores fit
# 32 MiB, the 1,024 rung's does not. At this length the read model's
# penalties lie about 600 +- 50, past both rungs
BUDGET = 32 << 20
N_READS = 6
AMPLICON = 1000


def _load(rel):
    path = os.path.join(ROOT, rel)
    spec = importlib.util.spec_from_file_location(
        "bench_" + os.path.basename(rel)[:-3], path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


gap_affine = _load("benchmark/reference/gap_affine.py")
ont = _load("benchmark/generators/ont_amplicon.py")
with open(os.path.join(ROOT, "benchmark/configs/ont_raw_4kb.json")) as _fh:
    MODEL = ont.read_model(json.load(_fh)["error_model"])


def ont_run(workdir, seed=2 ** 31 + 23, amplicon=AMPLICON, n=N_READS,
            **kwargs):
    """align_reads(engine="wfa", mode="ont") on the CPU over n seeded ONT
    reads of a seeded amplicon: (reference, reads, BAM path, metrics)."""
    rng = np.random.default_rng(seed)
    ref = rng.choice(ont.BASES, amplicon)
    reads = [ont.ont_read(rng, ref, *MODEL).tobytes() for _ in range(n)]
    fq = os.path.join(workdir, "reads.fastq")
    with open(fq, "w") as fh:
        fh.writelines(f"@ont{i}\n{r.decode()}\n+\n{'I' * len(r)}\n"
                      for i, r in enumerate(reads))
    ypath = os.path.join(workdir, "layout.yaml")
    with open(ypath, "w") as fh:
        fh.write("known_strand: true\nreads:\n  - !Read1\n"
                 "    orientation: Forward\nreferences:\n  amp:\n"
                 f"    sequence: \"{ref.tobytes().decode()}\"\n")
    layout = SequenceLayout.from_yaml(ypath)
    out = os.path.join(workdir, "aligned.bam")
    mpath = os.path.join(workdir, "metrics.json")
    align_reads(layout, ReferenceManager.from_layout(layout), out, read1=fq,
                batch_size=1024, engine="wfa", mode="ont", device="cpu",
                metrics_path=mpath, **kwargs)
    with open(mpath) as fh:
        metrics = json.load(fh)
    return ref.tobytes(), reads, out, metrics


def test_engine_penalties_equal_the_plain_optimum(tmp_path, monkeypatch):
    monkeypatch.setenv("CLIQUE_WFA_MEM_BUDGET", str(BUDGET))
    ref, reads, out, m = ont_run(str(tmp_path))
    with BamReader(out) as reader:
        recs = {r.name: r for r in reader}
    assert len(recs) == len(reads)
    optimum = gap_affine.penalty([ref] * len(reads), reads, X, O, E, "cpu")
    assert optimum.min() > 512                 # past both rungs
    for i, (read, want) in enumerate(zip(reads, optimum.tolist())):
        rec = recs[f"ont{i}"]
        assert rec.seq == read and rec.pos == 1
        assert -float(rec.tags["as"]) == want
        assert gap_affine.cigar_penalty(rec.cigar_string, ref, read, X, O,
                                        E) == want
    # every read censored at the 256 and 512 rungs, then bialign
    assert m["wfa_bialign_pairs"] == len(reads) == m["aligned"]
    assert m["wfa_rung_lanes"] == m["wfa_rung_lanes_censored"] == \
        2 * len(reads)
    assert m["wfa_mid_levels"] >= 1 and m["wfa_leaf_pairs"] >= 2 * len(reads)
    assert m["wfa_dp_fallbacks"] == 0
    # every CIGAR a leaf's, from the plain host replay on the CPU
    assert m["wfa_cigars_replayed"] == m["wfa_leaf_pairs"]
    assert m["wfa_cigars_from_card"] == 0


def _brute(a: bytes, b: bytes, x, o, e):
    """Gotoh's three planes, cell by cell in Python."""
    inf = float("inf")
    n, m = len(a), len(b)
    H = [[inf] * (m + 1) for _ in range(n + 1)]
    I = [[inf] * (m + 1) for _ in range(n + 1)]
    D = [[inf] * (m + 1) for _ in range(n + 1)]
    H[0][0] = 0
    for i in range(n + 1):
        for j in range(m + 1):
            if i == 0 and j == 0:
                continue
            if j > 0:
                I[i][j] = min(H[i][j - 1] + o + e, I[i][j - 1] + e)
            if i > 0:
                D[i][j] = min(H[i - 1][j] + o + e, D[i - 1][j] + e)
            h = min(I[i][j], D[i][j])
            if i > 0 and j > 0:
                h = min(h, H[i - 1][j - 1] + (x if a[i - 1] != b[j - 1]
                                              else 0))
            H[i][j] = h
    return H[n][m]


def _pairs():
    rng = np.random.default_rng(64)
    pairs = [(b"", b""), (b"", b"ACGTA"), (b"GATTACA", b""),
             (b"ACGTACGTAC", b"ACGTTTTACGTAC"),        # pure insertion
             (b"ACGTTTTACGTAC", b"ACGTACGTAC")]        # pure deletion
    while len(pairs) < 64:
        a = rng.choice(ont.BASES, rng.integers(10, 41))
        b = ont.ont_read(rng, a, 0.1, 0.05, 0.05, (1, 3)) \
            if rng.random() < 0.7 \
            else rng.choice(ont.BASES, rng.integers(10, 41))
        pairs.append((a.tobytes(), b.tobytes()))
    return pairs


@pytest.mark.parametrize("pen", [(4, 6, 2), (1, 0, 1), (3, 5, 1)])
def test_gap_affine_penalty_matches_brute_force(pen):
    pairs = _pairs()
    got = gap_affine.penalty([a for a, _ in pairs], [b for _, b in pairs],
                             *pen, "cpu")
    assert got.tolist() == [_brute(a, b, *pen) for a, b in pairs]


def test_cigar_penalty_rescoring():
    ref, read = b"ACGTACGT", b"ACGAACGTT"
    assert gap_affine.cigar_penalty("8M1I", ref, read, X, O, E) == 4 + 8
    assert gap_affine.cigar_penalty("3=1X4=1I", ref, read, X, O, E) == 12
    assert gap_affine.cigar_penalty("4=4M1I", ref, read, X, O, E) is None
    assert gap_affine.cigar_penalty("3=1=4M1I", ref, read, X, O, E) is None
    assert gap_affine.cigar_penalty("8M", ref, read, X, O, E) is None
    assert gap_affine.cigar_penalty("1S7M1I", ref, read, X, O, E) is None
    assert gap_affine.cigar_penalty("8D9I", ref, read, X, O, E) == \
        (O + 8 * E) + (O + 9 * E)
    assert gap_affine.cigar_penalty("", b"", b"", X, O, E) == 0
    assert gap_affine.cigar_penalty("", b"A", b"", X, O, E) is None
