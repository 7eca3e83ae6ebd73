"""The port's anchored (seed-and-extend) path and banded `align_reads` on
the CPU, held against the host golden model and the JAX package.

The port's AnchoredBatchAligner (a copy of the JAX package's) wraps the
port's BatchAligner as its inner aligner, as
clique_tpu/align/pipeline.py:938-944 wraps the JAX one; the host golden
model is the JAX package's align_string_with_anchors. Every DP decision is exact, so aligned strings, CIGARs, scores and
inflated BAM payloads must be identical.
"""

import dataclasses
import gzip

import numpy as np
import pytest

from clique_tpu.align.anchored import align_string_with_anchors
from clique_tpu.align.pipeline import align_reads as jax_align_reads
from clique_tpu.align.scoring import AffineScoring as JaxAffineScoring
from clique_tpu.collapse.pipeline import collapse as jax_collapse
from clique_tpu.reference.manager import (SeedIndex,
                                          find_greedy_non_overlapping_segments)
from clique_tpu_torch.align import dp_kernels
from clique_tpu_torch.align.anchored import AnchoredBatchAligner
from clique_tpu_torch.align.pipeline import BatchAligner, align_reads
from clique_tpu_torch.align.scoring import AffineScoring
from clique_tpu_torch.chain import run_chain
from clique_tpu_torch.io.sam import BamReader
from clique_tpu_torch.reference.manager import (
    find_greedy_non_overlapping_segments as port_segments)
from clique_tpu_torch.reference.manager import SeedIndex as PortSeedIndex
from test_torch_align_pipeline import (_bench_shaped, _golden_inputs,
                                       _inflate_bgzf, _load_make_golden,
                                       load_jax_layout, load_layout)

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
SCORING = AffineScoring.aligner_default()
JAX_SCORING = JaxAffineScoring.aligner_default()


def _mutate(rng, seq, subs, indels, margin=100):
    read = bytearray(seq)
    for _ in range(subs):
        read[int(rng.integers(0, len(read)))] = int(rng.choice(BASES))
    for _ in range(indels):
        p = int(rng.integers(margin, len(read) - margin))
        if rng.random() < 0.5:
            del read[p:p + int(rng.integers(1, 7))]
        else:
            read[p:p] = rng.choice(BASES, int(rng.integers(1, 7))).tobytes()
    return bytes(read)


def _golden(read, ref, name="read", index=None):
    segs = find_greedy_non_overlapping_segments(
        read, ref, index if index is not None else SeedIndex(ref, 12))
    return align_string_with_anchors(name, "ref", read, ref, segs, None,
                                     JAX_SCORING)


def test_anchored_batch_with_port_inner_matches_host_golden():
    """Mirror of tests/test_anchored_batch.py:45-62 with the port's
    BatchAligner inside: long reads with substitutions and 1-6 bp indels
    (some sub-DPs have an empty reference or read slice), plus a read that
    shares no seed with its reference (one whole-read sub-DP)."""
    rng = np.random.default_rng(808)
    pairs = []
    for _ in range(4):
        ref = rng.choice(BASES, 3000).tobytes()
        pairs.append((ref, _mutate(rng, ref, 20, 6)))
    ref = rng.choice(BASES, 300).tobytes()
    pairs.append((ref, b"A" * 200))
    inner = BatchAligner(SCORING, batch_size=64, device="cpu")
    aligner = AnchoredBatchAligner(inner, SCORING, seed_size=12)
    out = aligner.align_pairs([p[0] for p in pairs], [p[1] for p in pairs])
    assert not port_segments(
        b"A" * 200, ref, PortSeedIndex(ref, 12)).alignment_segments
    for (ref, read), (a1, a2, cigar, score) in zip(pairs, out):
        golden = _golden(read, ref)
        assert (a1, a2, cigar, score) == (golden.reference_aligned,
                                          golden.read_aligned, golden.cigar,
                                          golden.score)
    full_cells = sum((len(r) + 1) * (len(d) + 1) for r, d in pairs)
    assert inner.cells_filled < full_cells / 5


def _long_layout(tmp_path, n, rng):
    ref = rng.choice(BASES, n).tobytes().decode()
    layout_path = tmp_path / "layout.yaml"
    layout_path.write_text(f"""
known_strand: true
reads:
  - !Read1
    orientation: Forward
references:
  longamp:
    sequence: "{ref}"
""")
    return (ref, *load_layout(layout_path))


def test_align_reads_long_reads_match_jax(tmp_path):
    """Mirror of tests/test_anchored_batch.py:65-111: reads at least
    anchored_min_length go through the anchored path, after the flush's
    short reads; the BAM equals the JAX package's byte for byte and each
    long read's record the host golden's."""
    rng = np.random.default_rng(65)
    ref, layout, rm = _long_layout(tmp_path, 2600, rng)
    reads = [_mutate(rng, ref.encode(), 15, 2) for _ in range(3)]
    reads.insert(1, ref.encode()[400:900])          # a short read
    fq = tmp_path / "r.fastq.gz"
    with gzip.open(fq, "wt") as fh:
        for i, r in enumerate(reads):
            fh.write(f"@long{i}\n{r.decode()}\n+\n{'I' * len(r)}\n")

    out_t, out_j = str(tmp_path / "t.bam"), str(tmp_path / "j.bam")
    metrics = tmp_path / "m.json"
    stats_t = align_reads(layout, rm, out_t, read1=str(fq), batch_size=8,
                          anchored_min_length=1024, device="cpu",
                          metrics_path=str(metrics))
    j_layout, j_rm = load_jax_layout(tmp_path / "layout.yaml")
    stats_j = jax_align_reads(j_layout, j_rm, out_j, read1=str(fq),
                              batch_size=8, anchored_min_length=1024)
    assert dataclasses.asdict(stats_t) == dataclasses.asdict(stats_j)
    assert stats_t.aligned == 4
    assert _inflate_bgzf(out_t) == _inflate_bgzf(out_j)
    with BamReader(out_t) as reader:
        records = list(reader)
    assert [r.name for r in records] == ["long1", "long0", "long2", "long3"]
    for rec in records[1:]:
        golden = _golden(reads[int(rec.name[4:])], ref.encode(), rec.name,
                         j_rm.references[0].index)
        assert rec.seq == golden.read_aligned.replace(b"-", b"")
        assert rec.cigar_string == "".join(f"{c}{op}"
                                           for c, op in golden.cigar)
    import json

    anchored = json.loads(metrics.read_text())["anchored"]
    assert anchored["reads"] == 3 and anchored["sub_dps"] > 3
    assert 0 < anchored["dp_cells_filled"] < 3 * 2601 * 2601 / 5


def test_fused_chain_with_anchored_reads_matches_jax(tmp_path):
    """run_chain with every golden read on the anchored path: the sink
    takes them through emit_aligned / consume_aligned, and the aligned and
    collapsed BAMs equal the JAX package's two-stage chain with the same
    anchored_min_length."""
    _gd, layout, rm, r1, _r2 = _golden_inputs(_load_make_golden(), "golden",
                                              tmp_path)
    a_j, c_j = str(tmp_path / "aj.bam"), str(tmp_path / "cj.bam")
    j_layout, j_rm = load_jax_layout(tmp_path / "layout.yaml")
    jax_align_reads(j_layout, j_rm, a_j, read1=r1, batch_size=16,
                    anchored_min_length=100)
    s_j = jax_collapse(c_j, j_layout, a_j)
    a_f, c_f = str(tmp_path / "af.bam"), str(tmp_path / "cf.bam")
    stats, s_f = run_chain(layout, rm, a_f, c_f, read1=r1, batch_size=16,
                           device="cpu", anchored_min_length=100)
    assert stats.aligned == stats.total > 0
    assert _inflate_bgzf(a_f) == _inflate_bgzf(a_j)
    assert _inflate_bgzf(c_f) == _inflate_bgzf(c_j)
    assert (s_f.total_reads, s_f.passing) == (s_j.total_reads, s_j.passing)
    assert s_f.passing > 0


@pytest.mark.parametrize("bandwidth", [16, 3])
def test_align_reads_banded_matches_jax(tmp_path, bandwidth):
    """align_reads(bandwidth=) on the bench-shaped two-reference reads
    (single-amplicon kmer routing and the exhaustive search): stats and
    BAM bytes equal the JAX align_reads with the same band, and a narrow
    band changes the alignments against the full band."""
    layout, rm, fq = _bench_shaped(tmp_path, n_reads=96)
    out_t, out_j = str(tmp_path / "t.bam"), str(tmp_path / "j.bam")
    fills = dict(dp_kernels.fill_mode_launches)
    stats_t = align_reads(layout, rm, out_t, read1=fq, batch_size=32,
                          bandwidth=bandwidth, device="cpu")
    stats_j = jax_align_reads(*load_jax_layout(tmp_path / "layout.yaml"),
                              out_j, read1=fq, batch_size=32,
                              bandwidth=bandwidth)
    assert dataclasses.asdict(stats_t) == dataclasses.asdict(stats_j)
    assert _inflate_bgzf(out_t) == _inflate_bgzf(out_j)
    assert dp_kernels.fill_mode_launches == fills    # plain versions ran
    if bandwidth == 3:
        out_f = str(tmp_path / "f.bam")
        align_reads(layout, rm, out_f, read1=fq, batch_size=32, device="cpu")
        assert _inflate_bgzf(out_f) != _inflate_bgzf(out_t)


def test_batch_aligner_splits_groups_by_traceback_memory(monkeypatch):
    """A traceback budget of two alignments per group gives more
    dispatches and the same results."""
    from clique_tpu_torch.align import batch as tbatch

    rng = np.random.default_rng(3)
    refs = [rng.choice(BASES, 90).tobytes() for _ in range(5)]
    reads = [_mutate(rng, r, 3, 1, margin=10) for r in refs]
    whole = BatchAligner(SCORING, batch_size=16, device="cpu")
    want = whole.align_pairs(refs, reads)
    monkeypatch.setattr(tbatch, "MAX_TRACEBACK_BYTES",
                        2 * tbatch.traceback_bytes(128, 128))
    split = BatchAligner(SCORING, batch_size=16, device="cpu")
    assert split.align_pairs(refs, reads) == want
    assert (whole.dispatches, split.dispatches) == (1, 3)
