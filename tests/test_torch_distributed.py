"""The port's multi-process align and collapse (parallel/distributed.py)
in ONE process, against the JAX package's single-process align_reads and
collapse computed here: BAM part merges, single-process distributed align
(and its resume points), paired-end striping, and single-process
distributed collapse. Record multisets are compared exactly (name,
reference, sequence, every tag). The cases of
tests/test_distributed_align.py:28-180 and
tests/test_distributed_collapse.py:91; the multi-process ones are
tests/test_torch_distributed_mp.py."""

import gzip
import os

import numpy as np

from clique_tpu.align.pipeline import align_reads as jax_align_reads
from clique_tpu.collapse.pipeline import collapse as jax_collapse
from clique_tpu_torch.config.layout import SequenceLayout
from clique_tpu_torch.io.sam import BamReader, BamWriter, SamRecord
from clique_tpu_torch.parallel.distributed import (align_distributed,
                                                   collapse_distributed)
from clique_tpu_torch.reference.manager import ReferenceManager

from tests.test_distributed_collapse import build_dataset, record_multiset
from test_torch_align_pipeline import _inflate_bgzf


def _port_layout(layout_path):
    layout = SequenceLayout.from_yaml(str(layout_path))
    return layout, ReferenceManager.from_layout(layout)


def _mk_record(name, ref, pos, seq):
    return SamRecord(name=name, flag=0, reference_name=ref, pos=pos,
                     mapq=40, cigar=[(len(seq), "M")], seq=seq,
                     qual=b"I" * len(seq), tags={"ar": name})


def test_concat_bam_parts(tmp_path):
    """The port's concat_bam_parts: records in part order, an empty part
    skipped, and the same inflated payload as the JAX package's merge of
    the same parts."""
    from clique_tpu.io.sam import concat_bam_parts as jax_concat
    from clique_tpu_torch.io.sam import concat_bam_parts

    refs = [("amp1", 100)]
    parts = []
    for p, names in enumerate((["a", "b"], [], ["c"])):
        path = str(tmp_path / f"part{p}.bam")
        with BamWriter(path, refs) as w:
            for i, n in enumerate(names):
                w.write(_mk_record(n, "amp1", i + 1, b"ACGTACGT"))
        parts.append(path)
    out, out_j = str(tmp_path / "merged.bam"), str(tmp_path / "jax.bam")
    concat_bam_parts(out, refs, parts)
    jax_concat(out_j, refs, parts)
    with BamReader(out) as reader:
        got = [(r.name, r.pos, r.seq) for r in reader]
    assert got == [("a", 1, b"ACGTACGT"), ("b", 2, b"ACGTACGT"),
                   ("c", 1, b"ACGTACGT")]
    assert _inflate_bgzf(out) == _inflate_bgzf(out_j)


def test_align_distributed_single_process(tmp_path):
    _jl, layout_path, aligned = build_dataset(tmp_path)
    layout, rm = _port_layout(layout_path)
    fq = str(tmp_path / "reads.fastq.gz")
    out = str(tmp_path / "dist_align1.bam")
    stats = align_distributed(layout, rm, out, str(tmp_path / "workA"),
                              read1=fq, process_id=0, num_processes=1,
                              batch_size=8, device="cpu")
    assert stats.total == 30
    assert record_multiset(out) == record_multiset(aligned)


def test_align_distributed_resume_skips_complete_part(tmp_path):
    """Part BAMs are resume points: a rerun with a complete part skips
    its alignment (the part file is untouched); an interrupted part
    (truncated, no valid cqi sentinel) is redone, and so is a part whose
    inputs changed."""
    _jl, layout_path, aligned = build_dataset(tmp_path)
    layout, rm = _port_layout(layout_path)
    fq = str(tmp_path / "reads.fastq.gz")
    work = tmp_path / "wkr"
    out = str(tmp_path / "resume.bam")
    kw = dict(read1=fq, process_id=0, num_processes=1, batch_size=8,
              device="cpu")
    align_distributed(layout, rm, out, str(work), **kw)
    part = work / "part.p0.bam"
    before = part.stat().st_mtime_ns
    assert align_distributed(layout, rm, out, str(work), **kw) is None
    assert part.stat().st_mtime_ns == before    # part untouched
    assert record_multiset(out) == record_multiset(aligned)

    raw = part.read_bytes()
    part.write_bytes(raw[:len(raw) // 2])
    assert align_distributed(layout, rm, out, str(work), **kw) is not None
    assert record_multiset(out) == record_multiset(aligned)

    data = gzip.open(fq).read()
    with gzip.open(fq, "wb") as fh:
        fh.write(data)
    os.utime(fq, (0, 0))
    assert align_distributed(layout, rm, out, str(work), **kw) is not None


def test_align_distributed_paired_end(tmp_path):
    """Paired-end (R1+R2 align-merge) striping goes through the general
    reader loop: 1-process distributed == the JAX align_reads on merged
    pairs."""
    from clique_tpu.config.layout import SequenceLayout as JaxLayout
    from clique_tpu.reference.manager import ReferenceManager as JaxRM
    from clique_tpu_torch.utils.seq import reverse_complement

    rng = np.random.default_rng(88)
    a5 = "TTCAGACGTGTGCTCTTCCGATCT"
    a3 = "AGATCGGAAGAGCACACGTCTGAA"
    amp = a5 + "".join("ACGT"[i] for i in rng.integers(0, 4, 52)) + a3
    layout_path = tmp_path / "layout.yaml"
    layout_path.write_text(f"""
known_strand: true
merge: Align
reads:
  - !Read1
    orientation: Forward
  - !Read2
    orientation: Reverse
references:
  amp1:
    sequence: "{amp}"
    targets: []
    target_types: []
    umi_configurations: {{}}
""")
    r1p, r2p = tmp_path / "r1.fastq.gz", tmp_path / "r2.fastq.gz"
    with gzip.open(r1p, "wt") as f1, gzip.open(r2p, "wt") as f2:
        for i in range(12):
            r1 = amp[:70]
            r2 = reverse_complement(amp[30:].encode()).decode()
            f1.write(f"@p{i}\n{r1}\n+\n{'I' * len(r1)}\n")
            f2.write(f"@p{i}\n{r2}\n+\n{'I' * len(r2)}\n")
    jl = JaxLayout.from_yaml(str(layout_path))
    ref_bam = str(tmp_path / "ref.bam")
    jax_align_reads(jl, JaxRM.from_layout(jl), ref_bam, read1=str(r1p),
                    read2=str(r2p), batch_size=8)
    layout, rm = _port_layout(layout_path)
    out = str(tmp_path / "dist.bam")
    align_distributed(layout, rm, out, str(tmp_path / "wk"),
                      read1=str(r1p), read2=str(r2p), process_id=0,
                      num_processes=1, batch_size=8, device="cpu")
    got, want = record_multiset(out), record_multiset(ref_bam)
    assert got == want and len(got) == 12


def test_distributed_collapse_single_process(tmp_path):
    jax_layout, layout_path, aligned = build_dataset(tmp_path)
    ref_bam = tmp_path / "ref.bam"
    jax_collapse(str(ref_bam), jax_layout, aligned)
    layout, _rm = _port_layout(layout_path)
    work = tmp_path / "work1"
    work.mkdir()
    out_bam = tmp_path / "dist1.bam"
    stats = collapse_distributed(str(out_bam), layout, aligned, str(work),
                                 process_id=0, num_processes=1,
                                 device="cpu")
    assert stats.total_reads == 30
    assert record_multiset(str(out_bam)) == record_multiset(str(ref_bam))


def test_distributed_refuses_sam_output(tmp_path):
    import pytest

    _jl, layout_path, aligned = build_dataset(tmp_path)
    layout, rm = _port_layout(layout_path)
    with pytest.raises(ValueError):
        align_distributed(layout, rm, str(tmp_path / "x.sam"),
                          str(tmp_path / "w"), read1="r.fq",
                          device="cpu")
    with pytest.raises(ValueError):
        collapse_distributed(str(tmp_path / "x.sam"), layout, aligned,
                             str(tmp_path / "w"), device="cpu")
