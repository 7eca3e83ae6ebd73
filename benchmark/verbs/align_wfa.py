"""The `align` verb on a wavefront engine: one `align_reads` call a pass
over a cell's reads, with the configuration's `engine` and `mode` (the
call `clique align --engine wfa` makes).

Cell keys: `batch_size`, `warmup_reads` (how many of the reads the
warm-up aligns), `check_reads` (how many reads, drawn from the seed, the
check holds against the plain optimum). Configuration keys: `engine`,
`mode`, `penalties` (`x`, `o`, `e`: the model the check holds the
program to).

`wfa_kernels.wfa_align` and `wfa_kernels.wfa_mid` are tapped where the
program calls them: each launch's row widths, ceiling and gap penalties
are kept with its lanes' length tensors and its penalty tensor, on the
device and unsynchronised, and read back after the window for the counts
of the kernels' work.

The check, over every pass: for the sampled reads, the largest gap
between the program's penalty (its `as` tag, negated) and the plain
optimum (`reference/gap_affine.py`); every record whose CIGAR does not
re-score to its penalty, does not span the reference and the read from
position 1, or whose bases are not the read's; every read missing from a
pass's BAM. How many reads each pass finished on the bialign engine goes
into the info, not the check: a later change may route reads otherwise.
"""

from __future__ import annotations

import json
import os
from types import SimpleNamespace

import numpy as np

from benchlib import bam
from benchlib import fastq as bench_fastq
from reference import gap_affine

EXACT = 0                # penalties, CIGARs and missing reads
TAPPED = ("wfa_align", "wfa_mid")


def prepare(ctx):
    from clique_tpu_torch.align import wfa_kernels
    from clique_tpu_torch.config.layout import SequenceLayout
    from clique_tpu_torch.reference.manager import ReferenceManager

    path = os.path.join(ctx.workdir, "layout.yaml")
    with open(path, "w") as fh:
        fh.write(ctx.inputs["layout_text"])
    layout = SequenceLayout.from_yaml(path)
    st = SimpleNamespace(ctx=ctx, layout=layout,
                         rm=ReferenceManager.from_layout(layout), taps=None,
                         kernels=wfa_kernels,
                         real={k: getattr(wfa_kernels, k) for k in TAPPED})

    def tap(name):
        real = st.real[name]

        def tapped(refs, reads, ref_lens, read_lens, *, smax, **kw):
            out = real(refs, reads, ref_lens, read_lens, smax=smax, **kw)
            if st.taps is not None:
                st.taps[name].append((refs.shape[1], reads.shape[1], smax,
                                      kw.get("o", 6), kw.get("e", 2),
                                      ref_lens, read_lens, out[0]))
            return out

        return tapped

    for name in TAPPED:
        setattr(wfa_kernels, name, tap(name))
    return st


def _align(st, out_bam, metrics_path=None, fastq=None):
    from clique_tpu_torch.align.pipeline import align_reads

    cfg = st.ctx.config
    return align_reads(st.layout, st.rm, out_bam,
                       read1=fastq or st.ctx.inputs["fastq"],
                       batch_size=int(st.ctx.cell["batch_size"]),
                       engine=cfg["engine"], mode=cfg["mode"],
                       device=st.ctx.device, metrics_path=metrics_path)


def layer_spans():
    """The layers a traced pass passes through, as host spans."""
    from clique_tpu_torch.align import pipeline, wavefront

    return [(pipeline, "align_reads", "bench.align_reads"),
            (wavefront.WfaAligner, "align_pairs", "bench.wfa.align_pairs"),
            (wavefront.WfaAligner, "_bialign_fill", "bench.wfa.bialign"),
            (wavefront, "_mid_split_batch", "bench.wfa.mid_level"),
            (wavefront, "wfa_affine_align_pairs", "bench.wfa.leaves")]


def warmup(st):
    """One `align_reads` call over the first `warmup_reads` reads: every
    rung, split level and leaf chunk a pass runs, once."""
    fastq = bench_fastq.head(st.ctx.inputs,
                             int(st.ctx.cell["warmup_reads"]),
                             os.path.join(st.ctx.workdir, "warm.fastq"))
    _align(st, os.path.join(st.ctx.workdir, "warm.bam"), fastq=fastq)


def run_pass(st, k):
    st.taps = {name: [] for name in TAPPED}
    out = os.path.join(st.ctx.workdir, f"pass{k}.bam")
    mpath = out + ".metrics.json"
    stats = _align(st, out, mpath)
    with open(mpath) as fh:
        metrics = json.load(fh)
    taps, st.taps = st.taps, None
    return {"reads": stats.aligned, "attempted": stats.total,
            "failed": stats.total - stats.aligned, "bam": out,
            "metrics": metrics, "taps": taps}


def release(st):
    for name, real in st.real.items():
        setattr(st.kernels, name, real)
    st.layout = st.rm = None


def work(st, passes):
    """Per pass, each tapped kernel's launches as counts/<kernel>.py's
    work() arguments, read back from the device."""
    def host(t):
        return t.cpu().numpy().astype(np.int64)

    return [{name: [(n1, n2, smax, o, e, host(l1), host(l2), host(pen))
                    for n1, n2, smax, o, e, l1, l2, pen in p["taps"][name]]
             for name in TAPPED} for p in passes]


def check(st, passes, seed, device):
    """[(name, value, limit)] over every pass."""
    pen_cfg = st.ctx.config["penalties"]
    x, o, e = int(pen_cfg["x"]), int(pen_cfg["o"]), int(pen_cfg["e"])
    reads = st.ctx.inputs["reads"]
    seqs = dict(st.ctx.inputs["references"])
    rng = np.random.default_rng(seed)
    n_check = min(int(st.ctx.cell["check_reads"]), len(reads))
    sample = np.sort(rng.choice(len(reads), n_check, replace=False))
    (_name, ref), = st.ctx.inputs["references"]
    optimum = gap_affine.penalty([ref] * n_check,
                                 [reads[i][1] for i in sample], x, o, e,
                                 device)
    want = dict(zip((reads[i][0] for i in sample), optimum.tolist()))
    read_of = dict(reads)

    gap = 0
    missing = cigar_bad = 0
    for p in passes:
        _refs, records = bam.read_bam(p["bam"])
        seen = set()
        for rec in records:
            seen.add(rec.name)
            read = read_of.get(rec.name)
            pen = -float(rec.tags.get("as", "nan"))
            ok = read is not None and rec.seq == read and rec.pos == 1 and \
                rec.reference in seqs and gap_affine.cigar_penalty(
                    rec.cigar, seqs[rec.reference], read, x, o, e) == pen
            cigar_bad += not ok
            if rec.name in want:
                gap = max(gap, abs(pen - want[rec.name])
                          if np.isfinite(pen) else float("inf"))
        missing += len(read_of.keys() - seen)
    bialign = [p["metrics"].get("wfa_bialign_pairs") for p in passes]
    return [("penalty_gap", gap, EXACT),
            ("cigar_mismatches", cigar_bad, EXACT),
            ("reads_missing", missing, EXACT)], \
        {"sampled_reads": n_check, "reads_per_pass": len(reads),
         "bialign_pairs": bialign,
         "all_to_bialign": all(b == len(reads) for b in bialign),
         "optimum_min_median_max": [int(optimum.min()),
                                    int(np.median(optimum)),
                                    int(optimum.max())]}
