"""The fused chain (align -> collapse -> call) over a cell's reads: one
`run_chain` call a pass, which writes the aligned BAM, the collapsed BAM
and the allele table.

Cell keys: `batch_size`, `warmup_reads` (how many of the reads the
warm-up chain runs on).

The check works out all three outputs with the plain reference
(`reference/lineage_chain.py`) and compares one pass drawn from the seed
field by field: every aligned record, every collapsed record and every
allele row. Every other pass must have written the same bytes.
"""

from __future__ import annotations

import hashlib
import json
import os
import time
from types import SimpleNamespace

import numpy as np

from benchlib import bam
from benchlib import fastq as bench_fastq
from reference import lineage_chain

EXACT = 0


def prepare(ctx):
    from clique_tpu_torch.config.layout import SequenceLayout
    from clique_tpu_torch.reference.manager import ReferenceManager

    path = os.path.join(ctx.workdir, "layout.yaml")
    with open(path, "w") as fh:
        fh.write(ctx.inputs["layout_text"])
    layout = SequenceLayout.from_yaml(path)
    return SimpleNamespace(ctx=ctx, layout=layout,
                           rm=ReferenceManager.from_layout(layout))


def _chain(st, stem, fastq):
    from clique_tpu_torch.chain import run_chain

    paths = {k: f"{stem}.{k}" for k in ("aligned.bam", "collapsed.bam",
                                        "alleles.tsv", "align.json",
                                        "collapse.json")}
    align_stats, _cstats = run_chain(
        st.layout, st.rm, paths["aligned.bam"], paths["collapsed.bam"],
        read1=fastq, align_metrics_path=paths["align.json"],
        collapse_metrics_path=paths["collapse.json"],
        alleles_path=paths["alleles.tsv"], device=st.ctx.device,
        batch_size=int(st.ctx.cell["batch_size"]))
    return align_stats, paths


def layer_spans():
    from clique_tpu_torch import chain
    from clique_tpu_torch.align import pipeline
    from clique_tpu_torch.caller import events

    return [(pipeline, "align_reads", "bench.align_reads"),
            (pipeline.BatchAligner, "align_pairs_raw",
             "bench.align.dispatch"),
            (chain, "collapse_from_reads", "bench.collapse"),
            (events, "call_events_from_records", "bench.call")]


def warmup(st):
    """One chain over the first `warmup_reads` reads (all of them where it
    is at least their number)."""
    fastq = bench_fastq.head(st.ctx.inputs,
                             int(st.ctx.cell["warmup_reads"]),
                             os.path.join(st.ctx.workdir, "warm.fastq"))
    _chain(st, os.path.join(st.ctx.workdir, "warm"), fastq)


def run_pass(st, k):
    stats, paths = _chain(st, os.path.join(st.ctx.workdir, f"pass{k}"),
                          st.ctx.inputs["fastq"])
    with open(paths["align.json"]) as fh:
        metrics = json.load(fh)
    with open(paths["collapse.json"]) as fh:
        collapse = json.load(fh)
    return {"reads": stats.aligned, "attempted": stats.total,
            "failed": stats.total - stats.aligned, "bam": paths["aligned.bam"],
            "paths": paths, "metrics": metrics, "collapse": collapse}


def release(st):
    st.layout = st.rm = None


def work(st, passes):
    ref_len = {n: len(s) for n, s in st.ctx.inputs["references"]}
    out = []
    for p in passes:
        _full, recs = bam.scan_bam(p["bam"], ())
        out.append({"hmm_calls": [], "dp": np.array(
            [(ref_len[r], n) for r, n in recs]).reshape(-1, 2)})
    return out


def _digest(paths):
    h = hashlib.sha256()
    for k in ("aligned.bam", "collapsed.bam", "alleles.tsv"):
        with open(paths[k], "rb") as fh:
            h.update(fh.read())
    return h.hexdigest()


def _alleles(path):
    with open(path) as fh:
        head = fh.readline().rstrip("\n").split("\t")
        rows = {}
        for line in fh:
            f = dict(zip(head, line.rstrip("\n").split("\t")))
            rows[f["read"]] = (f["reference"], f["allele"], f.get("rc"),
                               f.get("rm"), f.get("e0"), f.get("e1"))
    return rows


def judge(paths, want):
    """Mismatch counts of one pass's three outputs against `want`."""
    _refs, recs = bam.read_bam(paths["aligned.bam"])
    aligned = want["aligned"]
    bad_al = 0
    seen = set()
    for rec in recs:
        seen.add(rec.name)
        if aligned.get(rec.name) != (rec.pos, rec.cigar, rec.seq,
                                     rec.tags.get("e0"), rec.tags.get("e1")):
            bad_al += 1
    bad_al += len(set(aligned) - seen)

    _refs, recs = bam.read_bam(paths["collapsed.bam"])
    coll = want["collapsed"]
    bad_co = 0
    seen = set()
    for rec in recs:
        seen.add(rec.name)
        w = coll.get(rec.name)
        if w is None:
            bad_co += 1
            continue
        got = dict(rec.tags, cigar=rec.cigar, seq=rec.seq)
        if rec.pos != 1 or any(got.get(k) != v for k, v in w.items()):
            bad_co += 1
    bad_co += len(set(coll) - seen)

    rows = _alleles(paths["alleles.tsv"])
    want_rows = want["alleles"]
    bad_rows = sum(rows.get(n) != r for n, r in want_rows.items())
    judged = set(want_rows) | {n for n, f in coll.items() if "cigar" not in f}
    bad_rows += len(set(rows) - judged)
    return bad_al, bad_co, bad_rows


def check(st, passes, seed, device):
    """[(name, value, limit)]."""
    t0 = time.time()
    want = lineage_chain.expected(st.ctx.inputs, st.ctx.config, device)
    t1 = time.time()
    k = int(np.random.default_rng(seed).integers(len(passes)))
    bad = list(judge(passes[k]["paths"], want))
    digest = _digest(passes[k]["paths"])
    differ = 0
    for j, p in enumerate(passes):
        if j != k and _digest(p["paths"]) != digest:
            differ += 1
            bad = [a + b for a, b in zip(bad, judge(p["paths"], want))]
    n_reads = len(st.ctx.inputs["reads"])
    missing = sum(max(0, n_reads - p["reads"]) for p in passes)
    return [("aligned_record_mismatches", bad[0], EXACT),
            ("collapsed_record_mismatches", bad[1], EXACT),
            ("allele_row_mismatches", bad[2], EXACT),
            ("reads_missing", missing, EXACT)], \
        {"unjudged_groups": want["unjudged"], "passes_with_other_bytes":
         differ, "judged_pass": k, "records": len(want["aligned"]),
         "collapsed": len(want["collapsed"]), "allele_rows":
         len(want["alleles"]), "reference_s": round(t1 - t0, 3),
         "judge_s": round(time.time() - t1, 3)}
