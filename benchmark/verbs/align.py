"""The `align` verb over a cell's reads: one `align_reads` call a pass.

Cell keys: `router` ("hmm" or "kmer"), `batch_size`, `warmup_reads` (how
many of the reads the warm-up aligns), `check_reads` (how many reads,
drawn from the seed, the check follows through every pass).

With the hmm router the router's per-pair log-likelihoods are tapped where
`HmmRouter.pair_lls` returns them, so the check can hold every pass's
values against the plain pair-HMM. The check then compares, for the
sampled reads of every pass: each pair's log-likelihood, the chosen
reference (the reference's best, or one within the log-likelihood limit of
it), and the alignment (score, position, CIGAR, bases) against the plain
affine DP; and that every read of every pass was written.
"""

from __future__ import annotations

import json
import os
from types import SimpleNamespace

import numpy as np

from benchlib import bam
from benchlib import fastq as bench_fastq
from reference import affine_dp, pair_hmm

# the limits, with the readings they were set from in PERF.md
HMM_LL_LIMIT = 0.02          # nats, the widest |program - reference| gap
EXACT = 0                    # routes, alignments and missing reads


def prepare(ctx):
    from clique_tpu_torch.align import hmm
    from clique_tpu_torch.config.layout import SequenceLayout
    from clique_tpu_torch.reference.manager import ReferenceManager

    path = os.path.join(ctx.workdir, "layout.yaml")
    with open(path, "w") as fh:
        fh.write(ctx.inputs["layout_text"])
    layout = SequenceLayout.from_yaml(path)
    st = SimpleNamespace(ctx=ctx, layout=layout,
                         rm=ReferenceManager.from_layout(layout),
                         taps=None, hmm=hmm, real_pair_lls=None)
    if ctx.cell["router"] == "hmm":
        real = hmm.HmmRouter.pair_lls
        st.real_pair_lls = real

        def tapped(self, reads, candidates=None):
            out = real(self, reads, candidates)
            if st.taps is not None:
                st.taps.append((reads, candidates, out[2]))
            return out

        hmm.HmmRouter.pair_lls = tapped
    return st


def _align(st, out_bam, metrics_path=None, fastq=None):
    from clique_tpu_torch.align.pipeline import align_reads

    return align_reads(st.layout, st.rm, out_bam,
                       read1=fastq or st.ctx.inputs["fastq"],
                       batch_size=int(st.ctx.cell["batch_size"]),
                       router=st.ctx.cell["router"], device=st.ctx.device,
                       metrics_path=metrics_path)


def layer_spans():
    """The layers a traced pass passes through, as host spans."""
    from clique_tpu_torch.align import hmm, pipeline

    return [(pipeline, "align_reads", "bench.align_reads"),
            (hmm.HmmRouter, "route", "bench.router.route"),
            (pipeline.BatchAligner, "align_pairs_raw",
             "bench.align.dispatch")]


def warmup(st):
    """One `align_reads` call over the first `warmup_reads` reads: enough
    for one full route call (4 batches) and the pass's last, partial one,
    so every shape the pass uses has run once."""
    fastq = bench_fastq.head(st.ctx.inputs,
                             int(st.ctx.cell["warmup_reads"]),
                             os.path.join(st.ctx.workdir, "warm.fastq"))
    _align(st, os.path.join(st.ctx.workdir, "warm.bam"), fastq=fastq)


def run_pass(st, k):
    st.taps = []
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
    if st.real_pair_lls is not None:
        st.hmm.HmmRouter.pair_lls = st.real_pair_lls
    st.layout = st.rm = None


def work(st, passes):
    """Per pass the pairs the router scored and the alignments written, as
    (reference length, read length) arrays."""
    ref_len = {n: len(s) for n, s in st.ctx.inputs["references"]}
    out = []
    for p in passes:
        hmm_calls = []
        for reads, cands, _ll in p["taps"]:
            if cands is not None:
                raise ValueError("the benchmark counts full-panel routes")
            hmm_calls.append((np.array([len(r) for r in reads]),
                              np.array(list(ref_len.values()))))
        _full, recs = bam.scan_bam(p["bam"], ())
        lens = np.array([(ref_len[r], n) for r, n in recs]).reshape(-1, 2)
        out.append({"hmm_calls": hmm_calls, "dp": lens})
    return out


def check(st, passes, seed, device):
    """[(name, value, limit)] over every pass."""
    inputs = st.ctx.inputs
    reads = inputs["reads"]
    refs = inputs["references"]
    ref_index = {n: k for k, (n, _s) in enumerate(refs)}
    rng = np.random.default_rng(seed)
    n_check = min(int(st.ctx.cell["check_reads"]), len(reads))
    sample = np.sort(rng.choice(len(reads), n_check, replace=False))
    names = {reads[i][0] for i in sample}

    # the reference's log-likelihoods of every sampled read against every
    # reference
    pair_refs = [s for _i in sample for _n, s in refs]
    pair_reads = [reads[i][1] for i in sample for _ in refs]
    ref_ll = pair_hmm.forward(pair_refs, pair_reads, device
                              ).reshape(n_check, len(refs))
    best = ref_ll.max(axis=1)
    row_of = {int(i): r for r, i in enumerate(sample)}
    row_of_seq = {reads[i][1]: r for r, i in enumerate(sample.tolist())}

    gap = 0.0
    missing = route_bad = dp_bad = 0
    wanted = {}                      # (read index, reference) -> record
    for p in passes:
        # the program's log-likelihoods of the sampled reads
        if st.ctx.cell["router"] == "hmm":
            seen = set()
            for call_reads, _c, ll in p["taps"]:
                ll = np.asarray(ll, np.float64).reshape(len(call_reads), -1)
                for j, seq in enumerate(call_reads):
                    r = row_of_seq.get(seq)
                    if r is None:
                        continue
                    g = np.abs(ll[j] - ref_ll[r])
                    gap = max(gap, float("inf") if np.isnan(g).any()
                              else float(g.max()))
                    seen.add(r)
            missing += n_check - len(seen)
        got, lens = bam.scan_bam(p["bam"], names)
        missing += max(0, len(reads) - len(lens))
        for i in sample.tolist():
            name = reads[i][0]
            rec = got.get(name)
            if rec is None:
                missing += 1
                continue
            r = row_of[i]
            if st.ctx.cell["router"] == "hmm":
                chosen = ref_index.get(rec.reference)
                if chosen is None or \
                        ref_ll[r, chosen] < best[r] - HMM_LL_LIMIT:
                    route_bad += 1
                    continue
            wanted.setdefault((i, rec.reference), []).append(rec)

    # the alignments against the plain affine DP
    keys = sorted(wanted)
    seqs = dict(refs)
    als = affine_dp.align([seqs[ref] for _i, ref in keys],
                          [reads[i][1] for i, _r in keys], "aligner_default",
                          "both", device)
    for (i, _ref), al in zip(keys, als):
        for rec in wanted[(i, _ref)]:
            if (rec.pos, rec.cigar, rec.seq, float(rec.tags.get("as", "nan"))
                ) != (1, al.cigar, reads[i][1], al.score):
                dp_bad += 1
    return [("hmm_ll_gap", gap, HMM_LL_LIMIT),
            ("route_mismatches", route_bad, EXACT),
            ("dp_mismatches", dp_bad, EXACT),
            ("reads_missing", missing, EXACT)], \
        {"sampled_reads": n_check, "alignments_compared": len(keys)}
