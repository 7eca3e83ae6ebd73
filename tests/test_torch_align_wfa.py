"""The port's wavefront engines (clique_tpu_torch/align/wavefront.py and
wfa_kernels.py) on the CPU, held against the JAX package's
clique_tpu/align/wavefront.py.

Each side builds its own inputs from the same numpy arrays or bytes, made
from a numpy seed. Every penalty, op byte, skeleton, CIGAR and BAM byte is
an exact integer result, so everything compares for equality: the plain
fills (both penalty models, with and without the op store, with
wildcards, censoring, the heuristic band and the wf-adaptive trim, the op
store whole), the plain walk (against wfa_walk_device and the host
walkers), the host helpers, WfaAligner.align_pairs (escalation, the
memory caps and waves, the DP fallback, the affine2p rerun), the
candidate screen, the exhaustive search and the golden pins under
`--engine wfa` and `--engine convex`, and the engine's two routes to its
bialign engine (tests/test_torch_wfa_bialign.py holds that engine).
"""

import dataclasses
import gzip
import os

import numpy as np
import pytest
import torch

from clique_tpu.align import wavefront as jw
from clique_tpu.align.pipeline import BatchAligner as JaxBatchAligner
from clique_tpu.align.pipeline import align_reads as jax_align_reads
from clique_tpu.align.scoring import AffineScoring as JaxAffineScoring
from clique_tpu_torch import cli
from clique_tpu_torch.align import wavefront as tw
from clique_tpu_torch.align import wfa_kernels as tk
from clique_tpu_torch.align.pipeline import BatchAligner, align_reads
from clique_tpu_torch.align.scoring import AffineScoring
from test_torch_align_pipeline import (_golden_inputs, _inflate_bgzf,
                                       _load_make_golden, load_jax_layout,
                                       load_layout)

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
PEN = dict(x=4, o=6, e=2, o2=24, e2=1)
A5 = "TTCAGACGTGTGCTCTTCCGATCT"
A3 = "AGATCGGAAGAGCACACGTCTGAA"
TARGET = "GGCACTGCGGCTGGAGGTGG"


def _mutate(rng, seq, sub, indel):
    out = bytearray()
    for c in seq:
        r = rng.random()
        if r < indel / 2:
            continue
        if r < indel:
            out.append(int(rng.choice(BASES)))
        out.append(int(rng.choice(BASES)) if rng.random() < sub else c)
    return bytes(out)


def _pairs(seed, n=28, lo=8, hi=60):
    """Random pairs: substitutions and indels, long deletions (the class-2
    gap), identical pairs (an empty skeleton), a wildcard zone, and one
    pair too divergent for a low ceiling."""
    rng = np.random.default_rng(seed)
    pairs = []
    for i in range(n):
        L = int(rng.integers(lo, hi))
        a = bytearray(rng.choice(BASES, L).tobytes())
        if i % 5 == 0:
            a[3:9] = b"012N45"
        a = bytes(a)
        if i % 4 == 0 and L > 20:
            cut = int(rng.integers(8, L // 2))
            b = a[:5] + a[5 + cut:]
        elif i % 4 == 1:
            b = a
        else:
            b = _mutate(rng, a, 0.10, 0.06)
        pairs.append((a, b[:hi]))
    pairs.append((b"A" * 40, b"C" * 40))
    return pairs


def _arrays(pairs, B, W):
    a = np.zeros((B, W), np.uint8)
    b = np.zeros((B, W), np.uint8)
    la = np.zeros(B, np.int32)
    lb = np.zeros(B, np.int32)
    for i, (s, t) in enumerate(pairs):
        a[i, :len(s)] = np.frombuffer(s, np.uint8)
        b[i, :len(t)] = np.frombuffer(t, np.uint8)
        la[i], lb[i] = len(s), len(t)
    return a, b, la, lb


def _replayed(host, fwd, fin, wildcards):
    """The JAX package's replay of each walked lane's skeleton (None where
    the walk did not converge), the oracle of wfa_align's runs."""
    a, b, la, lb = host
    skels = tw.WfaAligner._decode_walk(np.asarray(fwd),
                                       np.where(np.asarray(fin) == -1, -1,
                                                -2), len(la))
    return [None if sk is None else
            jw.wfa_replay_cigar(a[i, :la[i]].tobytes(), b[i, :lb[i]].tobytes(),
                                sk, wildcards=wildcards)
            for i, sk in enumerate(skels)]


def _decoded(host, runs, fin):
    """wfa_align's runs decoded as the engine decodes them, for every lane
    whose walk converged or was censored."""
    fin = fin.numpy()
    keep = np.flatnonzero((fin == -1) | (fin == -2))
    lens = list(zip(host[2][keep].tolist(), host[3][keep].tolist()))
    got = tw._decode_runs(runs.numpy()[keep], fin[keep], lens)
    out = [None] * len(fin)
    for i, cig in zip(keep, got):
        out[i] = cig
    return out


def _jax_fill(model, host, W, smax, wildcards, kband, adaptive, tb=True):
    kw = dict(n1=W, n2=W, smax=smax, x=4, wildcards=wildcards, kband=kband)
    if model == "affine":
        kw.update(o=6, e=2)
        if tb:
            return jw.wfa_affine_tb_batch(*host, adaptive=adaptive, **kw)
        return jw.wfa_affine_batch(*host, **kw)
    kw.update(o1=6, e1=2, o2=24, e2=1)
    if tb:
        return jw.wfa_affine2p_tb_batch(*host, adaptive=adaptive, **kw)
    return jw.wfa_affine2p_batch(*host, **kw)


OPTIONS = {
    "exact": dict(smax=96),
    "wildcards": dict(smax=96, wildcards=True),
    "kband": dict(smax=96, kband=5),
    "adaptive": dict(smax=96, wildcards=True, adaptive=3),
    "censored": dict(smax=12),
}


@pytest.mark.parametrize("option", list(OPTIONS))
@pytest.mark.parametrize("model", tk.MODELS)
def test_plain_fill_and_walk_match_jax(model, option):
    """The plain traceback fill (penalties and the whole op store), the
    fused walk (skeletons and end rows) and the score-only fill equal the
    JAX functions'."""
    opt = dict(OPTIONS[option])
    smax = opt.pop("smax")
    wildcards = opt.get("wildcards", False)
    kband, adaptive = opt.get("kband"), opt.get("adaptive")
    W = 64
    host = _arrays(_pairs(3), 32, W)
    j_pen, j_ops = _jax_fill(model, host, W, smax, wildcards, kband,
                             adaptive)
    j_fwd, j_fin = jw.wfa_walk_device(j_ops, j_pen, host[2] - host[3],
                                      model=model, x=4, o1=6, e1=2, o2=24,
                                      e2=1)
    args = [torch.from_numpy(v) for v in host]
    n = tk.wfa_align_launches
    pen, ops, fwd, fin, runs = tk.wfa_align(*args, smax=smax, model=model,
                                            **PEN, **opt)
    assert tk.wfa_align_launches == n       # the CPU runs no kernel
    assert np.array_equal(pen.numpy(), np.asarray(j_pen))
    assert np.array_equal(ops.numpy(), np.asarray(j_ops))
    assert np.array_equal(fwd.numpy(), np.asarray(j_fwd))
    assert np.array_equal(fin.numpy(), np.asarray(j_fin))
    assert (pen.numpy() > smax).any()
    # the runs: the JAX package's replay of its own walk, lane for lane
    assert runs.shape == (32, tk.runs_width(model, smax, 4, 2, 1))
    assert _decoded(host, runs, fin) == _replayed(host, j_fwd, j_fin,
                                                  wildcards)
    if adaptive is None:
        j_sc = _jax_fill(model, host, W, smax, wildcards, kband, None,
                         tb=False)
        sc = tk.wfa_score(*args, smax=smax, model=model, wildcards=wildcards,
                          kband=kband, **PEN)
        assert np.array_equal(sc.numpy(), np.asarray(j_sc))


@pytest.mark.parametrize("model", tk.MODELS)
def test_plain_walk_matches_host_walkers(model):
    """wfa_walk_reference is decision-identical to the host walkers (the
    port's copies and the JAX package's), censored lanes included."""
    W = 64
    host = _arrays(_pairs(5), 32, W)
    args = [torch.from_numpy(v) for v in host]
    pen, ops, fwd, fin, _runs = tk.wfa_align(*args, smax=96, model=model,
                                             **PEN)
    n = 29
    kt = (host[2] - host[3])[:n]
    if model == "affine":
        port = tw.wfa_backtrace_ops(ops.numpy()[:, :n], pen.numpy()[:n], kt,
                                    x=4, o=6, e=2)
        jax_ = jw.wfa_backtrace_ops(ops.numpy()[:, :n], pen.numpy()[:n], kt,
                                    x=4, o=6, e=2)
    else:
        port = tw.wfa_backtrace_ops_2p(ops.numpy()[:, :n], pen.numpy()[:n],
                                       kt, x=4, o1=6, e1=2, o2=24, e2=1)
        jax_ = jw.wfa_backtrace_ops_2p(ops.numpy()[:, :n], pen.numpy()[:n],
                                       kt, x=4, o1=6, e1=2, o2=24, e2=1)
    assert port == jax_
    walked = tw.WfaAligner._decode_walk(fwd.numpy(), fin.numpy(), n)
    assert walked == port
    assert sum(s is None for s in walked) == 1
    assert [] in walked                      # an identical pair


def test_host_helpers_match_jax():
    """The port's copies of the replay, penalty, golden and expansion
    helpers give the JAX package's results."""
    pairs = _pairs(7, n=14, hi=30)[:-1]
    for wild in (False, True):
        host = _arrays(pairs, 16, 30)
        pen, _ops, fwd, fin, runs = tk.wfa_align(
            *(torch.from_numpy(v) for v in host), smax=200, wildcards=wild,
            **PEN)
        skels = tw.WfaAligner._decode_walk(fwd.numpy(), fin.numpy(),
                                           len(pairs))
        cigars = _decoded(host, runs, fin)
        for (a, b), p, sk, got in zip(pairs, pen.tolist(), skels, cigars):
            cig = tw.wfa_replay_cigar(a, b, sk, wildcards=wild)
            assert cig == jw.wfa_replay_cigar(a, b, sk, wildcards=wild)
            assert got == cig
            assert tw.cigar_penalty(cig, a, b, x=4, o=6, e=2,
                                    wildcards=wild) == p
            assert p == tw.affine_penalty_golden(a, b, x=4, o=6, e=2,
                                                 wildcards=wild) == \
                jw.affine_penalty_golden(a, b, x=4, o=6, e=2, wildcards=wild)
            assert tw.affine2p_penalty_golden(
                a, b, x=4, o1=6, e1=2, o2=24, e2=1, wildcards=wild) == \
                jw.affine2p_penalty_golden(a, b, x=4, o1=6, e1=2, o2=24,
                                           e2=1, wildcards=wild)
            for c in (cig, [(len(a), "D"), (len(b), "I")]):
                assert tw.cigar_penalty(c, a, b, x=4, o=6, e=2,
                                        wildcards=wild) == \
                    jw.cigar_penalty(c, a, b, x=4, o=6, e=2, wildcards=wild)
                assert tw.cigar_penalty_2p(c, a, b, x=4, o1=6, e1=2, o2=24,
                                           e2=1, wildcards=wild) == \
                    jw.cigar_penalty_2p(c, a, b, x=4, o1=6, e1=2, o2=24,
                                        e2=1, wildcards=wild)
                assert tw.cigar_to_aligned(a, b, c) == \
                    jw.cigar_to_aligned(a, b, c)
    assert tk.exact_kband(192, ((6, 2), (24, 1))) == \
        jw.exact_kband(192, ((6, 2), (24, 1))) == 168
    assert tk.exact_kband(6, ((6, 2),)) == 0


def test_traceback_pairs_are_optimal():
    """wfa_affine_align_pairs: each CIGAR is a valid alignment whose affine
    penalty equals the returned one, which equals the O(nm) golden and
    the JAX package's (penalty and CIGAR)."""
    pairs = _pairs(11, n=20, hi=48)[:-1]
    out = tw.wfa_affine_align_pairs([p[0] for p in pairs],
                                    [p[1] for p in pairs], device="cpu")
    want = jw.wfa_affine_align_pairs([p[0] for p in pairs],
                                     [p[1] for p in pairs])
    assert out == want
    for (a, b), (pen, cig) in zip(pairs, out):
        assert pen == tw.affine_penalty_golden(a, b, x=4, o=6, e=2)
        assert tw.cigar_penalty(cig, a, b, x=4, o=6, e=2) == pen
        assert sum(n for n, op in cig if op in "MD") == len(a)
        assert sum(n for n, op in cig if op in "MI") == len(b)


def test_traceback_single_ops_wildcards_and_censoring():
    a = b"ACGTACGTACGT"
    cases = [(a, a), (a, a[:4] + b"T" + a[5:]), (a, a[:6] + a[8:]),
             (a[:6] + a[8:], a)]
    out = tw.wfa_affine_align_pairs([c[0] for c in cases],
                                    [c[1] for c in cases], device="cpu")
    assert out[0] == (0, [(12, "M")])
    assert out[1] == (4, [(12, "M")])
    assert out[2][0] == 10 and [c for c in out[2][1] if c[1] != "M"] == \
        [(2, "D")]
    assert out[3][0] == 10 and [c for c in out[3][1] if c[1] != "M"] == \
        [(2, "I")]
    ref = b"ACGTACGT" + b"0" * 8 + b"TTGGCCAA"
    read = b"ACGTACGT" + b"GATCGATC" + b"TTGGCCAA"
    assert tw.wfa_affine_align_pairs([ref], [read], wildcards=True,
                                     device="cpu") == [(0, [(24, "M")])]
    assert tw.wfa_affine_align_pairs([ref], [read], device="cpu")[0][0] == 32
    rng = np.random.default_rng(2)
    x, y = rng.choice(BASES, 40).tobytes(), rng.choice(BASES, 40).tobytes()
    assert tw.wfa_affine_align_pairs([x], [y], smax=6, device="cpu") == \
        [(7, None)]


def test_affine2p_traceback_is_optimal():
    """The dual-affine fill + walk + replay: CIGAR penalties equal the
    5-plane golden; a long deletion stays one gap."""
    pairs = _pairs(13, n=20, hi=48)
    host = _arrays(pairs, 32, 48)
    pen, _ops, fwd, fin, runs = tk.wfa_align(
        *(torch.from_numpy(v) for v in host), smax=300, model="affine2p",
        **PEN)
    skels = tw.WfaAligner._decode_walk(fwd.numpy(), fin.numpy(), len(pairs))
    cigars = _decoded(host, runs, fin)
    for (a, b), p, sk, got in zip(pairs, pen.tolist(), skels, cigars):
        want = tw.affine2p_penalty_golden(a, b, x=4, o1=6, e1=2, o2=24, e2=1)
        assert p == want
        cig = tw.wfa_replay_cigar(a, b, sk)
        assert got == cig
        assert tw.cigar_penalty_2p(cig, a, b, x=4, o1=6, e1=2, o2=24,
                                   e2=1) == want


def _run_cases():
    rng = np.random.default_rng(17)
    row = rng.choice(BASES, 4224).tobytes()
    a = rng.choice(BASES, 40).tobytes()
    return {
        # M runs as long as a rung's row, whole and split by one op
        "rows_of_4224": ([(row, row), (row, row[:2000] + b"T" + row[2001:]),
                          (row, row[:3000] + row[3007:])], 64),
        # skeletons that start or end with a gap
        "gaps_at_the_ends": ([(a, a[7:]), (a, a + b"ACGTAC"), (a[5:], a),
                              (a + b"TTT", a), (b"ACGT" + a, a + b"GG")], 96),
        # pairs of length 0 and 1
        "short": ([(b"", b"A"), (b"A", b""), (b"A", b"A"), (b"A", b"C"),
                   (b"", b""), (b"AC", b"")], 32),
    }


RUN_CASES = _run_cases()


@pytest.mark.parametrize("wild", [False, True])
@pytest.mark.parametrize("model", tk.MODELS)
@pytest.mark.parametrize("case", list(RUN_CASES))
def test_plain_runs_decode_to_the_replay(case, model, wild):
    """wfa_align's runs on the CPU decode (as the engine decodes them) to
    the JAX package's replay of the walk's skeletons, lane for lane."""
    pairs, smax = RUN_CASES[case]
    W = max(1, max(max(len(a), len(b)) for a, b in pairs))
    host = _arrays(pairs, len(pairs), W)
    pen, _ops, fwd, fin, runs = tk.wfa_align(
        *(torch.from_numpy(v) for v in host), smax=smax, model=model,
        wildcards=wild, **PEN)
    assert (fin.numpy() == -1).all()
    got = _decoded(host, runs, fin)
    assert got == _replayed(host, fwd, fin, wild)
    for (a, b), cig in zip(pairs, got):
        assert sum(n for n, op in cig if op in "MD") == len(a)
        assert sum(n for n, op in cig if op in "MI") == len(b)


def test_decode_runs_raises_as_the_replay():
    """A lane whose replay did not end at (l1, l2) raises wfa_replay_cigar's
    ValueError: in the plain version, and when the kernel's fault words
    are decoded; a walk that did not converge raises RuntimeError."""
    a = b"ACGT"
    with pytest.raises(ValueError) as want:
        tw.wfa_replay_cigar(a, a, ["X"])
    host = [torch.from_numpy(v) for v in _arrays([(a, a), (a, a)], 2, 4)]
    fwd = torch.zeros((2, 9), dtype=torch.uint8)
    fin = torch.tensor([-1, -1], dtype=torch.int32)
    assert tk.wfa_runs_reference(*host, fwd, fin, width=9)[:, :2].tolist() \
        == [[4 << 2, 0]] * 2
    fwd[0, 0] = ord("X")
    with pytest.raises(ValueError) as plain:
        tk.wfa_runs_reference(*host, fwd, fin, width=9)
    assert str(plain.value) == str(want.value)
    # the kernel's words for that lane: where its replay ended, then the 0
    runs = np.zeros((2, 9), np.int32)
    runs[0, :2] = 5 << 2 | tk.RUN_FAULT
    runs[1, 0] = 4 << 2
    lens = [(4, 4), (4, 4)]
    with pytest.raises(ValueError) as got:
        tw._decode_runs(runs, fin.numpy(), lens)
    assert str(got.value) == str(want.value)
    assert tw._decode_runs(runs[1:], fin.numpy()[1:], lens[1:]) == \
        [[(4, "M")]]
    assert tw._decode_runs(runs, np.array([-2, -1]), lens) == \
        [None, [(4, "M")]]
    with pytest.raises(RuntimeError, match="failed to converge"):
        tw._decode_runs(runs, np.array([-2, 3]), lens)


def _aligner_pairs(seed, n, L, sv_every=0):
    rng = np.random.default_rng(seed)
    refs, reads = [], []
    for i in range(n):
        ref = rng.choice(BASES, L).tobytes()
        read = bytearray(ref)
        for p in rng.choice(L, max(1, L // 40), replace=False):
            read[p] = BASES[rng.integers(4)]
        if sv_every and i % sv_every == 0:
            start = 40 + int(rng.integers(40))
            del read[start:start + 40]
        refs.append(ref)
        reads.append(bytes(read))
    return refs, reads


ALIGNERS = {
    "affine": dict(),
    "affine2p_sv": dict(model="affine2p"),
    "escalation": dict(s0=2),
    "kband": dict(kband=4),
    "adaptive_64": dict(adaptive=64),
    "adaptive_2_affine2p": dict(adaptive=2, model="affine2p"),
    "mem_cap": dict(budget=800_000),
    "waves_affine2p": dict(budget=1 << 16, model="affine2p"),
}


@pytest.mark.parametrize("case", list(ALIGNERS))
def test_aligner_matches_jax(case, monkeypatch):
    """WfaAligner.align_pairs: the JAX engine's (ref, read, CIGAR, score)
    for every pair, through escalation, the heuristic band, the trim, a
    binding memory cap and one-chunk waves."""
    kw = dict(ALIGNERS[case])
    budget = kw.pop("budget", None)
    if budget is not None:
        monkeypatch.setenv("CLIQUE_WFA_MEM_BUDGET", str(budget))
    # a floor chunk of the SV pairs' ceiling exceeds the capped affine
    # budget (the JAX engine's bialign route), so that case has none
    refs, reads = _aligner_pairs(5, 40 if case == "mem_cap" else 24, 150,
                                 sv_every=0 if case == "mem_cap" else 3)
    port = tw.WfaAligner(device="cpu", **kw)
    if case == "mem_cap":
        assert port._mem_cap(256, 64) == 32     # the budget binds
    got = port.align_pairs(refs, reads)
    want = jw.WfaAligner(**kw).align_pairs(refs, reads)
    assert got == want
    assert port.dispatches > 0 and port.fallbacks == 0
    # on the CPU every CIGAR comes from the plain replay, one a walked lane
    assert port.cigars_from_card == 0
    assert port.cigars_replayed == port.rung_lanes \
        - port.rung_lanes_censored + port.leaf_pairs


def test_aligner_dp_fallback_matches_jax():
    """Pairs censored past 2 L go to the DP fallback (affine) or rerun at
    a guaranteed ceiling (affine2p), as in the JAX engine; pairs past the
    run-table width go straight to the DP."""
    rng = np.random.default_rng(9)
    refs, reads = _aligner_pairs(6, 6, 100)
    # censored at a first ceiling past 2 L = 256 (penalty 480 affine, 288
    # affine2p)
    refs.append(b"A" * 120)
    reads.append(b"C" * 120)
    sc = AffineScoring.aligner_default()
    jsc = JaxAffineScoring.aligner_default()
    for model in ("affine", "affine2p"):
        port = tw.WfaAligner(model=model, s0=260, device="cpu",
                             dp_fallback=BatchAligner(sc, 16, device="cpu"))
        got = port.align_pairs(refs, reads)
        jax_ = jw.WfaAligner(model=model, s0=260,
                             dp_fallback=JaxBatchAligner(jsc, 16))
        assert got == jax_.align_pairs(refs, reads)
        assert port.fallbacks == jax_.fallbacks == 1

    class FakeDP:
        def __init__(self):
            self.seen = []

        def align_pairs(self, refs, reads):
            self.seen.extend(refs)
            return [(r, d, [(len(r), "M")], 1.0) for r, d in zip(refs, reads)]

    long_seq = rng.choice(BASES, 33000).tobytes()
    dp = FakeDP()
    engine = tw.WfaAligner(dp_fallback=dp, device="cpu")
    out = engine.align_pairs([long_seq, b"ACGTACGT"],
                             [long_seq, b"ACGAACGT"])
    assert engine.fallbacks == 1 and dp.seen == [long_seq]
    assert out[0][3] == 1.0 and out[1][2] == [(8, "M")]


def test_bialign_branches_raise(monkeypatch):
    """Both routes of the engine to its bialign engine give the JAX
    engine's (ref, read, CIGAR, score): a 64 KiB op-store budget sends
    every rung there (nothing is dispatched to wfa_align), and with no DP
    fallback a pair censored past 2 L finishes there."""
    refs, reads = _aligner_pairs(5, 8, 150, sv_every=3)
    with monkeypatch.context() as mp:
        mp.setenv("CLIQUE_WFA_MEM_BUDGET", str(1 << 16))
        eng = tw.WfaAligner(device="cpu")
        got = eng.align_pairs(refs, reads)
        assert got == jw.WfaAligner().align_pairs(refs, reads)
    assert eng.dispatches == 0 and eng.bialign_pairs == len(refs)
    # 70 substitutions in 128 bases: penalty 264, censored at the rungs
    # 129 and 258 = 2 L + 2, under the leaf's ceiling x + o + e * 128
    rng = np.random.default_rng(0)
    ref = rng.choice(BASES, 128)
    k = int(rng.integers(60, 72))
    pos = rng.choice(128, k, replace=False)
    read = ref.copy()
    read[pos] = BASES[(np.searchsorted(BASES, ref[pos])
                       + rng.integers(1, 4, k)) % 4]
    refs, reads = [ref.tobytes(), refs[0]], [read.tobytes(), reads[0]]
    eng = tw.WfaAligner(s0=129, device="cpu")
    got = eng.align_pairs(refs, reads)
    assert got == jw.WfaAligner(s0=129).align_pairs(refs, reads)
    assert eng.fallbacks == eng.bialign_pairs == 1
    assert got[0][3] == -264.0


@pytest.mark.parametrize("model", tk.MODELS)
def test_screen_matches_jax(model):
    refs, reads = [], []
    rng = np.random.default_rng(17)
    for i in range(40):
        r = rng.choice(BASES, int(rng.integers(30, 90))).tobytes()
        refs.append(r)
        reads.append(_mutate(rng, r, 0.08, 0.05) if i % 3 else
                     rng.choice(BASES, 60).tobytes())
    got = tw.wfa_screen_candidates(refs, reads, model=model, device="cpu")
    want = jw.wfa_screen_candidates(refs, reads, model=model)
    assert got.tolist() == np.asarray(want).tolist()
    assert (got > 64).any() and (got <= 64).any()


def test_screen_launches_exactly_its_pairs(monkeypatch):
    """The screen launches wfa_score on its P pairs, with no pad-up to a
    power of two (the JAX function's compile-reuse device)."""
    seen = []
    real = tk.wfa_score

    def record(*args, **kw):
        seen.append(args[0].shape[0])
        return real(*args, **kw)

    monkeypatch.setattr(tk, "wfa_score", record)
    rng = np.random.default_rng(5)
    refs = [rng.choice(BASES, 50).tobytes() for _ in range(37)]
    reads = [_mutate(rng, r, 0.05, 0.0) for r in refs]
    got = tw.wfa_screen_candidates(refs, reads, device="cpu")
    assert seen == [37] and got.shape == (37,)
    assert got.tolist() == np.asarray(
        jw.wfa_screen_candidates(refs, reads)).tolist()


def _two_amplicons(tmp_path, n_reads=8):
    """Two amplicons that differ in a 12 bp block A and a 6 bp block B;
    each read takes block A of its true reference and block B of the
    other, so the unique-kmer vote splits (no reference past 0.90), the
    exhaustive search runs, and the wavefront screen must route it by
    penalty."""
    rng = np.random.default_rng(31337)

    def rand_seq(n):
        return rng.choice(BASES, size=n).tobytes().decode()

    a1, a2, b1, b2 = rand_seq(12), rand_seq(12), rand_seq(6), rand_seq(6)
    spacer = rand_seq(20)

    def amp(a, b, umi="0" * 12):
        return A5 + umi + a + spacer + b + A3

    umi = """
    umi_configurations:
      umi:
        symbol: '0'
        sort_type: "DegenerateTag"
        length: 12
        order: 0
        max_distance: 2"""
    (tmp_path / "layout.yaml").write_text(f"""
known_strand: true
reads:
  - !Read1
    orientation: Forward
references:
  amp1:
    sequence: "{amp(a1, b1)}"{umi}
  amp2:
    sequence: "{amp(a2, b2)}"{umi}
""")
    fq = tmp_path / "reads.fastq.gz"
    with gzip.open(fq, "wt") as fh:
        for i in range(n_reads):
            read = amp(a1, b2, rand_seq(12)) if i % 2 == 0 else \
                amp(a2, b1, rand_seq(12))
            fh.write(f"@t{i % 2}_{i}\n{read}\n+\n{'I' * len(read)}\n")
    return str(fq)


@pytest.mark.parametrize("engine", ["wfa", "convex"])
def test_exhaustive_routing_matches_jax(engine, tmp_path):
    """align_reads over the two-amplicon panel: every read takes the
    screened exhaustive path, routes to its true reference, and the BAM
    equals the JAX package's."""
    import json

    from clique_tpu_torch.io.sam import BamReader

    fq = _two_amplicons(tmp_path)
    layout, rm = load_layout(tmp_path / "layout.yaml")
    out_t, out_j = str(tmp_path / "t.bam"), str(tmp_path / "j.bam")
    metrics = tmp_path / "m.json"
    stats = align_reads(layout, rm, out_t, read1=fq, batch_size=8,
                        engine=engine, device="cpu",
                        metrics_path=str(metrics))
    stats_j = jax_align_reads(*load_jax_layout(tmp_path / "layout.yaml"),
                              out_j, read1=fq, batch_size=8, engine=engine)
    assert dataclasses.asdict(stats) == dataclasses.asdict(stats_j)
    assert _inflate_bgzf(out_t) == _inflate_bgzf(out_j)
    with BamReader(out_t) as reader:
        recs = list(reader)
    assert len(recs) == 8
    for rec in recs:
        assert rec.reference_name == ("amp1" if rec.name.startswith("t0")
                                      else "amp2")
    m = json.loads(metrics.read_text())
    assert m["engine"] == engine and m["wfa_screened_reads"] == 8
    assert m["wfa_dp_fallbacks"] == 0


@pytest.fixture(scope="module")
def golden_engine_runs(tmp_path_factory):
    mg = _load_make_golden()
    runs = {}
    for engine in ("wfa", "convex"):
        wd = tmp_path_factory.mktemp(engine)
        gd, layout, rm, r1, _r2 = _golden_inputs(mg, "golden", wd)
        out = str(wd / "aligned.bam")
        metrics = wd / "m.json"
        stats = align_reads(layout, rm, out, read1=r1, batch_size=16,
                            engine=engine, device="cpu",
                            metrics_path=str(metrics))
        runs[engine] = (gd, wd, r1, out, stats, metrics)
    return runs


@pytest.mark.parametrize("engine", ["wfa", "convex"])
def test_golden_engine_bam_pinned(golden_engine_runs, engine):
    """align_reads(engine=...) on golden reproduces
    tests/data/golden/aligned_<engine>.bam byte for byte."""
    import json

    gd, _wd, _r1, out, stats, metrics = golden_engine_runs[engine]
    assert stats.aligned == stats.total > 0
    assert _inflate_bgzf(out) == _inflate_bgzf(
        os.path.join(gd, f"aligned_{engine}.bam"))
    m = json.loads(metrics.read_text())
    assert m["wfa_phase_seconds"]["dispatch"] >= 0
    assert m["kernel_launches"]["wfa_align"] == 0      # the CPU's plain run
    # every CIGAR from the plain host replay, one a walked lane
    assert m["wfa_cigars_from_card"] == 0
    assert m["wfa_cigars_replayed"] == m["wfa_rung_lanes"] \
        - m["wfa_rung_lanes_censored"] + m["wfa_leaf_pairs"] > 0


@pytest.mark.parametrize("engine", ["wfa", "convex"])
def test_cli_align_engine_golden(golden_engine_runs, engine):
    """`align --engine wfa|convex` exits 0 and writes the pinned bytes."""
    gd, wd, r1, _out, _stats, _m = golden_engine_runs[engine]
    out = wd / "cli.bam"
    assert cli.main(["align", "--read-structure", str(wd / "layout.yaml"),
                     "--read1", r1, "--output-bam-file", str(out),
                     "--batch-size", "16", "--device", "cpu", "--engine",
                     engine]) == 0
    assert _inflate_bgzf(str(out)) == _inflate_bgzf(
        os.path.join(gd, f"aligned_{engine}.bam"))


def test_run_chain_wfa_matches_jax_align_then_collapse(tmp_path):
    """`run --engine wfa` (align -> collapse fused through the sink's
    AlignedRead path) gives the collapsed bytes of the JAX package's
    align_reads(engine="wfa") followed by its collapse."""
    from clique_tpu.collapse.pipeline import collapse as jax_collapse
    from clique_tpu_torch.chain import run_chain

    mg = _load_make_golden()
    _gd, layout, rm, r1, _r2 = _golden_inputs(mg, "golden", tmp_path)
    a_t, c_t = str(tmp_path / "a_t.bam"), str(tmp_path / "c_t.bam")
    run_chain(layout, rm, a_t, c_t, read1=r1, batch_size=16, engine="wfa",
              device="cpu")
    a_j, c_j = str(tmp_path / "a_j.bam"), str(tmp_path / "c_j.bam")
    jl, jrm = load_jax_layout(tmp_path / "layout.yaml")
    jax_align_reads(jl, jrm, a_j, read1=r1, batch_size=16, engine="wfa")
    jax_collapse(c_j, jl, a_j)
    assert _inflate_bgzf(a_t) == _inflate_bgzf(a_j)
    assert _inflate_bgzf(c_t) == _inflate_bgzf(c_j)


def test_convex_structural_deletion_matches_jax(tmp_path):
    """A 40 bp dropout under --engine convex: one 40D run, the JAX
    package's BAM."""
    rng = np.random.default_rng(8)

    def rand_seq(n):
        return rng.choice(BASES, size=n).tobytes().decode()

    amp = A5 + "0" * 12 + TARGET + rand_seq(60) + A3
    (tmp_path / "layout.yaml").write_text(f"""
known_strand: true
reads:
  - !Read1
    orientation: Forward
references:
  amp1:
    sequence: "{amp}"
    umi_configurations:
      umi:
        symbol: '0'
        sort_type: "DegenerateTag"
        length: 12
        order: 0
        max_distance: 2
""")
    umi = rand_seq(12)
    full = A5 + umi + TARGET + amp[len(A5) + 12 + len(TARGET):]
    cut = len(A5) + 12 + len(TARGET) + 8
    read = full[:cut] + full[cut + 40:]
    fq = tmp_path / "r.fastq.gz"
    with gzip.open(fq, "wt") as fh:
        fh.write(f"@sv0\n{read}\n+\n{'I' * len(read)}\n")
    from clique_tpu_torch.io.sam import BamReader

    layout, rm = load_layout(tmp_path / "layout.yaml")
    out_t, out_j = str(tmp_path / "t.bam"), str(tmp_path / "j.bam")
    align_reads(layout, rm, out_t, read1=str(fq), batch_size=8,
                engine="convex", device="cpu")
    jax_align_reads(*load_jax_layout(tmp_path / "layout.yaml"), out_j,
                    read1=str(fq), batch_size=8, engine="convex")
    assert _inflate_bgzf(out_t) == _inflate_bgzf(out_j)
    with BamReader(out_t) as reader:
        (rec,) = list(reader)
    assert [c for c in rec.cigar if c[1] == "D"] == [(40, "D")]
    assert rec.tags["e0"] == umi


def test_wrappers_check_their_inputs():
    t = torch.zeros((2, 8), dtype=torch.uint8)
    lens = torch.full((2,), 8, dtype=torch.int32)
    with pytest.raises(ValueError, match="unknown WFA"):
        tk.wfa_align(t, t, lens, lens, smax=8, model="linear")
    with pytest.raises(TypeError):
        tk.wfa_score(t.int(), t, lens, lens, smax=8)
    with pytest.raises(ValueError, match="outside"):
        tk.wfa_align(t, t, lens + 1, lens, smax=8)
    with pytest.raises(ValueError, match="unsupported device"):
        tk.wfa_score(t.to("meta"), t.to("meta"), lens.to("meta"),
                     lens.to("meta"), smax=8)


def _dead_op_bytes(ops, la, lb, kmax, model, strict=False):
    """(step, lane, diagonal index) of every non-zero op byte outside the
    live band of csrc/wfa_align.cu: |k| <= min(s, kmax, reach(s)) with
    reach(s) the widest |k| a penalty of s pays for (max over the gap
    classes of (s - o_g) // e_g), and -l2 - 1 <= k <= l1 + 1 (strict:
    -l2 <= k <= l1)."""
    ops = np.asarray(ops)
    s = np.arange(ops.shape[0])[:, None, None]
    k = np.arange(ops.shape[2])[None, None, :] - kmax
    reach = np.maximum(0, (s - PEN["o"]) // PEN["e"])
    if model == "affine2p":
        reach = np.maximum(reach, np.maximum(0, (s - PEN["o2"]) // PEN["e2"]))
    r = np.minimum(np.minimum(s, kmax), reach)
    edge = 0 if strict else 1
    live = (np.abs(k) <= r) & (k >= -lb[None, :, None] - edge) & \
        (k <= la[None, :, None] + edge)
    return np.argwhere((ops != 0) & ~live)


@pytest.mark.parametrize("option", ["exact", "kband", "adaptive"])
@pytest.mark.parametrize("model", tk.MODELS)
def test_live_band_holds_every_op_byte(model, option):
    """The invariant the kernels' live band rests on: every non-zero op
    byte of the JAX package's wfa_affine_tb_batch / wfa_affine2p_tb_batch
    and of the port's wfa_fill_reference, at every step, lies inside the
    band, with and without kband and the wf-adaptive trim. Pairs of very
    different lengths set the op bits of k = l1 + 1 and -l2 - 1 (a gap
    extended from the rectangle's edge), which the band keeps."""
    pairs = _pairs(5)
    rng = np.random.default_rng(6)
    for n in (3, 5, 9):
        a = rng.choice(BASES, 50).tobytes()
        pairs += [(a[:n], a), (a, a[:n])]
    W, smax = 64, 96
    host = _arrays(pairs, len(pairs), W)
    kband = 5 if option == "kband" else None
    adaptive = 3 if option == "adaptive" else None
    kmax = tk.kmax_of(model, W, W, smax, PEN["o"], PEN["e"], PEN["o2"],
                      PEN["e2"], kband)
    _j_pen, j_ops = _jax_fill(model, host, W, smax, True, kband, adaptive)
    _p_pen, p_ops = tk.wfa_fill_reference(
        *(torch.from_numpy(v) for v in host), smax=smax, model=model,
        wildcards=True, kband=kband, adaptive=adaptive, **PEN)
    for ops in (np.asarray(j_ops), p_ops.numpy()):
        assert ops.shape[2] == 2 * kmax + 1
        assert len(_dead_op_bytes(ops, host[2], host[3], kmax, model)) == 0
    if option == "exact":
        assert len(_dead_op_bytes(p_ops.numpy(), host[2], host[3], kmax,
                                  model, strict=True)) > 0


@pytest.mark.parametrize("pen", [PEN, dict(x=3, o=10, e=1, o2=40, e2=3),
                                 dict(x=300, o=6, e=2, o2=24, e2=1),
                                 dict(x=1, o=6, e=2, o2=24, e2=2)],
                         ids=["default", "other", "wide-mismatch", "x1"])
@pytest.mark.parametrize("model", tk.MODELS)
def test_ring_heights_cover_their_lookbacks(model, pen):
    """M (and PM) is read x and o_g + e_g steps back, I_g and D_g (PI, PD)
    e_g: each plane keeps its longest lookback plus the steps of a barrier
    interval, which is 2 only where no lookback is shorter than 2 and no
    trim runs between the steps."""
    classes = tk.gap_classes(model, pen["o"], pen["e"], pen["o2"], pen["e2"])
    least = min([pen["x"]] + [e for _o, e in classes])
    for adaptive in (False, True):
        steps = tk.steps_of(model, pen["x"], pen["e"], pen["e2"], adaptive)
        assert steps == (2 if least >= 2 and not adaptive else 1)
        heights = tk.ring_heights(model, **pen, steps=steps)
        assert heights[0] == max([pen["x"]] + [o + e for o, e in classes]) \
            + steps
        assert list(heights[1:]) == [e + steps for _o, e in classes]
        plan = tk.wfa_plan("align", model, 64, 64, 8, 96, 45, **pen,
                           adaptive=adaptive)
        assert (plan.steps, plan.heights) == (steps, heights)
        assert plan.rows == heights[0] + 2 * sum(heights[1:])
    hm, he = tk.ring_heights("affine", **pen, steps=tk.steps_of(
        "affine", pen["x"], pen["e"], pen["e2"]))
    mid = tk.wfa_plan("mid", "affine", 64, 64, 8, 96, 45, **pen)
    assert (mid.heights, mid.rows, mid.value_bytes) == ((hm, he), hm + 2 * he,
                                                         2)


@pytest.mark.parametrize("K", [1, 3, 91, 1019, 2043, 4091])
def test_plan_slices_cover_the_diagonals_once(K):
    """Every cluster size that holds the rings splits the K diagonals into
    contiguous slices of cw (CTA r holds r * cw .. r * cw + cw - 1), each
    diagonal in one CTA, no CTA past the last diagonal's."""
    kmax = (K - 1) // 2
    for C in tk.CLUSTER_SIZES:
        try:
            plan = tk.wfa_plan("score", "affine", 64, 64, 8, 2 * K + 8,
                               kmax, **PEN, cluster=C)
        except ValueError:
            continue          # this C cannot hold the rings
        owned = [range(r * plan.cw, min(K, (r + 1) * plan.cw))
                 for r in range(C)]
        assert [k for ks in owned for k in ks] == list(range(K))
        assert plan.cw * C >= K > plan.cw * (C - 1) or K < C
        assert plan.threads <= tk.MAX_THREADS and plan.threads % 32 == 0
        assert plan.smem <= tk.SMEM_LIMIT


def _smem_of(kind, n1, n2, smax, K, C, rows, value_bytes):
    """A CTA's shared memory at C slices: sequences, control words, then
    the larger of its rings and the walk's ops."""
    walk = (smax + 4) // 4 * 4 if kind == "align" else 0
    rings = -(-value_bytes * rows * (-(-K // C) + 2) // 4) * 4
    return tk.seq_bytes(n1) + tk.seq_bytes(n2) + 4 * tk.CTRL_INTS + \
        max(rings, walk)


# (kind, model, n1 = n2, B, smax, penalties) -> the plan's C (0: rings in
# the global workspace): the ont-raw rung chunks, the 2,112 rung's
# one-pair chunk, a bialign leaf chunk, wfa_mid at the top rung, the hifi
# and screen launches, the convex rerun of an L = 384 bucket, and the
# CUDA tests' global shapes
PLAN_SHAPES = [
    ("align", "affine", 4096, 64, 1024, PEN, 1),
    ("align", "affine", 4096, 32, 2048, PEN, 2),
    ("align", "affine", 4224, 1, 2112, PEN, 8),
    ("align", "affine", 512, 64, 1034, PEN, 1),
    ("mid", "affine", 4224, 991, 4096, PEN, 1),
    ("align", "affine", 384, 512, 96, PEN, 1),
    ("score", "affine", 114, 4096, 64, PEN, 1),
    ("align", "affine2p", 384, 32, 1024, PEN, 2),
    ("align", "affine2p", 384, 32, 1024, dict(PEN, x=300), 0),
    ("mid", "affine", 1280, 6, 2300, dict(PEN, x=300), 0),
]


@pytest.mark.parametrize("shape", PLAN_SHAPES,
                         ids=[f"{s[0]}-{s[1]}-L{s[2]}-B{s[3]}-s{s[4]}-x"
                              f"{s[5]['x']}" for s in PLAN_SHAPES])
def test_plan_cluster_sizes_and_the_global_workspace(shape):
    """wfa_align and wfa_score: C is the least cluster size whose CTAs fit
    SMEM_LIMIT, doubled while a CTA would hold more than MAX_THREADS
    diagonals and B * 2C <= SMS / 2; the global workspace takes exactly
    the shapes past a cluster of 8. wfa_mid: one CTA a pair in a
    persistent grid, its int16 rings in shared memory where they fit. A
    persistent grid has at most B CTAs, whose workspaces L2 holds
    together."""
    kind, model, L, B, smax, pen, want = shape
    kmax = tk.kmax_of(model, L, L, smax, pen["o"], pen["e"], pen["o2"],
                      pen["e2"])
    K = 2 * kmax + 1
    plan = tk.wfa_plan(kind, model, L, L, B, smax, kmax, **pen)
    if plan.wp:
        # wfa_score's warp path (its rule: test_plan_warp_path_*); the CTA
        # layout below still holds for the same launch with the path off
        assert kind == "score" and plan.C == want == 1 and plan.cw == K
        assert plan.smem == plan.wp * tk.warp_slice(L, L, plan.rows, K) \
            <= tk.SMEM_LIMIT
        plan = tk.wfa_plan(kind, model, L, L, B, smax, kmax, warp=False,
                           **pen)
        assert plan.wp == 0
    smem = {C: _smem_of(kind, L, L, smax, K, C, plan.rows, plan.value_bytes)
            for C in tk.CLUSTER_SIZES}
    walk = (smax + 4) // 4 * 4 if kind == "align" else 0
    if plan.grid:
        assert 1 <= plan.grid <= B and plan.C == 1 and plan.cw == K
        assert plan.grid == 1 or \
            plan.grid * 4 * plan.ws_ints <= tk.L2_BYTES
    if kind == "mid":
        assert plan.grid and plan.ring_global == (smem[1] > tk.SMEM_LIMIT)
        assert plan.ws_ints == plan.rows * (K + 2) * (1 + plan.ring_global)
    else:
        assert plan.ring_global == (smem[8] > tk.SMEM_LIMIT) == \
            (plan.grid > 0)
    if plan.ring_global:
        assert want == 0
        assert plan.smem == 2 * tk.seq_bytes(L) + 4 * tk.CTRL_INTS + walk
        return
    assert plan.C == want
    assert plan.smem == smem[plan.C] <= tk.SMEM_LIMIT
    if kind == "mid":
        return
    least = min(C for C in tk.CLUSTER_SIZES if smem[C] <= tk.SMEM_LIMIT)
    assert plan.C == least or (-(-K // (plan.C // 2)) > tk.MAX_THREADS
                               and B * plan.C <= tk.SMS // 2)
    assert plan.C == 8 or -(-K // plan.C) <= tk.MAX_THREADS or \
        B * 2 * plan.C > tk.SMS // 2


@pytest.mark.parametrize("model", tk.MODELS)
def test_plan_warp_path_takes_the_bands_a_warp_holds(model):
    """wfa_score takes the warp path where K <= WARP_MAX_K (at most four
    diagonals a lane): the screen's launch (K = 59 affine, 81 affine2p),
    K = 1 and 127; K = 129 and the bench_wfa launches (K = 187, 337) keep
    the CTA path, as do every wfa_align and wfa_mid launch and a forced
    cluster. WARP_PAIRS pairs a CTA, at most B."""
    kw = dict(PEN) if model == "affine2p" else dict(PEN, o2=0, e2=0)
    screen = tk.kmax_of(model, 114, 114, 64, kw["o"], kw["e"], kw["o2"],
                        kw["e2"])
    assert 2 * screen + 1 == (59 if model == "affine" else 81)
    for kmax, L, smax, warp in ((screen, 114, 64, True), (0, 114, 64, True),
                                (63, 114, 64, True), (64, 200, 128, False),
                                (93, 512, 192, False)):
        plan = tk.wfa_plan("score", model, L, L, 4096, smax, kmax, **kw)
        assert (plan.wp > 0) == warp == (2 * kmax + 1 <= tk.WARP_MAX_K)
        if warp:
            assert (plan.wp, plan.threads, plan.C, plan.grid) == \
                (tk.WARP_PAIRS, 32 * tk.WARP_PAIRS, 1, 0)
    bench = tk.kmax_of(model, 512, 512, 192, kw["o"], kw["e"], kw["o2"],
                       kw["e2"])
    assert 2 * bench + 1 == (187 if model == "affine" else 337)
    assert tk.wfa_plan("score", model, 512, 512, 1024, 192, bench,
                       **kw).wp == 0
    for B, wp in ((1, 1), (3, 3), (4, 4), (5, 4), (4096, 4)):
        assert tk.wfa_plan("score", model, 114, 114, B, 64, screen,
                           **kw).wp == wp
    assert tk.wfa_plan("align", model, 114, 114, 4096, 64, screen,
                       **kw).wp == 0
    assert tk.wfa_plan("score", model, 114, 114, 4096, 64, screen, **kw,
                       cluster=1).wp == 0
    assert tk.wfa_plan("score", model, 114, 114, 4096, 64, screen, **kw,
                       warp=False).wp == 0
    with pytest.raises(ValueError, match="warp path"):
        tk.wfa_plan("score", model, 200, 200, 8, 128, 64, **kw, warp=True)
    with pytest.raises(ValueError, match="warp path"):
        tk.wfa_plan("align", model, 114, 114, 8, 64, screen, **kw,
                    warp=True)
    assert tk.wfa_plan("mid", "affine", 114, 114, 4096, 64, screen,
                       **PEN).wp == 0


@pytest.mark.parametrize("L", [114, 20_000, 50_000, 120_000])
def test_plan_warp_path_slices_fit(L):
    """A warp's slice holds both sequences and every ring row of all K
    diagonals (16-byte steps); WARP_PAIRS slices a CTA while they fit
    SMEM_LIMIT, fewer past it, the CTA path where one does not fit."""
    kmax = 29
    K = 2 * kmax + 1
    plan = tk.wfa_plan("score", "affine", L, L, 4096, 64, kmax, **PEN)
    one = tk.warp_slice(L, L, plan.rows, K)
    assert one % 16 == 0
    assert one >= 2 * tk.seq_bytes(L) + 4 * plan.rows * (K + 2)
    assert one < 2 * tk.seq_bytes(L) + 4 * plan.rows * (K + 2) + 16
    if one > tk.SMEM_LIMIT:
        assert plan.wp == 0
        return
    assert plan.smem == plan.wp * one <= tk.SMEM_LIMIT
    assert plan.wp == tk.WARP_PAIRS or (plan.wp * 2 * one > tk.SMEM_LIMIT
                                        and plan.wp >= 1)
    assert plan.rows == plan.heights[0] + 2 * sum(plan.heights[1:])


def test_plan_refuses_what_the_rings_cannot_hold():
    """A lookback of 0 (x or an extend of 0) reads the row being written;
    a forced cluster too small for the rings, or a cluster for wfa_mid,
    is refused too."""
    for bad in (dict(PEN, x=0), dict(PEN, e=0)):
        with pytest.raises(ValueError, match=">= 1"):
            tk.wfa_plan("align", "affine", 64, 64, 8, 96, 45, **bad)
    with pytest.raises(ValueError, match=">= 1"):
        tk.wfa_plan("align", "affine2p", 64, 64, 8, 96, 72,
                    **dict(PEN, e2=0))
    with pytest.raises(ValueError, match="cannot hold"):
        tk.wfa_plan("align", "affine", 4224, 4224, 991, 4096, 2045, **PEN,
                    cluster=1)
    with pytest.raises(ValueError, match="one CTA"):
        tk.wfa_plan("mid", "affine", 4224, 4224, 991, 4096, 2045, **PEN,
                    cluster=2)
