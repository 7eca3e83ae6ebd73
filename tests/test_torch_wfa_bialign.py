"""The port's bialign engine (clique_tpu_torch/align/wfa_kernels.py's
midpoint fill, align/wavefront.py's splitting and WfaAligner's routes
to it) on the CPU, held against the JAX package's
clique_tpu/align/wavefront.py: the cases of tests/test_wavefront_bialign.py
and the bialign length cap of tests/test_wfa_engine.py.

Both sides take the same byte pairs, made from a numpy seed. Penalties,
split payloads and CIGAR lists are integers and compare for equality;
the O(nm) golden DP (affine_penalty_golden) checks optimality besides.
Pairs stay short (a few hundred bases) so the plain fills and the JAX
compiles stay small.
"""

import numpy as np
import pytest
import torch

from clique_tpu.align import wavefront as jw
from clique_tpu_torch.align import wavefront as tw
from clique_tpu_torch.align import wfa_kernels as tk

X, O, E = 4, 6, 2
PEN = dict(x=X, o=O, e=E)


def _mutate(rng, seq: bytes, sub_p=0.05, ind_p=0.02) -> bytes:
    bases = b"ACGT"
    out = bytearray()
    for c in seq:
        r = rng.random()
        if r < ind_p / 2:
            continue                       # deletion
        if r < ind_p:
            out.append(bases[rng.integers(4)])   # insertion
        if rng.random() < sub_p:
            out.append(bases[rng.integers(4)])
        else:
            out.append(c)
    return bytes(out)


def _rand(rng, n: int) -> bytes:
    return bytes(bytes(b"ACGT")[i] for i in rng.integers(0, 4, n))


def _mid_both(pairs, smax, wildcards=False):
    """(penalties, payloads) of the JAX midpoint fill (32-lane padded, as
    its tests run it) and of wfa_mid on CPU tensors (unpadded), over
    [B, L] rows, L = max(64, longest)."""
    L = max(64, max(max(len(a), len(b)) for a, b in pairs))
    P = len(pairs)
    a, b, la, lb = tw._pad_pairs([p[0] for p in pairs],
                                 [p[1] for p in pairs], max(32, P), L)
    jp, jq = jw.wfa_affine_mid_batch(a, b, la, lb, n1=L, n2=L, smax=smax,
                                     wildcards=wildcards, **PEN)
    n = tk.wfa_mid_launches
    tp, tq = tk.wfa_mid(*(torch.from_numpy(t[:P]) for t in (a, b, la, lb)),
                        smax=smax, wildcards=wildcards, **PEN)
    assert tk.wfa_mid_launches == n            # the plain version ran
    return (np.asarray(jp)[:P].tolist(), np.asarray(jq)[:P].tolist(),
            tp.tolist(), tq.tolist())


def test_mid_penalty_and_payload_match_jax_and_golden():
    """Random mutated pairs: penalties and payloads equal the JAX
    function's; penalties equal the golden DP's."""
    rng = np.random.default_rng(7)
    pairs = []
    for _ in range(12):
        a = _rand(rng, int(rng.integers(20, 200)))
        pairs.append((a, _mutate(rng, a)))
    jp, jq, tp, tq = _mid_both(pairs, 256)
    assert (tp, tq) == (jp, jq)
    for (a, b), pen, pay in zip(pairs, tp, tq):
        assert pen == jw.affine_penalty_golden(a, b, **PEN)
        assert pay >= 0


def test_mid_split_is_on_an_optimal_path():
    """The reported cell lies at/before the middle anti-diagonal, and the
    halves' optimal penalties sum to the pair's (the JAX payloads too)."""
    rng = np.random.default_rng(11)
    pairs = []
    for _ in range(10):
        a = _rand(rng, int(rng.integers(30, 160)))
        pairs.append((a, _mutate(rng, a, sub_p=0.1, ind_p=0.05)))
    jp, jq, tp, tq = _mid_both(pairs, 512)
    assert (tp, tq) == (jp, jq)
    for (a, b), pen, pay in zip(pairs, tp, tq):
        h, v = pay // tk.MID_ENC, pay % tk.MID_ENC
        assert 0 <= h <= len(a) and 0 <= v <= len(b)
        assert h + v <= (len(a) + len(b)) // 2
        left = jw.affine_penalty_golden(a[:h], b[:v], **PEN)
        right = jw.affine_penalty_golden(a[h:], b[v:], **PEN)
        assert left + right == pen


def test_mid_identical_wildcard_and_censored_pairs():
    """An identical pair splits at its centre; wildcard bytes extend as
    matches; pairs past the ceiling report smax + 1 and payload -1; an
    all-gap-bound pair and one-base pairs; every lane equals JAX's."""
    rng = np.random.default_rng(13)
    ident = b"ACGTACGTACGTACGT" * 4
    wild = b"ACGT" + b"0" * 8 + b"TTTTGGGG"
    far = _rand(rng, 90)
    pairs = [(ident, ident), (wild, b"ACGT" + b"CCAACCAA" + b"TTTTGGGG"),
             (b"A" * 40, b"C" * 40), (far, _mutate(rng, far, 0.3, 0.1)),
             (b"A", b"C"), (b"ACGT" * 10, b"ACGT" * 3)]
    got = {}
    for smax, wildcards in ((24, False), (24, True), (300, True)):
        jp, jq, tp, tq = _mid_both(pairs, smax, wildcards)
        assert (tp, tq) == (jp, jq)
        assert all((p > smax) == (q < 0) for p, q in zip(tp, tq))
        got[smax, wildcards] = tp, tq
    tp, tq = got[300, True]
    assert tp[0] == 0 and tq[0] == 32 * tk.MID_ENC + 32
    assert tp[1] == 0                   # the wildcard zone matches
    tp, tq = got[24, False]
    assert tp[1] > 0 and tp[2] == 25 and tq[2] == -1   # censored


@pytest.mark.parametrize("leaf", [32, 48, 64])
def test_bialign_random_pairs_match_jax(leaf):
    """wfa_bialign_affine_pairs equals the JAX package's list for list; every
    penalty is the golden optimum and every CIGAR replays to it, covers
    both sequences and has merged runs."""
    rng = np.random.default_rng(23)
    pairs_a, pairs_b = [], []
    for _ in range(16):
        a = _rand(rng, int(rng.integers(10, 300)))
        pairs_a.append(a)
        pairs_b.append(_mutate(rng, a, sub_p=0.08, ind_p=0.04))
    n = tk.wfa_mid_launches
    out = tw.wfa_bialign_affine_pairs(pairs_a, pairs_b, leaf=leaf,
                                      device="cpu", **PEN)
    assert tk.wfa_mid_launches == n
    assert out == jw.wfa_bialign_affine_pairs(pairs_a, pairs_b, leaf=leaf,
                                              **PEN)
    for a, b, (pen, cig) in zip(pairs_a, pairs_b, out):
        assert pen == jw.affine_penalty_golden(a, b, **PEN)
        assert tw.cigar_penalty(cig, a, b, **PEN) == pen
        assert sum(n for n, op in cig if op in "MD") == len(a)
        assert sum(n for n, op in cig if op in "MI") == len(b)
        assert all(cig[i][1] != cig[i + 1][1] for i in range(len(cig) - 1))


def test_bialign_agrees_with_direct_engine():
    """The split engine and the direct traceback engine report the same
    penalties (both the JAX package's)."""
    rng = np.random.default_rng(31)
    pairs_a, pairs_b = [], []
    for _ in range(8):
        a = _rand(rng, int(rng.integers(100, 400)))
        pairs_a.append(a)
        pairs_b.append(_mutate(rng, a))
    lo = tw.wfa_bialign_affine_pairs(pairs_a, pairs_b, leaf=64,
                                     device="cpu", **PEN)
    hi = tw.wfa_affine_align_pairs(pairs_a, pairs_b, device="cpu", **PEN)
    assert lo == jw.wfa_bialign_affine_pairs(pairs_a, pairs_b, leaf=64,
                                             **PEN)
    for (pl, cl), (ph, ch) in zip(lo, hi):
        assert pl == ph and cl is not None and ch is not None


def test_bialign_edge_cases():
    pairs = ([b"", b"ACGT", b"", b"A"], [b"ACGT", b"", b"", b"A"])
    out = tw.wfa_bialign_affine_pairs(*pairs, device="cpu", **PEN)
    assert out[0] == (O + 4 * E, [(4, "I")])
    assert out[1] == (O + 4 * E, [(4, "D")])
    assert out[2] == (0, [])
    assert out[3] == (0, [(1, "M")])
    assert out == jw.wfa_bialign_affine_pairs(*pairs, **PEN)


def test_bialign_long_center_gap():
    """A deletion longer than `leaf` forces the degenerate-split fallback
    on a segment; the result stays optimal and equals the JAX package's."""
    rng = np.random.default_rng(47)
    flank1, flank2, gap = _rand(rng, 80), _rand(rng, 80), _rand(rng, 120)
    a = flank1 + gap + flank2
    b = flank1 + flank2
    out = tw.wfa_bialign_affine_pairs([a], [b], leaf=64, device="cpu",
                                      **PEN)
    assert out == jw.wfa_bialign_affine_pairs([a], [b], leaf=64, **PEN)
    pen, cig = out[0]
    assert pen == jw.affine_penalty_golden(a, b, **PEN)
    assert tw.cigar_penalty(cig, a, b, **PEN) == pen


def test_bialign_deep_recursion_small_leaf():
    """leaf far below the pair length: several split levels."""
    rng = np.random.default_rng(53)
    a = _rand(rng, 500)
    b = _mutate(rng, a, sub_p=0.06, ind_p=0.03)
    out = tw.wfa_bialign_affine_pairs([a], [b], leaf=32, device="cpu",
                                      **PEN)
    assert out == jw.wfa_bialign_affine_pairs([a], [b], leaf=32, **PEN)
    pen, cig = out[0]
    assert pen == jw.affine_penalty_golden(a, b, **PEN)
    assert tw.cigar_penalty(cig, a, b, **PEN) == pen


def test_bialign_wildcards():
    a = b"ACGT" + b"0" * 8 + b"TTTTGGGG"
    b = b"ACGT" + b"CCAACCAA" + b"TTTTGGGG"
    out = tw.wfa_bialign_affine_pairs([a], [b], wildcards=True, leaf=8,
                                      device="cpu", **PEN)
    assert out == jw.wfa_bialign_affine_pairs([a], [b], wildcards=True,
                                              leaf=8, **PEN)
    pen, cig = out[0]
    assert pen == 0
    assert tw.cigar_penalty(cig, a, b, wildcards=True, **PEN) == 0


def test_engine_routes_over_budget_pairs_to_bialign(monkeypatch):
    """A WfaAligner without a DP fallback finishes pairs whose op store
    passes CLIQUE_WFA_MEM_BUDGET on the bialign engine: the JAX engine's
    results, with the penalties of the unconstrained run."""
    rng = np.random.default_rng(61)
    refs, reads = [], []
    for _ in range(4):
        a = _rand(rng, 600)
        # heavy divergence and a structural deletion: a high penalty bound
        refs.append(a)
        reads.append(_mutate(rng, a[:240] + a[400:], sub_p=0.15,
                             ind_p=0.05))
    free = tw.WfaAligner(wildcards=False, device="cpu").align_pairs(refs,
                                                                    reads)
    monkeypatch.setenv("CLIQUE_WFA_MEM_BUDGET", str(1 << 20))
    tight = tw.WfaAligner(wildcards=False, device="cpu")
    got = tight.align_pairs(refs, reads)
    assert tight.bialign_pairs == len(refs) and tight.dispatches == 0
    assert got == jw.WfaAligner(wildcards=False).align_pairs(refs, reads)
    for a, b, (_, _, _, sc_f), (ra, da, cig, sc) in zip(refs, reads, free,
                                                        got):
        assert sc == sc_f
        assert tw.cigar_penalty(cig, a, b, **PEN) == -sc
        assert len(ra) == len(da)


def test_bialign_length_cap():
    """The routing predicate bounds the 128-quantized length, and the
    splitting refuses a pair at the cap before any fill, as the JAX
    package's (tests/test_wfa_engine.py:341-352)."""
    for n in (1, 32640, 32641, 32700, tk.MID_ENC):
        assert tw._bialign_len_ok(n) == jw._bialign_len_ok(n)
    assert tw._bialign_len_ok(32640) and not tw._bialign_len_ok(32641)
    n = tk.wfa_mid_launches
    with pytest.raises(ValueError, match="bialign split encoding"):
        tw.wfa_bialign_affine_pairs([b"A" * 32700], [b"A" * 32700],
                                    device="cpu")
    assert tk.wfa_mid_launches == n


def test_wfa_mid_checks_its_inputs():
    t = torch.zeros((2, 8), dtype=torch.uint8)
    lens = torch.full((2,), 8, dtype=torch.int32)
    with pytest.raises(TypeError):
        tk.wfa_mid(t.int(), t, lens, lens, smax=8)
    with pytest.raises(ValueError, match="outside"):
        tk.wfa_mid(t, t, lens + 1, lens, smax=8)
    with pytest.raises(ValueError, match="unsupported device"):
        tk.wfa_mid(t.to("meta"), t.to("meta"), lens.to("meta"),
                   lens.to("meta"), smax=8)


# the bialign engine's wfa_mid launches on 1,000 ONT raw reads of a 4 kb
# reference (chip_smoke.py's ont-raw phase): (B, L, smax), the 2x ladder
# of each split level
MID_LAUNCHES = [(991, 4224, s) for s in (256, 512, 1024, 2048, 4096)] + \
    [(1982, 2176, s) for s in (256, 512, 1024, 2048)] + \
    [(3964, 1152, s) for s in (256, 512, 1024)] + \
    [(259, 640, s) for s in (128, 256, 512)]


@pytest.mark.parametrize("launch", MID_LAUNCHES,
                         ids=[f"B{b}-L{n}-s{s}" for b, n, s in MID_LAUNCHES])
def test_mid_plan_at_the_engine_launches(launch):
    """Every wfa_mid launch of the bialign engine on ONT raw reads runs a
    persistent grid whose CTAs hold the int16 M, I and D rings in shared
    memory (two score steps a barrier at x 4, o 6, e 2: M 10 rows, I and D
    4) and their payload planes in a workspace that L2 holds for the
    whole grid."""
    B, L, smax = launch
    kmax = tk.kmax_of("affine", L, L, smax, O, E, 0, 0)
    K = 2 * kmax + 1
    plan = tk.wfa_plan("mid", "affine", L, L, B, smax, kmax, X, O, E, 0, 0)
    assert (plan.steps, plan.heights, plan.value_bytes) == (2, (10, 4), 2)
    assert not plan.ring_global and plan.C == 1 and plan.cw == K
    assert plan.smem == 2 * tk.seq_bytes(L) + 4 * tk.CTRL_INTS + \
        -(-2 * plan.rows * (K + 2) // 4) * 4 <= tk.SMEM_LIMIT
    assert plan.ws_ints == plan.rows * (K + 2)
    assert 1 <= plan.grid <= B and \
        plan.grid * 4 * plan.ws_ints <= tk.L2_BYTES
    assert plan.threads == min(tk.MID_THREADS, -(-K // 32) * 32)


def test_mid_int16_rings_hold_every_engine_length():
    """wfa_mid's int16 rings hold offsets up to the rows' widths, below
    32,767: the engine's length cap keeps every launch's rows there."""
    top = max(n for n in range(1, 1 << 15, 64) if tw._bialign_len_ok(n))
    assert -(-top // 128) * 128 < 32767
    assert not tw._bialign_len_ok(32767)
