"""The port's gap-linear wavefront penalty and WFA edit distance
(clique_tpu_torch/align/wavefront.py::wfa_linear_batch, wfa_edit_batch,
wfa_edit_distances; one wfa_score launch under the "linear" model, the
kernel's G = 0, whose plain version wfa_kernels.wfa_linear_reference runs
on CPU tensors) held against the JAX package's wfa_linear_batch,
wfa_edit_batch and wfa_edit_distances on the same seeded inputs, and
against plain DPs. Penalties are integers: every comparison is exact.

The edit and linear cases of tests/test_wavefront.py (:69-89, :405-438)
are ported here; the CUDA kernel itself is held by the cuda-marked case
at the end (skipped without a GPU)."""

import numpy as np
import pytest
import torch

from clique_tpu.align import wavefront as jwf
from clique_tpu_torch.align import wavefront as twf
from clique_tpu_torch.align import wfa_kernels as wk

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def _lev(a, b):
    m, n = len(a), len(b)
    d = np.zeros((m + 1, n + 1), dtype=int)
    d[:, 0] = np.arange(m + 1)
    d[0, :] = np.arange(n + 1)
    for i in range(1, m + 1):
        for j in range(1, n + 1):
            d[i, j] = min(d[i - 1, j] + 1, d[i, j - 1] + 1,
                          d[i - 1, j - 1] + (a[i - 1] != b[j - 1]))
    return d[m, n]


def _linear_penalty(a, b, x, e):
    m, n = len(a), len(b)
    d = np.zeros((m + 1, n + 1), dtype=int)
    d[:, 0] = np.arange(m + 1) * e
    d[0, :] = np.arange(n + 1) * e
    for i in range(1, m + 1):
        for j in range(1, n + 1):
            sub = 0 if a[i - 1] == b[j - 1] else x
            d[i, j] = min(d[i - 1, j] + e, d[i, j - 1] + e,
                          d[i - 1, j - 1] + sub)
    return d[m, n]


def _mutate(rng, seq, sub=0.05, indel=0.02):
    out = []
    for c in seq:
        r = rng.random()
        if r < indel / 2:
            continue
        if r < indel:
            out.append(int(rng.choice(BASES)))
        out.append(int(rng.choice(BASES)) if rng.random() < sub else c)
    return bytes(out)


def _batch(pairs_a, pairs_b, L):
    B = len(pairs_a)
    A = np.zeros((B, L), np.uint8)
    Bm = np.zeros((B, L), np.uint8)
    for i, (a, b) in enumerate(zip(pairs_a, pairs_b)):
        A[i, :len(a)] = np.frombuffer(a, np.uint8)
        Bm[i, :len(b)] = np.frombuffer(b, np.uint8)
    la = np.array([len(a) for a in pairs_a], np.int32)
    lb = np.array([len(b) for b in pairs_b], np.int32)
    return A, Bm, la, lb


def _np(t):
    return t.cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


# --- edit distance (test_wavefront.py:69-89) --------------------------------

def test_wfa_edit_random_pairs():
    rng = np.random.default_rng(11)
    pa, pb = [], []
    for _ in range(16):
        a = rng.choice(BASES, int(rng.integers(10, 60))).tobytes()
        pa.append(a)
        pb.append(_mutate(rng, a, sub=0.1, indel=0.06))
    got = twf.wfa_edit_distances(pa, pb, device="cpu")
    assert got.dtype == np.int32
    assert got.tolist() == np.asarray(jwf.wfa_edit_distances(pa, pb)).tolist()
    assert got.tolist() == [_lev(a, b) for a, b in zip(pa, pb)]


def test_wfa_edit_identical_and_empty_ish():
    rng = np.random.default_rng(12)
    s = rng.choice(BASES, 40).tobytes()
    for a, b, want in ((s, s, 0), (s, s[:-3], 3), (s, b"", 40), (b"", s, 40)):
        got = twf.wfa_edit_distances([a], [b], device="cpu")
        assert got.tolist() == [want]
        assert got.tolist() == np.asarray(
            jwf.wfa_edit_distances([a], [b])).tolist()


def test_wfa_edit_censoring():
    a = b"A" * 30
    b = b"T" * 30
    got = twf.wfa_edit_distances([a], [b], smax=5, device="cpu")
    assert got.tolist() == [6]  # censored at smax + 1
    assert got.tolist() == np.asarray(
        jwf.wfa_edit_distances([a], [b], smax=5)).tolist()
    assert twf.wfa_edit_distances([], [], device="cpu").shape == (0,)


@pytest.mark.parametrize("L,smax,ragged", [
    (48, 96, False), (64, 20, True), (33, 8, True), (100, 0, False),
], ids=["full", "narrow-ragged", "censoring", "smax0"])
def test_wfa_edit_batch_matches_jax(L, smax, ragged):
    """The port's edit route (the linear fill at x = e = 1) against the JAX
    wfa_edit_batch itself, whose clamp and Kmax differ in form from
    wfa_linear_batch's: ragged lengths (empty rows included), censored
    pairs, smax 0."""
    rng = np.random.default_rng(L * 7 + smax)
    pa, pb = [], []
    for _ in range(24):
        n = int(rng.integers(0, L + 1)) if ragged else L
        a = rng.choice(BASES, n).tobytes()
        pa.append(a)
        pb.append(_mutate(rng, a, sub=0.15, indel=0.1)[:L])
    A, Bm, la, lb = _batch(pa, pb, L)
    want = np.asarray(jwf.wfa_edit_batch(A, Bm, la, lb, n1=L, n2=L,
                                         smax=smax))
    got = twf.wfa_edit_batch(A, Bm, la, lb, n1=L, n2=L, smax=smax,
                             device="cpu")
    assert got.dtype == torch.int32 and got.device.type == "cpu"
    assert _np(got).tolist() == want.tolist()
    lev = np.array([_lev(a, b) for a, b in zip(pa, pb)])
    assert want.tolist() == np.where(lev <= smax, lev, smax + 1).tolist()


# --- gap-linear (test_wavefront.py:405-438) ---------------------------------

@pytest.mark.parametrize("x,e", [(4, 2), (3, 1), (2, 5)])
def test_wfa_linear_random_pairs(x, e):
    rng = np.random.default_rng(100 * x + e)
    L = 48
    refs, reads = [], []
    for _ in range(12):
        a = rng.choice(BASES, int(rng.integers(12, L))).tobytes()
        refs.append(a)
        reads.append(_mutate(rng, a, sub=0.12, indel=0.08)[:L])
    A, Bm, la, lb = _batch(refs, reads, L)
    want = np.asarray(jwf.wfa_linear_batch(A, Bm, la, lb, n1=L, n2=L,
                                           smax=256, x=x, e=e))
    got = twf.wfa_linear_batch(A, Bm, la, lb, n1=L, n2=L, smax=256, x=x,
                               e=e, device="cpu")
    assert _np(got).tolist() == want.tolist()
    assert want.tolist() == [_linear_penalty(a, b, x, e)
                             for a, b in zip(refs, reads)]


def test_wfa_linear_censoring_and_identity():
    a = np.frombuffer(b"ACGTACGTACGT", np.uint8)[None, :].copy()
    la = np.array([12], np.int32)
    got = twf.wfa_linear_batch(a, a, la, la, n1=12, n2=12, smax=16, x=4,
                               e=2, device="cpu")
    assert _np(got).tolist() == [0]
    b = np.frombuffer(b"TGCATGCATGCA", np.uint8)[None, :].copy()
    got = twf.wfa_linear_batch(a, b, la, la, n1=12, n2=12, smax=7, x=4, e=2,
                               device="cpu")
    assert _np(got).tolist() == [8]  # censored at smax + 1
    assert _np(got).tolist() == np.asarray(jwf.wfa_linear_batch(
        a, b, la, la, n1=12, n2=12, smax=7, x=4, e=2)).tolist()


@pytest.mark.parametrize("case", ["wildcards", "kband", "ragged"])
def test_wfa_linear_options_match_jax(case):
    """wildcards ('N' and bytes below '0' + 10 match anything), the
    heuristic kband, and ragged lengths with empty rows: the port equals
    the JAX function."""
    rng = np.random.default_rng({"wildcards": 1, "kband": 2,
                                 "ragged": 3}[case])
    L = 64
    pa, pb = [], []
    for _ in range(20):
        n = int(rng.integers(0, L + 1)) if case == "ragged" else L - 4
        a = rng.choice(BASES, n).tobytes()
        b = bytearray(_mutate(rng, a, sub=0.1, indel=0.08)[:L])
        if case == "wildcards":
            for i in range(len(b)):
                if rng.random() < 0.05:
                    b[i] = ord("N")
        pa.append(a)
        pb.append(bytes(b))
    A, Bm, la, lb = _batch(pa, pb, L)
    kw = dict(n1=L, n2=L, smax=150, x=4, e=2,
              wildcards=case == "wildcards",
              kband=3 if case == "kband" else None)
    want = np.asarray(jwf.wfa_linear_batch(A, Bm, la, lb, **kw))
    got = twf.wfa_linear_batch(A, Bm, la, lb, device="cpu", **kw)
    assert _np(got).tolist() == want.tolist()


def test_plain_linear_reference_through_wfa_score():
    """wfa_kernels.wfa_score(model="linear") on CPU tensors is the plain
    version, wfa_linear_reference; its affine siblings refuse the model."""
    rng = np.random.default_rng(5)
    L = 40
    pa = [rng.choice(BASES, L).tobytes() for _ in range(8)]
    pb = [_mutate(rng, a, sub=0.1, indel=0.05)[:L] for a in pa]
    args = [torch.from_numpy(t) for t in _batch(pa, pb, L)]
    a = wk.wfa_score(*args, smax=100, model="linear", x=3, e=2)
    b = wk.wfa_linear_reference(*args, smax=100, x=3, e=2)
    assert torch.equal(a, b)
    assert a.tolist() == [_linear_penalty(p, q, 3, 2) for p, q in
                          zip(pa, pb)]
    with pytest.raises(ValueError):
        wk.wfa_align(*args, smax=100, model="linear")
    with pytest.raises(ValueError):
        wk.wfa_fill_reference(*args, smax=100, model="linear")


def test_linear_plan_and_layout():
    """wfa_plan's gap-linear layout: the M ring alone (max(x, e) + steps
    rows), two steps a barrier where x and e are both >= 2, the warp path
    where K <= 128; the kernel's layout arguments carry 0 for the absent
    I and D rings. The gap-linear model is wfa_score's only."""
    p = wk.wfa_plan("score", "linear", 512, 512, 256, 256, 128, 4, 0, 2, 0, 0)
    assert p.heights == (6,) and p.rows == 6 and p.steps == 2
    assert p.wp == 0 and p.C == 1 and p.smem == (
        wk.seq_bytes(512) * 2 + 4 * wk.CTRL_INTS + 4 * 6 * (257 + 2))
    e = wk.wfa_plan("score", "linear", 512, 512, 256, 102, 102, 1, 0, 1, 0, 0)
    assert e.heights == (2,) and e.steps == 1
    w = wk.wfa_plan("score", "linear", 48, 48, 64, 60, 60, 1, 0, 1, 0, 0)
    assert w.wp == wk.WARP_PAIRS and w.rows == 2
    assert wk._layout_args(p) == (2, 6, 0, 0, 1, 0, 0)
    assert wk.kmax_of("linear", 512, 512, 256, 0, 2, 0, 0) == 128
    assert wk.kmax_of("linear", 10, 10, 256, 0, 1, 0, 0) == 20
    assert wk.hist_of("linear", 4, 0, 2, 0, 0) == 5
    for kind in ("align", "mid"):
        with pytest.raises(ValueError):
            wk.wfa_plan(kind, "linear", 48, 48, 8, 60, 60, 1, 0, 1, 0, 0)


@pytest.mark.cuda
def test_linear_kernel_matches_plain_on_cuda():
    """The G = 0 kernel on the card equals its plain version at the smoke
    shape (B = 256, L = 512, 5% substitutions) for edit distance and for
    x = 4, e = 2, and on ragged pairs on the warp path."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    refs = rng.choice(BASES, (256, 512)).astype(np.uint8)
    reads = refs.copy()
    subs = rng.random(refs.shape) < 0.05
    reads[subs] = rng.choice(BASES, int(subs.sum()))
    lens = np.full(256, 512, np.int32)
    args = [torch.from_numpy(t).to(dev) for t in (refs, reads, lens, lens)]
    for smax, x, e in ((102, 1, 1), (256, 4, 2)):
        got = wk.wfa_score(*args, smax=smax, model="linear", x=x, e=e)
        want = wk.wfa_linear_reference(*args, smax=smax, x=x, e=e)
        assert torch.equal(got, want)
    pa = [rng.choice(BASES, int(rng.integers(0, 48))).tobytes()
          for _ in range(64)]
    pb = [_mutate(rng, a, sub=0.1, indel=0.1) for a in pa]
    args = [torch.from_numpy(t).to(dev) for t in _batch(pa, pb, 48)]
    got = wk.wfa_score(*args, smax=60, model="linear", x=1, e=1)
    assert torch.equal(got, wk.wfa_linear_reference(*args, smax=60, x=1,
                                                    e=1))
