"""The port's pair-HMM router (clique_tpu_torch.align.hmm) against the JAX
package's (clique_tpu/align/hmm.py), on the CPU, where the port runs its
plain version.

Tolerance: log-likelihoods to rtol 1e-6. The plain version is the JAX
scan step for step, with the same order of operations in every LSE and
the gap borders rounded as XLA's fused multiply-add, but XLA's CPU exp and
log differ from PyTorch's by one ulp on about a tenth of their inputs, so
a pair's LL can differ in its last bits (1.2e-7 relative at most here).
Routes (argmax) and SAM bytes must be identical.
"""

import gzip

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clique_tpu.align import hmm as jhmm
from clique_tpu.align.pipeline import align_reads as jax_align_reads
from clique_tpu.config.layout import SequenceLayout as JaxLayout
from clique_tpu.reference.manager import ReferenceManager as JaxRM
from clique_tpu_torch.align import hmm as thmm
from clique_tpu_torch.align.pipeline import align_reads
from clique_tpu_torch.config.layout import SequenceLayout
from clique_tpu_torch.reference.manager import ReferenceManager

RTOL = 1e-6


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The plain version is a loop of small tensor operations, one step a
    DP anti-diagonal: intra-op threads only contend with the other test
    workers, so each test runs it on one thread."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(saved)
BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
ALPHABET = np.frombuffer(b"ACGTACGTACGTN0123", dtype=np.uint8)


def _pairs(seed, B, n1, n2, long_pair=False):
    """Seeded ragged pairs: wildcard reference bytes (N, digits), N read
    bases, reads from their reference with 8% substitutions and a 5-base
    deletion, and the corner cases l1 = 0, l2 = 0 and both."""
    rng = np.random.default_rng(seed)
    refs = np.zeros((B, n1 - 1), np.uint8)
    reads = np.zeros((B, n2 - 1), np.uint8)
    l1 = rng.integers(1, n1, B).astype(np.int32)
    l2 = np.zeros(B, np.int32)
    if long_pair:
        l1[0] = n1 - 1
    for i in range(B):
        refs[i, :l1[i]] = rng.choice(ALPHABET, l1[i])
        src = refs[i, :l1[i]].copy()
        if i % 2 and len(src) > 20:
            cut = rng.integers(0, len(src) - 5)
            src = np.concatenate([src[:cut], src[cut + 5:]])
        src = src[:n2 - 1]
        sub = rng.random(len(src)) < 0.08
        src[sub] = rng.choice(np.frombuffer(b"ACGTN", np.uint8), sub.sum())
        reads[i, :len(src)] = src
        l2[i] = len(src)
    if not long_pair:
        l1[0], l2[1] = 0, 0
        l1[2] = l2[2] = 0
        l2[3] = n2 - 1
        reads[3] = rng.choice(BASES, n2 - 1)
    return refs, reads, l1, l2


def _jax_ll(refs, reads, l1, l2):
    return np.asarray(jhmm.hmm_forward_batch(
        refs, reads, l1, l2, jnp.asarray(jhmm.default_hmm_params()),
        n1=refs.shape[1] + 1, n2=reads.shape[1] + 1))


def _port_ll(refs, reads, l1, l2):
    return thmm.hmm_forward_batch(
        torch.from_numpy(refs), torch.from_numpy(reads),
        torch.from_numpy(l1), torch.from_numpy(l2),
        torch.from_numpy(thmm.default_hmm_params())).numpy()


@pytest.mark.parametrize("shape", [(16, 140, 150), (2, 6160, 24)],
                         ids=["ragged", "past_6144_rows"])
def test_forward_matches_jax(shape):
    """Ragged pairs with wildcards, N and the l1 = 0 / l2 = 0 corners; and
    pairs past 6,144 reference rows (the kernel's row bands)."""
    B, n1, n2 = shape
    args = _pairs(7, B, n1, n2, long_pair=n1 > 6144)
    want = _jax_ll(*args)
    got = _port_ll(*args)
    assert got.dtype == np.float32 and got.shape == (B,)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)


def test_empty_pairs_match_jax_exactly():
    """l1 = 0 and/or l2 = 0: the corner is a border cell (or the origin),
    LSE over NEG and one gap border, bit for bit."""
    refs = np.full((4, 30), ord("A"), np.uint8)
    reads = np.full((4, 30), ord("C"), np.uint8)
    l1 = np.array([0, 0, 17, 30], np.int32)
    l2 = np.array([0, 29, 0, 0], np.int32)
    want = _jax_ll(refs, reads, l1, l2)
    got = _port_ll(refs, reads, l1, l2)
    assert got[0] == 0.0
    np.testing.assert_array_equal(got, want)


def test_plain_version_refuses_lengths_past_the_rows():
    refs = np.zeros((2, 10), np.uint8)
    reads = np.zeros((2, 10), np.uint8)
    with pytest.raises(ValueError, match="lengths"):
        _port_ll(refs, reads, np.array([11, 3], np.int32),
                 np.array([2, 3], np.int32))


def test_wrapper_refuses_bad_inputs():
    t = torch.zeros((2, 8), dtype=torch.uint8)
    lens = torch.ones(2, dtype=torch.int32)
    p = torch.from_numpy(thmm.default_hmm_params())
    with pytest.raises(TypeError):
        thmm.hmm_forward_batch(t.int(), t, lens, lens, p)
    with pytest.raises(ValueError, match="one row"):
        thmm.hmm_forward_batch(t, t[:1], lens, lens, p)
    with pytest.raises(ValueError, match="6 entries"):
        thmm.hmm_forward_batch(t, t, lens, lens, p[:5])


def test_wrapper_on_cpu_runs_the_plain_version(monkeypatch):
    """A CPU tensor runs the plain version and counts no launch."""
    args = [torch.from_numpy(a) for a in _pairs(3, 6, 40, 40)]
    p = torch.from_numpy(thmm.default_hmm_params())
    thmm.reset_counts()
    got = thmm.hmm_forward_batch(*args, p)
    assert thmm.hmm_forward_launches == 0
    assert torch.equal(got, thmm.hmm_forward_batch_reference(*args, p))


def test_terms_match_the_jax_transitions():
    """The parameters bit for bit; the transitions within RTOL (PyTorch's
    log1p(-0.35000002) is the correctly rounded -0.43078294, XLA's is one
    ulp off it)."""
    p = thmm.default_hmm_params()
    np.testing.assert_array_equal(p, jhmm.default_hmm_params())
    t = thmm.hmm_terms(torch.from_numpy(p)).numpy()
    np.testing.assert_array_equal(t[:5], p[:5])
    lgo, lge = jnp.float32(p[3]), jnp.float32(p[4])
    np.testing.assert_allclose(
        t[5:], [np.float32(jnp.log1p(-2.0 * jnp.exp(lgo))),
                np.float32(jnp.log1p(-jnp.exp(lge)))], rtol=RTOL)


# The kernel's LSEs (csrc/hmm_forward.cu:94-110, lse3 and lse2) put 1.0f in
# the slot of the maximum instead of computing expf(0), and keep the plain
# version's order of summation: (ea + eb) + 1 when c is the maximum, else
# (1 + x) + y with x, y the other two in order; lse2 is 1 + exp(min - max).
# Transcribed here in float32, they must equal the plain _lse3 / _lse2
# (align/hmm.py, the JAX package's order) bit for bit: that is why the
# kernel still equals the plain version on the card.


def _kernel_lse3(a, b, c):
    m = torch.maximum(a, torch.maximum(b, c))
    cmax = c == m
    eu = torch.exp(torch.where(cmax | (a != m), a, b) - m)
    ev = torch.exp(torch.where(cmax, b, c) - m)
    one = torch.ones_like(m)
    return m + torch.log((torch.where(cmax, eu, one)
                          + torch.where(cmax, ev, eu))
                         + torch.where(cmax, one, ev))


def _kernel_lse2(a, b):
    m = torch.maximum(a, b)
    return m + torch.log(1.0 + torch.exp(torch.minimum(a, b) - m))


def _lse_operands(kind, n=4096):
    """Three seeded float32 operand vectors of log-likelihood size (-10^3
    to 0, NEG = -1e30 among them where the kind says)."""
    rng = np.random.default_rng(["random", "two_way_ties", "three_way_ties",
                                 "neg", "all_neg", "transitions"].index(kind))
    x = (-rng.gamma(2.0, 40.0, (3, n))).astype(np.float32)
    if kind == "two_way_ties":
        # each pair of slots tied, at the maximum and below it
        for k, (i, j) in enumerate(((0, 1), (0, 2), (1, 2))):
            rows = slice(k * n // 3, (k + 1) * n // 3)
            x[j, rows] = x[i, rows]
        low = rng.random(n) < 0.5
        x[:, low] = np.sort(x[:, low], axis=0)   # the tie need not be the max
    elif kind == "three_way_ties":
        x[1] = x[2] = x[0]
    elif kind == "neg":
        x[rng.random((3, n)) < 0.4] = thmm.NEG
    elif kind == "all_neg":
        x[:] = thmm.NEG
        x[:, : n // 2] = np.where(rng.random((3, n // 2)) < 0.5, thmm.NEG,
                                  x[:, : n // 2])
    elif kind == "transitions":
        # a cell's own operands: the diagonal plus t_mm / t_gc, the up and
        # left neighbours plus lgo / lge, NEG borders among them
        x[rng.random((3, n)) < 0.1] = thmm.NEG
        t = thmm.hmm_terms(torch.from_numpy(thmm.default_hmm_params()))
        x = torch.from_numpy(x)
        return (x[0] + t[5], x[1] + t[6], x[2] + t[6], x[0] + t[3],
                x[1] + t[4])
    x = torch.from_numpy(x)
    return x[0], x[1], x[2], x[0], x[1]


@pytest.mark.parametrize("kind", ["random", "two_way_ties", "three_way_ties",
                                  "neg", "all_neg", "transitions"])
def test_kernel_lse_without_the_max_exp_equals_plain(kind):
    a, b, c, d, e = _lse_operands(kind)
    for got, want in ((_kernel_lse3(a, b, c), thmm._lse3(a, b, c)),
                      (_kernel_lse2(d, e), thmm._lse2(d, e)),
                      (_kernel_lse2(e, d), thmm._lse2(e, d))):
        assert got.dtype == torch.float32
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def _noisy(rng, seq, sub=0.08, indel=0.03):
    out = bytearray()
    for b in seq:
        r = rng.random()
        if r < indel / 2:
            continue
        if r < indel:
            out.append(rng.choice(BASES))
        out.append(rng.choice(BASES) if rng.random() < sub else b)
    return bytes(out)


@pytest.mark.parametrize("restricted", [False, True],
                         ids=["whole_panel", "candidates"])
def test_route_matches_jax(restricted):
    """HmmRouter.route with and without candidates: the same ref ids and
    LLs within tolerance; an empty candidate list gives (-1, -inf)."""
    rng = np.random.default_rng(11)
    refs = [rng.choice(BASES, 70 + 5 * k).tobytes() for k in range(4)]
    refs.append(refs[0])                   # a tie: the first one wins
    reads = [_noisy(rng, refs[i % 4]) for i in range(10)] + [b"ACGTN012"]
    cands = None
    if restricted:
        cands = [[(i + 1) % 5, 4, 0][:1 + i % 3] for i in range(len(reads))]
        cands[5] = []
    got = thmm.HmmRouter(refs, device="cpu").route(reads, cands)
    want = jhmm.HmmRouter(refs).route(reads, cands)
    assert [r for r, _ll in got] == [r for r, _ll in want]
    np.testing.assert_allclose([ll for _r, ll in got],
                               [ll for _r, ll in want], rtol=RTOL)
    if restricted:
        assert got[5] == (-1, float("-inf"))
    else:
        assert all(r != 4 for r, _ll in got)


# the four cases of tests/test_hmm.py on the port

def _rand_seq(rng, n):
    return rng.choice(BASES, size=n).tobytes()


def test_forward_ll_prefers_true_reference():
    rng = np.random.default_rng(9)
    refs = [_rand_seq(rng, 80) for _ in range(4)]
    router = thmm.HmmRouter(refs, device="cpu")
    reads = [_noisy(rng, refs[i % 4]) for i in range(12)]
    for i, (ref_id, ll) in enumerate(router.route(reads)):
        assert ref_id == i % 4, f"read {i} routed to {ref_id}"
        assert np.isfinite(ll)


def test_forward_ll_exact_read_scores_higher_than_noisy():
    rng = np.random.default_rng(9)
    ref = _rand_seq(rng, 60)
    router = thmm.HmmRouter([ref], device="cpu")
    exact = router.route([ref])[0][1]
    noisy_ll = router.route([_noisy(rng, ref, sub=0.2)])[0][1]
    assert exact > noisy_ll


def test_forward_handles_wildcards():
    rng = np.random.default_rng(9)
    ref = b"ACGTACGTACGT" + b"0" * 10 + b"TTGGCCAATTGG"
    router = thmm.HmmRouter([ref], device="cpu")
    read = b"ACGTACGTACGT" + _rand_seq(rng, 10) + b"TTGGCCAATTGG"
    ref_id, ll = router.route([read])[0]
    assert ref_id == 0
    assert np.isfinite(ll)


def test_candidates_restriction():
    rng = np.random.default_rng(9)
    refs = [_rand_seq(rng, 50) for _ in range(3)]
    router = thmm.HmmRouter(refs, device="cpu")
    read = _noisy(rng, refs[0])
    assert router.route([read], candidates=[[1, 2]])[0][0] in (1, 2)


@pytest.fixture(scope="module")
def panel(tmp_path_factory):
    """tests/test_multiref.py's three-amplicon panel (seed 31)."""
    rng = np.random.default_rng(31)
    tmp = tmp_path_factory.mktemp("panel")
    cores = [rng.choice(BASES, 70).tobytes().decode() for _ in range(3)]
    refs_yaml = "\n".join(
        f"""  amp{i}:
    sequence: "{core}{'0' * 10}"
    targets: []
    target_types: []
    umi_configurations:
      umi:
        symbol: '0'
        sort_type: "DegenerateTag"
        length: 10
        order: 0
        max_distance: 2"""
        for i, core in enumerate(cores))
    layout_path = tmp / "layout.yaml"
    layout_path.write_text(f"""
known_strand: true
reads:
  - !Read1
    orientation: Forward
references:
{refs_yaml}
""")
    fq = tmp / "reads.fastq.gz"
    truth = {}
    with gzip.open(fq, "wt") as fh:
        for i in range(30):
            k = i % 3
            umi = rng.choice(BASES, 10).tobytes().decode()
            read = "".join(chr(rng.choice(BASES)) if rng.random() < 0.05
                           else c for c in cores[k]) + umi
            truth[f"r{i}"] = k
            fh.write(f"@r{i}\n{read}\n+\n{'I' * len(read)}\n")
    return tmp, str(layout_path), str(fq), truth


def test_panel_router_hmm_matches_jax(panel):
    """The panel through align_reads(router="hmm") in both packages: the
    same SAM bytes, every read aligned, >= 90% routed to its amplicon."""
    tmp, layout_path, fq, truth = panel
    layout = SequenceLayout.from_yaml(layout_path)
    out_t, out_j = tmp / "torch.sam", tmp / "jax.sam"
    stats = align_reads(layout, ReferenceManager.from_layout(layout),
                        str(out_t), read1=fq, batch_size=8, router="hmm",
                        device="cpu")
    jlayout = JaxLayout.from_yaml(layout_path)
    jax_align_reads(jlayout, JaxRM.from_layout(jlayout), str(out_j),
                    read1=fq, batch_size=8, router="hmm")
    assert out_t.read_bytes() == out_j.read_bytes()
    assert stats.aligned == len(truth)
    lines = [ln.split("\t") for ln in out_t.read_text().splitlines()
             if not ln.startswith("@")]
    right = sum(f[2] == f"amp{truth[f[0]]}" for f in lines)
    assert right >= 0.9 * len(truth), f"{right}/{len(truth)}"


def test_panel_router_hmm_metrics(panel):
    """The align metrics name the router and count no kernel launch on the
    CPU."""
    import json

    tmp, layout_path, fq, _truth = panel
    layout = SequenceLayout.from_yaml(layout_path)
    mpath = tmp / "m.json"
    align_reads(layout, ReferenceManager.from_layout(layout),
                str(tmp / "m.bam"), read1=fq, batch_size=8, router="hmm",
                device="cpu", metrics_path=str(mpath))
    m = json.loads(mpath.read_text())
    assert m["router"] == "hmm"
    assert m["kernel_launches"]["hmm_forward"] == 0
