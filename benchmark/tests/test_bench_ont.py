"""The ONT configuration (`ont_raw_4kb`, cell `ont_raw.wfa`) and the panel
on ONT-like reads (`panel180.ont`): the generator, the wavefront kernels'
counts, whole runs on the CPU at a small size with their per-layer
metrics, the controls that have to come out not correct, and the
manifest's entries for them.

On the CPU the op-store budget is lowered (CLIQUE_WFA_MEM_BUDGET) so that
a small run's reads take the route the configuration's 3.6 kb reads
take at the default budget: censored at two rungs, then finished on the
bialign engine. On
the card (`-m cuda`) the control runs at the cell's own size.
"""

import json
import os
import time

import numpy as np
import pytest

from benchlib import runner, wfa_band
from conftest import ROOT

CELL = "ont_raw.wfa"
SPAN_METRICS = ("wfa.bialign_host_us_per_read", "wfa.mid_wait_us_per_read",
                "wfa.rounds_us_per_read", "wfa.censored_pct")
# a 1,000 bp amplicon (rows of 1,024 bytes): the 256 and 512 rungs'
# 32-lane op stores fit 32 MiB, the 1,024 rung's does not
SMALL = {CELL: ({"reads": 8, "warmup_reads": 4, "check_reads": 6,
                 "batch_size": 16}, {"amplicon_length": 1000}),
         "panel180.ont": ({"reads_per_reference": 3, "check_reads": 12,
                           "batch_size": 8}, {"references": 6})}
BUDGET = 32 << 20


@pytest.fixture
def small(monkeypatch):
    monkeypatch.setenv("CLIQUE_WFA_MEM_BUDGET", str(BUDGET))

    def go(workload, seed=2 ** 31 + 2203, trace=False):
        cell, cfg = SMALL[workload]
        return runner.run(workload, seed, 0.0, trace, t_start=time.time(),
                          root=ROOT, device="cpu", cell_overrides=cell,
                          config_overrides=cfg)
    return go


def _failed(result):
    return [n for n, c in result["checks"].items() if c["value"] > c["limit"]]


# --- the generator -----------------------------------------------------------

def _config():
    with open(os.path.join(ROOT, "benchmark/configs/ont_raw_4kb.json")) as fh:
        return json.load(fh)


def _loop_read(rng, ref, bases, sub, dele, ins, indel, events):
    """The read model walked position by position from the generator's
    draws, counting its events."""
    n = len(ref)
    lo, hi = indel
    u = rng.random(n)
    draw = rng.choice(bases, (n, hi))
    shift = rng.integers(1, 4, n)
    span = rng.integers(lo, hi + 1, n)
    out = bytearray()
    i = 0
    while i < n:
        events["visited"] += 1
        if u[i] < sub:
            here = bytes(bases).index(ref[i])
            out.append(bases[(here + shift[i]) % 4])
            assert out[-1] != ref[i]
            events["substitution"] += 1
        elif u[i] < sub + dele:
            events["deletion"] += 1
            events["deleted_bases"] += int(span[i])
            i += int(span[i])
            continue
        elif u[i] < sub + dele + ins:
            events["insertion"] += 1
            events["inserted_bases"] += int(span[i])
            out += draw[i, :span[i]].tobytes()
            out.append(ref[i])
        else:
            out.append(ref[i])
        i += 1
    return bytes(out)


def test_generator_is_seeded(tmp_path):
    gen = runner.part("generators", "ont_amplicon")
    cfg = dict(_config(), amplicon_length=500)
    a = gen.generate(cfg, {"reads": 16}, 2 ** 33 + 5, str(tmp_path))
    b = gen.generate(cfg, {"reads": 16}, 2 ** 33 + 5, str(tmp_path))
    c = gen.generate(cfg, {"reads": 16}, 2 ** 33 + 6, str(tmp_path))
    assert a["reads"] == b["reads"] != c["reads"]
    assert a["references"] == b["references"] != c["references"]
    assert all(set(s) <= set(b"ACGT") for _n, s in a["reads"])
    with open(a["fastq"]) as fh:
        assert fh.read().count("\n") == 4 * 16


@pytest.mark.parametrize("indel_bases", [None, [1, 3]])
def test_generator_is_the_error_model_with_its_rates(indel_bases):
    """2,048 reads: each equals the loop's from the same draws, and each
    event's rate lies within 10% of the configuration's, as does each
    indel's mean length (the configuration's one base, and 1-3 bases)."""
    gen = runner.part("generators", "ont_amplicon")
    em = _config()["error_model"]
    if indel_bases is not None:
        em = dict(em, indel_bases=indel_bases)
    model = gen.read_model(em)
    rates, indel = model[:3], model[3]
    rng = np.random.default_rng(2 ** 32 + 1)
    ref = rng.choice(gen.BASES, 500)
    ev = dict.fromkeys(("visited", "substitution", "deletion", "insertion",
                        "deleted_bases", "inserted_bases"), 0)
    for k in range(2048):
        state = rng.bit_generator.state
        want = _loop_read(rng, ref, gen.BASES, *model, ev)
        rng.bit_generator.state = state
        assert gen.ont_read(rng, ref, *model).tobytes() == want, k
    for name, rate in zip(("substitution", "deletion", "insertion"), rates):
        assert abs(ev[name] / ev["visited"] / rate - 1) < 0.1, name
    for name, events in (("deleted_bases", "deletion"),
                         ("inserted_bases", "insertion")):
        assert abs(ev[name] / ev[events] / (sum(indel) / 2) - 1) < 0.1


# --- the counts --------------------------------------------------------------

NEG = -(1 << 30)


def _plain_wfa(a, b, x, o, e, smax):
    """The gap-affine wavefront by dictionaries: (penalty or smax + 1,
    the (s, k) of every finite M, I or D value)."""
    l1, l2 = len(a), len(b)

    def ok(h, k):
        return h <= l1 and 0 <= h - k <= l2

    def extend(h, k):
        while h < l1 and h - k < l2 and a[h] == b[h - k]:
            h += 1
        return h

    M, I, D = [{0: extend(0, 0)}], [{}], [{}]
    live = {(0, 0)}
    if l1 == l2 and M[0][0] >= l1:
        return 0, live

    def get(plane, s, k):
        return plane[s].get(k, NEG) if s >= 0 else NEG

    for s in range(1, smax + 1):
        m, ii, dd = {}, {}, {}
        for k in range(-l2 - 1, l1 + 2):
            i_v = max(get(M, s - o - e, k + 1), get(I, s - e, k + 1))
            d_v = max(get(M, s - o - e, k - 1), get(D, s - e, k - 1)) + 1
            m_v = max(get(M, s - x, k) + 1, i_v, d_v)
            if i_v > NEG // 2 and ok(i_v, k):
                ii[k] = i_v
            if d_v > NEG // 2 and ok(d_v, k):
                dd[k] = d_v
            if m_v > NEG // 2 and ok(m_v, k):
                m[k] = extend(m_v, k)
        M.append(m)
        I.append(ii)
        D.append(dd)
        live |= {(s, k) for k in set(m) | set(ii) | set(dd)}
        if m.get(l1 - l2, NEG) >= l1:
            return s, live
    return smax + 1, live


def _brute_band(n1, n2, smax, o, e, l1, l2, pen):
    kmax = min(n1 + n2, smax, max(0, (smax - o) // e))
    out = set()
    for s in range(min(pen, smax) + 1):
        reach = (s - o) // e if s > o else 0
        r = 0 if s == 0 else min(s, kmax, reach)
        out |= {(s, k) for k in range(-kmax, kmax + 1)
                if abs(k) <= r and -l2 - 1 <= k <= l1 + 1}
    return out


@pytest.mark.parametrize("kernel", ["wfa_align", "wfa_mid"])
def test_counts_are_the_live_band(kernel):
    """Each launch's cells are the brute count of the live band up to each
    lane's penalty (or ceiling), and every finite value of the plain
    wavefront lies in that band."""
    counts = runner.part("counts", kernel)
    rng = np.random.default_rng(77)
    gen = runner.part("generators", "ont_amplicon")
    x, o, e = 4, 6, 2
    for smax in (24, 48, 400):
        pairs = [(b"ACGTACGT", b"ACGTACGT"), (b"", b"ACG"),
                 (b"ACGTTGCA", b"")]
        for _ in range(6):
            a = rng.choice(gen.BASES, rng.integers(8, 30))
            pairs.append((a.tobytes(),
                          gen.ont_read(rng, a, 0.1, 0.05, 0.05).tobytes()))
        n1 = max(len(a) for a, _b in pairs)
        n2 = max(len(b) for _a, b in pairs)
        pens, want = [], 0
        for a, b in pairs:
            pen, live = _plain_wfa(a, b, x, o, e, smax)
            band = _brute_band(n1, n2, smax, o, e, len(a), len(b), pen)
            assert live <= band
            pens.append(pen)
            want += len(band)
        l1 = np.array([len(a) for a, _b in pairs])
        l2 = np.array([len(b) for _a, b in pairs])
        ops, nbytes = counts.work(n1, n2, smax, o, e, l1, l2,
                                  np.array(pens))
        assert ops == counts.OPS_PER_CELL * want
        assert nbytes > int(l1.sum() + l2.sum())
        assert wfa_band.cells(n1, n2, smax, o, e, l1, l2, pens) == want


def test_roofline_reads_the_int32_bound():
    from types import SimpleNamespace

    counts = runner.part("counts", "wfa_mid")
    args = (64, 64, 200, 6, 2, np.array([50]), np.array([60]),
            np.array([120]))
    acts = [("void clique_wfa::(anonymous namespace)::wfa_kernel<1, false, "
             "true, 2, short>(...)", 0.0, 10.0),
            ("void clique_wfa::(anonymous namespace)::wfa_kernel<1, true, "
             "false, 2, int>(...)", 0.0, 99.0)]
    ctx = SimpleNamespace(acts=acts, counts=lambda k: runner.part("counts",
                                                                  k))
    ops, nb = counts.work(*args)
    want = 100 * wfa_band.bound_s(ops, nb) / 10e-6
    assert wfa_band.roofline_pct(ctx, "wfa_mid", [args]) == \
        pytest.approx(want)
    assert wfa_band.bound_s(wfa_band.PEAK_INT32_OPS_PER_S, 0) == \
        pytest.approx(1)
    ctx.acts = []
    assert wfa_band.roofline_pct(ctx, "wfa_mid", [args]) is None


def test_reference_precision():
    """At the configuration's size the penalties (about 2,000-2,350) come
    out whole in float16, every value on an optimal path being an even
    integer under 4,096, and not in bfloat16, whose steps of 4 past 512
    swallow each gap extension of 2."""
    from reference import gap_affine
    import torch

    gen = runner.part("generators", "ont_amplicon")
    rng = np.random.default_rng(2 ** 31 + 4001)
    ref = rng.choice(gen.BASES, _config()["amplicon_length"])
    model = gen.read_model(_config()["error_model"])
    reads = [gen.ont_read(rng, ref, *model).tobytes() for _ in range(4)]
    refs = [ref.tobytes()] * 4
    exact = gap_affine.penalty(refs, reads, 4, 6, 2, "cpu")
    assert exact.min() > 1500
    half = gap_affine.penalty(refs, reads, 4, 6, 2, "cpu", torch.float16)
    assert (half == exact).all()
    bf16 = gap_affine.penalty(refs, reads, 4, 6, 2, "cpu", torch.bfloat16)
    assert np.abs(bf16 - exact).min() > 1000


# --- whole runs --------------------------------------------------------------

def test_ont_run_is_correct_and_reads_its_metrics(small):
    r = small(CELL, trace=True)
    assert r["correct"] and not _failed(r), r["checks"]
    assert r["attempted"] == 8 and r["failed"] == 0
    for name in SPAN_METRICS:
        v = r["metrics"][name]["value"]
        assert np.isfinite(v) and v >= 0, (name, v)
    # every lane of the first rung is censored, some of the second's may
    # finish there
    assert 50.0 < r["metrics"]["wfa.censored_pct"]["value"] <= 100.0
    # no device on the CPU: the kernels' and the device's metrics read
    # nothing
    assert "wfa_mid.roofline_pct" not in r["metrics"]


def test_panel_ont_run_is_correct(small):
    r = small("panel180.ont")
    assert r["correct"] and not _failed(r), r["checks"]
    assert r["attempted"] == 18 and r["failed"] == 0


def swap_a_leaf(monkeypatch):
    """Each bialign leaf chunk's first CIGAR replaced by a gap-only path
    over the same bases (all of the reference's, then all of the read's),
    its penalty left as it was."""
    from clique_tpu_torch.align import wavefront

    real = wavefront.wfa_affine_align_pairs

    def control(pairs_a, pairs_b, **kw):
        out = real(pairs_a, pairs_b, **kw)
        if out:
            pen, _cig = out[0]
            out[0] = (pen, [(len(pairs_a[0]), "D"), (len(pairs_b[0]), "I")])
        return out

    monkeypatch.setattr(wavefront, "wfa_affine_align_pairs", control)


def open_at_five(monkeypatch):
    """The program's gap open at 5 where the configuration states 6."""
    from clique_tpu_torch.align import wavefront

    real = wavefront.WfaAligner.__init__

    def control(self, *args, **kwargs):
        real(self, *args, **dict(kwargs, o=5))

    monkeypatch.setattr(wavefront.WfaAligner, "__init__", control)


def test_swapped_leaf_is_not_correct(small, monkeypatch):
    swap_a_leaf(monkeypatch)
    r = small(CELL)
    assert not r["correct"] and "cigar_mismatches" in _failed(r)


def test_gap_open_at_five_is_not_correct(small, monkeypatch):
    open_at_five(monkeypatch)
    r = small(CELL)
    assert not r["correct"]
    assert {"penalty_gap", "cigar_mismatches"} <= set(_failed(r))


@pytest.mark.cuda
def test_swapped_leaf_at_the_cell_size(cuda, monkeypatch, capsys):
    swap_a_leaf(monkeypatch)
    r = runner.run(CELL, 2 ** 31 + 2204, 0.0, False, t_start=time.time(),
                   root=ROOT, device=cuda)
    with capsys.disabled():
        print(f"\ncontrol {CELL}: {r['checks']}")
    assert not r["correct"] and "cigar_mismatches" in _failed(r)


# --- the manifest ------------------------------------------------------------

def test_manifest_entries():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        spec = json.load(fh)
    cfg = next(c for c in spec["configs"] if c["name"] == "ont_raw_4kb")
    assert cfg["reduced"] == [] and cfg["file"].endswith("ont_raw_4kb.json")
    conf = _config()
    assert conf["reduced"] == [] and conf["architecture"] is None
    assert {"amplicon_length", "error_model", "penalties"} <= \
        set(conf["sourced"])
    assert "sequence" in conf["assumed"]
    cells = {w["name"]: w for w in spec["workloads"]}
    assert cells["ont_raw.wfa"]["config"] == "ont_raw_4kb"
    assert cells["panel180.ont"]["config"] == "guide_panel_180"
    assert cells["ont_raw.wfa"]["chips"] == cells["panel180.ont"]["chips"] \
        == 1
    metrics = {m["name"]: m for m in spec["end_to_end"] + spec["per_layer"]}
    for name in ("wfa_mid.roofline_pct", "wfa_align.roofline_pct") + \
            SPAN_METRICS:
        assert metrics[name]["workloads"] == ["ont_raw.wfa"]
        assert metrics[name]["moves"] == "align_reads_per_s"
    for name in ("align_reads_per_s", "device.idle_pct", "setup.warmup_s"):
        assert {"ont_raw.wfa", "panel180.ont"} <= \
            set(metrics[name]["workloads"])
    for name in ("hmm_forward.roofline_pct", "dp_align.roofline_pct",
                 "align.host_post_us_per_read", "align.reader_us_per_read",
                 "router.host_us_per_read", "router.wait_us_per_read",
                 "router.overlap_pct"):
        assert "panel180.ont" in metrics[name]["workloads"]
        assert "ont_raw.wfa" not in metrics[name]["workloads"]
