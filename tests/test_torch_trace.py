"""The port's spans (clique_tpu_torch/utils/trace.py) and what the verbs
record with them: nesting and self time on any thread, the "spans" of the
align and collapse metrics JSON with the views kept from the timers they
replaced, the profiler ranges they open, and outputs that do not depend on
whether a profiler runs."""

import json
import os
import sys
import threading
import time

import pytest
import torch

from clique_tpu_torch.align.pipeline import align_reads
from clique_tpu_torch.chain import run_chain
from clique_tpu_torch.collapse.pipeline import collapse
from clique_tpu_torch.utils import trace
from clique_tpu_torch.utils.trace import span

from clique_tpu_torch.config.layout import SequenceLayout
from clique_tpu_torch.reference.manager import ReferenceManager

from test_torch_align_pipeline import (_golden_inputs, _inflate_bgzf,
                                       _load_make_golden)
from test_torch_wfa_ont import BUDGET as WFA_BUDGET
from test_torch_wfa_ont import ont_run

# the spans of the dp engine's align path, the sink's and the router's
ALIGN_SPANS = {"align.run", "align.read", "align.flush", "align.drain_put",
               "align.tail", "align.join", "align.drain", "align.pull",
               "align.build", "align.write"}
SINK_SPANS = {"align.sink", "align.build_put"}
ROUTER_SPANS = {"router.route", "router.wait"}
COLLAPSE_SPANS = {"collapse.level", "collapse.outputs", "collapse.group_sort",
                  "collapse.consensus", "collapse.records",
                  "collapse.encode_join"}
# the wavefront engine's spans: its call, the rung ladder's rounds, waits
# and walks (a decode and a replay each), and the bialign engine with its
# levels and leaf chunks
WFA_SPANS = {"wfa.align_pairs", "wfa.round", "wfa.wait", "wfa.walk",
             "wfa.decode", "wfa.replay", "wfa.bialign", "wfa.mid",
             "wfa.mid_wait", "wfa.leaves"}
WFA_PARENTS = {"wfa.round": "wfa.align_pairs", "wfa.wait": "wfa.align_pairs",
               "wfa.walk": "wfa.align_pairs", "wfa.decode": "wfa.walk",
               "wfa.replay": "wfa.walk",
               "wfa.bialign": "wfa.align_pairs", "wfa.mid": "wfa.bialign",
               "wfa.mid_wait": "wfa.bialign", "wfa.leaves": "wfa.bialign"}
PHASE_WALLS = {"reader_wall", "flush_wall", "drain_wall", "tail_wall",
               "join_wall", "drain_busy", "build_busy", "write_busy"}


def _sleep_ms(ms):
    time.sleep(ms / 1e3)


def _nest():
    with span("outer"):
        _sleep_ms(20)
        with span("inner"):
            _sleep_ms(30)
        with span("inner"):
            with span("leaf"):
                _sleep_ms(10)


def _check_nesting(t):
    assert t["outer"]["n"] == 1 and t["inner"]["n"] == 2
    assert t["leaf"]["n"] == 1
    # self time: the span less its children on the same thread
    assert t["outer"]["self_s"] == pytest.approx(
        t["outer"]["s"] - t["inner"]["s"], abs=2e-6)
    assert t["inner"]["self_s"] == pytest.approx(
        t["inner"]["s"] - t["leaf"]["s"], abs=2e-6)
    assert t["leaf"]["self_s"] == t["leaf"]["s"]
    assert t["outer"]["s"] >= 0.059 and 0.019 <= t["outer"]["self_s"] < 0.05
    assert t["leaf"]["s"] >= 0.0099


def test_nesting_and_self_time_on_the_main_thread():
    with trace.recording() as rec:
        _nest()
    _check_nesting(rec.tallies())


def test_nesting_and_self_time_on_a_worker_thread():
    """A bound worker's spans tally into the run's recorder with parents
    from its own stack: the main thread's open span is no parent of
    them."""
    with trace.recording() as rec:
        with span("main"):
            t = threading.Thread(target=rec.bind(_nest))
            t.start()
            t.join(timeout=30)
            assert not t.is_alive()
    tallies = rec.tallies()
    _check_nesting(tallies)
    assert tallies["main"]["self_s"] == tallies["main"]["s"]


def test_span_outside_a_run_measures_only_itself():
    with span("alone") as sp:
        _sleep_ms(5)
    assert sp.seconds >= 0.0049
    with trace.recording() as rec:
        pass
    with span("after"):
        pass
    assert rec.tallies() == {}


def test_recordings_nest_and_restore():
    with trace.recording() as outer:
        with span("a"):
            with trace.recording() as inner:
                with span("b"):
                    pass
            with span("c"):
                pass
    assert set(inner.tallies()) == {"b"}
    assert set(outer.tallies()) == {"a", "c"}
    # b belonged to the inner run: no child time of a
    t = outer.tallies()
    assert t["a"]["self_s"] == pytest.approx(t["a"]["s"] - t["c"]["s"],
                                             abs=2e-6)


def test_tracing_follows_the_profiler_on_the_starting_thread():
    with trace.recording() as rec:
        assert not rec.tracing
    with trace.recording(tracing=True) as rec:
        assert rec.tracing
    with torch.profiler.profile() as prof:
        with trace.recording() as rec:
            assert rec.tracing
            with span("seen"):
                pass
    assert "seen" in {e.name for e in prof.events()}


def test_counts_survive_many_threads():
    """More threads than cores on a short switch interval: no tally is
    lost."""
    per, n = 500, 16
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with trace.recording() as rec:
            def work():
                for _ in range(per):
                    with span("x"):
                        with span("y"):
                            pass
            ts = [threading.Thread(target=rec.bind(work)) for _ in range(n)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(old)
    t = rec.tallies()
    assert t["x"]["n"] == t["y"]["n"] == per * n


@pytest.fixture(scope="module")
def golden(tmp_path_factory):
    mg = _load_make_golden()
    wd = tmp_path_factory.mktemp("golden")
    gd, layout, rm, r1, _r2 = _golden_inputs(mg, "golden", wd)
    return wd, gd, layout, rm, r1


def _metrics(path):
    with open(path) as fh:
        return json.load(fh)


def test_align_reads_writes_spans_and_their_views(golden):
    wd, _gd, layout, rm, r1 = golden
    mpath = wd / "a.json"
    align_reads(layout, rm, str(wd / "a.bam"), read1=r1, batch_size=16,
                device="cpu", metrics_path=str(mpath))
    m = _metrics(mpath)
    spans = m["spans"]
    assert ALIGN_SPANS <= set(spans)
    assert not (SINK_SPANS | ROUTER_SPANS) & set(spans)
    for t in spans.values():
        assert set(t) == {"n", "s", "self_s"} and t["n"] >= 1
        assert 0 <= t["self_s"] <= t["s"] + 1e-6
    assert spans["align.run"]["n"] == spans["align.read"]["n"] == 1
    # the kept keys, views of the spans
    assert {"device_seconds", "host_post_seconds"} <= set(m)
    assert "dp_cells_per_s" not in m
    walls = m["phase_walls"]
    assert set(walls) == PHASE_WALLS
    assert walls["reader_wall"] == round(spans["align.read"]["s"], 3)
    assert walls["flush_wall"] == round(spans["align.flush"]["s"], 3)
    assert walls["build_busy"] == round(spans["align.build"]["self_s"], 3)
    assert walls["write_busy"] == round(spans["align.write"]["s"], 3)


def _tiny_panel(tmp_path, n_reads=12):
    """Three 50-base amplicons with a 6-base UMI and reads of each, with a
    few substitutions: a panel the router scores in moments on the CPU."""
    import gzip

    import numpy as np

    rng = np.random.default_rng(5)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    cores = [rng.choice(bases, 50).tobytes().decode() for _ in range(3)]
    refs = "\n".join(f"""  amp{i}:
    sequence: "{core}{'0' * 6}"
    targets: []
    target_types: []
    umi_configurations:
      umi: {{symbol: '0', sort_type: "DegenerateTag", length: 6, order: 0, max_distance: 1}}"""
                     for i, core in enumerate(cores))
    path = tmp_path / "layout.yaml"
    path.write_text(f"""
known_strand: true
reads:
  - !Read1
    orientation: Forward
references:
{refs}
""")
    fq = str(tmp_path / "reads.fastq.gz")
    with gzip.open(fq, "wt") as fh:
        for i in range(n_reads):
            read = "".join(chr(rng.choice(bases)) if rng.random() < 0.05
                           else c for c in cores[i % 3])
            read += rng.choice(bases, 6).tobytes().decode()
            fh.write(f"@r{i}\n{read}\n+\n{'I' * len(read)}\n")
    layout = SequenceLayout.from_yaml(str(path))
    return layout, ReferenceManager.from_layout(layout), fq


def test_align_reads_with_the_router_writes_its_spans(tmp_path):
    layout, rm, fq = _tiny_panel(tmp_path)
    mpath = tmp_path / "m.json"
    align_reads(layout, rm, str(tmp_path / "h.bam"), read1=fq, batch_size=2,
                router="hmm", device="cpu", metrics_path=str(mpath))
    spans = _metrics(mpath)["spans"]
    assert (ALIGN_SPANS | ROUTER_SPANS) <= set(spans)
    # each route call waits once for its log-likelihoods, inside its
    # collect; its launch (preparation) is a route span of its own
    assert 2 * spans["router.wait"]["n"] == spans["router.route"]["n"] >= 4
    assert spans["router.route"]["self_s"] <= spans["router.route"]["s"]


def test_router_spans_are_profiler_ranges(tmp_path):
    """Under a profiler around align_reads(router="hmm") the main thread's
    spans are ranges of the profile."""
    layout, rm, fq = _tiny_panel(tmp_path)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        align_reads(layout, rm, str(tmp_path / "p.bam"), read1=fq,
                    batch_size=8, router="hmm", device="cpu")
    names = {e.name for e in prof.events()}
    assert {"router.route", "router.wait", "align.flush", "align.read",
            "align.run"} <= names


def test_bam_equal_with_and_without_a_profiler(golden):
    wd, gd, layout, rm, r1 = golden
    plain, traced = str(wd / "plain.bam"), str(wd / "traced.bam")
    align_reads(layout, rm, plain, read1=r1, batch_size=16, device="cpu")
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        align_reads(layout, rm, traced, read1=r1, batch_size=16,
                    device="cpu")
    assert _inflate_bgzf(traced) == _inflate_bgzf(plain) == \
        _inflate_bgzf(os.path.join(gd, "aligned.bam"))


def test_wfa_engine_writes_its_spans_and_counters(tmp_path, monkeypatch):
    """align_reads(engine="wfa") with reads past the rungs the op-store
    budget allows: the wavefront spans, self time as the nesting gives
    it, the counters, and wfa_phase_seconds as views of the spans."""
    monkeypatch.setenv("CLIQUE_WFA_MEM_BUDGET", str(WFA_BUDGET))
    _ref, reads, _out, m = ont_run(str(tmp_path))
    spans = m["spans"]
    assert WFA_SPANS <= set(spans)
    assert spans["wfa.align_pairs"]["n"] == spans["wfa.bialign"]["n"] == 1
    # two rounds of one chunk each (the 256 and 512 rungs)
    assert spans["wfa.round"]["n"] == spans["wfa.wait"]["n"] == \
        spans["wfa.walk"]["n"] == spans["wfa.decode"]["n"] == \
        spans["wfa.replay"]["n"] == 2
    assert spans["wfa.walk"]["self_s"] == pytest.approx(
        spans["wfa.walk"]["s"] - spans["wfa.decode"]["s"]
        - spans["wfa.replay"]["s"], abs=1e-5)
    assert spans["wfa.mid"]["n"] == spans["wfa.mid_wait"]["n"] >= \
        m["wfa_mid_levels"] >= 1
    assert spans["wfa.leaves"]["n"] == -(-m["wfa_leaf_pairs"] // 64)
    kids = sum(spans[k]["s"] for k in ("wfa.mid", "wfa.mid_wait",
                                        "wfa.leaves"))
    assert spans["wfa.bialign"]["self_s"] == pytest.approx(
        spans["wfa.bialign"]["s"] - kids, abs=1e-5)
    kids = sum(spans[k]["s"] for k in ("wfa.round", "wfa.wait", "wfa.walk",
                                        "wfa.bialign"))
    assert spans["wfa.align_pairs"]["self_s"] == pytest.approx(
        spans["wfa.align_pairs"]["s"] - kids, abs=1e-5)
    assert spans["align.flush"]["s"] >= spans["wfa.align_pairs"]["s"]
    assert m["wfa_rung_lanes"] == m["wfa_rung_lanes_censored"] == \
        2 * len(reads)
    assert m["wfa_leaf_pairs"] >= 2 * len(reads)
    assert (m["wfa_cigars_from_card"], m["wfa_cigars_replayed"]) == \
        (0, m["wfa_leaf_pairs"])
    assert m["wfa_phase_seconds"] == {
        key: round(spans[name]["s"], 3) for key, name in (
            ("dispatch", "wfa.round"), ("score_sync", "wfa.wait"),
            ("window_pull", "wfa.decode"), ("host_walk", "wfa.replay"),
            ("bialign", "wfa.bialign"))}


def test_wfa_spans_nest_as_profiler_ranges(tmp_path, monkeypatch):
    """Under a profiler the wavefront spans are ranges, each inside its
    parent's, and the BAM is the bytes of the run without one."""
    monkeypatch.setenv("CLIQUE_WFA_MEM_BUDGET", str(WFA_BUDGET))
    (tmp_path / "plain").mkdir()
    (tmp_path / "traced").mkdir()
    _r, _q, plain, _m = ont_run(str(tmp_path / "plain"))
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _r, _q, traced, _m = ont_run(str(tmp_path / "traced"))
    assert _inflate_bgzf(traced) == _inflate_bgzf(plain)
    ranges = {}
    # the profiler's raw events: its event list of the plain fills' ~10^6
    # operations takes minutes to build
    for k in prof.profiler.kineto_results.events():
        if k.name() in WFA_SPANS:
            ranges.setdefault(k.name(), []).append(
                (k.start_ns(), k.start_ns() + k.duration_ns()))
    assert set(ranges) == WFA_SPANS
    for child, parent in WFA_PARENTS.items():
        for s, t in ranges[child]:
            assert any(ps <= s and t <= pt for ps, pt in ranges[parent]), \
                (child, parent)


def test_run_chain_writes_align_and_collapse_spans(golden):
    wd, _gd, layout, rm, r1 = golden
    apath, cpath = wd / "chain_a.json", wd / "chain_c.json"
    run_chain(layout, rm, str(wd / "ca.bam"), str(wd / "cc.bam"), read1=r1,
              batch_size=16, align_metrics_path=str(apath),
              collapse_metrics_path=str(cpath),
              alleles_path=str(wd / "ct.tsv"), device="cpu")
    a, c = _metrics(apath), _metrics(cpath)
    assert (ALIGN_SPANS | SINK_SPANS) <= set(a["spans"])
    assert a["phase_walls"]["sink_busy"] == \
        round(a["spans"]["align.sink"]["s"], 3)
    assert COLLAPSE_SPANS <= set(c["spans"])
    assert not {k for k in c["spans"] if k.startswith("align.")}
    # the kept keys, views of the spans
    assert c["ingest_s"] == round(a["spans"]["align.sink"]["s"], 3)
    assert c["levels_s"] == round(c["spans"]["collapse.level"]["s"], 3)
    assert c["outputs_s"] == round(c["spans"]["collapse.outputs"]["s"], 3)
    refs = c["references"].values()
    for ref in refs:
        assert set(ref["output_phases"]) == {
            "group_sort_s", "consensus_precompute_s", "record_loop_s",
            "encode_join_s"}
    assert c["spans"]["collapse.level"]["n"] == \
        sum(len(ref["levels"]) for ref in refs)


def test_collapse_writes_its_spans(golden):
    wd, gd, layout, _rm, _r1 = golden
    out = str(wd / "col.bam")
    collapse(out, layout, os.path.join(gd, "aligned.bam"), device="cpu")
    m = _metrics(out + ".collapse_metrics.json")
    assert COLLAPSE_SPANS <= set(m["spans"])
    assert m["levels_s"] == round(m["spans"]["collapse.level"]["s"], 3)
    assert m["outputs_s"] == round(m["spans"]["collapse.outputs"]["s"], 3)
    assert _inflate_bgzf(out) == \
        _inflate_bgzf(os.path.join(gd, "collapsed.bam"))
