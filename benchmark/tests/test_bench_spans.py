"""The per-layer metrics that read the program's own spans: a traced run
of each cell on the CPU reports every one of them with a finite value,
and the metrics the benchmark had before them still."""

import json
import math
import os

import pytest

from conftest import ROOT


def _span_metrics(workload):
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        spec = json.load(fh)
    return [m["name"] for m in spec["per_layer"]
            if m["source"] == "program_span"
            and workload in m.get("workloads", [workload])]


@pytest.mark.parametrize("workload", ["panel180.hmm", "gestalt.chain"])
def test_traced_run_reports_the_span_metrics(small_run, workload):
    names = _span_metrics(workload)
    assert len(names) >= 3
    r = small_run(workload, trace=True)
    assert r["correct"]
    for name in names:
        v = r["metrics"][name]["value"]
        assert r["metrics"][name]["unit"] == "us"
        assert math.isfinite(v) and v >= 0, (name, v)
    assert "setup.warmup_s" in r["metrics"]


def test_a_program_without_spans_reports_none():
    """The readers return nothing, and raise nothing, on passes whose
    metrics JSON has no spans (a program from before them)."""
    from types import SimpleNamespace

    from benchlib import program_spans

    ctx = SimpleNamespace(passes=[{"metrics": {"aligned": 10},
                                   "collapse": {"levels_s": 0.1}}])
    assert program_spans.us_per_read(ctx, "align.read", "self_s") is None
    ctx.passes[0]["metrics"]["spans"] = {
        "align.read": {"n": 1, "s": 0.002, "self_s": 0.001}}
    assert program_spans.us_per_read(ctx, "align.read", "self_s") == \
        pytest.approx(100.0)
