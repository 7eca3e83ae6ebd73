"""BENCHMARK.json against the benchmark's format rules, and every file a cell
needs found by name."""

import json
import os
import re

import pytest

from conftest import BENCH, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTHS = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|state|"
                    r"projection|head|expansion|experts_per_token|length")


@pytest.fixture(scope="module")
def spec():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        return json.load(fh)


def _line(s):
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys(spec):
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert 1 <= spec["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert 1 <= len(spec["paths"]) <= 16
    for p in spec["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and \
            not p.startswith("/") and ".." not in p
    assert len(spec["command"]) <= 32 and all(map(_line, spec["command"]))
    for word in spec["command"][1:]:
        assert not word.startswith("/") and ".." not in word
        if os.path.exists(os.path.join(ROOT, word)):
            assert any(word.startswith(p + "/") for p in spec["paths"])


def test_names_and_units(spec):
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in spec[k]]
    assert all(NAME.match(n) for n in names)
    for k in ("configs", "workloads"):
        assert len({x["name"] for x in spec[k]}) == len(spec[k])
    metrics = spec["end_to_end"] + spec["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for w in spec["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])


def test_entries(spec):
    cfgs = {c["name"] for c in spec["configs"]}
    assert 1 <= len(cfgs) <= 24 and 1 <= len(spec["workloads"]) <= 24
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"])
        assert any(c["file"].startswith(p + "/") for p in spec["paths"])
        assert len(c["reduced"]) <= 16
        assert not any(WIDTHS.search(k) for k in c["reduced"])
        assert all(NAME.match(k) for k in c["reduced"])
    files = [c["file"] for c in spec["configs"]]
    assert len(set(files)) == len(files)
    pairs = [(w["config"], w["traffic"]) for w in spec["workloads"]]
    assert len(set(pairs)) == len(pairs)
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in cfgs and w["chips"] in (1, 4) and _line(w["why"])
    four = sum(w["chips"] == 4 for w in spec["workloads"])
    assert four <= max(1, len(spec["workloads"]) // 4)
    cells = {w["name"] for w in spec["workloads"]}
    used = {w["config"] for w in spec["workloads"]}
    assert used == cfgs


def test_metrics(spec):
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert 1 <= len(e2e) <= 16 and 1 <= len(spec["per_layer"]) <= 128
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    cells = {w["name"] for w in spec["workloads"]}
    for m in spec["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
        assert set(m.get("workloads", cells)) <= cells
    layers = {}
    for m in spec["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"]) and m["moves"] in e2e
        for w in m.get("workloads", cells):
            assert w in cells
            assert w in e2e[m["moves"]].get("workloads", cells)
        if m["name"].endswith("_roofline_pct") or "roofline" in m["name"]:
            assert m["unit"] == "%"
    for w in cells:
        reported = [m for m in spec["end_to_end"]
                    if w in m.get("workloads", cells)]
        assert len(reported) >= 2
        assert any(w in m.get("workloads", cells) for m in spec["per_layer"])


def test_run_seconds_fit(spec):
    """A full check of 24 cells fits its time."""
    rs = spec["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_every_cell_found_by_name(spec):
    for w in spec["workloads"]:
        with open(os.path.join(BENCH, "cells", w["name"] + ".json")) as fh:
            cell = json.load(fh)
        assert cell["name"] == w["name"] and cell["config"] == w["config"]
        assert cell["traffic"] == w["traffic"]
        assert os.path.exists(os.path.join(BENCH, "verbs",
                                           cell["verb"] + ".py"))
        cfg_file = next(c["file"] for c in spec["configs"]
                        if c["name"] == w["config"])
        with open(os.path.join(ROOT, cfg_file)) as fh:
            config = json.load(fh)
        assert config["name"] == w["config"]
        assert os.path.exists(os.path.join(BENCH, "generators",
                                           config["generator"] + ".py"))
        # the run's values: set-up, the cell's rate, the card's peak
        made = {"setup_s", cell["rate_metric"], "device_memory_peak_mib"}
        assert {m["name"] for m in spec["end_to_end"]
                if w["name"] in m.get("workloads", [w["name"]])} <= made
    for m in spec["per_layer"]:
        assert os.path.exists(os.path.join(BENCH, "metrics",
                                           m["name"] + ".py"))


def test_file_names():
    for dirpath, _dirs, files in os.walk(BENCH):
        for f in files:
            rel = os.path.relpath(os.path.join(dirpath, f), BENCH)
            assert re.fullmatch(r"[A-Za-z0-9_./-]+", rel), rel
