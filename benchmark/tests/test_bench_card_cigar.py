"""`wfa.card_cigar_pct`: the share of the wavefront engine's CIGARs built
on the card, from the counters that align_reads writes into its metrics
JSON."""

import json
import os
from types import SimpleNamespace

import pytest

from benchlib import runner
from conftest import ROOT


def _read(passes):
    return runner.part("metrics", "wfa.card_cigar_pct").read(
        SimpleNamespace(passes=passes))


def test_reader_on_hand_made_passes():
    passes = [{"metrics": {"aligned": 2048, "wfa_cigars_from_card": 4100,
                           "wfa_cigars_replayed": 0}},
              {"metrics": {"aligned": 8, "wfa_cigars_from_card": 0,
                           "wfa_cigars_replayed": 20}}]
    assert _read(passes[:1]) == 100.0
    assert _read(passes[1:]) == 0.0
    assert _read(passes) == pytest.approx(100.0 * 4100 / 4120)


@pytest.mark.parametrize("metrics", [
    {"aligned": 10},                                    # a program without
    {"aligned": 10, "wfa_cigars_from_card": None,       # another engine
     "wfa_cigars_replayed": None},
    {"aligned": 10, "wfa_cigars_from_card": 0,          # no lane walked
     "wfa_cigars_replayed": 0},
], ids=["no_counters", "not_wfa", "no_lane"])
def test_reader_reads_none_without_cigars(metrics):
    assert _read([{"metrics": metrics}, {"metrics": dict(metrics)}]) is None


def test_manifest_entry():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        spec = json.load(fh)
    m = next(m for m in spec["per_layer"]
             if m["name"] == "wfa.card_cigar_pct")
    assert (m["unit"], m["better"], m["source"], m["layer"], m["moves"],
            m["workloads"]) == ("%", "higher", "program_counter",
                                "wfa engine", "align_reads_per_s",
                                ["ont_raw.wfa"])
