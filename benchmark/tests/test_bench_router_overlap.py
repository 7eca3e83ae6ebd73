"""`router.overlap_pct`: the share of the pair-HMM router's route calls
launched while the call before was in flight, from the counters that
align_reads writes into its metrics JSON."""

from types import SimpleNamespace

import pytest

from benchlib import runner


def _read(passes):
    return runner.part("metrics", "router.overlap_pct").read(
        SimpleNamespace(passes=passes))


def test_reader_on_hand_made_passes():
    passes = [{"metrics": {"aligned": 36000, "route_calls": 18,
                           "route_calls_overlapped": 17}},
              {"metrics": {"aligned": 2000, "route_calls": 1,
                           "route_calls_overlapped": 0}}]
    assert _read(passes) == pytest.approx(100.0 * 17 / 19)
    assert _read(passes[1:]) == 0.0


@pytest.mark.parametrize("metrics", [
    {"aligned": 10},                                   # a program without
    {"aligned": 10, "route_calls": 0, "route_calls_overlapped": 0},  # kmer
], ids=["no_counters", "no_route_call"])
def test_reader_reads_none_without_route_calls(metrics):
    assert _read([{"metrics": metrics}, {"metrics": dict(metrics)}]) is None


def test_traced_panel_run_reports_the_overlap(small_run):
    """72 reads at batch 8: route calls of 32, 32 and 8 reads a pass, the
    second and third launched while the one before was in flight."""
    r = small_run("panel180.hmm", trace=True, reads_per_reference=12)
    assert r["correct"]
    m = r["metrics"]["router.overlap_pct"]
    assert m["unit"] == "%"
    assert m["value"] == pytest.approx(100.0 * 2 / 3)
