"""The kernels' operation and byte counts at small shapes, worked by hand."""

import pytest

from benchlib import peaks, runner


def test_hmm_forward_counts():
    counts = runner.part("counts", "hmm_forward")
    ops, nbytes = counts.work([3, 4], [5, 6, 7])
    # cells: (3 + 4) x (5 + 6 + 7) over 6 pairs
    assert ops == counts.OPS_PER_CELL * 7 * 18
    assert nbytes == 7 * 3 + 18 * 2 + 12 * 6


def test_dp_align_counts():
    counts = runner.part("counts", "dp_align")
    ops, nbytes = counts.work([10, 20], [12, 18])
    assert ops == counts.OPS_PER_CELL * (10 * 12 + 20 * 18)
    assert nbytes == (22 + 38) + 16 + (6 + 10) + 16


def test_bound_takes_the_larger():
    assert peaks.bound_s(peaks.PEAK_LANE_OPS_PER_S, 0) == pytest.approx(1)
    assert peaks.bound_s(0, 2 * peaks.PEAK_BYTES_PER_S) == pytest.approx(2)


def test_roofline_reader_reads_nothing_without_a_kernel():
    from types import SimpleNamespace

    from benchlib import readers

    ctx = SimpleNamespace(acts=[], counts=lambda k: runner.part("counts", k))
    assert readers.roofline_pct(ctx, "hmm_forward", [([3], [4])]) is None


def test_roofline_reader():
    from types import SimpleNamespace

    from benchlib import readers

    counts = runner.part("counts", "hmm_forward")
    acts = [("void hmm_forward_kernel<8>(...)", 0.0, 1000.0),
            ("other", 0.0, 5000.0)]
    ctx = SimpleNamespace(acts=acts, counts=lambda k: runner.part("counts", k))
    ops, nb = counts.work([100], [200])
    want = 100 * peaks.bound_s(ops, nb) / 1e-3
    assert readers.roofline_pct(ctx, "hmm_forward", [([100], [200])]) == \
        pytest.approx(want)
