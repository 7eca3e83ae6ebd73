"""The whole harness on the CPU at a small size: sound runs come out
correct, and a run whose timed path is broken underneath comes out not
correct, once for each fault the cells can have (an answer altered where
it is produced; half the reads left out)."""

import numpy as np
import pytest

CELLS = ["panel180.hmm", "gestalt.chain"]


def _failed(result):
    return [n for n, c in result["checks"].items() if c["value"] > c["limit"]]


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(small_run, workload):
    r = small_run(workload)
    assert r["correct"] and not _failed(r)
    assert r["attempted"] > 0 and r["failed"] == 0
    assert set(r["metrics"]) >= {"setup_s"}


def test_traced_run_reads_its_metrics(small_run):
    r = small_run("panel180.hmm", trace=True)
    assert r["correct"]
    assert {"align.host_post_us_per_read", "setup.warmup_s"} <= \
        set(r["metrics"])
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}


def test_log_likelihood_altered(small_run, monkeypatch):
    from clique_tpu_torch.align import hmm

    real = hmm.hmm_forward_batch

    def altered(*args, **kwargs):
        out = real(*args, **kwargs).clone()
        out[len(out) // 2] += 0.5
        return out

    monkeypatch.setattr(hmm, "hmm_forward_batch", altered)
    r = small_run("panel180.hmm", check_reads=18)
    assert not r["correct"] and "hmm_ll_gap" in _failed(r)


def test_alignment_altered(small_run, monkeypatch):
    from clique_tpu_torch.align import batch

    real = batch.scoring_to_params

    def altered(scoring, device):
        p = real(scoring, device).clone()
        p[1] += 1.0                       # the mismatch score
        return p

    monkeypatch.setattr(batch, "scoring_to_params", altered)
    r = small_run("panel180.hmm")
    assert not r["correct"] and "dp_mismatches" in _failed(r)


def test_corrected_tag_altered(small_run, monkeypatch):
    from clique_tpu_torch.collapse import correct

    real = correct.correct_degenerate_groups

    def altered(group_counts, *args, **kwargs):
        maps = real(group_counts, *args, **kwargs)
        for m in maps:
            tags = sorted(m)
            if len(tags) > 1:
                m[tags[0]] = tags[1] if m[tags[0]] != tags[1] else tags[0]
                break
        return maps

    monkeypatch.setattr(correct, "correct_degenerate_groups", altered)
    r = small_run("gestalt.chain")
    assert not r["correct"] and "collapsed_record_mismatches" in _failed(r)


@pytest.mark.parametrize("workload", CELLS)
def test_half_the_reads_left_out(small_run, monkeypatch, workload):
    from clique_tpu_torch.io.fastq import ReadIterator

    real = ReadIterator.read_one_records

    def every_other(self):
        for i, rec in enumerate(real(self)):
            if i % 2 == 0:
                yield rec

    monkeypatch.setattr(ReadIterator, "read_one_records", every_other)
    r = small_run(workload)
    assert not r["correct"]
    assert "reads_missing" in _failed(r) or \
        "aligned_record_mismatches" in _failed(r)


def test_checks_print_numbers_beside_limits(small_run):
    r = small_run("panel180.hmm")
    assert list(r)[-1] == "checks"
    for c in r["checks"].values():
        assert set(c) == {"value", "limit"} and np.isfinite(c["value"])
