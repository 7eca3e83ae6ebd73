"""The controls, each driven through the harness's whole run and its own
check: put in the program's place, they have to come out not correct.

- `panel180.hmm`: the plain pair-HMM in bfloat16 (the configuration's is
  float32) in place of the program's `hmm_forward_batch`, on each call's
  own operands; `hmm_ll_gap` has to fail.
- `gestalt.chain`: the guarantee the configuration states broken: the
  program corrects cell barcodes and UMIs at one edit less than their
  max_distance; the collapsed records have to fail.

On the CPU at a size a test can hold; on the card (`-m cuda`) at the
cells' own sizes, one pass in the window, on three seeds each."""

import time

import pytest
import torch

from benchlib import runner
from conftest import ROOT
from reference import pair_hmm


def bfloat16_router(monkeypatch):
    """hmm_forward_batch replaced by the plain pair-HMM in bfloat16."""
    from clique_tpu_torch.align import hmm

    def control(refs, reads, ref_lens, read_lens, params, *, stream=None,
                block=131072):
        p = torch.exp(params.detach().double().cpu())
        probs = {"match": float(p[0]), "gap_open": float(p[3]),
                 "gap_extend": float(p[4])}
        out = [pair_hmm.forward_rows(refs[s:s + block], ref_lens[s:s + block],
                                     reads[s:s + block],
                                     read_lens[s:s + block], torch.bfloat16,
                                     probs).float()
               for s in range(0, refs.shape[0], block)]
        return torch.cat(out) if out else \
            torch.zeros(0, dtype=torch.float32, device=refs.device)

    monkeypatch.setattr(hmm, "hmm_forward_batch", control)


def narrow_correction(monkeypatch):
    """Degenerate tags corrected at one edit less than configured."""
    from clique_tpu_torch.collapse import correct

    real = correct.correct_degenerate_groups

    def control(group_counts, max_distance, *args, **kwargs):
        return real(group_counts, max_distance - 1, *args, **kwargs)

    monkeypatch.setattr(correct, "correct_degenerate_groups", control)


CONTROLS = {"panel180.hmm": (bfloat16_router, "hmm_ll_gap"),
            "gestalt.chain": (narrow_correction,
                              "collapsed_record_mismatches")}


def _failed(result):
    return [n for n, c in result["checks"].items() if c["value"] > c["limit"]]


def test_panel_control_fails(small_run, monkeypatch):
    bfloat16_router(monkeypatch)
    r = small_run("panel180.hmm", check_reads=12)
    assert not r["correct"] and "hmm_ll_gap" in _failed(r)
    gap = r["checks"]["hmm_ll_gap"]
    assert gap["value"] > 10 * gap["limit"]


def test_chain_control_fails(small_run, monkeypatch):
    narrow_correction(monkeypatch)
    r = small_run("gestalt.chain")
    assert not r["correct"] and "collapsed_record_mismatches" in _failed(r)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [3101, 2 ** 31 + 3102, 3103])
@pytest.mark.parametrize("workload", ["panel180.hmm", "gestalt.chain"])
def test_control_fails_at_the_cell_size(cuda, monkeypatch, workload, seed,
                                        capsys):
    plant, number = CONTROLS[workload]
    plant(monkeypatch)
    r = runner.run(workload, seed, 0.0, False, t_start=time.time(),
                   root=ROOT, device=cuda)
    with capsys.disabled():
        print(f"\ncontrol {workload} seed {seed}: {r['checks']}")
    assert not r["correct"] and number in _failed(r)
