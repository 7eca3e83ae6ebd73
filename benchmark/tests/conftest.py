"""Shared fixtures of the benchmark's own tests (run them with
`python -m pytest benchmark/tests`; on a machine with an NVIDIA GPU,
`python -m pytest -m cuda benchmark/tests` runs the card's too)."""

import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for p in (BENCH, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)


@pytest.fixture
def cuda():
    """The card, decided when the test runs: skips without one."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return "cuda"


@pytest.fixture
def small_run():
    """A cell run on the CPU at a size a test can hold: the harness's
    whole run (inputs from the seed, set-up, a window of one pass, the
    check) with the chip requirement left out."""
    import time

    from benchlib import runner

    def go(workload, seed=12345678901, **over):
        sizes = {"panel180.hmm": ({"reads_per_reference": 3,
                                   "check_reads": 10, "batch_size": 8},
                                  {"references": 6}),
                 "gestalt.chain": ({"reads": 400, "cells": 20,
                                    "warmup_reads": 40, "batch_size": 64},
                                   {})}[workload]
        return runner.run(workload, seed, 0.0, over.pop("trace", False),
                          t_start=time.time(), root=ROOT, device="cpu",
                          cell_overrides=dict(sizes[0], **over),
                          config_overrides=sizes[1])
    return go
