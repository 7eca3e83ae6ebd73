"""Cyclic-GC control for the hot pipeline stages.

The pipeline stages hold millions of small acyclic objects (SamRecords,
SortingReads, tag bytes) alive while allocating steadily; CPython's
generational collector then scans the whole growing heap on every gen2
pass, which made nominally linear stages superlinear in dataset size
(measured: BAM ingest at 160k reads spent ~50% of its wall in GC —
docs/ROUND5.md). The pipeline's data objects are acyclic, so refcounting
alone reclaims them; the cycle collector only adds heap scans.

`hot_section()` disables the cycle collector for the duration of a stage
and, on exit, freezes the survivors into the permanent generation so
later stages never re-scan them (the standard long-lived-heap pattern,
cf. gc.freeze's CoW/pre-fork use). Cycles created inside a section are
reclaimed by the next full collection after the LAST section exits (the
process usually ends first for CLI runs). CLIQUE_TPU_GC=1 opts out.

Reference parity note: output bytes are unaffected — this is purely an
allocator-behavior change (the reference is Rust and has no GC at all).
"""

from __future__ import annotations

import gc
import os
from contextlib import contextmanager

_DEPTH = [0]


def _enabled() -> bool:
    return os.environ.get("CLIQUE_TPU_GC", "0") != "1"


@contextmanager
def hot_section():
    """Disable cyclic GC inside, freeze survivors on exit (re-entrant)."""
    if not _enabled():
        yield
        return
    _DEPTH[0] += 1
    was = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        _DEPTH[0] -= 1
        if _DEPTH[0] == 0:
            # survivors (the stage's output lists) go to the permanent
            # generation: later stages' collections skip them entirely
            gc.freeze()
            if was:
                gc.enable()
