"""Spans at the program's layer boundaries.

A run (`align_reads`, `collapse`'s single-process path, the chain's
`collapse_from_reads`) opens a `Recorder` with `recording()`, and the
threads it starts run their loops under `Recorder.bind`. Inside them,
`with span(name):` tallies into the run's recorder, per name: the count
`n`, the seconds `s` and the self seconds `self_s` (`s` less the child
spans on the same thread; parents come from a per-thread stack). Times
come from `time.perf_counter_ns()` and stay in memory until the run
writes `Recorder.tallies()` into its metrics JSON under `"spans"`.

While the run is traced (a profiler records on the thread that opens it,
or the run writes its own trace), each span also opens a
`torch.profiler.record_function` range named after it, on whatever thread
it runs, so the ranges share the profiler's clock with the card's
activities. Outside a run a span only measures its own `seconds`.

Spans sit at layer boundaries only (a route call, a flush, a queue item,
a collapse level), never per read or per pair. This module imports torch
only to open a range: collapse's worker processes, which never import
torch, load it.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Dict, Iterator, List, Optional

_local = threading.local()


def _current() -> Optional["Recorder"]:
    return getattr(_local, "rec", None)


class Recorder:
    """One run's span tallies, shared by the threads the run binds."""

    def __init__(self, tracing: bool):
        self.tracing = tracing
        self._lock = threading.Lock()
        self._tally: Dict[str, List[int]] = {}   # name -> [n, ns, self ns]

    def add(self, name: str, ns: int, self_ns: int) -> None:
        with self._lock:
            t = self._tally.get(name)
            if t is None:
                self._tally[name] = [1, ns, self_ns]
            else:
                t[0] += 1
                t[1] += ns
                t[2] += self_ns

    def seconds(self, name: str, self_time: bool = False) -> float:
        """The total (or self) seconds of `name`'s spans so far."""
        with self._lock:
            t = self._tally.get(name)
        return 0.0 if t is None else t[2 if self_time else 1] / 1e9

    def tallies(self) -> Dict[str, Dict[str, float]]:
        """{name: {"n", "s", "self_s"}}, the metrics JSON's "spans"."""
        with self._lock:
            items = sorted((k, list(v)) for k, v in self._tally.items())
        return {k: {"n": n, "s": round(ns / 1e9, 6),
                    "self_s": round(sns / 1e9, 6)}
                for k, (n, ns, sns) in items}

    def bind(self, fn):
        """`fn` to run as another thread's target, under this recorder."""
        def run(*args, **kwargs):
            _local.rec, _local.stack = self, []
            try:
                return fn(*args, **kwargs)
            finally:
                _local.rec = _local.stack = None
        return run


@contextmanager
def recording(tracing: bool = False) -> Iterator[Recorder]:
    """A recorder for one run on this thread. It traces when `tracing`
    (the run writes its own profile) or when a profiler records on this
    thread as the run starts."""
    import torch

    rec = Recorder(tracing or torch.autograd._profiler_enabled())
    saved = _current(), getattr(_local, "stack", None)
    _local.rec, _local.stack = rec, []
    try:
        yield rec
    finally:
        _local.rec, _local.stack = saved


class span:
    """`with span(name) as sp:` tallies the block into the current run's
    recorder (and opens a profiler range while the run is traced);
    `sp.seconds` holds the block's seconds afterwards."""

    __slots__ = ("name", "seconds", "_rec", "_t0", "_child", "_range")

    def __init__(self, name: str):
        self.name = name
        self.seconds = 0.0

    def __enter__(self) -> "span":
        rec = self._rec = _current()
        self._range = None
        if rec is not None:
            self._child = 0
            _local.stack.append(self)
            if rec.tracing:
                from torch.profiler import record_function

                self._range = record_function(self.name)
                self._range.__enter__()
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        ns = time.perf_counter_ns() - self._t0
        self.seconds = ns / 1e9
        rec = self._rec
        if rec is not None:
            if self._range is not None:
                self._range.__exit__(*exc)
            stack = _local.stack
            stack.pop()
            if stack:
                stack[-1]._child += ns
            rec.add(self.name, ns, ns - self._child)
        return False
