"""Host spans around the calls into the program's layers, for traced runs
only: each (owner, attribute, span name) is wrapped in a
`torch.profiler.record_function` range while the context is open."""

from __future__ import annotations

import contextlib
import functools


@contextlib.contextmanager
def wrapped(points):
    from torch.profiler import record_function

    saved = []
    try:
        for owner, attr, name in points:
            real = getattr(owner, attr)

            def span(*args, _real=real, _name=name, **kwargs):
                with record_function(_name):
                    return _real(*args, **kwargs)

            functools.update_wrapper(span, real)
            saved.append((owner, attr, real))
            setattr(owner, attr, span)
        yield
    finally:
        for owner, attr, real in reversed(saved):
            setattr(owner, attr, real)
