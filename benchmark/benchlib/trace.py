"""Reduction of a `torch.profiler` trace to what the metrics read: the
device activities (kernels and copies) and host spans of the traced window,
the union of the device's busy time, and the breakdown of device time by
operation and of idle gaps by the host span that held them.

The reduction follows `profile_port.py`'s (device activities from the
profiler's events, busy time as a union of intervals)."""

from __future__ import annotations

from typing import Dict, List, Tuple

Interval = Tuple[str, float, float]     # name, start us, end us
# the benchmark's own host spans (record_function ranges), which the
# profiler also lists as annotations on the device's timeline
SPAN_PREFIX = "bench."


def device_activities(prof) -> List[Interval]:
    """(name, start_us, end_us) of every activity that ran on the card."""
    from torch.autograd import DeviceType

    out = [(e.name, e.time_range.start, e.time_range.end)
           for e in prof.events() if e.device_type == DeviceType.CUDA
           and not getattr(e, "is_user_annotation", False)
           and not e.name.startswith(SPAN_PREFIX)]
    if not out:
        # versions that attach device activities to their host op only
        for k in prof.profiler.kineto_results.events():
            if k.device_type() == DeviceType.CUDA and \
                    not k.name().startswith(SPAN_PREFIX):
                s = k.start_ns() / 1e3
                out.append((k.name(), s, s + k.duration_ns() / 1e3))
    return out


def host_spans(prof, prefix: str) -> List[Interval]:
    """The host ranges (record_function) whose names start with `prefix`."""
    from torch.autograd import DeviceType

    return [(e.name, e.time_range.start, e.time_range.end)
            for e in prof.events()
            if e.device_type == DeviceType.CPU and e.name.startswith(prefix)]


def clip(acts: List[Interval], lo: float, hi: float) -> List[Interval]:
    return [(n, max(s, lo), min(e, hi)) for n, s, e in acts
            if e > lo and s < hi]


def union(intervals) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy_us(acts: List[Interval]) -> float:
    return sum(e - s for s, e in union((s, e) for _n, s, e in acts))


def by_name(acts: List[Interval]) -> Dict[str, float]:
    """Device microseconds by activity name."""
    out: Dict[str, float] = {}
    for n, s, e in acts:
        out[n] = out.get(n, 0.0) + (e - s)
    return out


def breakdown(acts: List[Interval], spans: List[Interval], lo: float,
              hi: float, top: int = 10) -> Dict[str, list]:
    """The `top` device operations by time, and the `top` longest idle
    gaps of the window, each named by the innermost host span around its
    middle (seconds)."""
    ops = sorted(by_name(acts).items(), key=lambda kv: -kv[1])[:top]
    busy = union((s, e) for _n, s, e in acts)
    gaps, t = [], lo
    for s, e in busy + [(hi, hi)]:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
    named = []
    for s, e in gaps:
        mid = (s + e) / 2
        around = [sp for sp in spans if sp[1] <= mid <= sp[2]]
        name = min(around, key=lambda sp: sp[2] - sp[1])[0] if around \
            else "outside any span"
        named.append([name, (e - s) / 1e6])
    return {"device_ops": [[n, us / 1e6] for n, us in ops],
            "idle_gaps": named}
