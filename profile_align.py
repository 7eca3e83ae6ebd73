#!/usr/bin/env python3
"""Where the time of the port's `align` verb goes, on one GPU.

    python3 profile_align.py [--runs 3] [--reads 80000]

Makes the bench-shaped dataset of chip_smoke.py (the generator of
bench.py, seed 2026), aligns its first 2,048 reads once to warm up, then
aligns all of it `--runs` times without the profiler (wall, reads/s and
the metrics JSON's phase walls per run) and once under torch.profiler.

From the profiled run it prints the device activities only (kernels and
memory copies/sets, as the CUDA tracer records them on the card) with
their total device time and count, and the device busy share: the union
of those activities' intervals over the run's wall. Rows of the host side
(aten ops, CUDA runtime calls) are not device time and are left out, so
a copy is counted once, as its Memcpy activity, and not again as the
aten::copy_ that issued it. Imports no jax.
"""

import argparse
import json
import os
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def device_activities(prof):
    """(name, start_us, end_us) of every activity that ran on the card."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            out.append((e.name, e.time_range.start, e.time_range.end))
    if not out:
        # versions that attach device activities to their host op only
        for k in prof.profiler.kineto_results.events():
            if k.device_type() == DeviceType.CUDA:
                s = k.start_ns() / 1e3
                out.append((k.name(), s, s + k.duration_ns() / 1e3))
    return out


def union_us(intervals):
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--reads", type=int, default=80_000)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("profile_align: torch.cuda.is_available() is false")
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from torch.profiler import ProfilerActivity, profile

    from clique_tpu_torch.align.pipeline import align_reads

    card = cs.phase_card()
    with tempfile.TemporaryDirectory() as wd:
        text, fq, head, _cells = cs._bench_dataset(wd, args.reads)
        layout, rm = cs._layout_from_text(text, wd)
        kw = dict(batch_size=cs.BENCH_BATCH, device="cuda")
        align_reads(layout, rm, os.path.join(wd, "warm.bam"), read1=head,
                    **kw)
        for i in range(args.runs):
            mpath = os.path.join(wd, f"m{i}.json")
            t0 = time.time()
            st = align_reads(layout, rm, os.path.join(wd, "o.bam"),
                             read1=fq, metrics_path=mpath, **kw)
            wall = time.time() - t0
            with open(mpath) as fh:
                m = json.load(fh)
            print(f"run {i}: wall {wall} s, {st.aligned / wall} reads/s, "
                  f"device_seconds {m['device_seconds']}, host_post_seconds "
                  f"{m['host_post_seconds']}, phase walls "
                  f"{json.dumps(m['phase_walls'])}", flush=True)

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.time()
            st = align_reads(layout, rm, os.path.join(wd, "p.bam"),
                             read1=fq, **kw)
            torch.cuda.synchronize()
            wall = time.time() - t0
    acts = device_activities(prof)
    if not acts:
        raise SystemExit("profile_align: the profiler recorded no device "
                         "activity; time with CUDA events instead")
    by_name = {}
    for name, s, e in acts:
        tot, n = by_name.get(name, (0.0, 0))
        by_name[name] = (tot + (e - s), n + 1)
    print(f"profiled run on {card}: wall {wall} s, {st.aligned} reads")
    for name, (tot, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0]):
        print(f"  device {tot / 1e3} ms  x{n}  {name[:100]}")
    busy = union_us([(s, e) for _n, s, e in acts])
    print(f"device activity: {sum(t for t, _n in by_name.values()) / 1e3} "
          f"ms summed, {busy / 1e3} ms as a union of intervals; busy share "
          f"of the wall {busy / 1e6 / wall}")


if __name__ == "__main__":
    main()
