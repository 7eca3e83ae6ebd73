"""One run of one cell: set-up, the measured window of whole passes, the
check against the plain reference, and the result line.

Everything a cell needs is found by name: the cell in `BENCHMARK.json`,
its configuration's file, `cells/<cell>.json` (the traffic and the verb),
`generators/<generator>.py` (named by the configuration),
`verbs/<verb>.py` (named by the cell), `metrics/<metric>.py` (one
reader a per-layer metric) and `counts/<kernel>.py` (read by the
readers). A later cell, configuration or metric adds files and entries.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from types import SimpleNamespace

BANNED = ("jax", "jaxlib", "flax", "clique_tpu")
HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class RunError(Exception):
    """A run that cannot give a result: exit non-zero, print none."""


def load(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise RunError(f"{path} is missing")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def part(kind: str, name: str):
    """benchmark/<kind>/<name>.py as a module."""
    path = os.path.join(HERE, kind, f"{name}.py")
    if not os.path.exists(path):
        raise RunError(f"no {kind[:-1]} named {name!r} ({path})")
    return load(path, f"bench_{kind}_{name.replace('.', '_')}")


class Manifest:
    def __init__(self, root: str):
        self.root = root
        with open(os.path.join(root, "BENCHMARK.json")) as fh:
            self.spec = json.load(fh)

    def cell(self, name: str):
        """(workload entry, configuration, cell file) of a cell that
        BENCHMARK.json lists."""
        wl = next((w for w in self.spec["workloads"] if w["name"] == name),
                  None)
        path = os.path.join(HERE, "cells", f"{name}.json")
        if wl is None or not os.path.exists(path):
            raise RunError(f"no cell named {name!r}")
        with open(path) as fh:
            cell = json.load(fh)
        cfg = next(c["file"] for c in self.spec["configs"]
                   if c["name"] == wl["config"])
        with open(os.path.join(self.root, cfg)) as fh:
            config = json.load(fh)
        return wl, config, cell

    def metrics(self, kind: str, name: str):
        """The cell's metrics of `kind` ("end_to_end" or "per_layer")."""
        return [m for m in self.spec[kind]
                if name in m.get("workloads", [name])]


def banned_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(BANNED))


def power_limit():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return out.strip().splitlines()[0] if out.strip() else None


def _window(verb, st, seconds, device, log):
    """Whole passes back to back until `seconds` have passed: (passes,
    the window's seconds, the process's CPU seconds in it)."""
    import torch
    from torch.profiler import record_function

    passes = []
    with record_function("bench.window"):
        w0, c0 = time.time(), time.process_time()
        while True:
            t0, pc0 = time.time(), time.process_time()
            with record_function("bench.pass"):
                p = verb.run_pass(st, len(passes))
            p["seconds"] = time.time() - t0
            p["cpu_s"] = time.process_time() - pc0
            passes.append(p)
            print(f"[bench] pass {len(passes) - 1}: {p['reads']} reads in "
                  f"{p['seconds']:.3f} s, cpu {p['cpu_s']:.3f} s", file=log,
                  flush=True)
            if time.time() - w0 >= seconds:
                break
        if device == "cuda":
            torch.cuda.synchronize()
        return passes, time.time() - w0, time.process_time() - c0


def _traced_window(verb, st, seconds, device, log):
    """_window under the profiler, with host spans around the layers:
    _window's result and the profile."""
    from torch.profiler import ProfilerActivity, profile

    from benchlib import spans

    acts = [ProfilerActivity.CPU] + \
        ([ProfilerActivity.CUDA] if device == "cuda" else [])
    with spans.wrapped(verb.layer_spans()), profile(activities=acts) as prof:
        out = _window(verb, st, seconds, device, log)
    return out + (prof,)


def _per_layer(prof, verb, st, passes, layer, device):
    """(per-layer metrics, breakdown, busy_s and window_s) of a traced
    window."""
    from benchlib import trace as tr

    (_n, lo, hi), = tr.host_spans(prof, "bench.window")
    acts = tr.clip(tr.device_activities(prof) if device == "cuda" else [],
                   lo, hi)
    busy = tr.busy_us(acts) / 1e6
    window_s = (hi - lo) / 1e6
    rctx = SimpleNamespace(acts=acts, window_s=window_s, busy_s=busy,
                           passes=passes, work=verb.work(st, passes),
                           cell=st.ctx.cell, config=st.ctx.config,
                           inputs=st.ctx.inputs, warmup_s=st.warmup_s,
                           counts=lambda k: part("counts", k))
    metrics = {}
    for m in layer:
        v = part("metrics", m["name"]).read(rctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    return (metrics, tr.breakdown(acts, tr.host_spans(prof, "bench."), lo, hi),
            {"busy_s": busy, "window_s": window_s})


def run(workload: str, seed: int, seconds: float, trace: bool, *,
        t_start: float, root: str = None, device: str = "cuda",
        out_dir: str = None, log=sys.stderr, cell_overrides=None,
        config_overrides=None):
    """One run; returns the result object (the run's last line).
    `device`, `cell_overrides` and `config_overrides` are for the tests,
    which drive a run on the CPU at a small size."""
    import torch

    man = Manifest(root or os.path.dirname(HERE))
    wl, config, cell = man.cell(workload)
    cell = dict(cell, **(cell_overrides or {}))
    config = dict(config, **(config_overrides or {}))
    if device == "cuda" and (not torch.cuda.is_available() or
                             torch.cuda.device_count() < int(wl["chips"])):
        raise RunError(f"{workload} needs {wl['chips']} CUDA device(s); "
                       f"found {torch.cuda.device_count()}")
    gen = part("generators", config["generator"])
    verb = part("verbs", cell["verb"])

    workdir = tempfile.mkdtemp(prefix="bench-")
    try:
        ctx = SimpleNamespace(cell=cell, config=config, device=device,
                              workdir=workdir, seed=seed)
        t_inputs = time.time()
        ctx.inputs = gen.generate(config, cell, seed, workdir)
        t_prepare = time.time()
        st = verb.prepare(ctx)
        t_warm = time.time()
        verb.warmup(st)
        if device == "cuda":
            torch.cuda.synchronize()
        setup_s = time.time() - t_start
        st.warmup_s = time.time() - t_warm
        print(f"[bench] {workload} seed {seed}: set-up {setup_s:.3f} s "
              f"(start {t_inputs - t_start:.3f}, inputs "
              f"{t_prepare - t_inputs:.3f}, prepare {t_warm - t_prepare:.3f}, "
              f"warm-up {st.warmup_s:.3f})", file=log, flush=True)

        if trace:
            passes, window_s, cpu_s, prof = _traced_window(
                verb, st, seconds, device, log)
        else:
            passes, window_s, cpu_s = _window(verb, st, seconds, device,
                                              log)
        found = banned_modules()
        if found:
            raise RunError("the run loaded " + ", ".join(found))
        peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
        verb.release(st)
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()

        reads = sum(p["reads"] for p in passes)
        values = {"setup_s": setup_s, cell["rate_metric"]: reads / window_s,
                  "device_memory_peak_mib": peak / 2 ** 20,
                  "cpu_us_per_read": 1e6 * cpu_s / reads}
        extra_device = {}
        if trace:
            metrics, breakdown, extra_device = _per_layer(
                prof, verb, st, passes, man.metrics("per_layer", workload),
                device)
        else:
            metrics = {m["name"]: {"value": values[m["name"]],
                                   "unit": m["unit"]}
                       for m in man.metrics("end_to_end", workload)
                       if m["name"] in values}
        print(f"[bench] " + ", ".join(f"{k} {v}" for k, v in values.items()),
              file=log, flush=True)

        t_check = time.time()
        checks, info = verb.check(st, passes, seed, device)
        check_s = time.time() - t_check
        print(f"[bench] window {window_s:.3f} s, {len(passes)} passes, "
              f"{reads} reads; check {check_s:.3f} s; {json.dumps(info)}",
              file=log, flush=True)
        for p in passes:
            if "collapse" in p:
                print(f"[bench] chain pass: {p['reads'] / p['seconds']:.1f} "
                      f"reads/s, align {p['metrics']['elapsed_s']} s, "
                      f"collapse levels {p['collapse'].get('levels_s')} s, "
                      f"outputs {p['collapse'].get('outputs_s')} s, "
                      f"device_seconds {p['metrics']['device_seconds']}",
                      file=log, flush=True)
        result = {
            "correct": all(v <= lim for _n, v, lim in checks),
            "attempted": int(sum(p["attempted"] for p in passes)),
            "failed": int(sum(p["failed"] for p in passes)),
            "metrics": metrics,
            "device": {
                "platform": "gpu" if device == "cuda" else "cpu",
                "kind": torch.cuda.get_device_name(0) if device == "cuda"
                else "cpu",
                "count": int(wl["chips"]),
                "memory_peak_bytes": int(peak),
                "power_limit": power_limit() if device == "cuda" else None,
                **extra_device},
        }
        if trace:
            result["breakdown"] = breakdown
        result["checks"] = {n: {"value": v, "limit": lim}
                            for n, v, lim in checks}
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
            summary = {
                "passes": [{k: p[k] for k in ("reads", "seconds", "cpu_s")} |
                           {k: p[k] for k in ("metrics", "collapse") if k in p}
                           for p in passes],
                "window_s": window_s, "values": values,
                "check_seconds": check_s, "info": info, "result": result}
            with open(os.path.join(out_dir, f"{workload}-{seed}-"
                                   f"trace{int(trace)}.json"), "w") as fh:
                json.dump(summary, fh, indent=1, default=str)
        for n, v, lim in checks:
            print(f"check {n}: {v} (limit {lim})", file=log, flush=True)
        return result
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
