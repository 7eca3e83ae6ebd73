#!/usr/bin/env python3
"""Design measurements of the wavefront kernels (csrc/wfa_align.cu) on one
GPU, beside profile_port.py's `wfa` workload (the same launch shapes).

    python3 profile_wfa.py plans [SHAPE ...]
    python3 profile_wfa.py cycles
    python3 profile_wfa.py variant zero|mid512 DST

- plans: each shape under forced launch plans (wfa_kernels.wfa_plan with
  cluster=C: C CTAs a pair, 0 the rings in a global workspace), the
  kernels' device time by torch.profiler and by CUDA events, and whether
  every plan gives the same outputs. SHAPE picks shapes by a word of
  their names ("rung", "leaf", "top" ...).
- cycles: builds a copy of this checkout whose kernels count clock64
  cycles (each thread's time in the cell loop, in the greedy extension
  inside it, and at the barrier of each interval of score steps) into
  _build_cycles/, and prints each shape's account.
- variant: writes a copy of this checkout to DST with one design change
  undone, for `profile_port.py wfa . DST` in turns: zero (the op store's
  dead cells zeroed by each step's threads instead of one memset before
  the launch), mid512 (wfa_mid's CTAs at 512 threads, not 1,024).
Imports no jax."""

import argparse
import ctypes
import hashlib
import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
# every shape but the mid's at each plan; the mid's at its own and the
# global workspace's
PLANS = {"rung 1,024": (1, 2), "rung 2,048": (1, 2, 4),
         "rung 2,112": (1, 2, 4, 8, 0), "top rung": (None, 0),
         "leaf": (1, 2, 4), "hifi": (None,), "screen": (None,)}


def _copy(dst):
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(HERE, dst, ignore=shutil.ignore_patterns(
        ".git", "_chip", "_build", "_build_cycles", "__pycache__"))
    return os.path.join(dst, "clique_tpu_torch", "csrc", "wfa_align.cu")


def _patch(path, edits):
    s = open(path).read()
    for a, b in edits:
        if a not in s:
            raise SystemExit(f"{path}: no {a[:60]!r} to patch")
        s = s.replace(a, b, 1)
    with open(path, "w") as fh:
        fh.write(s)


ZERO = [("""  if (kTb) {
    // the op store's dead cells read 0 (the steps write live cells only)
    const cudaError_t err = cudaMemsetAsync(
        g.ops, 0, (size_t)(p.smax + 1) * p.B * p.K, stream);
    if (err != cudaSuccess) return err;
  }
""", ""), ("""    if (p.adaptive >= 0) {
      // wf-adaptive trim""", """    if (kTb) {
#pragma unroll
      for (int dt = 0; dt < kSteps; ++dt) {
        if (s0 + dt > p.smax) continue;
        const int live = hi[dt] - lo[dt];
        const int n = min(p.cw, K - k0) - live;
        for (int i = tid; i < n; i += nt) {
          const int li = i < lo[dt] ? i : i + live;
          g.ops[((size_t)(s0 + dt) * p.B + b) * K + li + k0] = 0;
        }
      }
    }
    if (p.adaptive >= 0) {
      // wf-adaptive trim"""), ("""  if (tid == 0) {
    ctrl[0] = ctrl[1] = ctrl[4] = -1;""", """  if (kTb)
    for (int li = tid; li < min(p.cw, K - k0); li += nt)
      g.ops[(size_t)b * K + li + k0] = 0;
  if (tid == 0) {
    ctrl[0] = ctrl[1] = ctrl[4] = -1;""")]
MID512 = [("constexpr int kMidThreads = 1024;",
           "constexpr int kMidThreads = 512;")]
CYCLES = [("namespace cg = cooperative_groups;\n",
           "namespace cg = cooperative_groups;\n"
           "__device__ unsigned long long clique_cycles[4];\n"),
          ("    const int sl = it & 1;\n    int best = kNeg;\n",
           "    const int sl = it & 1;\n    int best = kNeg;\n"
           "    const long long t_a = clock64();\n"),
          ("          if (n > 0) m += extend_run(sref, sread, m, v, n, wild);",
           "          const long long t_e = clock64();\n"
           "          if (n > 0) m += extend_run(sref, sread, m, v, n, wild);\n"
           "          ext_c += clock64() - t_e;"),
          ("""    sync_pair(p);
    result = ctrl[sl];
  }""", """    const long long t_b = clock64();
    sync_pair(p);
    result = ctrl[sl];
    loop_c += t_b - t_a;
    bar_c += clock64() - t_b;
    ++n_int;
  }
  atomicAdd(&clique_cycles[0], (unsigned long long)loop_c);
  atomicAdd(&clique_cycles[1], (unsigned long long)ext_c);
  atomicAdd(&clique_cycles[2], (unsigned long long)bar_c);
  if (tid == 0) atomicAdd(&clique_cycles[3], (unsigned long long)n_int);"""),
          ("  int rq[2] = {0, 0}, rr[2] = {0, 0};",
           "  int rq[2] = {0, 0}, rr[2] = {0, 0};\n"
           "  long long loop_c = 0, ext_c = 0, bar_c = 0, n_int = 0;")]
CYCLES_READ = """
extern "C" int clique_wfa_cycles(unsigned long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, clique_cycles, 32);
  const unsigned long long z[4] = {0, 0, 0, 0};
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(clique_cycles, z, 32);
  return e;
}
"""


def _shapes(words):
    import profile_port as pp

    return [s for s in pp._wfa_shapes()
            if not words or any(w in s[0] for w in words)]


def _call(wk, kind, inputs, kw):
    fn = {"align": wk.wfa_align, "score": wk.wfa_score, "mid": wk.wfa_mid}
    return lambda: fn[kind](*inputs, **kw)


def run_plans(words):
    import torch

    import profile_port as pp
    from clique_tpu_torch.align import wfa_kernels as wk

    orig, dev = wk.wfa_plan, torch.device("cuda", 0)
    for name, kind, host, kw in _shapes(words):
        inputs = [torch.from_numpy(a).to(dev) for a in host]
        digests = set()
        for C in next(v for k, v in PLANS.items() if k in name):
            wk.wfa_plan = orig if C is None else (
                lambda *a, _C=C, **k: orig(*a, **{**k, "cluster": _C}))
            call = _call(wk, kind, inputs, kw)
            call()
            torch.cuda.synchronize()
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                for _ in range(3):
                    call()
                torch.cuda.synchronize()
            dev_ms = sum(getattr(e, "device_time_total", 0) for e in
                         prof.key_averages() if "wfa_kernel" in e.key) / 3e3
            ev_ms = pp._event_ms(call, 3)
            out = call()
            out = out if isinstance(out, tuple) else (out,)
            if kind == "align":
                out = (out[0], out[2], out[3])
            h = hashlib.sha256()
            for t in out:
                h.update(t.cpu().numpy().tobytes())
            digests.add(h.hexdigest()[:16])
            print(f"{name} cluster={C}: device {dev_ms:.4f} ms, events "
                  f"{ev_ms:.4f} ms", flush=True)
        wk.wfa_plan = orig
        print(f"  outputs agree across plans: {len(digests) == 1}",
              flush=True)


def run_cycles():
    dst = os.path.join(HERE, "_build_cycles")
    path = _copy(dst)
    _patch(path, CYCLES)
    with open(path, "a") as fh:
        fh.write(CYCLES_READ)
    code = f"""
import ctypes, sys
sys.path.insert(0, {dst!r}); sys.path.insert(1, {HERE!r})
import torch
import profile_wfa as pw
from clique_tpu_torch import _build
from clique_tpu_torch.align import wfa_kernels as wk
lib = _build.load()
lib.clique_wfa_cycles.argtypes = [ctypes.c_void_p]
buf = (ctypes.c_ulonglong * 4)()
for name, kind, host, kw in pw._shapes([]):
    inputs = [torch.from_numpy(a).cuda() for a in host]
    call = pw._call(wk, kind, inputs, kw)
    call(); torch.cuda.synchronize(); lib.clique_wfa_cycles(buf)
    call(); torch.cuda.synchronize(); lib.clique_wfa_cycles(buf)
    loop, ext, bar, n = list(buf)
    tot = loop + bar
    print(f"{{name}}: thread-cycles {{tot:.4g}}: cell loop {{loop / tot:.3f}} "
          f"(its extension {{ext / tot:.3f}}), barrier {{bar / tot:.3f}}; "
          f"{{n}} intervals", flush=True)
"""
    subprocess.run([sys.executable, "-c", code], check=True,
                   env={**os.environ, "PYTHONPATH": ""})


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("what", choices=("plans", "cycles", "variant"))
    ap.add_argument("args", nargs="*")
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    if args.what == "plans":
        run_plans(args.args)
    elif args.what == "cycles":
        run_cycles()
    else:
        kind, dst = args.args
        _patch(_copy(os.path.abspath(dst)),
               {"zero": ZERO, "mid512": MID512}[kind])
        print(f"wrote {dst}: {kind}")


if __name__ == "__main__":
    main()
