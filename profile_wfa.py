#!/usr/bin/env python3
"""Design measurements of the wavefront kernels (csrc/wfa_align.cu) on one
GPU, beside profile_port.py's `wfa` workload (the same launch shapes).

    python3 profile_wfa.py plans [SHAPE ...]
    python3 profile_wfa.py cycles
    python3 profile_wfa.py variant zero|mid512|cta32 DST
    python3 profile_wfa.py sass ROOT ROOT [ROOT ...] [--out DIR]
        [--source FILE]

- plans: each shape under forced launch plans (wfa_kernels.wfa_plan with
  cluster=C: C CTAs a pair, 0 the rings in a global workspace; the
  screen's wfa_score on its warp path and on the CTA path), the kernels'
  device time by torch.profiler and by CUDA events, and whether every
  plan gives the same outputs. SHAPE picks shapes by a word of their
  names ("rung", "leaf", "top" ...).
- cycles: builds a copy of this checkout whose kernels count clock64
  cycles (each thread's time in the cell loop, in the greedy extension
  inside it, and at the barrier of each interval of score steps: the
  CTA's, or the warp's __syncwarp and ballot on wfa_score's warp path)
  into _build_cycles/, and prints each shape's account (the screen's on
  its own plan and on the CTA path).
- variant: writes a copy of this checkout to DST with one design change
  undone, for `profile_port.py wfa . DST` in turns: zero (the op store's
  dead cells zeroed by each step's threads instead of one memset before
  the launch), mid512 (wfa_mid's CTAs at 512 threads, not 1,024), cta32
  (no warp path: a wfa_score launch of K <= 128 runs the CTA kernel as
  one-warp CTAs, one a pair, under launch bounds of its own, 32 threads
  and 32 CTAs an SM: the warp path's 32 warps an SM).
- sass: compiles each ROOT's csrc/wfa_align.cu (or csrc/FILE, e.g.
  --source dp_align.cu) to a cubin with the build's flags (all at once)
  and prints, for every wfa_kernel and wfa_score_warp_kernel
  instantiation (every kernel of another FILE), its registers, spills
  and SASS instruction count in each root, and whether the SASS of the
  instantiations every root has is the same, instruction for
  instruction; where a root's differs from the first root's, the unified
  diff goes to DIR (default chiprun_out/wfa_sass).
Imports no jax."""

import argparse
import ctypes
import hashlib
import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
# every shape but the mid's at each plan (a cluster of C CTAs a pair, 0
# the global workspace); the mid's at its own and the global workspace's;
# the screen at its own (the warp path) and the CTA path's ("cta")
PLANS = {"rung 1,024": (1, 2), "rung 2,048": (1, 2, 4),
         "rung 2,112": (1, 2, 4, 8, 0), "top rung": (None, 0),
         "leaf": (1, 2, 4), "hifi": (None,), "screen": (None, "cta"),
         "bench_wfa": (None,)}


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
""", ""), ("""    if (!kWarp && p.adaptive >= 0) {
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
    if (!kWarp && p.adaptive >= 0) {
      // wf-adaptive trim"""), ("""  if (!kWarp && tid == 0) {
    ctrl[0] = ctrl[1] = ctrl[4] = -1;""", """  if (kTb)
    for (int li = tid; li < min(p.cw, K - k0); li += nt)
      g.ops[(size_t)b * K + li + k0] = 0;
  if (!kWarp && tid == 0) {
    ctrl[0] = ctrl[1] = ctrl[4] = -1;""")]
MID512 = [("constexpr int kMidThreads = 1024;",
           "constexpr int kMidThreads = 512;")]
CTA32 = [("""template <int G, bool kTb, bool kMid, int kSteps, class RT>
__global__ void __launch_bounds__(kMid ? kMidThreads : kMaxThreads, 1)
    wfa_kernel(""", """template <int G, bool kTb, bool kMid, int kSteps, class RT,
          bool kNarrow>
__global__ void __launch_bounds__(kNarrow ? 32
                                          : kMid ? kMidThreads : kMaxThreads,
                                  kNarrow ? 32 : 1)
    wfa_kernel("""),
         ("""  auto kern = wfa_kernel<G, kTb, kMid, kSteps, RT>;""",
          """  const bool narrow =
      !kTb && !kMid && p.C == 1 && !p.grid && p.K <= kWarpMaxK;
  auto kern = narrow ? wfa_kernel<G, kTb, kMid, kSteps, RT, true>
                     : wfa_kernel<G, kTb, kMid, kSteps, RT, false>;"""),
         ("""  const int threads = std::min(""",
          """  const int threads = narrow ? 32 : std::min(""")]
CTA32_PY = [("WARP_MAX_K = 128", "WARP_MAX_K = 0")]
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
          ("""    sync();
    result = done_at(sl);
  }""", """    const long long t_b = clock64();
    sync();
    result = done_at(sl);
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
            force = {"warp": False} if C == "cta" else {"cluster": C}
            wk.wfa_plan = orig if C is None else (
                lambda *a, _f=force, **k: orig(*a, **{**k, **_f}))
            call = _call(wk, kind, inputs, kw)
            call()
            torch.cuda.synchronize()
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                for _ in range(3):
                    call()
                torch.cuda.synchronize()
            dev_ms = sum(getattr(e, "device_time_total", 0) for e in
                         prof.key_averages()
                         if "wfa_kernel" in e.key
                         or "wfa_score_warp_kernel" in e.key) / 3e3
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


def _sass_of(root, out_dir, source="wfa_align.cu"):
    """(cubin path, the running nvcc) of root's csrc/<source> compiled
    with the build's flags into out_dir."""
    from clique_tpu_torch import _build

    src = os.path.join(root, "clique_tpu_torch", "csrc", source)
    cubin = os.path.join(out_dir, hashlib.sha256(
        os.path.abspath(root).encode()).hexdigest()[:12] + ".cubin")
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xcompiler",
                                                        "-fPIC")]
    return cubin, subprocess.Popen([_build._nvcc(), *flags, "-cubin", "-o",
                                    cubin, src], stdout=subprocess.PIPE,
                                   stderr=subprocess.STDOUT, text=True)


def _plain(name):
    """A mangled name without its anonymous namespace's tag, which differs
    from file to file."""
    import re

    return re.sub(r"_GLOBAL__N__[0-9a-f]+_", "_GLOBAL__N__", name)


def _read_sass(cubin, log, every=False):
    """{function: (registers, spill bytes, [instructions])} of the
    wfa_kernel and wfa_score_warp_kernel instantiations in the cubin (of
    every function with `every`; log: its nvcc's -Xptxas -v output)."""
    import re

    from clique_tpu_torch import _build

    usage = {}
    fn = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn = _plain(m.group(1))
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and fn:
            usage.setdefault(fn, [0, 0])[1] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            usage.setdefault(fn, [0, 0])[0] = int(m.group(1))
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    res = subprocess.run([tool, "-sass", cubin], capture_output=True,
                         text=True, check=True)
    out, cur = {}, None
    for line in res.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = _plain(m.group(1)) if (every or "wfa_kernel" in m.group(1)
                                         or "wfa_score_warp_kernel" in
                                         m.group(1)) else None
            if cur:
                out[cur] = (*usage.get(cur, (None, None)), [])
            continue
        m = re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;", line)
        if m and cur:
            out[cur][2].append(m.group(1))
    return out


def run_sass(roots, out_dir, source="wfa_align.cu"):
    import difflib

    os.makedirs(out_dir, exist_ok=True)
    jobs = [_sass_of(r, out_dir, source) for r in roots]
    found = []
    for root, (cubin, proc) in zip(roots, jobs):
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {root}:\n{log[-3000:]}")
        found.append(_read_sass(cubin, log, source != "wfa_align.cu"))
    names = sorted(set().union(*found))
    for i, name in enumerate(names):
        cols = []
        for root, got in zip(roots, found):
            if name in got:
                regs, spill, ins = got[name]
                cols.append(f"{regs} registers, {spill} spill bytes, "
                            f"{len(ins)} instructions")
            else:
                cols.append("absent")
        shared = [got[name][2] for got in found if name in got]
        if len(shared) < len(roots):
            print(f"{name}: " + " | ".join(cols), flush=True)
            continue
        print(f"{name}: " + " | ".join(cols) + "; SASS against the first "
              "root's: " + ", ".join("the same" if x == shared[0] else
                                     "differs" for x in shared[1:]),
              flush=True)
        for j in range(1, len(roots)):
            if shared[j] == shared[0]:
                continue
            path = os.path.join(out_dir, f"diff_{i}_{j}.txt")
            with open(path, "w") as fh:
                fh.write(name + "\n")
                fh.writelines(line + "\n" for line in difflib.unified_diff(
                    shared[0], shared[j], roots[0], roots[j], n=3,
                    lineterm=""))
            print(f"  {roots[j]} against {roots[0]}: diff in {path}",
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
orig = wk.wfa_plan
for name, kind, host, kw in pw._shapes([]):
    inputs = [torch.from_numpy(a).cuda() for a in host]
    for label, force in (("", None), (" (CTA path)", dict(warp=False))):
        if force and "screen" not in name:
            continue
        wk.wfa_plan = orig if force is None else (
            lambda *a, _f=force, **k: orig(*a, **{{**k, **_f}}))
        call = pw._call(wk, kind, inputs, kw)
        call(); torch.cuda.synchronize(); lib.clique_wfa_cycles(buf)
        call(); torch.cuda.synchronize(); lib.clique_wfa_cycles(buf)
        loop, ext, bar, n = list(buf)
        tot = loop + bar
        print(f"{{name}}{{label}}: thread-cycles {{tot:.4g}}: cell loop "
              f"{{loop / tot:.3f}} (its extension {{ext / tot:.3f}}), barrier "
              f"{{bar / tot:.3f}}; {{n}} intervals", flush=True)
    wk.wfa_plan = orig
"""
    subprocess.run([sys.executable, "-c", code], check=True,
                   env={**os.environ, "PYTHONPATH": ""})


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("what", choices=("plans", "cycles", "variant", "sass"))
    ap.add_argument("args", nargs="*")
    ap.add_argument("--out", default=os.path.join("chiprun_out", "wfa_sass"),
                    help="sass: where the diffs go")
    ap.add_argument("--source", default="wfa_align.cu",
                    help="sass: the csrc/ file to compile")
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    if args.what == "plans":
        run_plans(args.args)
    elif args.what == "cycles":
        run_cycles()
    elif args.what == "sass":
        if len(args.args) < 2:
            raise SystemExit("sass needs two roots or more")
        run_sass([os.path.abspath(r) for r in args.args],
                 os.path.abspath(args.out), args.source)
    else:
        kind, dst = args.args
        cu = _copy(os.path.abspath(dst))
        _patch(cu, {"zero": ZERO, "mid512": MID512, "cta32": CTA32}[kind])
        if kind == "cta32":
            _patch(os.path.join(os.path.dirname(os.path.dirname(cu)),
                                "align", "wfa_kernels.py"), CTA32_PY)
        print(f"wrote {dst}: {kind}")


if __name__ == "__main__":
    main()
