#!/usr/bin/env python3
"""Time the port's known-list Hamming search (`hamming_hits`) on one GPU,
for one checkout or several in turns.

    python3 profile_hamming.py [--tags 25000] [--reps 3] [ROOT ...]

Each ROOT (default: this checkout) is the root of a checkout of the repo;
its clique_tpu_torch is imported and its kernels built in a process of its
own. With several roots the runs go in turns, the list and then the list
reversed (A B B A for two), so that a comparison lies inside one call on
one card. Every run makes the same seeded inputs: a 737,280-entry 16 bp
ACGT allowlist (the size of 10x Chromium v2's 737K-august-2016.txt) and
`--tags` observed tags (40% allowlist entries, 40% one substitution off
one, 10% with an N, 10% random), and calls
hamming_hits(tags, allowlist, 1, device="cuda") once to warm up and then
`--reps` times, each on the host clock (the call ends with host lists).
It prints one JSON line per run (root, seconds of each call, the kernel
launches of the last call, a checksum of the hits) and the card's name
and power limit; the hits must agree between roots. Imports no jax.
"""

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
N_ALLOWLIST = 737_280


def _inputs(n_tags):
    import numpy as np

    rng = np.random.default_rng(737280)
    bases = np.frombuffer(b"ACGT", np.uint8)
    allow = rng.choice(bases, (N_ALLOWLIST, 16))
    tags = allow[rng.integers(0, N_ALLOWLIST, n_tags)]
    kind = rng.random(n_tags)
    rows = np.arange(n_tags)
    cols = rng.integers(0, 16, n_tags)
    one_off = (kind >= 0.4) & (kind < 0.8)
    tags[rows[one_off], cols[one_off]] = rng.choice(bases, int(one_off.sum()))
    with_n = (kind >= 0.8) & (kind < 0.9)
    tags[rows[with_n], cols[with_n]] = ord("N")
    rand = kind >= 0.9
    tags[rand] = rng.choice(bases, (int(rand.sum()), 16))
    return ([r.tobytes() for r in tags], [r.tobytes() for r in allow])


def child(root, n_tags, reps):
    """One run: import `root`'s package, time hamming_hits, print JSON."""
    sys.path.insert(0, root)
    import torch

    from clique_tpu_torch import _build
    from clique_tpu_torch.collapse import distance

    got = os.path.abspath(os.path.join(os.path.dirname(distance.__file__),
                                       os.pardir, os.pardir))
    if os.path.realpath(got) != os.path.realpath(root):
        raise SystemExit(f"imported the package of {got}, expected {root}")
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    _build.load()
    tags, allow = _inputs(n_tags)
    # trees with the matrix kernel count `match_count_launches`, trees with
    # the fused one `match_hits_launches`
    counter = next(n for n in ("match_hits_launches", "match_count_launches")
                   if hasattr(distance, n))
    hits = distance.hamming_hits(tags, allow, 1, device="cuda")
    seconds = []
    for _ in range(reps):
        n0 = getattr(distance, counter)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hits = distance.hamming_hits(tags, allow, 1, device="cuda")
        seconds.append(time.perf_counter() - t0)
        launches = getattr(distance, counter) - n0
    digest = sum((u + 1) * sum(h) + len(h) for u, h in enumerate(hits))
    print(json.dumps({"root": root, "tags": n_tags, "allowlist": len(allow),
                      "seconds": seconds, "launches": launches,
                      "hits": sum(map(len, hits)), "checksum": digest}),
          flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tags", type=int, default=25_000)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("roots", nargs="*", default=[HERE])
    args = ap.parse_args()
    roots = [os.path.abspath(r) for r in args.roots]
    if args.child:
        child(roots[0], args.tags, args.reps)
        return
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    if smi.returncode != 0:
        raise SystemExit(f"nvidia-smi failed: {smi.stderr}")
    print(smi.stdout.strip().splitlines()[0], flush=True)
    order = roots + roots[::-1] if len(roots) > 1 else roots
    runs = []
    for root in order:
        res = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--child", "--tags", str(args.tags), "--reps",
                              str(args.reps), root], capture_output=True,
                             text=True, env={**os.environ, "PYTHONPATH": ""})
        if res.returncode != 0:
            raise SystemExit(f"{root} failed:\n{res.stderr[-3000:]}")
        runs.append(json.loads(res.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]), flush=True)
    sums = {r["checksum"] for r in runs}
    if len(sums) != 1:
        raise SystemExit(f"the roots' hits differ: {sums}")
    print(json.dumps({root: sorted(s for r in runs if r["root"] == root
                                   for s in r["seconds"])
                      for root in roots}), flush=True)


if __name__ == "__main__":
    main()
