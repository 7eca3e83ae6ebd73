"""The benchmark of clique_tpu_torch on one NVIDIA GPU.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1> [--out DIR]

from the root of a checkout. Makes the cell's inputs from the seed, sets
up and warms up the program, runs whole passes back to back for at least
`--seconds`, checks what the passes produced against the plain reference
under `benchmark/reference/`, and prints the result as one JSON object on
the last line of standard output (with `--trace 1`, the per-layer metrics
from a profiled window instead of the end-to-end ones). The numbers
compared are the last lines of standard error and the result's last key.

Exits non-zero and prints no result without a CUDA device, when the
program cannot be imported, or when the run loaded JAX or the JAX package.
`--out DIR` also writes the run's summary (every pass, the program's own
timers, the check's details) to DIR.
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path[:0] = [HERE, ROOT]
    from benchlib import runner

    try:
        result = runner.run(args.workload, args.seed, args.seconds,
                            bool(args.trace), t_start=T_START, root=ROOT,
                            out_dir=args.out)
    except (runner.RunError, ImportError) as exc:
        print(f"benchmark: {exc}", file=sys.stderr)
        return 2
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
