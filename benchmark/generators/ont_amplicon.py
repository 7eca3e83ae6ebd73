"""Raw ONT reads of one amplicon: a seeded reference of the configuration's
length, and reads drawn from it end to end with raw-read differences.

The read model is PBSIM2's for ONT reads: differences are substitutions,
insertions and deletions in a fixed ratio at a fixed total rate. Walking
the reference, each position is substituted with `substitution` (to one
of the three other bases, drawn uniformly), else starts a deletion with
`deletion` (the positions it covers draw nothing), else takes an
insertion of drawn bases before its own base with `insertion`, else is
copied. An indel's length is drawn uniformly from `indel_bases` (lo, hi),
[1, 1] for PBSIM2's one-base differences. The walk is vectorised: only
the deletions, which skip positions, are taken in order.

Configuration keys: `amplicon_length`, `error_model` (`substitution`,
`deletion`, `insertion`: rates a reference position; `indel_bases`).
Traffic keys: `reads` (a pass). Reads are A/C/G/T only, every quality
'I'.
"""

from __future__ import annotations

import os

import numpy as np

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
CODE = np.zeros(256, np.int64)
CODE[BASES] = np.arange(4)


def read_model(error_model) -> tuple:
    """(substitution, deletion, insertion, (lo, hi)) from a configuration's
    `error_model`."""
    lo, hi = (int(v) for v in error_model["indel_bases"])
    return (float(error_model["substitution"]),
            float(error_model["deletion"]), float(error_model["insertion"]),
            (lo, hi))


def ont_read(rng, ref: np.ndarray, sub: float, dele: float, ins: float,
             indel: tuple = (1, 1)) -> np.ndarray:
    """One read of `ref` (u8 array of A/C/G/T) under the read model."""
    n = len(ref)
    lo, hi = indel
    u = rng.random(n)
    draw = rng.choice(BASES, (n, hi))          # an insertion's bases
    shift = rng.integers(1, 4, n)               # a substitution's base
    span = rng.integers(lo, hi + 1, n)
    is_sub = u < sub
    is_del = ~is_sub & (u < sub + dele)
    is_ins = ~is_sub & ~is_del & (u < sub + dele + ins)
    # a deletion at a visited position skips the next span - 1 positions
    visited = np.ones(n, bool)
    for i in np.flatnonzero(is_del).tolist():
        if visited[i]:
            visited[i + 1:i + span[i]] = False
    # each position's bytes, in order: an insertion's drawn bases and then
    # its own base, else one base (another base or the reference's)
    mat = np.zeros((n, hi + 1), np.uint8)
    mat[:, :hi] = draw
    rows = np.flatnonzero(is_ins)
    mat[rows, span[rows]] = ref[rows]
    one = ~is_ins
    other = BASES[(CODE[ref] + shift) % 4]
    mat[one, 0] = np.where(is_sub[one], other[one], ref[one])
    count = np.where(~visited | is_del, 0, np.where(is_ins, span + 1, 1))
    return mat[np.arange(hi + 1)[None, :] < count[:, None]]


def generate(config, traffic, seed, workdir):
    rng = np.random.default_rng(seed)
    ref = rng.choice(BASES, int(config["amplicon_length"]))
    model = read_model(config["error_model"])
    reads = [(f"ont{i}", ont_read(rng, ref, *model).tobytes())
             for i in range(int(traffic["reads"]))]
    name = "amplicon"
    layout_text = ("known_strand: true\nreads:\n  - !Read1\n"
                   "    orientation: Forward\nreferences:\n"
                   f"  {name}:\n    sequence: \"{ref.tobytes().decode()}\"\n")
    fastq = os.path.join(workdir, "reads.fastq")
    with open(fastq, "w") as fh:
        fh.writelines(f"@{n}\n{s.decode()}\n+\n{'I' * len(s)}\n"
                      for n, s in reads)
    return {"layout_text": layout_text, "fastq": fastq, "reads": reads,
            "references": [(name, ref.tobytes())]}
