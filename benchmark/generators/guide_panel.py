"""A CRISPR guide-library panel: references that share one backbone and
differ only in a guide, and reads drawn from them with sequencing errors.

The shape is `chip_smoke.py::_panel_dataset`'s (one seeded backbone, a
seeded guide a reference at the configuration's span, reads with seeded
errors in a seeded order), with every size and rate read from the
configuration and the traffic instead of fixed, and the seed taken from
the run. Read `e<k>` comes from reference `k // reads_per_reference`.

Configuration keys: `references`, `backbone_length`, `guide_start`,
`guide_end`. Traffic keys: `reads_per_reference`, `substitution`,
`insertion`, `deletion` (rates a base), `trim` (up to this many bases cut
from each end of a read, uniformly; 0 for full-length reads).
"""

from __future__ import annotations

import os

import numpy as np

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def mutate(rng, seq, sub, ins, dele):
    """One read from `seq` (u8 array): each base deleted with `dele`,
    otherwise substituted with `sub`, and a random base inserted after it
    with `ins`."""
    n = len(seq)
    out = seq.copy()
    subs = rng.random(n) < sub
    out[subs] = rng.choice(BASES, int(subs.sum()))
    if not ins and not dele:
        return out
    keep = rng.random(n) >= dele
    extra = rng.random(n) < ins
    pieces = []
    for i in np.flatnonzero(keep | extra).tolist():
        if keep[i]:
            pieces.append(out[i:i + 1])
        if extra[i]:
            pieces.append(rng.choice(BASES, 1))
    return np.concatenate(pieces) if pieces else out[:0]


def generate(config, traffic, seed, workdir):
    rng = np.random.default_rng(seed)
    n_refs = int(config["references"])
    g0, g1 = int(config["guide_start"]), int(config["guide_end"])
    backbone = rng.choice(BASES, int(config["backbone_length"]))
    refs = []
    for _ in range(n_refs):
        r = backbone.copy()
        r[g0:g1] = rng.choice(BASES, g1 - g0)
        refs.append(r)
    names = [f"guide{k:03d}" for k in range(n_refs)]
    layout_text = ("known_strand: true\nreads:\n  - !Read1\n"
                   "    orientation: Forward\nreferences:\n" + "".join(
                       f"  {name}:\n    sequence: \"{r.tobytes().decode()}\"\n"
                       for name, r in zip(names, refs)))
    per_ref = int(traffic["reads_per_reference"])
    sub = float(traffic["substitution"])
    ins = float(traffic.get("insertion", 0.0))
    dele = float(traffic.get("deletion", 0.0))
    trim = int(traffic.get("trim", 0))
    reads = []
    for k, ref in enumerate(refs):
        for i in range(per_ref):
            read = mutate(rng, ref, sub, ins, dele)
            if trim:
                a, b = rng.integers(0, trim + 1, 2)
                read = read[a:len(read) - b]
            reads.append((f"e{k * per_ref + i}", read.tobytes()))
    reads = [reads[i] for i in rng.permutation(len(reads))]
    fastq = os.path.join(workdir, "reads.fastq")
    with open(fastq, "w") as fh:
        fh.writelines(f"@{name}\n{seq.decode()}\n+\n{'I' * len(seq)}\n"
                      for name, seq in reads)
    return {"layout_text": layout_text, "fastq": fastq, "reads": reads,
            "references": [(n, r.tobytes()) for n, r in zip(names, refs)],
            "truth": {name: names[int(name[1:]) // per_ref]
                      for name, _ in reads}}
