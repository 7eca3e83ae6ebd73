"""A single-cell lineage-barcode library: one amplicon of Cas9 targets
behind a cell barcode and a UMI, read per cell.

The shape is `bench.py:52-110`'s generator (anchors, a cell barcode and a
UMI as wildcard digits in the reference, seeded targets joined by a
linker, cells x UMIs, read `r<i>` from cell `i % cells` and UMI
`(i // cells) % umis_per_cell`, substitutions only), with every size read
from the configuration and the traffic and the seed taken from the run.

Configuration keys: `anchor5`, `anchor3`, `targets`, `protospacer_length`,
`pam`, `linker`, `target_type`, `cell_barcode` and `umi` (each with
`length`, `max_distance`, `sort_type`). Traffic keys: `cells`,
`umis_per_cell`, `reads`, `substitution`.
"""

from __future__ import annotations

import os

import numpy as np

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def _tag_yaml(name, symbol, order, tag):
    return (f"      {name}: {{symbol: '{symbol}', sort_type: "
            f"\"{tag['sort_type']}\", length: {tag['length']}, order: "
            f"{order}, max_distance: {tag['max_distance']}}}\n")


def generate(config, traffic, seed, workdir):
    rng = np.random.default_rng(seed)
    a5, a3 = config["anchor5"], config["anchor3"]
    targets = [rng.choice(BASES, int(config["protospacer_length"])
                          ).tobytes().decode() + config["pam"]
               for _ in range(int(config["targets"]))]
    block = config["linker"].join(targets)
    lc = int(config["cell_barcode"]["length"])
    lu = int(config["umi"]["length"])
    ref_seq = f"{a5}{'0' * lc}{'1' * lu}{block}{a3}"
    layout_text = (
        "known_strand: true\nreads:\n  - !Read1\n    orientation: Forward\n"
        "references:\n  amplicon1:\n"
        f"    sequence: \"{ref_seq}\"\n"
        f"    targets: [{', '.join(repr(t) for t in targets)}]\n"
        f"    target_types: [{', '.join([repr(config['target_type'])] * len(targets))}]\n"
        "    umi_configurations:\n"
        + _tag_yaml("cell_id", "0", 0, config["cell_barcode"])
        + _tag_yaml("cell_umi", "1", 1, config["umi"]))
    base_read = np.frombuffer((a5 + "N" * (lc + lu) + block + a3).encode(),
                              dtype=np.uint8)
    L = len(base_read)
    n_cells = int(traffic["cells"])
    n_umis = int(traffic["umis_per_cell"])
    cells = rng.choice(BASES, (n_cells, lc))
    umis = rng.choice(BASES, (n_cells, n_umis, lu))
    sub = float(traffic["substitution"])
    c0 = len(a5)
    reads = []
    for i in range(int(traffic["reads"])):
        c = i % n_cells
        read = base_read.copy()
        read[c0:c0 + lc] = cells[c]
        read[c0 + lc:c0 + lc + lu] = umis[c, (i // n_cells) % n_umis]
        subs = rng.random(L) < sub
        read[subs] = rng.choice(BASES, int(subs.sum()))
        reads.append((f"r{i}", read.tobytes()))
    fastq = os.path.join(workdir, "reads.fastq")
    with open(fastq, "w") as fh:
        fh.writelines(f"@{name}\n{seq.decode()}\n+\n{'I' * L}\n"
                      for name, seq in reads)
    return {"layout_text": layout_text, "fastq": fastq, "reads": reads,
            "references": [("amplicon1", ref_seq.encode())],
            "targets": targets}
