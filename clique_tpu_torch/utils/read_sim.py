"""Read-simulator QC helpers (host code).

Counterpart of clique_tpu/utils/read_sim.py, on the port's io/fastq.py.

Equivalent of the reference's python_package/clique/read_simulation.py:
parse simulator (pbsim / badread style) FASTQ headers into a read->truth
assignment table for benchmarking alignment accuracy.
"""

from __future__ import annotations

import re
from typing import Iterator, Optional, Tuple

from clique_tpu_torch.io.fastq import fastq_records

# badread: "@<uuid> <ref>,<strand>,<start>-<end> length=..." ;
# pbsim:   "@S1_42" with the reference in the file name; our simulator
# (tests/bench) encodes "@r<idx>" with truth carried separately.
_BADREAD = re.compile(r"^(\S+)\s+(\S+?),([+-]strand|[+-]),(\d+)-(\d+)")


def parse_simulated_assignments(fastq_path: str) -> Iterator[Tuple[str, Optional[str], Optional[int], Optional[int]]]:
    """Yields (read_name, reference_or_None, start_or_None, end_or_None)."""
    from clique_tpu_torch.io.fastq import _open_maybe_gz

    with _open_maybe_gz(str(fastq_path)) as fh:
        while True:
            header = fh.readline()
            if not header:
                return
            fh.readline()
            fh.readline()
            fh.readline()
            full = header[1:].rstrip(b"\n").decode()
            m = _BADREAD.match(full)
            if m:
                yield (full.split(" ")[0], m.group(2), int(m.group(4)),
                       int(m.group(5)))
            else:
                yield full.split(" ")[0], None, None, None


def write_assignment_tsv(fastq_path: str, output_path: str) -> int:
    n = 0
    with open(output_path, "w") as fh:
        fh.write("read\treference\tstart\tend\n")
        for name, ref, start, end in parse_simulated_assignments(fastq_path):
            fh.write(f"{name}\t{ref or ''}\t{start if start is not None else ''}"
                     f"\t{end if end is not None else ''}\n")
            n += 1
    return n
