"""FASTQ helpers the verbs share."""

from __future__ import annotations


def head(inputs: dict, n: int, dst: str) -> str:
    """The path of a FASTQ of the first `n` of the inputs' reads: the
    inputs' own where `n` takes them all, else a copy of their first
    records written to `dst`."""
    if n >= len(inputs["reads"]):
        return inputs["fastq"]
    with open(inputs["fastq"]) as fi, open(dst, "w") as fo:
        fo.writelines(fi.readline() for _ in range(4 * n))
    return dst
