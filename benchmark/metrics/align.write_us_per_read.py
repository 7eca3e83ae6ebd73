"""align_reads' writer thread, its items (`align.write`: BAM encoding and
BGZF compression), a read aligned (us)."""

from benchlib import program_spans


def read(ctx):
    return program_spans.us_per_read(ctx, "align.write", "s")
