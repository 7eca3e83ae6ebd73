"""Collapse's ingestion on align's sink thread, its items (`align.sink`),
a read aligned (us)."""

from benchlib import program_spans


def read(ctx):
    return program_spans.us_per_read(ctx, "align.sink", "s")
