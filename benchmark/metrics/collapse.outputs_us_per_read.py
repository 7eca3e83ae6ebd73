"""Collapse's consensus outputs (`collapse.outputs`), a read aligned (us)."""

from benchlib import program_spans


def read(ctx):
    return program_spans.us_per_read(ctx, "collapse.outputs", "s")
