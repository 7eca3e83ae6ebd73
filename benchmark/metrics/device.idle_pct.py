"""The share of the traced window in which no kernel or copy ran (%)."""

from benchlib import readers


def read(ctx):
    return readers.idle_pct(ctx)
