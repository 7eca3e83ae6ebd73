"""dp_align's share of its roofline over the traced window (%)."""

from benchlib import readers


def read(ctx):
    calls = [(w["dp"][:, 0], w["dp"][:, 1]) for w in ctx.work
             if len(w["dp"])]
    return readers.roofline_pct(ctx, "dp_align", calls)
