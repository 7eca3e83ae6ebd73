"""hmm_forward's share of its roofline over the traced window (%)."""

from benchlib import readers


def read(ctx):
    calls = [c for w in ctx.work for c in w["hmm_calls"]]
    return readers.roofline_pct(ctx, "hmm_forward", calls)
