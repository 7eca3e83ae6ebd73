"""wfa_align's share of its int32 roofline over the traced window (%): the
live-band work of every launch tapped in the window's passes."""

from benchlib import wfa_band


def read(ctx):
    calls = [c for w in ctx.work for c in w.get("wfa_align", ())]
    return wfa_band.roofline_pct(ctx, "wfa_align", calls)
