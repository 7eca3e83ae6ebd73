"""The bialign engine's host work, the self time of its runs
(`wfa.bialign` less its levels' launches `wfa.mid`, their copies back
`wfa.mid_wait` and its leaf chunks `wfa.leaves`: the split recursion's
segment lists, splits, merges and aligned rows), a read aligned (us)."""

from benchlib import program_spans


def read(ctx):
    return program_spans.us_per_read(ctx, "wfa.bialign", "self_s")
