"""The bialign engine's waits for `wfa_mid`, its copies of each level's
penalties and payloads back to the host (`wfa.mid_wait`), a read aligned
(us)."""

from benchlib import program_spans


def read(ctx):
    return program_spans.us_per_read(ctx, "wfa.mid_wait", "s")
