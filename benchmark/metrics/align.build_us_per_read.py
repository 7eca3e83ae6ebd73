"""align_reads' build thread, the self time of its items (`align.build`
less the waits for room in the sink queue: record construction), a read
aligned (us)."""

from benchlib import program_spans


def read(ctx):
    return program_spans.us_per_read(ctx, "align.build", "self_s")
