"""align_reads' drain thread, the self time of its items (`align.drain`
less the event waits `align.pull`: the expansion of the device results),
a read aligned (us)."""

from benchlib import program_spans


def read(ctx):
    return program_spans.us_per_read(ctx, "align.drain", "self_s")
