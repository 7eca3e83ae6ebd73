"""align_reads' reader, the self time of its parse loop (`align.read`: parse,
length gates, batching), a read aligned (us)."""

from benchlib import program_spans


def read(ctx):
    return program_spans.us_per_read(ctx, "align.read", "self_s")
