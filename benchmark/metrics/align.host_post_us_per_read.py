"""align_reads' host post-processing (its `host_post_seconds` counter,
the expansion of device results into records) a read aligned (us)."""

from benchlib import readers


def read(ctx):
    return readers.host_post_us_per_read(ctx)
