"""The router's wait for the card, its synchronising copy of the
log-likelihoods (`router.wait`), a read aligned (us)."""

from benchlib import program_spans


def read(ctx):
    return program_spans.us_per_read(ctx, "router.wait", "s")
