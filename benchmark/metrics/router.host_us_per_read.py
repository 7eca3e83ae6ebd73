"""The pair-HMM router's host work, the self time of its route calls
(`router.route`: byte rows, copies in, gathers, the launch, the pick), a
read aligned (us)."""

from benchlib import program_spans


def read(ctx):
    return program_spans.us_per_read(ctx, "router.route", "self_s")
