"""The wavefront engine's rung ladder on the host: its rounds' dispatches
(`wfa.round`: padding and launches) and its chunks' skeleton decode and
CIGAR replay (`wfa.walk`), a read aligned (us)."""

from benchlib import program_spans


def read(ctx):
    rounds = program_spans.us_per_read(ctx, "wfa.round", "s")
    walks = program_spans.us_per_read(ctx, "wfa.walk", "s")
    if rounds is None or walks is None:
        return None
    return rounds + walks
