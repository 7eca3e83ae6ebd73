"""The warm-up's seconds within the set-up: the cell's entry (its verb's
first calls into the program over the cell's own shapes) run once before
the window (s)."""


def read(ctx):
    return ctx.warmup_s if ctx.warmup_s > 0 else None
