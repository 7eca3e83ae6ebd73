"""What the per-layer readers under metrics/ share."""

from benchlib import peaks


def kernel_seconds(ctx, pattern):
    """Device seconds of the traced window's activities whose name holds
    `pattern`."""
    return sum(e - s for n, s, e in ctx.acts if pattern in n) / 1e6


def roofline_pct(ctx, kernel, calls):
    """The kernel's share of its roofline over the window, in %: the least
    time its work could take on the card over its device time. `calls`
    are argument tuples of counts/<kernel>.py's work()."""
    counts = ctx.counts(kernel)
    t = kernel_seconds(ctx, counts.KERNEL)
    if t <= 0 or not calls:
        return None
    ops = nbytes = 0
    for args in calls:
        o, b = counts.work(*args)
        ops += o
        nbytes += b
    return 100.0 * peaks.bound_s(ops, nbytes) / t


def idle_pct(ctx):
    if ctx.window_s <= 0 or not ctx.acts:
        return None
    return 100.0 * (1.0 - ctx.busy_s / ctx.window_s)


def host_post_us_per_read(ctx):
    reads = sum(p["metrics"]["aligned"] for p in ctx.passes)
    if not reads:
        return None
    return 1e6 * sum(p["metrics"]["host_post_seconds"]
                     for p in ctx.passes) / reads
