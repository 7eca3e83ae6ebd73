"""What the readers of the program's own spans share: the tallies that
`align_reads` and `collapse_from_reads` write into their metrics JSON
under "spans" ({name: {"n", "s", "self_s"}}), which each pass carries
(`p["metrics"]`, and the chain's `p["collapse"]`)."""


def us_per_read(ctx, name, field="s"):
    """The window's sum of span `name`'s `field` ("s" or "self_s") over
    the reads its passes aligned (us), or None where no pass has the span
    (a program that records none)."""
    total, found, reads = 0.0, False, 0
    for p in ctx.passes:
        reads += p["metrics"].get("aligned", 0)
        for doc in (p["metrics"], p.get("collapse") or {}):
            t = (doc.get("spans") or {}).get(name)
            if t is not None:
                total += t[field]
                found = True
    if not found or not reads:
        return None
    return 1e6 * total / reads
