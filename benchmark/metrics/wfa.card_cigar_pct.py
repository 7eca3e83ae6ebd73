"""The wavefront engine's CIGARs built on the card, over all its CIGARs of
`wfa_align` lanes (%): align_reads' `wfa_cigars_from_card` and
`wfa_cigars_replayed` (the plain host replay's) in the window's passes.
None where no pass reports them or no lane was walked."""


def read(ctx):
    card = replayed = 0
    for p in ctx.passes:
        m = p["metrics"]
        card += m.get("wfa_cigars_from_card") or 0
        replayed += m.get("wfa_cigars_replayed") or 0
    if not card + replayed:
        return None
    return 100.0 * card / (card + replayed)
