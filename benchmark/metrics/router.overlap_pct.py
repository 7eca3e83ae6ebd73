"""The pair-HMM router's route calls launched while the call before was
still in flight, over its route calls (%): align_reads' `route_calls` and
`route_calls_overlapped` in the window's passes."""


def read(ctx):
    calls = overlapped = 0
    for p in ctx.passes:
        m = p["metrics"]
        if "route_calls" in m:
            calls += m["route_calls"]
            overlapped += m["route_calls_overlapped"]
    if not calls:
        return None
    return 100.0 * overlapped / calls
