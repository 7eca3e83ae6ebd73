"""The wavefront engine's rung-ladder lanes that came back censored, over
the lanes it launched there (%): align_reads' `wfa_rung_lanes_censored`
and `wfa_rung_lanes` in the window's passes."""


def read(ctx):
    lanes = censored = 0
    for p in ctx.passes:
        m = p["metrics"]
        if m.get("wfa_rung_lanes"):
            lanes += m["wfa_rung_lanes"]
            censored += m["wfa_rung_lanes_censored"]
    if not lanes:
        return None
    return 100.0 * censored / lanes
