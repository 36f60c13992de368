"""The combine and pair reduce stage of a fenced pass, in ms (median)."""


def read(ev):
    return ev.stage_ms("combine + pair reduce")
