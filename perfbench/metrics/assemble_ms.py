"""The readback and host assemble stage of a fenced pass, in ms (median)."""


def read(ev):
    return ev.stage_ms("readback + host assemble")
