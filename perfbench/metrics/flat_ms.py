"""The flat engine's stages of a fenced pass, moments and pairs, in ms
(median over the fenced passes)."""


def read(ev):
    return ev.stage_ms("device sweep (flat moments)", "device sweep (flat pairs)")
