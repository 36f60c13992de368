"""A fenced pass's time less the sum of its stages, in ms (median): the
engine's own host work between the stages."""


def read(ev):
    return ev.host_ms()
