"""The share of a pass in which the device is idle, in %: one less the
device time of a traced pass over the mean pass of the untraced window.
The profiled window's own gaps are not used: the profiler slows the host."""

import statistics


def read(ev):
    dev = ev.device_ms()
    if dev is None or not ev.pass_s:
        return None
    return 100.0 * (1.0 - dev / (statistics.fmean(ev.pass_s) * 1e3))
