"""The 95th percentile of every pass of the window, from the call to its
table on the host, in ms (linear interpolation between ranks)."""

import numpy as np


def read(ev):
    return float(np.percentile(ev.pass_s, 95)) * 1e3 if ev.pass_s else None
