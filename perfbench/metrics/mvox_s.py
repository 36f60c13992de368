"""Voxels analysed in the window over the window's seconds, in Mvox/s."""


def read(ev):
    return ev.voxels / ev.window_s / 1e6 if ev.window_s > 0 else None
