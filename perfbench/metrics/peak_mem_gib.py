"""The device memory the program held at the window's peak above what was
allocated when the window opened (the resident frames), in GiB."""


def read(ev):
    return ev.peak_window_bytes / 2**30 if ev.peak_window_bytes > 0 else None
