"""The least time of a pass's work over its device time, in %: the stack
read once and the table written once (roofline.pass_bytes) at the card's
peak bandwidth (peaks.json), over the device time of a traced pass."""


def read(ev):
    dev = ev.device_ms()
    if dev is None or ev.peak_bytes_per_s is None:
        return None
    return 100.0 * (ev.work_bytes / ev.peak_bytes_per_s) / (dev / 1e3)
