"""Seconds from the process's start to the first timed pass: frames made,
ingested, and every shape of the window warmed up."""


def read(ev):
    return ev.setup_s
