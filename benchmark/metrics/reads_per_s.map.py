"""Reads mapped in the window (a GAF record written), over the whole
window (host clock)."""


def read(run):
    return run.reads / run.window_s
