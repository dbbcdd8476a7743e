"""Reads scored in the window (scores on the host), over the whole window
(host clock)."""


def read(run):
    return run.reads / run.window_s
