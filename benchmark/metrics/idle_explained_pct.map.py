"""The share of the traced window's device-idle time (the gaps no device
interval covers) that the port's own leaf spans cover, their union over
threads, % (``benchmark.program_spans``)."""

from benchmark.program_spans import idle_explained_pct


def read(run):
    return idle_explained_pct(run)
