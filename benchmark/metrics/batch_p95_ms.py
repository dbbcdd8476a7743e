"""The 95th percentile of the host wall of every call in the window, ms:
the latency of one ``score_batch`` call as a library caller feels it."""

from benchmark.yardstick import percentile


def read(run):
    return percentile([t1 - t0 for t0, t1, _ in run.calls], 95) * 1e3
