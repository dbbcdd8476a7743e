"""100 less the union of the profiler's device intervals over the traced
window, % (chip_profile.py's arithmetic, ``yardstick.busy_union``)."""

from benchmark.yardstick import busy_union


def read(run):
    if run.trace_window is None or not run.device:
        return None
    lo, hi = run.trace_window
    busy = busy_union([(s, e) for _, s, e in run.device])
    return 100.0 * (1.0 - busy / (hi - lo))
