"""100 less the mean over the cards the run used of each card's busy
share of the traced window, %: a card's busy time the union of its
profiler device intervals (chip_profile.py's arithmetic,
``yardstick.mean_busy``)."""

from benchmark.yardstick import mean_busy


def read(run):
    if run.trace_window is None or not run.device_by_card or not run.cards:
        return None
    lo, hi = run.trace_window
    mean = mean_busy(run.device_by_card, run.cards, run.trace_window)
    return 100.0 * (1.0 - mean / (hi - lo))
