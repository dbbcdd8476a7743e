"""The profiler's device time of the trace fill (``trace_fill_kernel``,
B18) over the cells the port handed it (its ``cells.trace_fill`` counter:
ranks x reads x tier width a launch), ns a cell."""

from benchmark.program_spans import ns_per_cell


def read(run):
    return ns_per_cell(run, r"\btrace_fill_kernel\b", "cells.trace_fill")
