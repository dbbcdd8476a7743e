"""The profiler's device time of the full-fill kernels (``full_fill_*``:
B7, the capped tail of the reads the seeded corridors leave unresolved)
over the cells the port handed them (its ``cells.tail_fill`` counter:
ranks x padded length x reads a launch, cap retries included), ns a
cell."""

from benchmark.program_spans import ns_per_cell


def read(run):
    return ns_per_cell(run, r"\bfull_fill_\w*kernel", "cells.tail_fill")
