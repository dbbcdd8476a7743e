"""The profiler's device time of the seeded corridor fill
(``seed_fill_kernel``, B8) over the cells the port handed it (its
``cells.seed_fill`` counter: each read's corridor ranks x the corridor
width a launch), ns a cell."""

from benchmark.program_spans import ns_per_cell


def read(run):
    return ns_per_cell(run, r"\bseed_fill_kernel\b", "cells.seed_fill")
