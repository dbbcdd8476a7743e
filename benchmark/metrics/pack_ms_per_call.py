"""Host ms of packing and upload (the port's ``mapper.pack`` spans) per
``score_batch`` call (its ``mapper.score_batch`` spans)."""

from benchmark.program_spans import ms_per_span


def read(run):
    return ms_per_span(run, ("mapper.pack",), "mapper.score_batch")
