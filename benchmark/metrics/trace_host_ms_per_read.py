"""Host ms of the trace driver's host stages (the port's ``trace.inputs``
and ``trace.replay`` spans) per read of the window."""

from benchmark.program_spans import TRACE_HOST, ms_per_read


def read(run):
    return ms_per_read(run, TRACE_HOST)
