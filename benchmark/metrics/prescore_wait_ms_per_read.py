"""Host ms the main thread of ``lasagna``'s batch loop waits on the
scorer thread (the port's ``lasagna.prescore_wait`` spans) per read of the
window."""

from benchmark.program_spans import ms_per_read


def read(run):
    return ms_per_read(run, ("lasagna.prescore_wait",))
