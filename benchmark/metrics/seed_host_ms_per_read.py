"""Host ms of seeding's host stages (the port's ``seed.hits``,
``seed.clusters`` and ``seed.certify`` spans) per read of the window."""

from benchmark.program_spans import SEED_HOST, ms_per_read


def read(run):
    return ms_per_read(run, SEED_HOST)
