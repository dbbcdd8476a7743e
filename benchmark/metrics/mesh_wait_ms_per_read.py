"""Host ms the threads that deal batches to the cards wait for their
blocks (the port's ``mesh.gather`` spans, the main thread's and the scorer
thread's) per read of the window."""

from benchmark.mesh_spans import shard_seconds
from benchmark.program_spans import recorded, seconds


def read(run):
    shard_seconds(run)  # the first reader drains the recorder with attrs
    rec = recorded(run)
    if rec is None or not run.reads \
            or not any(s[0] == "mesh.gather" for s in rec["spans"]):
        return None
    return seconds(rec, ("mesh.gather",)) * 1e3 / run.reads
