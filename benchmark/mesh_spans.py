"""The port's ``mesh.shard`` spans with their attributes (the card a
block ran on and its stage), as the readers of a mesh cell see them.

``program_spans.recorded`` keeps no span attributes, so this module drains
the recorder itself at the first read and leaves what ``recorded`` would
have made on the run for the other readers.  Where another reader drained
it first, or the run was untraced, or the port has no recorder, it has
nothing to read (None).
"""

from __future__ import annotations

import sys

from .program_spans import RECORDER


def shard_seconds(run):
    """{card: host seconds of its ``mesh.shard`` spans} over the run's
    traced window, every card of the cell present (0.0 where it ran none);
    None where the port recorded no ``mesh.shard`` span."""
    if run.trace_window is None:
        return None
    shards = getattr(run, "_mesh_shards", None)
    if shards is None:
        if getattr(run, "_program_spans", None) is not None:
            return None
        mod = sys.modules.get(RECORDER)
        if mod is None:
            return None
        raw = mod.drain()
        shift = run.trace_window[1] - run.calls[-1][1]
        run._program_spans = {
            "spans": [(s.name, s.id, s.parent, s.thread,
                       s.start_ns * 1e-9 + shift, s.end_ns * 1e-9 + shift)
                      for s in raw["spans"]],
            "counts": dict(raw["counts"])}
        shards = run._mesh_shards = [
            (s.attrs["card"], (s.end_ns - s.start_ns) * 1e-9)
            for s in raw["spans"] if s.name == "mesh.shard"]
    if not shards:
        return None
    out = {card: 0.0 for card in range(len(run.ctx.devices))}
    for card, secs in shards:
        out[card] = out.get(card, 0.0) + secs
    return out
