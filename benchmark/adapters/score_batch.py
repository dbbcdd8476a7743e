"""``BatchMapper.score_batch`` on the traffic's batches, cycled in order:
each call scores one batch of reads, the scores on the host.  The warm-up
scores each batch once, so the window sees the ladder's ub hints and
window layouts as a caller with a steady length profile does."""

from __future__ import annotations

import numpy as np

from . import port as port_mod


def start(ctx):
    return Caller(ctx)


class Caller:
    def __init__(self, ctx):
        port = port_mod.names()
        _, _, self.mapper = port_mod.mapper(ctx, port)
        self.score = ctx.spans.wrap(self.mapper.score_batch, "score_batch")
        self.batches = ctx.batches
        self.calls = []

    def warm_up(self):
        for batch in self.batches:
            self.mapper.score_batch(batch)
        self.mapper.scorer.reset_stats()

    def step(self) -> int:
        k = len(self.calls) % len(self.batches)
        scores = np.asarray(self.score(self.batches[k]))
        self.calls.append((k, scores))
        return len(self.batches[k])

    def counters(self) -> dict:
        return {**self.mapper.scorer.stats,
                "calls": len(self.calls),
                "batch_of_call": [k for k, _ in self.calls]}

    def outputs(self) -> dict:
        return {"kind": "scores", "calls": self.calls}

    def close(self):
        self.mapper = self.score = None
