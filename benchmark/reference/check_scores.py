"""The check of a scoring cell: every score the window's calls returned,
against the reference's score of the same read.  Exact: each limit is 0.
"""

from __future__ import annotations

import numpy as np

from .dp import best_scores


def check(outputs, ctx):
    costs = ctx.config["costs"]
    free = ctx.config["span"] != "global"
    used = sorted({k for k, _ in outputs["calls"]})
    want = {k: best_scores(ctx.ref_graph, ctx.batches[k], costs, free,
                           device=ctx.device) for k in used}
    mismatches = missing = 0
    for k, got in outputs["calls"]:
        got = np.asarray(got)
        if got.shape != want[k].shape:
            missing += want[k].shape[0]
            continue
        mismatches += int((got.astype(np.int64) != want[k]).sum())
    return [("score_mismatches", mismatches, 0),
            ("answers_missing", missing, 0)]
