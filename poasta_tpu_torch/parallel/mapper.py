"""Batch read mapping against a static graph: port of the global,
single-device part of ``poasta_tpu/parallel/mapper.py``."""

from __future__ import annotations

import numpy as np

from ..aligner.banded import BandedScorer
from ..aligner.wavefront import DeviceGraph, pack_queries


class BatchMapper:
    """Scores batches of reads against one static POA graph.

    The graph is flattened and placed on ``device`` once; each batch is
    packed there and scored exactly by the banded scorer, which falls
    back to the full-width fill internally when banding does not pay.
    """

    def __init__(self, graph, costs, device="cpu"):
        if getattr(costs, "is_two_piece", False):
            raise NotImplementedError("two-piece costs are not ported yet")
        self.graph = graph
        self.flat = graph.flatten()
        self.dg = DeviceGraph.build(self.flat, device=device)
        self.costs = costs
        self.scorer = BandedScorer(self.flat, costs, dg=self.dg)

    def score_batch(self, queries) -> np.ndarray:
        """(B,) exact global alignment scores of byte-string reads."""
        qshift, lengths = pack_queries(queries, device=self.dg.device)
        return self.scorer.scores(qshift, lengths)
