"""Batch read mapping against a static graph: port of the single-device
part of ``poasta_tpu/parallel/mapper.py`` (scoring of global and ends-free
spans, alignment of global spans)."""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ..aligner.banded import BandedScorer
from ..aligner.costs import EndsFree, Global
from ..aligner.wavefront import (
    DeviceGraph,
    backtrace_dense,
    dp_fill_full,
    pack_queries,
)
from ..ops.trace import trace_align, trace_enabled


class BatchMapper:
    """lasagna's batch read mapper: scores and aligns batches of reads
    against one static POA graph, deterministically.

    The graph is flattened and placed on ``device`` once (None: the card;
    raises without one).  Scores come from the banded scorer (exact by
    verify-and-retry, the full-width fill as its last resort), under
    ``aln_type``: None or Global, or an ``EndsFree`` span.  Alignments, of
    global spans only so far, come from dense tables and a host
    backtrace for small batches, and otherwise from the device traceback,
    with the native engine's banded backtrace for the reads the trace
    leaves unverified.
    """

    # dense tables cost Np*B*L*12 bytes; past this budget align_batch takes
    # the banded route (the reference's rule, so both packages route alike)
    DENSE_TABLE_BUDGET = 64 * 1024 * 1024

    def __init__(self, graph, costs, device=None, batch_size: int = 64,
                 aln_type=None):
        if getattr(costs, "is_two_piece", False):
            raise NotImplementedError("two-piece costs are not ported yet")
        if aln_type is not None \
                and not isinstance(aln_type, (Global, EndsFree)):
            raise TypeError(f"unknown alignment span {aln_type!r}")
        self.graph = graph
        self.flat = graph.flatten()
        self.dg = DeviceGraph.build(self.flat, device=device)
        self.costs = costs
        self.batch_size = batch_size
        self.aln_type = aln_type
        self.ends_free = isinstance(aln_type, EndsFree)
        self.scorer = BandedScorer(self.flat, costs, dg=self.dg,
                                   aln_type=aln_type)
        self._native = None
        self.last_banded_stats = {"device_traced": 0, "host_backtraced": 0}

    def score_batch(self, queries) -> np.ndarray:
        """(B,) exact alignment scores of byte-string reads under the
        mapper's span."""
        qshift, lengths = pack_queries(queries, device=self.dg.device)
        return self.scorer.scores(qshift, lengths)

    def _table_bytes(self, n_reads: int, L: int) -> int:
        return self.dg.n_nodes_padded * n_reads * L * 12

    def align_batch(self, queries, prescored=None):
        """[(score, alignment)] of a read batch, in input order.

        Small shapes: one fill returns dense M/I/D tables and the host
        backtraces them.  Past :data:`DENSE_TABLE_BUDGET`: exact banded
        scores, then the device traceback (see :meth:`_align_batch_banded`).
        ``prescored`` is :meth:`prescore`'s token for this batch.
        """
        if self.ends_free:
            raise NotImplementedError(
                "aligning an ends-free span is not ported yet "
                "(score_batch scores it)")
        if not queries:
            return []
        pre_scores = None
        if prescored is not None and prescored[0] is queries:
            # reuse the packed batch: re-packing would upload it again
            pre_scores, qshift, lengths = prescored[1:]
        else:
            qshift, lengths = pack_queries(queries, device=self.dg.device)
        B, L = int(qshift.shape[0]), int(qshift.shape[1])
        if self._table_bytes(B, L) > self.DENSE_TABLE_BUDGET:
            return self._align_batch_banded(queries, qshift, lengths,
                                            scores=pre_scores)
        self.last_banded_stats = {"device_traced": 0, "host_backtraced": 0}
        scores, M, I, D = dp_fill_full(self.dg, qshift, lengths, self.costs)
        scores = scores.cpu().numpy()
        M, I, D = M.cpu().numpy(), I.cpu().numpy(), D.cpu().numpy()
        return [(int(scores[b]),
                 backtrace_dense(self.flat, M[:, b, :], I[:, b, :],
                                 D[:, b, :], q, self.costs))
                for b, q in enumerate(queries)]

    def _init_banded(self) -> None:
        """Construct the native engine once.  A missing native library
        raises: the banded route has no other host backtrace."""
        if self._native is None:
            from ..native import NativeAligner

            self._native = NativeAligner(self.graph)

    def _device_scores(self, qshift, lengths) -> np.ndarray:
        """The scoring phase of the banded route (the pipelined serving
        loop runs it on a worker thread while the main thread aligns the
        previous batch)."""
        return self.scorer.scores(qshift, lengths)

    def takes_banded_path(self, queries) -> bool:
        """Whether align_batch would take the banded route for this batch,
        from the raw reads (no packing, no upload): the batches whose
        scoring :meth:`prescore` can overlap with alignment."""
        maxlen = max((len(q) for q in queries), default=0)
        L = ((maxlen + 1 + 127) // 128) * 128  # pack_queries' padding rule
        return self._table_bytes(len(queries), L) > self.DENSE_TABLE_BUDGET

    def prescore(self, queries):
        """Run the scoring phase of a batch ahead of time.

        Returns a token for ``align_batch(prescored=...)``, or None when
        the batch takes the dense route (nothing to overlap).  Safe against
        a concurrent :meth:`align_batch` of another prescored batch, not
        against concurrent prescore calls.
        """
        if not self.takes_banded_path(queries):
            return None
        self._init_banded()
        qshift, lengths = pack_queries(queries, device=self.dg.device)
        return (queries, self._device_scores(qshift, lengths), qshift,
                lengths)

    def _align_batch_banded(self, queries, qshift, lengths, scores=None):
        """Device traceback first: the trace kernel and decode rebuild
        every verified read's alignment on the device, identical to the
        native backtrace.  Reads the trace returns as None (unverified at
        every tier, INF or empty) take ``NativeAligner.align_banded``
        seeded with their exact score, on a thread per core.  An error in
        the trace propagates."""
        self._init_banded()
        na = self._native
        if scores is None:
            scores = self._device_scores(qshift, lengths)
        out = [None] * len(queries)
        stats = {"device_traced": 0, "host_backtraced": 0}
        if trace_enabled():
            traced = trace_align(self.dg, self.flat, qshift, lengths,
                                 self.costs, scores)
            for b, aln in enumerate(traced):
                if aln is not None:
                    out[b] = (int(scores[b]), aln)
                    stats["device_traced"] += 1

        rest = [b for b in range(len(queries)) if out[b] is None]
        if rest:
            def one(b):
                score, aln = na.align_banded(queries[b], self.costs,
                                             ub=int(scores[b]))
                if score != int(scores[b]):
                    raise RuntimeError(
                        f"read {b}: native banded score {score} != device "
                        f"score {int(scores[b])}")
                return score, aln

            stats["host_backtraced"] = len(rest)
            workers = max(1, min(len(rest), os.cpu_count() or 4))
            with ThreadPoolExecutor(max_workers=workers) as pool:
                for b, res in zip(rest, pool.map(one, rest)):
                    out[b] = res
        self.last_banded_stats = stats
        return out
