"""Device scoring beside the sequential graph-fusion loop: port of
``poasta_tpu/aligner/fusion_assist.py``.

``poasta align`` fuses sequences one at a time, and each alignment depends
on the graph the previous fusion left, so the loop cannot batch.  What can
overlap: while the native engine aligns sequence *i* on the host, the card
scores sequence *i+1* against the current graph on a worker thread.
Fusion only adds nodes and edges, so the optimal score against the graph
before the fusion is an upper bound on the score against the graph after
it, and seeding the native banded fill with it makes the first fill verify
at a near-minimal band width.

``take()`` never blocks: a result that is not ready yet is left for no one
(the caller seeds the band its own way, and the late result is discarded).
The seed only changes the band's width, and the native verify-and-retry
certifies the optimum either way, so the alignment does not depend on it.
An error in the background scoring is not a late result: it is kept and
re-raised by the next ``take()``, ``prefetch()`` or ``close()``.
"""

from __future__ import annotations

from concurrent.futures import Future, ThreadPoolExecutor
from typing import Optional

from ..utils.device import resolve_device


class DeviceSeedPrefetcher:
    """Background scoring of the next sequence to fuse, on ``device``
    (None: the card; raises without one).

    ``stats`` counts prefetches ``started``, ``finished`` (a score was
    computed) and ``taken`` (a score was handed to the caller).  Call
    :meth:`close` when done: it waits for the prefetch in flight.
    """

    def __init__(self, costs, device=None) -> None:
        self.costs = costs
        self.device = resolve_device(device)
        # one worker: prefetches never stack up, and the future carries a
        # worker error to the caller's thread
        self._pool = ThreadPoolExecutor(max_workers=1)
        self._future: Optional[Future] = None
        self._seq: Optional[bytes] = None  # request identity for take()
        self._last_score: Optional[int] = None
        self.stats = {"started": 0, "finished": 0, "taken": 0}

    def _score(self, flat, seq: bytes, hint: Optional[int]) -> int:
        from .banded import BandedScorer
        from .wavefront import DeviceGraph, pack_queries

        dg = DeviceGraph.build(flat, device=self.device)
        scorer = BandedScorer(flat, self.costs, dg=dg)
        qshift, lengths = pack_queries([seq], device=self.device)
        ub = None if hint is None else hint * 5 // 4 + 32
        score = int(scorer.scores(qshift, lengths, ub=ub)[0])
        self.stats["finished"] += 1
        return score

    def prefetch(self, graph, seq: bytes) -> bool:
        """Start scoring ``seq`` against a snapshot of ``graph``.

        The flatten runs here (the caller mutates the graph later); the
        device layout and the scoring run on the worker thread.  Returns
        False, and does nothing, while the previous prefetch is still
        running.  A finished prefetch that failed raises its error here
        if no :meth:`take` has.
        """
        if self._future is not None:
            if not self._future.done():
                return False
            self._future.result()  # re-raises a worker error
        flat = graph.flatten()
        self._seq = seq
        self._future = self._pool.submit(self._score, flat, seq,
                                         self._last_score)
        self.stats["started"] += 1
        return True

    def take(self, seq: Optional[bytes] = None) -> Optional[int]:
        """The prefetched score if it is ready and was computed for ``seq``
        (by identity), else None, without waiting.  A result for another
        sequence would seed the band with an unrelated bound, so it is
        discarded.  A worker error raises here."""
        fut = self._future
        if fut is None or not fut.done():
            return None
        self._future = None
        score = fut.result()  # re-raises a worker error
        if seq is not None and self._seq is not seq:
            return None
        self._last_score = score
        self.stats["taken"] += 1
        return score

    def close(self) -> None:
        """Wait for the prefetch in flight and stop the worker; a worker
        error raises here."""
        fut, self._future = self._future, None
        try:
            if fut is not None:
                fut.result()
        finally:
            self._pool.shutdown(wait=True)
