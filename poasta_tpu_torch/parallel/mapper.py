"""Batch read mapping against a static graph, on one device or over a
mesh: port of ``poasta_tpu/parallel/mapper.py`` (scoring and alignment of
global and ends-free spans under one- and two-piece costs).

The mesh (:mod:`..utils.mesh`) is a (dp, sp) grid of devices driven by
this one process, as one controller drives the reference's ``shard_map``:

* ``dp`` splits the read batch (the reference's ``-j`` fan-out as a mesh
  axis).  The graph replicates, once per distinct device; each shard runs
  the same kernel on its own device, and no communication is needed until
  the scores gather.
* ``sp`` splits the query offsets of each read (:func:`_sp_scan_rows`):
  per rank a one-column halo of the predecessors' M row from the previous
  slab (the reference's ``ppermute``), and the insertion chain's affine
  prefix-min as local cummins, the slabs' totals gathered and an exclusive
  combine (its ``all_gather``).  The reference calls it a correctness
  demonstrator and runs it as an XLA scan; here it is plain PyTorch, on
  the card too.
"""

from __future__ import annotations

import copy
import os
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..aligner.banded import LADDER_INF_SKIP, BandedScorer, run_capped_ladder
from ..aligner.costs import EndsFree, Global
from ..aligner.seeds import (
    KmerIndex,
    certify_reads,
    propose_clusters,
    subset_hits,
)
from ..aligner.wavefront import (
    DeviceGraph,
    backtrace_dense,
    dp_fill_ends_free_with_ends,
    dp_fill_full,
    dp_fill_scores,
    dp_fill_scores_ends_free,
    pack_queries,
    query_end_lo,
)
from ..ops.dp_rows import INF
from ..ops.seed import seed_scores
from ..ops.trace import trace_align, trace_enabled
from ..utils import spans
from ..utils.mesh import (
    Mesh,
    bound_to,
    check_mesh,
    dp_shards,
    gather,
    make_mesh,
    parse_mesh_spec,
)

__all__ = ["BatchMapper", "Mesh", "TailPool", "make_mesh",
           "make_sharded_score_fn", "parse_mesh_spec"]


class TailPool:
    """The reads of several batches that their seeded corridors left
    unresolved, gathered for one capped full fill.

    ``lasagna``'s chunk loop owns one a chunk: ``prescore(queries,
    pool=pool)`` appends each batch's unresolved reads in row order instead
    of filling them, and :meth:`BatchMapper.fill_tail_pool` fills them all
    in one launch (one thread block a read, so one read alone leaves all
    but one SM idle).  Only the thread that scores writes it.

    Under a mapper's replicas (:meth:`BatchMapper._on_cards`) each card
    keeps a pool of its own, ``parts[card]``, and fills it on that card;
    ``cards`` names the card of each read of ``reads``."""

    def __init__(self):
        self.reads: list = []
        self.parts: list = []
        self.cards: list = []

    @staticmethod
    def deferred(token) -> np.ndarray:
        """The rows of a :meth:`BatchMapper.prescore` token whose reads
        joined a pool (none for a token made without one)."""
        if isinstance(token, _Dealt):
            return token.deferred
        if token is None or len(token) < 5:
            return np.zeros(0, dtype=np.int64)
        return token[4]


class _Dealt:
    """A token of a mapper with replicas: ``parts`` holds (card, the rows
    of ``queries`` the card holds, the card's own token or None), and
    ``deferred`` the rows that joined a :class:`TailPool`."""

    __slots__ = ("queries", "parts", "deferred")

    def __init__(self, queries, parts, deferred):
        self.queries, self.parts, self.deferred = queries, parts, deferred


# the counts of ``last_seed_stats`` that a mapper with replicas sums over
# its cards
SEED_COUNTS = ("seeded", "seed_tail", "seed_attempts", "cert_failed",
               "unverified", "no_cluster")


def _summed(stats, keys=None):
    """Per-card counter dicts summed key by key (``keys``: those keys
    alone); None where no card set one."""
    got = [s for s in stats if s]
    if not got:
        return None
    return {k: sum(s[k] for s in got) for k in keys or got[0]}


def _sp_scan_rows(dg: DeviceGraph, qshift: torch.Tensor,
                  lengths: torch.Tensor, devices, costs, free_start: bool,
                  free_end: bool) -> torch.Tensor:
    """(B,) one-piece scores of one dp shard's reads, the query offsets
    split into ``len(devices)`` contiguous slabs, slab k on ``devices[k]``:
    the reference's shard body (``poasta_tpu/parallel/mapper.py:79-177``),
    one rank at a time across the slabs, in plain PyTorch.

    Per rank, each slab takes its diagonal term's column 0 from the
    previous slab's last column of the predecessors' min M row, moved to
    its device (the halo); its insertion chain is the affine prefix-min of
    A - e*j, a local cummin joined with the min of the earlier slabs'
    totals (the gather and exclusive combine).  A read's value at its
    length lives on one slab; the min over the slabs picks it.  Scores
    return on ``devices[0]``."""
    o, e, x = costs.gap_open, costs.gap_extend, costs.mismatch
    B, L = qshift.shape
    sp = len(devices)
    edges = np.cumsum([0] + [L // sp + (k < L % sp) for k in range(sp)])
    slabs = []
    for k, dev in enumerate(devices):
        a, b = int(edges[k]), int(edges[k + 1])
        idx = lengths.to(dev).long() - a
        ring = (B, dg.window, b - a)
        slabs.append({
            "dev": dev, "q": qshift[:, a:b].to(dev),
            "j": torch.arange(a, b, dtype=torch.int32, device=dev),
            "idx": idx.clamp(0, max(b - a - 1, 0)).view(-1, 1),
            "in": (idx >= 0) & (idx < b - a),
            "M": torch.full(ring, INF, dtype=torch.int32, device=dev),
            "D": torch.full(ring, INF, dtype=torch.int32, device=dev)})
    symbols = dg.symbols.tolist()
    slots = dg.pred_slots.tolist()
    valid = dg.pred_valid.tolist()
    wslots = dg.write_slots.tolist()
    end = dg.end_rank_i
    out_dev = devices[0]
    inf_col = torch.full((B,), INF, dtype=torch.int32, device=out_dev)
    score, best = None, inf_col
    for r in range(end + 1):
        live = [sl for sl, ok in zip(slots[r], valid[r]) if ok]
        origin = r == 0 or (free_start and r < end)
        halo = None
        for k, sl in enumerate(slabs):
            if live:
                min_pm = sl["M"][:, live].min(dim=1).values
                min_pd = sl["D"][:, live].min(dim=1).values
            else:
                min_pm = torch.full_like(sl["M"][:, 0], INF)
                min_pd = min_pm
            D = torch.minimum(min_pm + (o + e), min_pd + e)
            halo_in = torch.full_like(min_pm[:, :1], INF) if halo is None \
                else halo.to(sl["dev"])
            halo = min_pm[:, -1:]
            diag = torch.cat([halo_in, min_pm[:, :-1]], dim=1) + torch.where(
                sl["q"] == symbols[r], 0, x).to(torch.int32)
            A = torch.minimum(diag, D)
            if origin and k == 0:
                A[:, 0] = torch.clamp(A[:, 0], max=0)
            cum = torch.cummin(A - e * sl["j"], dim=1).values
            sl.update(min_pm=min_pm, D_row=D, A=A, cum=cum)
        totals = [sl["cum"][:, -1] for sl in slabs]
        at_len = inf_col
        for k, sl in enumerate(slabs):
            excl = torch.full_like(totals[k], INF)
            for t in totals[:k]:
                excl = torch.minimum(excl, t.to(sl["dev"]))
            prefix = torch.minimum(sl["cum"], excl.view(-1, 1))
            prefix = torch.cat([excl.view(-1, 1), prefix[:, :-1]], dim=1)
            if r == end:
                # the virtual end node: a zero-cost hop at the same offset
                M = sl["min_pm"]
                D = torch.full_like(M, INF)
            else:
                I = torch.clamp(prefix + o + e * sl["j"], max=INF)
                M = torch.minimum(sl["A"], I)
                D = torch.clamp(sl["D_row"], max=INF)
            sl["M"][:, wslots[r]] = M
            sl["D"][:, wslots[r]] = D
            here = torch.where(sl["in"], M.gather(1, sl["idx"])[:, 0], INF)
            at_len = torch.minimum(at_len, here.to(out_dev))
        if r == end:
            score = at_len
        elif free_end and r > 0:
            best = torch.minimum(best, at_len)
    return torch.minimum(score, best) if free_end else score


def make_sharded_score_fn(dg: DeviceGraph, costs, mesh: Mesh,
                          free_start: bool = False, free_end: bool = False):
    """``fn(qshift (B, L), lengths (B,)) -> (B,)`` scores over ``mesh``,
    gathered on its first device.

    The reads split over dp; the graph replicates, once per distinct
    device.  With sp = 1 each shard runs the full-fill kernel on the first
    device of its mesh row through :func:`..aligner.wavefront.dp_fill_scores`
    (B2, B12 for two-piece costs; with free graph ends B2f, B12f), at any
    shard size.  With sp > 1 each dp shard runs :func:`_sp_scan_rows` across
    its row's devices (one-piece costs only, as in the reference).  A
    shard's error reaches the caller: ``poasta_tpu`` takes its XLA body
    after any exception of the sharded kernel
    (``poasta_tpu/parallel/mapper.py:245-253``), the port does not.
    """
    check_mesh(mesh)
    if mesh is None:
        raise ValueError("make_sharded_score_fn needs a mesh")
    sp = mesh.shape["sp"]
    if sp > 1 and costs.is_two_piece:
        raise NotImplementedError(
            "two-piece sharded scoring needs a dp-only mesh (sp = 1), or "
            "BandedScorer(mesh=...)")

    def fn(qshift, lengths):
        B = int(qshift.shape[0])
        parts = []
        for row, (dev, rows) in enumerate(dp_shards(mesh, B, mesh.first)):
            if sp == 1:
                parts.append(dp_fill_scores(
                    dg.on(dev), qshift[rows].to(dev), lengths[rows].to(dev),
                    costs, free_start, free_end))
            else:
                parts.append(_sp_scan_rows(
                    dg.on(dev), qshift[rows], lengths[rows],
                    list(mesh.devices[row]), costs, free_start, free_end))
        return gather(parts, mesh.first)

    return fn


class BatchMapper:
    """lasagna's batch read mapper: scores and aligns batches of reads
    against one static POA graph, deterministically.

    The graph is flattened and placed on ``device`` once (None: the card,
    or the mesh's first device; raises without one).  Scores come from the
    banded scorer (exact by verify-and-retry, the full-width fill as its
    last resort), under ``aln_type``: None or Global, or an ``EndsFree``
    span.  ``costs``: ``GapAffine`` or ``GapAffine2Piece``.  Alignments of a
    global span come from dense tables and a host backtrace for small
    one-piece batches, and otherwise from the device traceback, with the
    native engine's banded backtrace for the reads the trace leaves
    unverified; two-piece costs always take the banded route and skip the
    trace (it is one-piece), so the native engine backtraces every read,
    seeded with its exact device score.  Alignments of an ends-free span
    (see :meth:`_align_batch_ends_free`) come from a fill that also returns
    each read's end state (seeded corridors on large graphs once a batch
    has taught the score rates, the full-width fill otherwise), then the
    device traceback anchored at that end state, with the native engine's
    anchored corridor for the rest; two-piece costs neither seed nor trace,
    as in ``poasta_tpu``, so every read takes the anchored corridor.

    ``mesh``: None, or a port mesh (:mod:`..utils.mesh`) over which the
    batch splits.  A one-piece ends-free span over a dp-only mesh (sp = 1;
    ``lasagna --mesh auto``'s) keeps ``replicas``: one single-card mapper
    a mesh row, on that row's device, each with its own graph copy,
    scorer, ub hints, seed rates and tail pool, sharing the host k-mer
    index and native engine.  :meth:`prescore`, :meth:`fill_tail_pool`
    and :meth:`align_batch` deal a batch to them in contiguous blocks
    (:func:`..utils.mesh.dp_shards`), each block on a thread bound to its
    card through the whole one-card path (seeded corridors, certificate,
    capped tail, anchored trace and decode), and gather the results on the
    host in input order; ``last_seed_stats`` sums the cards' counts
    (``"cards"``: each card's own).  Every other mesh follows the
    reference's branches: ``score_batch`` takes the sharded full fill
    under a global span (:func:`make_sharded_score_fn`), the sharded
    banded scorer under two-piece costs, and the sharded bounded fill
    under an ends-free span; ``align_batch`` takes the banded route at
    every size, with no capped ladder and no seeding, and the trace and
    the decode run on the mesh's first device.
    """

    # dense tables cost Np*B*L*12 bytes; past this budget align_batch takes
    # the banded route (the reference's rule, so both packages route alike)
    DENSE_TABLE_BUDGET = 64 * 1024 * 1024
    # seeding engages on its own from this graph size up (the full bounded
    # fill pays n_ranks x L per read; below this a corridor saves too few
    # cells).  POASTA_SEED: "0" off, "all" every graph size, default auto.
    SEED_MIN_NODES = 8192

    def __init__(self, graph, costs, mesh=None, batch_size: int = 64,
                 aln_type=None, *, device=None):
        check_mesh(mesh)
        if aln_type is not None \
                and not isinstance(aln_type, (Global, EndsFree)):
            raise TypeError(f"unknown alignment span {aln_type!r}")
        self.graph = graph
        self.flat = graph.flatten()
        self.mesh = mesh
        if device is None and mesh is not None:
            device = mesh.first
        self.costs = costs
        self.batch_size = batch_size
        self.aln_type = aln_type
        self.ends_free = isinstance(aln_type, EndsFree)
        self._native = None
        # the host k-mer index, built at the first eligible batch by the
        # mapper whose replicas share it (``_home``), under its lock; the
        # share of the host's cores this mapper's native pools take
        self._home = self
        self._index_lock = threading.Lock()
        self._seed_index = None
        self._host_share = 1
        self._place(DeviceGraph.build(self.flat, device=device))
        self.replicas = None
        if mesh is not None and self.ends_free \
                and not costs.is_two_piece and mesh.shape["sp"] == 1:
            self._init_banded()
            self.replicas = [self._replica(dev)
                             for dev in mesh.devices[:, 0]]

    def _place(self, dg) -> None:
        """The mapper's state on ``dg``'s device: the graph, the scorer,
        and what its batches teach it."""
        self.dg = dg
        # an ends-free span scores over the mesh through the bounded fill
        # (score_batch); its scorer keeps the span's tables and counters
        self.scorer = BandedScorer(self.flat, self.costs,
                                   mesh=None if self.ends_free else self.mesh,
                                   dg=dg, aln_type=self.aln_type)
        self._score_fn = None
        self.last_banded_stats = {"device_traced": 0, "host_backtraced": 0}
        # ends-free alignment: ub hints of the capped full fill per
        # (n_min, n_max); the (tight, wide) per-character score rates that
        # size the seeded corridors; the last batch's counters
        self._ef_ub_hint: dict = {}
        self._seed_rate = None
        self.last_seed_stats = None
        self.last_ends_free_stats = None

    def _replica(self, device) -> "BatchMapper":
        """A single-card mapper on ``device`` that shares this mapper's
        graph, flattening, native engine and k-mer index, and takes a
        mesh row's share of the host's cores for its native pools."""
        rep = copy.copy(self)
        rep.mesh = None
        rep._home = self
        rep._host_share = self.mesh.shape["dp"]
        rep._place(self.dg.on(device))
        return rep

    def _host_workers(self, n: int) -> int:
        """Threads of a native host pool for ``n`` reads: this mapper's
        share of the host's cores."""
        return max(1, min(n, (os.cpu_count() or 4) // self._host_share))

    def score_batch(self, queries) -> np.ndarray:
        """(B,) exact alignment scores of byte-string reads under the
        mapper's span."""
        with spans.span("mapper.score_batch"):
            qshift, lengths = self._pack(queries)
            if self.mesh is not None and self.ends_free:
                return dp_fill_scores_ends_free(
                    self.dg, self.flat, qshift, lengths, self.costs,
                    self.aln_type, mesh=self.mesh).cpu().numpy()
            if self.mesh is not None and not self.costs.is_two_piece:
                if self._score_fn is None:
                    self._score_fn = make_sharded_score_fn(
                        self.dg, self.costs, self.mesh)
                return self._score_fn(qshift, lengths).cpu().numpy()
            return self.scorer.scores(qshift, lengths)

    def _pack(self, queries):
        """:func:`pack_queries` on the graph's device: packing and
        upload."""
        with spans.span("mapper.pack"):
            return pack_queries(queries, device=self.dg.device)

    def _table_bytes(self, n_reads: int, L: int) -> int:
        return self.dg.n_nodes_padded * n_reads * L * 12

    def align_batch(self, queries, prescored=None):
        """[(score, alignment)] of a read batch, in input order.

        Small one-piece shapes: one fill returns dense M/I/D tables and the
        host backtraces them.  Past :data:`DENSE_TABLE_BUDGET`, and at any
        size under two-piece costs (the dense tables are one-piece): exact
        banded scores, then the traceback (see :meth:`_align_batch_banded`).
        ``prescored`` is :meth:`prescore`'s token for this batch; where
        that call deferred reads to a :class:`TailPool`, the list holds
        the other reads alone, in order (:meth:`TailPool.deferred` names
        the rows left out; :meth:`fill_tail_pool`'s token aligns them).
        """
        if not queries:
            return []
        if self.replicas is not None:
            return self._align_dealt(queries, prescored)
        with spans.span("mapper.align_batch"):
            return self._align_batch(queries, prescored)

    def _align_batch(self, queries, prescored):
        pre_scores = None
        if prescored is not None and prescored[0] is queries:
            # reuse the packed batch: re-packing would upload it again
            pre_scores, qshift, lengths = prescored[1:4]
            deferred = TailPool.deferred(prescored)
            if deferred.size:
                # the resolved rows alone: the pool's token aligns the rest
                keep = np.setdiff1d(np.arange(len(queries)), deferred)
                at = torch.as_tensor(keep, device=qshift.device)
                queries = [queries[b] for b in keep]
                qshift = qshift.index_select(0, at)
                lengths = lengths.index_select(0, at)
                pre_scores = tuple(a[keep] for a in pre_scores)
        else:
            qshift, lengths = self._pack(queries)
        if self.ends_free:
            return self._align_batch_ends_free(queries, qshift, lengths,
                                               pre_scores=pre_scores)
        B, L = int(qshift.shape[0]), int(qshift.shape[1])
        # with a mesh the banded route serves every size: it is the one
        # that shards (both routes give the same alignments)
        if self.mesh is not None or self.costs.is_two_piece \
                or self._table_bytes(B, L) > self.DENSE_TABLE_BUDGET:
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

    def supports_prescore(self, queries) -> bool:
        """Whether :meth:`prescore` has a scoring phase to overlap with the
        alignment of another batch (the CLI's pipeline gate).  About half of
        an ends-free span's scoring phase is host work (k-mer hits, cluster
        proposals), which only pays beside the alignment where a second
        core can run it."""
        if self.ends_free:
            return (os.cpu_count() or 1) > 1
        return self.takes_banded_path(queries)

    def takes_banded_path(self, queries) -> bool:
        """Whether align_batch would take the banded route for this batch,
        from the raw reads (no packing, no upload): the global-span batches
        whose scoring :meth:`prescore` can overlap with alignment (every
        batch under two-piece costs or a mesh)."""
        if self.ends_free:
            return False
        if self.costs.is_two_piece or self.mesh is not None:
            return True
        maxlen = max((len(q) for q in queries), default=0)
        L = ((maxlen + 1 + 127) // 128) * 128  # pack_queries' padding rule
        return self._table_bytes(len(queries), L) > self.DENSE_TABLE_BUDGET

    def prescore(self, queries, pool=None):
        """Run the scoring phase of a batch ahead of time.

        Returns a token for ``align_batch(prescored=...)``, or None when
        the batch takes the dense route (nothing to overlap).  Under an
        ends-free span the token carries (scores, end ranks, end offsets).
        Safe against a concurrent :meth:`align_batch` of another prescored
        batch, not against concurrent prescore calls.

        ``pool``: a :class:`TailPool` that the caller fills with
        :meth:`fill_tail_pool` once its last batch is prescored.  The reads
        the seeded corridors leave unresolved then join it unfilled, and
        the token ends with their rows.
        """
        if self.ends_free:
            if not queries:
                return None
        elif not self.takes_banded_path(queries):
            return None
        if self.replicas is not None:
            return self._prescore_dealt(queries, pool)
        with spans.span("mapper.prescore"):
            self._init_banded()
            qshift, lengths = self._pack(queries)
            if not self.ends_free:
                return queries, self._device_scores(qshift, lengths), \
                    qshift, lengths
            if pool is None:
                return queries, self._ends_free_scores(
                    queries, qshift, lengths), qshift, lengths
            sc, er, ej, deferred = self._ends_free_scores(
                queries, qshift, lengths, pool)
            return queries, (sc, er, ej), qshift, lengths, deferred

    def fill_tail_pool(self, pool):
        """Prescore's token for ``align_batch(pool.reads, prescored=...)``:
        one capped full fill (:meth:`_fill_ends_free_capped`, its ladder and
        ub hints) over every read of ``pool``, repacked from the reads (each
        batch padded its own).  Exact per read whichever reads share the
        fill: the cap argument of :func:`..aligner.banded.ins_run_cap` and
        the end-state tie-breaks hold read by read."""
        if self.replicas is not None:
            return self._fill_pool_dealt(pool)
        with spans.span("seed.tail_pool", reads=len(pool.reads)):
            spans.count("reads.tail_pooled", len(pool.reads))
            qshift, lengths = self._pack(pool.reads)
            lengths_np = np.fromiter((len(q) for q in pool.reads),
                                     dtype=np.int64, count=len(pool.reads))
            scores = self._fill_ends_free_capped(qshift, lengths, lengths_np)
        return pool.reads, scores, qshift, lengths

    def _align_batch_banded(self, queries, qshift, lengths, scores=None):
        """Device traceback first: the trace kernel and decode rebuild
        every verified read's alignment on the device, identical to the
        native backtrace.  Reads the trace returns as None (unverified at
        every tier, INF or empty) take ``NativeAligner.align_banded``
        seeded with their exact score, on a thread per core.  An error in
        the trace propagates.  Two-piece costs skip the trace (its kernel
        is one-piece, as the reference's is): every read takes the native
        backtrace, which must reproduce the device score."""
        self._init_banded()
        na = self._native
        if scores is None:
            scores = self._device_scores(qshift, lengths)
        out = [None] * len(queries)
        stats = {"device_traced": 0, "host_backtraced": 0}
        if not self.costs.is_two_piece and trace_enabled():
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
            workers = self._host_workers(len(rest))
            with spans.span("mapper.host_backtrace"), \
                    ThreadPoolExecutor(max_workers=workers) as pool:
                for b, res in zip(rest, pool.map(one, rest)):
                    out[b] = res
        self.last_banded_stats = stats
        spans.count("reads.device_traced", stats["device_traced"])
        spans.count("reads.host_backtraced", stats["host_backtraced"])
        return out

    # ---- ends-free spans ------------------------------------------------

    def _ef_cap_enabled(self) -> bool:
        """Whether the capped fill ladder applies: on the card, where the
        cap removes scan rounds from the kernel, and without a mesh, as in
        the reference.  On the CPU one uncapped plain fill gives the same
        exact result.  Split out so that tests can drive the ladder on the
        CPU."""
        return self.mesh is None and self.dg.device.type == "cuda"

    def _fill_ends_free_capped(self, qshift, lengths, lengths_np):
        """(scores, end_ranks, end_offsets), numpy, by the full-width
        bounded fill, under a verify-and-retry insertion-run cap on the
        card (:func:`..aligner.banded.run_capped_ladder`).

        Exact, anchors included: truncation only raises values, and when a
        read's score is <= ub its optimal path's insertion runs all fit the
        cap, so its cells and every true tie among end cells are computed
        exactly, and the (largest offset, lowest rank) choice is the
        uncapped fill's.  The ub hint is kept per (n_min, n_max).
        """
        costs = self.costs
        L = int(qshift.shape[1])
        cells = self.flat.n_nodes * L * int(qshift.shape[0])

        def fill(cap=0):
            spans.count("cells.tail_fill", cells)
            with spans.span("ladder.full_fill", cap=cap):
                return tuple(t.cpu().numpy()
                             for t in dp_fill_ends_free_with_ends(
                                 self.dg, self.flat, qshift, lengths, costs,
                                 self.aln_type, "auto", self.mesh,
                                 max_run=cap))

        if not self._ef_cap_enabled():
            return fill()
        key = (int(lengths_np.min()), int(lengths_np.max()))
        hint = self._ef_ub_hint.get(key)
        if hint is not None and hint <= 0:
            # INF rows seen lately at this shape: no ub can verify them,
            # so skip the ladder, and probe again after the countdown
            if hint < 0:
                self._ef_ub_hint[key] = hint + 1
            else:
                self._ef_ub_hint.pop(key)
            return fill()
        guess = ((costs.gap_open + costs.gap_extend) * 4
                 + costs.mismatch * max(key[1] // 16, 4))
        out, vmax = run_capped_ladder(costs, L, hint or guess, fill, fill)
        if vmax == 0:
            self._ef_ub_hint[key] = -LADDER_INF_SKIP
        elif vmax is None:
            finite = out[0][out[0] < INF]
            if finite.size:
                self._ef_ub_hint[key] = max(int(finite.max()), 1)
        else:
            self._ef_ub_hint[key] = vmax
        return out

    def _ends_free_scores(self, queries, qshift, lengths, pool=None):
        """(scores, end_ranks, end_offsets), numpy: the seeded corridor
        fill where it is provably exact and pays, the full bounded fill
        otherwise and for the reads the corridors leave unresolved.  Either
        way the batch's scores teach the seed rates.  An error of the
        seeded fill propagates; it returns None only to route.  Two-piece
        costs and a mesh always take the full fill and learn nothing,
        whatever ``POASTA_SEED`` says (the corridors and their certificate
        are one-piece and single-device, as in ``poasta_tpu``).

        With a :class:`TailPool` the unresolved reads join ``pool``
        unfilled (their scores INF) and a fourth array, their rows, comes
        back beside the three."""
        mode = "0" if self.costs.is_two_piece or self.mesh is not None \
            else os.environ.get("POASTA_SEED", "")
        lengths_np = np.fromiter((len(q) for q in queries), dtype=np.int64,
                                 count=len(queries))
        out = None
        if mode != "0":
            out = self._fill_ends_free_seeded(qshift, lengths, lengths_np,
                                              mode, queries, pool)
        if out is None:
            out = self._fill_ends_free_capped(qshift, lengths, lengths_np)
            if mode != "0":
                self._learn_seed_ub(lengths_np, out[0])
            if pool is not None:
                out = (*out, np.zeros(0, dtype=np.int64))
        return out

    def _kmer_index(self) -> KmerIndex:
        """The host k-mer index over the graph, built at its first use by
        whichever of a mesh's replicas gets there first; read-only after."""
        home = self._home
        with home._index_lock:
            if home._seed_index is None:
                with spans.span("seed.index"):
                    home._seed_index = KmerIndex(self.flat)
        return home._seed_index

    def _learn_seed_ub(self, lengths_np, scores, deferred=None) -> None:
        """Learn per-character score rates from a batch's scores.  Rates,
        not scores: streaming batches are sorted by length, so each has its
        own (n_min, n_max), and a bound per read scales with its length.

        ``tight`` (the 95th percentile rate and ~6%) sizes the first tier's
        corridor margin, and with it the corridor width; reads above it
        retry at ``wide`` (the 90th percentile and 25%); only reads above
        that pay the full fill.  Percentiles keep one outlier read from
        widening every later batch's corridors.

        ``deferred``: rows whose scores a :class:`TailPool` fills later.
        The next batch's corridors need the rates now, so each such read
        counts at rate +inf, above every score known.  Where the deferred
        reads are the batch's highest rates (the usual case: the tail is
        the divergent reads) and no percentile index falls on one of them,
        the sorted rates at both indices are the ones the full scores give:
        the same rates.  Otherwise each order statistic can only rise (a
        value raised to +inf, or a read the full scores leave out as INF
        counted at the top), so the rates are never narrower.  Wider rates
        cost corridor width, never exactness, since the certificate
        decides; infinite ones seed nothing until a batch teaches finite
        rates again."""
        sc = np.asarray(scores, dtype=np.float64)
        ln = np.maximum(lengths_np.astype(np.float64), 1.0)
        ok = sc < INF
        rates = sc / ln
        if deferred is not None:
            ok[deferred] = True
            rates[deferred] = np.inf
        if ok.any():
            rates = np.sort(rates[ok])
            q90 = rates[int(0.9 * (rates.size - 1))]
            q95 = rates[int(0.95 * (rates.size - 1))]
            wide = q90 * 1.25
            self._seed_rate = (min(q95 * 1.0625, wide), wide)

    def _fill_ends_free_seeded(self, qshift, lengths, lengths_np, mode,
                               queries=None, pool=None):
        """Exact (scores, end_ranks, end_offsets) by k-mer seeded corridors,
        or None where they do not apply (no finite rates learned yet, a
        small graph, a bounded graph begin, no certifiable read, a repeat
        blow-up of hits, corridors past the width budget, nothing
        resolved): the caller then runs the full fill.

        The corridors are a guess built from each read's dominant hit
        cluster.  After the corridor fill (:mod:`..ops.seed`) returns score
        s_b, the certificate of :mod:`..aligner.seeds` proves, at c = s_b,
        that no alignment outside the corridor scores <= s_b.  Certified
        reads equal the full fill in score and end state; every other read
        (no cluster, unverified score, failed certificate) joins the tail
        that the full fill scores.  A read's work becomes its span times
        the corridor width instead of every rank times its length.

        With a :class:`TailPool` the tail's reads (of ``queries``) join
        ``pool`` instead, and their rows come back as a fourth array.
        """
        n = self.flat.n_nodes
        if mode != "all" and n < self.SEED_MIN_NODES:
            return None
        free_start, end_ok, _ = self.scorer._ef_params(lengths)
        if not free_start:
            # a bounded graph begin anchors at the start node, where the
            # banded fills already narrow the work
            return None
        rate = self._seed_rate
        if rate is None or not np.isfinite(rate[1]):
            return None  # a full fill learns the rates
        e = self.costs.gap_extend
        if e <= 0:
            return None
        idx = self._kmer_index()
        if not idx.ok:
            return None
        jlo_np = query_end_lo(self.aln_type, lengths_np).astype(np.int64)
        # the certificate needs T(c) <= T(0) = jlo - (k-1) > 0: a span whose
        # reads may end at offset ~1 can never certify
        if not (jlo_np - (idx.k - 1) > 0).any():
            return None
        with spans.span("seed.hits"):
            hits = idx.seed_hits(qshift.cpu().numpy(), lengths_np)
        if hits is None:
            return None  # repeat blow-up
        B = lengths_np.shape[0]
        pad_c = 2 * self.costs.mismatch
        ub_wide_np = (rate[1] * lengths_np + pad_c).astype(np.int64)
        ub_tight_np = np.minimum(
            (rate[0] * lengths_np + pad_c).astype(np.int64), ub_wide_np)
        # one proposal (the wide window admits every drift the wide tier
        # does); only the corridor margin differs between the tiers
        with spans.span("seed.clusters"):
            a_star, b_star, n_cluster = propose_clusters(hits,
                                                         ub_wide_np // e)
        seedable = (n_cluster > 0) & hits.clean
        if not seedable.any():
            return None
        sc = np.full(B, INF, dtype=np.int64)
        er = np.zeros(B, dtype=np.int64)
        ej = np.zeros(B, dtype=np.int64)
        resolved = np.zeros(B, dtype=bool)
        n_cert_failed = n_unverified = attempts = 0
        tiers = [ub_tight_np]
        if (ub_wide_np > ub_tight_np).any():
            tiers.append(ub_wide_np)
        for t_i, ub_arr in enumerate(tiers):
            act = np.nonzero(seedable & ~resolved)[0]
            if act.size == 0:
                break
            ub_sub, jlo_sub = ub_arr[act], jlo_np[act]
            a_sub, b_sub = a_star[act], b_star[act]
            with spans.span("seed.fill", tier=t_i):
                q_sub = qshift if act.size == B else qshift.index_select(
                    0, torch.as_tensor(act, device=qshift.device))
                res = seed_scores(self.dg, self.flat, q_sub, lengths_np[act],
                                  self.costs, free_start, end_ok, jlo_sub,
                                  a_sub, b_sub, ub_sub)
            if res is None:
                break  # the width budget: a wider tier cannot help
            attempts += 1
            s_s, er_s, ej_s, ok_s = res
            with spans.span("seed.certify", tier=t_i):
                hits_sub = hits if act.size == B else subset_hits(hits, act)
                verified = ok_s & (s_s <= ub_sub)
                certified, _ = certify_reads(
                    hits_sub, a_sub, b_sub, np.where(verified, s_s, -1),
                    ub_sub // e, idx.k, jlo_sub, self.costs, idx.all_acgt)
            done = verified & certified
            sc[act[done]] = s_s[done]
            er[act[done]] = er_s[done]
            ej[act[done]] = ej_s[done]
            resolved[act[done]] = True
            if t_i == len(tiers) - 1:
                n_cert_failed = int((verified & ~certified).sum())
                n_unverified = int((ok_s & ~verified).sum())
        self.last_seed_stats = {
            "seeded": int(resolved.sum()),
            "seed_tail": int((~resolved).sum()),
            "seed_ub": [round(float(rate[0]), 4), round(float(rate[1]), 4)],
            "seed_k": idx.k, "seed_attempts": attempts,
            "cert_failed": n_cert_failed, "unverified": n_unverified,
            "no_cluster": int((~seedable).sum())}
        for key in ("seeded", "seed_tail", "cert_failed", "unverified"):
            spans.count("reads." + key, self.last_seed_stats[key])
        if not resolved.any():
            return None
        tail = np.nonzero(~resolved)[0]
        if pool is not None:
            pool.reads += [queries[b] for b in tail]
            self._learn_seed_ub(lengths_np, sc, deferred=tail)
            return sc, er, ej, tail
        if tail.size:
            with spans.span("seed.tail", reads=int(tail.size)):
                at = torch.as_tensor(tail, device=qshift.device)
                sc[tail], er[tail], ej[tail] = self._fill_ends_free_capped(
                    qshift.index_select(0, at), lengths.index_select(0, at),
                    lengths_np[tail])
        self._learn_seed_ub(lengths_np, sc)
        return sc, er, ej

    def _align_batch_ends_free(self, queries, qshift, lengths,
                               pre_scores=None):
        """Ends-free scores and alignments.

        The fill returns each read's optimal score and end state (rank,
        offset).  The device traceback refills a corridor that ends at that
        anchor and decodes the alignment; a read it leaves unverified takes
        ``NativeAligner.align_anchored``, which fills only a corridor around
        that read's own locus.  An error of the trace propagates, and so
        does a corridor the native engine cannot verify: a wrong end state
        would show up there and nowhere else.  Two-piece costs skip the
        trace (its kernel is one-piece): every read takes the corridor.
        """
        self._init_banded()
        native = self._native
        free_start = self.aln_type.graph_free_begin[0] == "unbounded"
        sc, er, ej = pre_scores if pre_scores is not None \
            else self._ends_free_scores(queries, qshift, lengths)
        stats = {"anchored_ok": 0, "exact_fallback": 0, "device_traced": 0}
        traced = [None] * len(queries)
        if not self.costs.is_two_piece and trace_enabled():
            traced = trace_align(self.dg, self.flat, qshift, lengths,
                                 self.costs, sc, anchor_r=er, anchor_j=ej,
                                 free_start=free_start)
            stats["device_traced"] = sum(a is not None for a in traced)
        node_of_rank = self.flat.node_of_rank

        def one(b):
            if sc[b] >= INF:
                raise RuntimeError(
                    "ends-free alignment: unsatisfiable bounds")
            if traced[b] is not None:
                return int(sc[b]), traced[b]
            try:
                return native.align_anchored(
                    queries[b], self.costs, int(node_of_rank[er[b]]),
                    int(ej[b]), int(sc[b]), free_start=free_start)
            except RuntimeError as exc:
                raise RuntimeError(
                    f"read {b}: the anchored corridor never verified score "
                    f"{int(sc[b])} at end state (rank {int(er[b])}, offset "
                    f"{int(ej[b])}): {exc}") from exc

        workers = self._host_workers(len(queries))
        with spans.span("mapper.anchored_host"), \
                ThreadPoolExecutor(max_workers=workers) as pool:
            out = list(pool.map(one, range(len(queries))))
        stats["anchored_ok"] = len(out)
        self.last_ends_free_stats = stats
        self.last_banded_stats = {
            "device_traced": stats["device_traced"],
            "host_backtraced": len(out) - stats["device_traced"]}
        spans.count("reads.device_traced", stats["device_traced"])
        spans.count("reads.host_backtraced", len(out) - stats["device_traced"])
        return out

    # ---- replicas: one single-card mapper a mesh row ----------------------

    def _on_cards(self, stage: str, jobs) -> list:
        """Run each job, (card, reads, fn), as ``fn(replicas[card])`` on a
        thread of its own bound to that card, under a ``mesh.shard`` span
        (attrs ``card``, ``reads``, ``stage``) attached to the caller's
        span; their results in the jobs' order.  The calling thread waits
        in ``mesh.gather``; a card's failure reaches it once every job has
        ended."""
        if not jobs:
            return []
        caller = spans.current()

        def run(card, reads, fn):
            rep = self.replicas[card]
            with spans.attach(caller), bound_to(rep.dg.device), \
                    spans.span("mesh.shard", card=card, reads=reads,
                               stage=stage):
                return fn(rep)

        with ThreadPoolExecutor(max_workers=len(jobs)) as pool:
            futures = [pool.submit(run, *job) for job in jobs]
            with spans.span("mesh.gather"):
                return [f.result() for f in futures]

    def _blocks(self, n: int):
        """(card, rows) of each card's contiguous block of ``n`` reads."""
        return [(card, np.arange(rows.start, rows.stop))
                for card, (_, rows) in enumerate(dp_shards(self.mesh, n,
                                                           None))]

    def _prescore_dealt(self, queries, pool):
        """:meth:`prescore` of each card's block on its replica; the
        reads a card's corridors leave unresolved join its own part of
        ``pool``."""
        if pool is not None and not pool.parts:
            pool.parts = [TailPool() for _ in self.replicas]

        def job(card, rows):
            block = queries[rows[0]:rows[-1] + 1]
            part = None if pool is None else pool.parts[card]

            def fn(rep):
                rep.last_seed_stats = None
                return rep.prescore(block, pool=part), rep.last_seed_stats
            return card, rows.size, fn

        blocks = self._blocks(len(queries))
        got = self._on_cards("prescore", [job(*b) for b in blocks])
        parts, deferred = [], []
        for (card, rows), (token, _) in zip(blocks, got):
            at = rows[TailPool.deferred(token)]
            parts.append((card, rows, token))
            deferred.append(at)
            if pool is not None:
                pool.reads += [queries[r] for r in at]
                pool.cards += [card] * at.size
        seed = [stats for _, stats in got]
        self.last_seed_stats = _summed(seed, SEED_COUNTS)
        if self.last_seed_stats is not None:
            self.last_seed_stats["cards"] = seed
        return _Dealt(queries, parts, np.concatenate(deferred))

    def _fill_pool_dealt(self, pool):
        """Each card fills its own part of ``pool`` on its replica."""
        cards = np.asarray(pool.cards, dtype=np.int64)
        held = [(card, np.nonzero(cards == card)[0])
                for card in range(len(self.replicas)) if (cards == card).any()]
        tokens = self._on_cards("pool", [
            (card, rows.size,
             lambda rep, part=pool.parts[card]: rep.fill_tail_pool(part))
            for card, rows in held])
        return _Dealt(pool.reads, [(card, rows, token) for (card, rows), token
                                   in zip(held, tokens)],
                      np.zeros(0, dtype=np.int64))

    def _align_dealt(self, queries, prescored):
        """:meth:`align_batch` of each card's rows on its replica, with the
        card's own token where ``prescored`` is this batch's; the results
        gathered in input order, the deferred rows left out."""
        if isinstance(prescored, _Dealt) and prescored.queries is queries:
            parts = prescored.parts
        else:
            parts = [(card, rows, None)
                     for card, rows in self._blocks(len(queries))]
        kept = [np.delete(rows, TailPool.deferred(token))
                for _, rows, token in parts]

        def job(card, rows, token, keep):
            block = token[0] if token is not None \
                else [queries[r] for r in rows]
            return card, keep.size, \
                lambda rep: (rep.align_batch(block, prescored=token),
                             rep.last_banded_stats, rep.last_ends_free_stats)

        got = self._on_cards("align", [job(*p, k)
                                       for p, k in zip(parts, kept)])
        results = [None] * len(queries)
        for keep, (out, _, _) in zip(kept, got):
            for r, res in zip(keep, out, strict=True):
                results[r] = res
        self.last_banded_stats = _summed([g[1] for g in got])
        self.last_ends_free_stats = _summed([g[2] for g in got])
        spans.count("reads.sharded", sum(k.size for k in kept))
        return [r for r in results if r is not None]
