"""Batch read mapping against a static graph: port of the single-device
part of ``poasta_tpu/parallel/mapper.py`` (scoring and alignment of global
and ends-free spans under one- and two-piece costs)."""

from __future__ import annotations

import os
import time
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
    pack_queries,
    query_end_lo,
)
from ..ops.dp_rows import INF
from ..ops.seed import seed_scores
from ..ops.trace import trace_align, trace_enabled


class BatchMapper:
    """lasagna's batch read mapper: scores and aligns batches of reads
    against one static POA graph, deterministically.

    The graph is flattened and placed on ``device`` once (None: the card;
    raises without one).  Scores come from the banded scorer (exact by
    verify-and-retry, the full-width fill as its last resort), under
    ``aln_type``: None or Global, or an ``EndsFree`` span.  ``costs``:
    ``GapAffine`` or ``GapAffine2Piece``.
    Alignments of a global span come from dense tables and a host
    backtrace for small one-piece batches, and otherwise from the device
    traceback, with the native engine's banded backtrace for the reads the
    trace leaves unverified; two-piece costs always take the banded route
    and skip the trace (it is one-piece), so the native engine backtraces
    every read, seeded with its exact device score.  Alignments of an
    ends-free span (see :meth:`_align_batch_ends_free`) come from a fill
    that also returns each read's end state (seeded corridors on large
    graphs once a batch has taught the score rates, the full-width fill
    otherwise), then the device traceback anchored at that end state, with
    the native engine's anchored corridor for the rest; two-piece costs
    neither seed nor trace, as in ``poasta_tpu``, so every read takes the
    anchored corridor.
    """

    # dense tables cost Np*B*L*12 bytes; past this budget align_batch takes
    # the banded route (the reference's rule, so both packages route alike)
    DENSE_TABLE_BUDGET = 64 * 1024 * 1024
    # seeding engages on its own from this graph size up (the full bounded
    # fill pays n_ranks x L per read; below this a corridor saves too few
    # cells).  POASTA_SEED: "0" off, "all" every graph size, default auto.
    SEED_MIN_NODES = 8192

    def __init__(self, graph, costs, device=None, batch_size: int = 64,
                 aln_type=None):
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
        # ends-free alignment: ub hints of the capped full fill per
        # (n_min, n_max); the k-mer index (built at the first eligible
        # batch) and the (tight, wide) per-character score rates that size
        # the seeded corridors; the last batch's counters
        self._ef_ub_hint: dict = {}
        self._seed_index = None
        self._seed_rate = None
        self.last_seed_stats = None
        self.last_ends_free_stats = None

    def score_batch(self, queries) -> np.ndarray:
        """(B,) exact alignment scores of byte-string reads under the
        mapper's span."""
        qshift, lengths = pack_queries(queries, device=self.dg.device)
        return self.scorer.scores(qshift, lengths)

    def _table_bytes(self, n_reads: int, L: int) -> int:
        return self.dg.n_nodes_padded * n_reads * L * 12

    def align_batch(self, queries, prescored=None):
        """[(score, alignment)] of a read batch, in input order.

        Small one-piece shapes: one fill returns dense M/I/D tables and the
        host backtraces them.  Past :data:`DENSE_TABLE_BUDGET`, and at any
        size under two-piece costs (the dense tables are one-piece): exact
        banded scores, then the traceback (see :meth:`_align_batch_banded`).
        ``prescored`` is :meth:`prescore`'s token for this batch.
        """
        if not queries:
            return []
        pre_scores = None
        if prescored is not None and prescored[0] is queries:
            # reuse the packed batch: re-packing would upload it again
            pre_scores, qshift, lengths = prescored[1:]
        else:
            qshift, lengths = pack_queries(queries, device=self.dg.device)
        if self.ends_free:
            return self._align_batch_ends_free(queries, qshift, lengths,
                                               pre_scores=pre_scores)
        B, L = int(qshift.shape[0]), int(qshift.shape[1])
        if self.costs.is_two_piece \
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
        batch under two-piece costs)."""
        if self.ends_free:
            return False
        if self.costs.is_two_piece:
            return True
        maxlen = max((len(q) for q in queries), default=0)
        L = ((maxlen + 1 + 127) // 128) * 128  # pack_queries' padding rule
        return self._table_bytes(len(queries), L) > self.DENSE_TABLE_BUDGET

    def prescore(self, queries):
        """Run the scoring phase of a batch ahead of time.

        Returns a token for ``align_batch(prescored=...)``, or None when
        the batch takes the dense route (nothing to overlap).  Under an
        ends-free span the token carries (scores, end ranks, end offsets).
        Safe against a concurrent :meth:`align_batch` of another prescored
        batch, not against concurrent prescore calls.
        """
        if self.ends_free:
            if not queries:
                return None
            self._init_banded()
            qshift, lengths = pack_queries(queries, device=self.dg.device)
            return (queries, self._ends_free_scores(queries, qshift, lengths),
                    qshift, lengths)
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
            workers = max(1, min(len(rest), os.cpu_count() or 4))
            with ThreadPoolExecutor(max_workers=workers) as pool:
                for b, res in zip(rest, pool.map(one, rest)):
                    out[b] = res
        self.last_banded_stats = stats
        return out

    # ---- ends-free spans ------------------------------------------------

    def _ef_cap_enabled(self) -> bool:
        """Whether the capped fill ladder applies: on the card, where the
        cap removes scan rounds from the kernel.  On the CPU one uncapped
        plain fill gives the same exact result.  Split out so that tests
        can drive the ladder on the CPU."""
        return self.dg.device.type == "cuda"

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

        def fill(cap=0):
            return tuple(t.cpu().numpy() for t in dp_fill_ends_free_with_ends(
                self.dg, self.flat, qshift, lengths, costs, self.aln_type,
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

    def _ends_free_scores(self, queries, qshift, lengths):
        """(scores, end_ranks, end_offsets), numpy: the seeded corridor
        fill where it is provably exact and pays, the full bounded fill
        otherwise and for the reads the corridors leave unresolved.  Either
        way the batch's scores teach the seed rates.  An error of the
        seeded fill propagates; it returns None only to route.  Two-piece
        costs always take the full fill and learn nothing, whatever
        ``POASTA_SEED`` says (the corridors and their certificate are
        one-piece, as in ``poasta_tpu``)."""
        mode = "0" if self.costs.is_two_piece \
            else os.environ.get("POASTA_SEED", "")
        lengths_np = np.fromiter((len(q) for q in queries), dtype=np.int64,
                                 count=len(queries))
        out = None
        if mode != "0":
            out = self._fill_ends_free_seeded(qshift, lengths, lengths_np,
                                              mode)
        if out is None:
            out = self._fill_ends_free_capped(qshift, lengths, lengths_np)
            if mode != "0":
                self._learn_seed_ub(lengths_np, out[0])
        return out

    def _learn_seed_ub(self, lengths_np, scores) -> None:
        """Learn per-character score rates from a batch's scores.  Rates,
        not scores: streaming batches are sorted by length, so each has its
        own (n_min, n_max), and a bound per read scales with its length.

        ``tight`` (the 95th percentile rate and ~6%) sizes the first tier's
        corridor margin, and with it the corridor width; reads above it
        retry at ``wide`` (the 90th percentile and 25%); only reads above
        that pay the full fill.  Percentiles keep one outlier read from
        widening every later batch's corridors."""
        sc = np.asarray(scores, dtype=np.float64)
        ln = np.maximum(lengths_np.astype(np.float64), 1.0)
        ok = sc < INF
        if ok.any():
            rates = np.sort(sc[ok] / ln[ok])
            q90 = rates[int(0.9 * (rates.size - 1))]
            q95 = rates[int(0.95 * (rates.size - 1))]
            wide = q90 * 1.25
            self._seed_rate = (min(q95 * 1.0625, wide), wide)

    def _fill_ends_free_seeded(self, qshift, lengths, lengths_np, mode):
        """Exact (scores, end_ranks, end_offsets) by k-mer seeded corridors,
        or None where they do not apply (no rates learned yet, a small
        graph, a bounded graph begin, no certifiable read, a repeat blow-up
        of hits, corridors past the width budget, nothing resolved): the
        caller then runs the full fill.

        The corridors are a guess built from each read's dominant hit
        cluster.  After the corridor fill (:mod:`..ops.seed`) returns score
        s_b, the certificate of :mod:`..aligner.seeds` proves, at c = s_b,
        that no alignment outside the corridor scores <= s_b.  Certified
        reads equal the full fill in score and end state; every other read
        (no cluster, unverified score, failed certificate) joins the tail
        that the full fill scores.  A read's work becomes its span times
        the corridor width instead of every rank times its length.
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
        if rate is None:
            return None  # the first batch learns the rates
        e = self.costs.gap_extend
        if e <= 0:
            return None
        if self._seed_index is None:
            self._seed_index = KmerIndex(self.flat)
        idx = self._seed_index
        if not idx.ok:
            return None
        jlo_np = query_end_lo(self.aln_type, lengths_np).astype(np.int64)
        # the certificate needs T(c) <= T(0) = jlo - (k-1) > 0: a span whose
        # reads may end at offset ~1 can never certify
        if not (jlo_np - (idx.k - 1) > 0).any():
            return None
        t0 = time.perf_counter()
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
        a_star, b_star, n_cluster = propose_clusters(hits, ub_wide_np // e)
        t_hits = time.perf_counter() - t0
        seedable = (n_cluster > 0) & hits.clean
        if not seedable.any():
            return None
        sc = np.full(B, INF, dtype=np.int64)
        er = np.zeros(B, dtype=np.int64)
        ej = np.zeros(B, dtype=np.int64)
        resolved = np.zeros(B, dtype=bool)
        t_fill = t_cert = 0.0
        n_cert_failed = n_unverified = attempts = 0
        tiers = [ub_tight_np]
        if (ub_wide_np > ub_tight_np).any():
            tiers.append(ub_wide_np)
        for t_i, ub_arr in enumerate(tiers):
            act = np.nonzero(seedable & ~resolved)[0]
            if act.size == 0:
                break
            if act.size == B:
                q_sub, hits_sub = qshift, hits
            else:
                q_sub = qshift.index_select(
                    0, torch.as_tensor(act, device=qshift.device))
                hits_sub = subset_hits(hits, act)
            ub_sub, jlo_sub = ub_arr[act], jlo_np[act]
            a_sub, b_sub = a_star[act], b_star[act]
            t0 = time.perf_counter()
            res = seed_scores(self.dg, self.flat, q_sub, lengths_np[act],
                              self.costs, free_start, end_ok, jlo_sub, a_sub,
                              b_sub, ub_sub)
            t_fill += time.perf_counter() - t0
            if res is None:
                break  # the width budget: a wider tier cannot help
            attempts += 1
            s_s, er_s, ej_s, ok_s = res
            t0 = time.perf_counter()
            verified = ok_s & (s_s <= ub_sub)
            certified, _ = certify_reads(
                hits_sub, a_sub, b_sub, np.where(verified, s_s, -1),
                ub_sub // e, idx.k, jlo_sub, self.costs, idx.all_acgt)
            t_cert += time.perf_counter() - t0
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
            "no_cluster": int((~seedable).sum()),
            "hits_s": round(t_hits, 4), "fill_s": round(t_fill, 4),
            "cert_s": round(t_cert, 4)}
        if not resolved.any():
            return None
        tail = np.nonzero(~resolved)[0]
        if tail.size:
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
        t0 = time.perf_counter()
        sc, er, ej = pre_scores if pre_scores is not None \
            else self._ends_free_scores(queries, qshift, lengths)
        stats = {"device_s": time.perf_counter() - t0, "anchored_ok": 0,
                 "exact_fallback": 0, "host_s": 0.0, "device_traced": 0}
        traced = [None] * len(queries)
        if not self.costs.is_two_piece and trace_enabled():
            t1 = time.perf_counter()
            traced = trace_align(self.dg, self.flat, qshift, lengths,
                                 self.costs, sc, anchor_r=er, anchor_j=ej,
                                 free_start=free_start)
            stats["device_s"] += time.perf_counter() - t1
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

        workers = max(1, min(len(queries), os.cpu_count() or 4))
        t0 = time.perf_counter()
        with ThreadPoolExecutor(max_workers=workers) as pool:
            out = list(pool.map(one, range(len(queries))))
        stats["host_s"] = time.perf_counter() - t0
        stats["anchored_ok"] = len(out)
        self.last_ends_free_stats = stats
        self.last_banded_stats = {
            "device_traced": stats["device_traced"],
            "host_backtraced": len(out) - stats["device_traced"]}
        return out
