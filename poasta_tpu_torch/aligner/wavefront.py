"""Dense wavefront fill: the static device graph, read packing, the
full-fill scores (global spans, with or without free graph ends, and
ends-free spans, the latter also with each read's end state; one- and
two-piece costs), and the dense tables + host backtraces of small
one-piece batches.  Port of the single-device part of
``poasta_tpu/aligner/wavefront.py``.

Ranks are the sequential axis, query offsets the lanes and reads the
batch; rows live in a ring of ``W`` liveness-coloured slots, so the
working set is O(B·W·L), not O(B·N·L).
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Optional, Tuple

import numpy as np
import torch

from ..graphs.flat import FlatGraph
from ..ops.cuda_fill import (
    bounded_scores,
    bounded_scores_2p,
    bounded_with_ends,
    bounded_with_ends_2p,
    fill_scores,
    fill_scores_2p,
    free_fill_scores,
)
from ..ops.dp_rows import INF, row_update
from ..ops.dp_rows_2p import row_update_2p
from ..utils.device import check_engine, resolve_device
from ..utils.mesh import check_mesh, dp_shards, gather, normalize
from .alignment import AlignedPair, Alignment
from .costs import EndsFree

# rank rows are padded to a multiple of this, as in the reference's
# default layout; the kernels loop over the true rank count only
NODE_BUCKET = 64


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _next_pow2(x: int) -> int:
    v = 1
    while v < x:
        v <<= 1
    return v


def _color_ring_slots(n: int, last_use: np.ndarray) -> np.ndarray:
    """Greedy interval colouring of row lifetimes [r, last_use[r]].

    Maximal runs of the unbranched-chain case (``last_use == r+1``) are
    coloured by parity against the slots live across the run, vectorised;
    only ranks inside irregular regions run the heap.
    """
    import heapq

    slot_of = np.zeros(n, dtype=np.int32)
    if n == 0:
        return slot_of
    chain = last_use == np.arange(n, dtype=np.int64) + 1
    # a chain run [a, b] can be bulk-coloured iff no earlier interval is
    # still live inside it: running max of last_use
    prev_reach = np.zeros(n, dtype=np.int64)
    if n > 1:
        np.maximum.accumulate(last_use[:-1], out=prev_reach[1:])
    isolated_chain = chain & (prev_reach <= np.arange(n, dtype=np.int64))

    free: list = []
    live: list = []  # heap of (death_rank, slot)
    next_slot = 0
    r = 0
    while r < n:
        b = r
        if isolated_chain[r]:
            while b + 1 < n and isolated_chain[b + 1]:
                b += 1
        if b > r:
            # maximal chain run [r, b]: two alternating slots suffice
            while live and live[0][0] < r:
                _, s = heapq.heappop(live)
                free.append(s)
            if free:
                s0 = free.pop()
            else:
                s0 = next_slot
                next_slot += 1
            # take the second slot only after releasing intervals that die
            # exactly at r, as the sequential greedy would at rank r+1
            while live and live[0][0] < r + 1:
                _, s = heapq.heappop(live)
                free.append(s)
            if free:
                s1 = free.pop()
            else:
                s1 = next_slot
                next_slot += 1
            js = np.arange(r, b + 1)
            slot_of[js] = np.where((js - r) % 2 == 0, s0, s1)
            # only the last two rows of the run are live past it
            heapq.heappush(live, (int(last_use[b - 1]), int(slot_of[b - 1])))
            heapq.heappush(live, (int(last_use[b]), int(slot_of[b])))
            r = b + 1
            continue
        while live and live[0][0] < r:
            _, s = heapq.heappop(live)
            free.append(s)
        if free:
            s = free.pop()
        else:
            s = next_slot
            next_slot += 1
        slot_of[r] = s
        heapq.heappush(live, (int(last_use[r]), s))
        r += 1
    return slot_of


@dataclass(frozen=True)
class DeviceGraph:
    """Static, bucket-padded view of a flat graph, held on one device.

    Everything a fill needs per call is built here once, so a call moves
    no graph data between host and device.  A graph built with
    ``place_on_device=False`` keeps its arrays on the host and fills on
    the device it names (:meth:`placed`); a mesh's shards fill from its
    copies on their devices (:meth:`on`).
    """

    symbols: torch.Tensor  # (Np,) int32; padding rows are symbol -1
    pred_slots: torch.Tensor  # (Np, P) int32 ring slot per predecessor
    pred_valid: torch.Tensor  # (Np, P) bool
    end_rank: torch.Tensor  # () int32, the end node's rank
    window: int  # ring size W = liveness-colouring peak
    n_nodes_padded: int
    n_nodes: int
    # the defaults are the reference's (built graphs set every field)
    pred_ranks_np: np.ndarray = None  # (Np, P) predecessor ranks (host)
    pred_valid_np: np.ndarray = None  # (Np, P) valid mask (host)
    end_rank_i: int = 0
    pred_slots_flat: torch.Tensor = None  # (Np*P,) int32
    pred_valid_flat: torch.Tensor = None  # (Np*P,) int32 0/1
    meta: torch.Tensor = None  # (4,) int32 [n_nodes, end_rank, 0, 0]
    write_slots: torch.Tensor = None  # (Np,) int32 ring slot each rank writes
    # arrays kept on the host (place_on_device=False), and the device their
    # fills run on (None: the card, resolved at the fill)
    on_host: bool = field(default=False, kw_only=True)
    fill_device: Optional[torch.device] = field(default=None, kw_only=True)
    # copies on other devices, one per device (see on())
    replicas: dict = field(default_factory=dict, kw_only=True, compare=False,
                           repr=False)

    @property
    def device(self) -> torch.device:
        return self.symbols.device

    _TENSORS = ("symbols", "pred_slots", "pred_valid", "end_rank",
                "pred_slots_flat", "pred_valid_flat", "meta", "write_slots")

    def on(self, device) -> "DeviceGraph":
        """This graph with its tensors on ``device``: itself where they lie
        there already, else a copy made at the first call and kept (a
        mesh replicates its graph once per distinct device)."""
        device = normalize(device)
        if device == self.device and not self.on_host:
            return self
        rep = self.replicas.get(device)
        if rep is None:
            rep = replace(self, on_host=False, fill_device=None, replicas={},
                          **{k: getattr(self, k).to(device)
                             for k in self._TENSORS})
            self.replicas[device] = rep
        return rep

    def placed(self) -> "DeviceGraph":
        """The graph a fill runs on: itself, or for host arrays
        (``place_on_device=False``) its copy on the device it was built
        for, which a missing card makes raise."""
        if not self.on_host:
            return self
        return self.on(resolve_device(self.fill_device))

    @staticmethod
    def from_arrays(symbols, pred_slots, pred_valid, pred_ranks, write_slots,
                    window: int, n_nodes: int, device) -> "DeviceGraph":
        """Place host arrays (numpy) of a built graph on ``device``."""
        pred_valid = np.asarray(pred_valid, dtype=bool)

        def put(a):
            return torch.tensor(a, device=device)  # copies: the graph owns it

        return DeviceGraph(
            symbols=put(np.asarray(symbols, dtype=np.int32)),
            pred_slots=put(np.asarray(pred_slots, dtype=np.int32)),
            pred_valid=put(pred_valid),
            end_rank=torch.tensor(n_nodes - 1, dtype=torch.int32,
                                  device=device),
            window=int(window),
            n_nodes_padded=int(symbols.shape[0]),
            n_nodes=int(n_nodes),
            pred_ranks_np=np.asarray(pred_ranks, dtype=np.int32),
            pred_valid_np=pred_valid,
            end_rank_i=int(n_nodes) - 1,
            pred_slots_flat=put(np.asarray(pred_slots, np.int32).reshape(-1)),
            pred_valid_flat=put(pred_valid.reshape(-1).astype(np.int32)),
            # the rank loop runs over the true rank count: padding never runs
            meta=put(np.asarray([n_nodes, n_nodes - 1, 0, 0], dtype=np.int32)),
            write_slots=put(np.asarray(write_slots, dtype=np.int32)),
        )

    @staticmethod
    def build(flat: FlatGraph, node_bucket: int = NODE_BUCKET,
              place_on_device: bool = True, *,
              device=None) -> "DeviceGraph":
        """Lay ``flat`` out on ``device`` (None: the card; raises without
        one).  Rank rows are padded to a multiple of ``node_bucket``.
        ``place_on_device=False`` keeps the arrays on the host (CPU
        tensors) without a device call, as the reference keeps numpy
        arrays; fills still run on ``device`` (:meth:`placed`)."""
        if place_on_device:
            device = resolve_device(device)
        n = flat.n_nodes
        P = _next_pow2(max(1, flat.max_in_degree))
        np_nodes = _round_up(n, node_bucket)

        # a rank's row stays live until its last reader (max successor
        # rank); greedy interval colouring gives W = peak live rows
        counts = np.diff(flat.pred_ptr.astype(np.int64))
        readers = np.repeat(np.arange(n, dtype=np.int64), counts)
        last_use = np.arange(n, dtype=np.int64)
        np.maximum.at(last_use, flat.pred_idx.astype(np.int64), readers)
        slot_of = _color_ring_slots(n, last_use)
        window = max(int(slot_of.max()) + 1 if n else 1, 1)

        symbols = np.full((np_nodes,), -1, dtype=np.int32)
        symbols[:n] = flat.symbols.astype(np.int32)
        pred_slots = np.zeros((np_nodes, P), dtype=np.int32)
        pred_valid = np.zeros((np_nodes, P), dtype=bool)
        pred_ranks = np.zeros((np_nodes, P), dtype=np.int32)
        write_slots = np.zeros((np_nodes,), dtype=np.int32)
        write_slots[:n] = slot_of
        cols = np.arange(len(flat.pred_idx)) - np.repeat(
            flat.pred_ptr[:-1].astype(np.int64), counts)
        preds = flat.pred_idx.astype(np.int64)
        pred_slots[readers, cols] = slot_of[preds]
        pred_valid[readers, cols] = True
        pred_ranks[readers, cols] = preds
        if place_on_device:
            return DeviceGraph.from_arrays(symbols, pred_slots, pred_valid,
                                           pred_ranks, write_slots, window,
                                           n, device)
        host = DeviceGraph.from_arrays(symbols, pred_slots, pred_valid,
                                       pred_ranks, write_slots, window, n,
                                       "cpu")
        return replace(host, on_host=True, fill_device=None
                       if device is None else torch.device(device))


def pack_queries(queries, pad_to: Optional[int] = None,
                 place_on_device: bool = True, *,
                 device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pack byte-string reads into a padded (B, L) int32 batch + (B,)
    lengths on ``device`` (None: the card; raises without one).

    Column ``j`` holds ``q[j-1]`` (offset j consumes query char j-1);
    column 0 and the padding are 0, which matches no nucleotide symbol.
    ``L`` is the longest read, or ``pad_to`` if longer, plus one, rounded
    up to a multiple of 128.  ``place_on_device=False`` returns host (CPU)
    tensors without a device call, whatever ``device`` says: the fills
    move their inputs to the graph's device at the call.
    """
    device = resolve_device(device) if place_on_device \
        else torch.device("cpu")
    maxlen = max((len(q) for q in queries), default=0)
    L = _round_up(max(pad_to or 0, maxlen) + 1, 128)
    arr = np.zeros((len(queries), L), dtype=np.int32)
    lengths = np.zeros((len(queries),), dtype=np.int32)
    for b, q in enumerate(queries):
        arr[b, 1:len(q) + 1] = np.frombuffer(bytes(q), dtype=np.uint8)
        lengths[b] = len(q)
    return (torch.as_tensor(arr, device=device),
            torch.as_tensor(lengths, device=device))


def _at_graph(dg: DeviceGraph, *batch: torch.Tensor):
    """(graph, *batch) as a fill takes them: the graph on the device it
    fills on (:meth:`DeviceGraph.placed`) and the batch's tensors moved
    there, as the reference's fills take host arrays."""
    dg = dg.placed()
    return (dg,) + tuple(t.to(dg.device) for t in batch)


def _scan_rows(dg: DeviceGraph, qshift: torch.Tensor, costs, n_ranks: int,
               free_start: bool = False):
    """Yield (rank, M, I, D) rows of the clamped dense recurrence for ranks
    0 .. n_ranks-1: a plain rank scan over :func:`row_update`, written
    independently of the fill kernels and their plain versions.
    ``free_start`` seeds offset 0 at every real rank (0 < rank < end), as
    the global origin seeds rank 0."""
    o, e, x = costs.gap_open, costs.gap_extend, costs.mismatch
    B, L = qshift.shape
    M_ring = torch.full((B, dg.window, L), INF, dtype=torch.int32,
                        device=qshift.device)
    D_ring = torch.full_like(M_ring, INF)
    symbols = dg.symbols.tolist()
    slots = dg.pred_slots.tolist()
    wslots = dg.write_slots.tolist()
    end = dg.end_rank_i
    for r in range(n_ranks):
        idx = torch.as_tensor(slots[r], device=qshift.device)
        pred_M = M_ring.index_select(1, idx)
        pred_D = D_ring.index_select(1, idx)
        valid = dg.pred_valid[r]
        match_cost = torch.where(qshift == symbols[r], 0, x).to(torch.int32)
        M, I, D = row_update(pred_M, pred_D, valid, match_cost, o, e,
                             is_start_row=r == 0,
                             free_start=free_start and 0 < r < end)
        if r == end:
            # virtual end node: a zero-cost hop at the same offset
            M = torch.where(valid.view(1, -1, 1), pred_M, INF).min(1).values
            I = torch.full_like(I, INF)
            D = torch.full_like(D, INF)
        M_ring[:, wslots[r]] = M
        D_ring[:, wslots[r]] = D
        yield r, M, I, D


def _scan_rows_2p(dg: DeviceGraph, qshift: torch.Tensor, costs,
                  free_start: bool = False):
    """Yield (rank, M) rows of the two-piece recurrence up to the end rank,
    by a plain rank scan over :func:`..ops.dp_rows_2p.row_update_2p` with
    its coupled insertion scan; ``free_start`` as in :func:`_scan_rows`."""
    o1, e1, e2 = costs.gap_open, costs.gap_extend, costs.gap_extend2
    x = costs.mismatch
    B, L = qshift.shape
    rings = [torch.full((B, dg.window, L), INF, dtype=torch.int32,
                        device=qshift.device) for _ in range(3)]
    symbols = dg.symbols.tolist()
    slots = dg.pred_slots.tolist()
    wslots = dg.write_slots.tolist()
    for r in range(dg.n_nodes):
        idx = torch.as_tensor(slots[r], device=qshift.device)
        pred_M, pred_D1, pred_D2 = (rg.index_select(1, idx) for rg in rings)
        valid = dg.pred_valid[r]
        if r == dg.end_rank_i:
            # virtual end node: a zero-cost hop at the same offset
            yield r, torch.where(valid.view(1, -1, 1), pred_M,
                                 INF).min(1).values
            return
        match_cost = torch.where(qshift == symbols[r], 0, x).to(torch.int32)
        M, _, _, D1, D2 = row_update_2p(pred_M, pred_D1, pred_D2, valid,
                                        match_cost, o1, e1, e2,
                                        is_start_row=r == 0,
                                        free_start=free_start and r > 0)
        for rg, row in zip(rings, (M, D1, D2)):
            rg[:, wslots[r]] = row
        yield r, M
    raise ValueError("the graph has no end rank")


def scan_scores(dg: DeviceGraph, qshift: torch.Tensor, lengths: torch.Tensor,
                costs, free_start: bool = False,
                free_end: bool = False) -> torch.Tensor:
    """(B,) global scores by a plain rank scan over :func:`row_update`, or
    for two-piece costs over ``row_update_2p``.  ``free_start``: every real
    rank may begin the alignment at offset 0; ``free_end``: every real
    rank's M at the read's length may end it, beside the end rank's.

    Twin of ``poasta_tpu``'s XLA ``_scores_exec`` and ``_scores_exec_2p``,
    independent of the fill kernels and their plain versions, so it can
    serve as their oracle.
    """
    if costs.is_two_piece:
        rows = _scan_rows_2p(dg, qshift, costs, free_start)
    else:
        rows = ((r, M) for r, M, _, _ in _scan_rows(
            dg, qshift, costs, dg.n_nodes, free_start))
    idx = lengths.long().view(-1, 1)
    score = None
    best = torch.full((qshift.shape[0],), INF, dtype=torch.int32,
                      device=qshift.device)
    for r, M in rows:
        at = M.gather(1, idx)[:, 0]
        if r == dg.end_rank_i:
            score = at
        elif free_end and r > 0:
            best = torch.minimum(best, at)
    return torch.minimum(score, best) if free_end else score


def dp_fill_full(dg: DeviceGraph, qshift: torch.Tensor, lengths: torch.Tensor,
                 costs, free_start: bool = False):
    """Full fill for the host backtrace: (scores (B,), M, I, D each
    (Np, B, L) int32).  Twin of ``poasta_tpu``'s XLA ``dp_fill_full``: the
    same scan over every padded rank, keeping each rank's rows;
    ``free_start`` seeds offset 0 at every real rank (the tables of
    :func:`backtrace_dense_ends_free` under a free graph begin).  The scores
    are the end rank's.  Plain PyTorch on any device; the tables feed
    :func:`backtrace_dense` on the mapper's small global batches (under its
    dense-table budget) and :func:`backtrace_dense_ends_free` for library
    callers only (the mapper aligns ends-free spans through the native
    engine)."""
    if costs.is_two_piece:
        # as in the reference: the dense tables hold one insertion and one
        # deletion layer, so two-piece alignment takes the banded route
        raise NotImplementedError(
            "dp_fill_full implements the one-piece recurrence; use "
            "BatchMapper.align_batch / the banded path for two-piece costs")
    dg, qshift, lengths = _at_graph(dg, qshift, lengths)
    B, L = qshift.shape
    shape = (dg.n_nodes_padded, B, L)
    M = torch.empty(shape, dtype=torch.int32, device=qshift.device)
    I = torch.empty_like(M)
    D = torch.empty_like(M)
    for r, m, i, d in _scan_rows(dg, qshift, costs, dg.n_nodes_padded,
                                 free_start):
        M[r], I[r], D[r] = m, i, d
    scores = M[dg.end_rank_i].gather(1, lengths.long().view(-1, 1))[:, 0]
    return scores, M, I, D


def backtrace_dense(flat: FlatGraph, M: np.ndarray, I: np.ndarray,
                    D: np.ndarray, query: bytes, costs) -> Alignment:
    """Reconstruct one optimal alignment from converged dense score tables
    (rank-major: ``M[rank, offset]``).  Numpy twin of
    ``poasta_tpu.aligner.wavefront.backtrace_dense``.

    Same priority rules as the exact engine's backtrace (diagonal first,
    predecessors scanned oldest-edge-first, then deletion closure, then
    insertion closure).  A query prefix that aligns as a leading
    insertion run against the virtual start node is not emitted as pairs:
    the alignment starts at the first real-node visit.
    """
    o, e, x = costs.gap_open, costs.gap_extend, costs.mismatch
    n = len(query)
    end_rank = flat.n_nodes - 1

    def preds(r):
        # CSR stores newest-edge-first; the backtrace scans oldest-first.
        lst = flat.pred_idx[flat.pred_ptr[r]: flat.pred_ptr[r + 1]]
        return list(lst[::-1])

    alignment: Alignment = []
    j = n
    cur = int(M[end_rank, j])
    r = None
    for p in preds(end_rank):
        if int(M[p, j]) == cur:
            r = int(p)
            break
    if r is None:
        raise RuntimeError("dense backtrace: no predecessor for end state")
    state = "M"

    while True:
        cur = int(M[r, j]) if state == "M" else (
            int(D[r, j]) if state == "D" else int(I[r, j]))
        step = None
        if state == "M":
            if j > 0:
                sym_match = int(flat.symbols[r]) == query[j - 1]
                want = cur if sym_match else cur - x
                for p in preds(r):
                    if int(M[p, j - 1]) == want:
                        step = (int(p), j - 1, "M")
                        break
            if step is None and int(D[r, j]) == cur:
                step = (r, j, "D")
            if step is None and int(I[r, j]) == cur:
                step = (r, j, "I")
        elif state == "D":
            for p in preds(r):
                if int(M[p, j]) == cur - o - e:
                    step = (int(p), j, "M")
                    break
            if step is None:
                for p in preds(r):
                    if int(D[p, j]) == cur - e:
                        step = (int(p), j, "D")
                        break
        else:  # insertion
            if j > 0:
                if int(M[r, j - 1]) == cur - o - e:
                    step = (r, j - 1, "M")
                elif int(I[r, j - 1]) == cur - e:
                    step = (r, j - 1, "I")

        if step is None:
            break

        bt_r, bt_j, bt_state = step
        if state == "M" and bt_state in ("D", "I"):
            r, j, state = bt_r, bt_j, bt_state
            continue

        node = int(flat.node_of_rank[r])
        if state == "M":
            alignment.append(AlignedPair(node, j - 1))
        elif state == "I":
            alignment.append(AlignedPair(None, j - 1))
        else:
            alignment.append(AlignedPair(node, None))

        if bt_r == 0:  # virtual start node
            break
        r, j, state = bt_r, bt_j, bt_state

    alignment.reverse()
    return alignment


def backtrace_dense_ends_free(flat: FlatGraph, M: np.ndarray, I: np.ndarray,
                              D: np.ndarray, query: bytes, costs,
                              end_ok: np.ndarray, jlo: int,
                              free_start: bool) -> Tuple[int, Alignment]:
    """Ends-free backtrace over converged dense tables (rank-major, from
    :func:`dp_fill_full` with the span's ``free_start``).  Numpy twin of
    ``poasta_tpu.aligner.wavefront.backtrace_dense_ends_free``.

    Picks the best permitted end state (``end_ok`` per rank, query offsets
    [jlo, n]; ties go to the largest offset, then the lowest rank), walks
    with :func:`backtrace_dense`'s priority rules, and stops at any origin:
    the global origin, or under a free graph begin any zero-score offset-0
    seed.  The free query prefix and suffix are not emitted as pairs.

    Returns (score, alignment).
    """
    n = len(query)
    end_rank = flat.n_nodes - 1
    # tables may carry bucket-padded rows; the mask's padding entries are 0
    eo = np.asarray(end_ok)[: M.shape[0]].astype(bool)
    lo = max(int(jlo), 0)
    if lo > n or not eo.any():
        raise RuntimeError("ends-free backtrace: unsatisfiable bounds")
    score = int(M[eo][:, lo:n + 1].min())
    if score >= INF:
        raise RuntimeError("ends-free backtrace: no finite end state")
    ranks_eo = np.flatnonzero(eo)
    best = None
    for j in range(n, lo - 1, -1):
        hit = np.flatnonzero(M[eo, j] == score)
        if hit.size:
            best = (int(ranks_eo[hit[0]]), j)
            break
    r, j = best

    def preds(r_):
        # CSR stores newest-edge-first; the backtrace scans oldest-first.
        lst = flat.pred_idx[flat.pred_ptr[r_]: flat.pred_ptr[r_ + 1]]
        return list(lst[::-1])

    alignment: Alignment = []
    if r == end_rank:
        # virtual end: hop to the real predecessor carrying the score
        r = next((int(p) for p in preds(end_rank) if int(M[p, j]) == score),
                 None)
        if r is None:
            raise RuntimeError("ends-free backtrace: no pred for end state")
    state = "M"
    o, e, x = costs.gap_open, costs.gap_extend, costs.mismatch

    while True:
        cur = int(M[r, j]) if state == "M" else (
            int(D[r, j]) if state == "D" else int(I[r, j]))
        # an origin: a zero-score M cell at offset 0 (the global origin, or
        # under a free graph begin any real rank's seed) consumes nothing
        if state == "M" and j == 0 and cur == 0 and (free_start or r == 0):
            break
        step = None
        if state == "M":
            if j > 0:
                sym_match = int(flat.symbols[r]) == query[j - 1]
                want = cur if sym_match else cur - x
                for p in preds(r):
                    if int(M[p, j - 1]) == want:
                        step = (int(p), j - 1, "M")
                        break
            if step is None and int(D[r, j]) == cur:
                step = (r, j, "D")
            if step is None and int(I[r, j]) == cur:
                step = (r, j, "I")
        elif state == "D":
            for p in preds(r):
                if int(M[p, j]) == cur - o - e:
                    step = (int(p), j, "M")
                    break
            if step is None:
                for p in preds(r):
                    if int(D[p, j]) == cur - e:
                        step = (int(p), j, "D")
                        break
        else:  # insertion
            if j > 0:
                if int(M[r, j - 1]) == cur - o - e:
                    step = (r, j - 1, "M")
                elif int(I[r, j - 1]) == cur - e:
                    step = (r, j - 1, "I")

        if step is None:
            break

        bt_r, bt_j, bt_state = step
        if state == "M" and bt_state in ("D", "I"):
            r, j, state = bt_r, bt_j, bt_state
            continue

        node = int(flat.node_of_rank[r])
        if state == "M":
            alignment.append(AlignedPair(node, j - 1))
        elif state == "I":
            alignment.append(AlignedPair(None, j - 1))
        else:
            alignment.append(AlignedPair(node, None))

        if bt_r == 0:  # virtual start node
            break
        r, j, state = bt_r, bt_j, bt_state

    alignment.reverse()
    return score, alignment


def dp_fill_scores(dg: DeviceGraph, qshift: torch.Tensor,
                   lengths: torch.Tensor, costs, free_start: bool = False,
                   free_end: bool = False,
                   engine: str = "auto") -> torch.Tensor:
    """(B,) optimal alignment scores by the full-width fill, under one- or
    two-piece costs: global, or with a free graph begin (every real rank
    may start at offset 0) and/or a free graph end (every real rank may
    end at the read's length).

    On a CUDA tensor the fill kernel runs (or raises); on a CPU tensor its
    plain PyTorch version does.  Free graph ends run the bounded fill under
    an end mask with jlo = n (:func:`..ops.cuda_fill.free_end_mask`), as
    ``poasta_tpu`` does past its kernels' size budget.  ``engine``:
    "auto" or "pallas" (:func:`..utils.device.check_engine`).
    """
    check_engine(engine)
    dg, qshift, lengths = _at_graph(dg, qshift, lengths)
    if free_start or free_end:
        return free_fill_scores(dg, qshift, lengths, costs, free_start,
                                free_end)
    if costs.is_two_piece:
        return fill_scores_2p(dg, qshift, lengths, costs)
    return fill_scores(dg, qshift, lengths, costs)


def query_end_lo(aln_type: EndsFree, lengths_np: np.ndarray,
                 two_piece: bool = False) -> np.ndarray:
    """(B,) lowest query offset at which a read may end under
    ``aln_type.qry_free_end``: the permitted end offsets are [jlo, n]
    (empty when the bound cannot be met).  The unbounded case keeps the
    exact engines' rules: offset > 0 under one-piece costs (an empty read
    ends at 0), the read's last base under two-piece costs.  The one place
    this bound is lowered; host and device users share it."""
    li = np.asarray(lengths_np).astype(np.int64)
    kind, val = aln_type.qry_free_end
    if kind == "unbounded":
        jlo = li if two_piece else np.minimum(li, 1)
    elif kind == "included":
        jlo = np.maximum(li - val, 0)
    else:
        jlo = np.maximum(li - val + 1, 0)
    return jlo.astype(np.int32)


def ends_free_device_params(flat: FlatGraph, aln_type: EndsFree,
                            lengths: torch.Tensor, n_nodes_padded: int,
                            two_piece: bool = False, with_jlo: bool = True):
    """Lower an ``EndsFree`` span to what the bounded fills take:
    ``(free_start, end_ok, jlo)`` on ``lengths``' device.

    * ``free_start``: graph_free_begin is unbounded (a bounded free begin
      degenerates to the start node, as in the exact engine).
    * ``end_ok``: (Np,) int32, rank may end the alignment by the
      graph_free_end bound on its min distance to the end node.  No rank is
      excluded by kind: the virtual end rank (distance 0) passes every
      bound but excluded(0).
    * ``jlo``: (B,) int32, :func:`query_end_lo` (``two_piece``: the
      two-piece engines' rule), or None with ``with_jlo=False``.
    ``qry_free_begin`` is parsed and ignored, as in the exact engine.
    """
    if not isinstance(aln_type, EndsFree):
        raise TypeError(f"expected an EndsFree span, got {aln_type!r}")
    n = flat.n_nodes
    de = flat.min_dist_to_end.astype(np.int64)
    kind, val = aln_type.graph_free_end
    if kind == "unbounded":
        ok = np.ones(n, dtype=np.int32)
    elif kind == "included":
        ok = (de <= val).astype(np.int32)
    else:
        ok = (de < val).astype(np.int32)
    end_ok = np.zeros(n_nodes_padded, dtype=np.int32)
    end_ok[:n] = ok
    dev = lengths.device
    jlo = None
    if with_jlo:
        jlo = torch.as_tensor(
            query_end_lo(aln_type, lengths.cpu().numpy(), two_piece),
            device=dev)
    return (aln_type.graph_free_begin[0] == "unbounded",
            torch.as_tensor(end_ok, device=dev), jlo)


def _ends_free_fill(fill, dg, flat, qshift, lengths, costs, aln_type,
                    mesh, max_run):
    """``fill`` (a bounded fill of :mod:`..ops.cuda_fill`) of an ends-free
    span on each dp shard of ``mesh`` (None: the graph's device), the
    graph and the span's end mask replicated, the reads split; the outputs
    gathered on the graph's device."""
    check_mesh(mesh)
    dg, qshift, lengths = _at_graph(dg, qshift, lengths)
    free_start, end_ok, jlo = ends_free_device_params(
        flat, aln_type, lengths, dg.n_nodes_padded, costs.is_two_piece)
    return gather([fill(dg.on(d), qshift[rows].to(d), lengths[rows].to(d),
                        costs, free_start, end_ok.to(d), jlo[rows].to(d),
                        max_run=max_run)
                   for d, rows in dp_shards(mesh, int(qshift.shape[0]),
                                            dg.device)], dg.device)


def dp_fill_scores_ends_free(dg: DeviceGraph, flat: FlatGraph,
                             qshift: torch.Tensor, lengths: torch.Tensor,
                             costs, aln_type: EndsFree,
                             engine: str = "auto", mesh=None,
                             max_run: int = 0) -> torch.Tensor:
    """(B,) optimal ends-free scores by the full-width bounded fill, with
    included/excluded/unbounded bounds on the graph and query free ends,
    under one- or two-piece costs.  ``max_run`` caps the insertion scan
    (scores are then upper bounds; see ``aligner.banded.run_capped_ladder``).

    On a CUDA tensor the bounded fill kernel runs (or raises); on a CPU
    tensor its plain PyTorch version does.  ``engine``: see
    :func:`..utils.device.check_engine`.  ``mesh``: a port mesh
    (:mod:`..utils.mesh`) runs the fill (B4, B13 for two-piece costs) on
    each dp shard; a shard's error reaches the caller.
    """
    check_engine(engine)
    fill = bounded_scores_2p if costs.is_two_piece else bounded_scores
    return _ends_free_fill(fill, dg, flat, qshift, lengths, costs, aln_type,
                           mesh, max_run)


def dp_fill_ends_free_with_ends(dg: DeviceGraph, flat: FlatGraph,
                                qshift: torch.Tensor, lengths: torch.Tensor,
                                costs, aln_type: EndsFree,
                                engine: str = "auto", mesh=None,
                                max_run: int = 0):
    """(scores, end_ranks, end_offsets), each (B,) int32, for an ends-free
    span by the full-width bounded fill.

    The end state is each read's optimal permitted (rank, offset), the
    anchor of the device traceback and of
    ``NativeAligner.align_anchored``; ties go to the largest offset, then
    the lowest rank.  ``max_run`` caps the insertion scan as in
    :func:`dp_fill_scores_ends_free`; one- or two-piece costs.

    On a CUDA tensor the fill kernel runs (or raises); on a CPU tensor its
    plain PyTorch version does.  ``engine`` and ``mesh`` as in
    :func:`dp_fill_scores_ends_free` (B7, B14 for two-piece costs, on each
    shard).
    """
    check_engine(engine)
    fill = bounded_with_ends_2p if costs.is_two_piece else bounded_with_ends
    return _ends_free_fill(fill, dg, flat, qshift, lengths, costs, aln_type,
                           mesh, max_run)


def alignment_cost(graph, query: bytes, alignment: Alignment, costs) -> int:
    """Recompute an alignment's gap-affine cost from its pairs (a
    validation helper: under any span the cost of the returned pairs must
    equal the returned score, free ends emitting no pairs).

    Two-piece costs follow the engines' state machine (I -> I2 and
    D -> D2 at ``gap_extend2``): a run's first character costs
    open + extend, each further one the cheaper of the two extends.
    """
    o, e = costs.gap_open, costs.gap_extend
    cont = min(e, costs.gap_extend2) if costs.is_two_piece else e
    total = 0
    prev_state = "M"
    for pair in alignment:
        if pair.is_aligned():
            total += 0 if graph.is_symbol_equal(pair.rpos, query[pair.qpos]) \
                else costs.mismatch
            prev_state = "M"
        elif pair.is_insertion():  # graph node skipped: deletion state
            total += (o + e) if prev_state != "D" else cont
            prev_state = "D"
        else:  # query char unaligned: insertion state
            total += (o + e) if prev_state != "I" else cont
            prev_state = "I"
    return total
