"""Dense wavefront fill: the static device graph, read packing, the
full-fill scores (global and ends-free spans), and the dense tables + host
backtrace of small batches.  Port of the one-piece, single-device part of
``poasta_tpu/aligner/wavefront.py``.

Ranks are the sequential axis, query offsets the lanes and reads the
batch; rows live in a ring of ``W`` liveness-coloured slots, so the
working set is O(B·W·L), not O(B·N·L).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from ..graphs.flat import FlatGraph
from ..ops.cuda_fill import bounded_scores, fill_scores
from ..ops.dp_rows import INF, row_update
from ..utils.device import resolve_device
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
    no graph data between host and device.
    """

    symbols: torch.Tensor  # (Np,) int32; padding rows are symbol -1
    pred_slots: torch.Tensor  # (Np, P) int32 ring slot per predecessor
    pred_valid: torch.Tensor  # (Np, P) bool
    end_rank: torch.Tensor  # () int32, the end node's rank
    window: int  # ring size W = liveness-colouring peak
    n_nodes_padded: int
    n_nodes: int
    pred_ranks_np: np.ndarray  # (Np, P) predecessor ranks (host)
    pred_valid_np: np.ndarray  # (Np, P) valid mask (host)
    end_rank_i: int
    pred_slots_flat: torch.Tensor  # (Np*P,) int32
    pred_valid_flat: torch.Tensor  # (Np*P,) int32 0/1
    meta: torch.Tensor  # (4,) int32 [n_nodes, end_rank, 0, 0]
    write_slots: torch.Tensor  # (Np,) int32 ring slot each rank writes

    @property
    def device(self) -> torch.device:
        return self.symbols.device

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
    def build(flat: FlatGraph, device=None) -> "DeviceGraph":
        """Lay ``flat`` out on ``device`` (None: the card; raises without
        one)."""
        device = resolve_device(device)
        n = flat.n_nodes
        P = _next_pow2(max(1, flat.max_in_degree))
        np_nodes = _round_up(n, NODE_BUCKET)

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
        return DeviceGraph.from_arrays(symbols, pred_slots, pred_valid,
                                       pred_ranks, write_slots, window, n,
                                       device)


def pack_queries(queries, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pack byte-string reads into a padded (B, L) int32 batch + (B,)
    lengths on ``device`` (None: the card; raises without one).

    Column ``j`` holds ``q[j-1]`` (offset j consumes query char j-1);
    column 0 and the padding are 0, which matches no nucleotide symbol.
    ``L`` is rounded up to a multiple of 128.
    """
    device = resolve_device(device)
    maxlen = max((len(q) for q in queries), default=0)
    L = _round_up(maxlen + 1, 128)
    arr = np.zeros((len(queries), L), dtype=np.int32)
    lengths = np.zeros((len(queries),), dtype=np.int32)
    for b, q in enumerate(queries):
        arr[b, 1:len(q) + 1] = np.frombuffer(bytes(q), dtype=np.uint8)
        lengths[b] = len(q)
    return (torch.as_tensor(arr, device=device),
            torch.as_tensor(lengths, device=device))


def _scan_rows(dg: DeviceGraph, qshift: torch.Tensor, costs, n_ranks: int):
    """Yield (rank, M, I, D) rows of the clamped dense recurrence for ranks
    0 .. n_ranks-1: a plain rank scan over :func:`row_update`, written
    independently of the fill kernels and their plain versions."""
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
                             is_start_row=r == 0, free_start=False)
        if r == end:
            # virtual end node: a zero-cost hop at the same offset
            M = torch.where(valid.view(1, -1, 1), pred_M, INF).min(1).values
            I = torch.full_like(I, INF)
            D = torch.full_like(D, INF)
        M_ring[:, wslots[r]] = M
        D_ring[:, wslots[r]] = D
        yield r, M, I, D


def scan_scores(dg: DeviceGraph, qshift: torch.Tensor, lengths: torch.Tensor,
                costs) -> torch.Tensor:
    """(B,) global scores by a plain rank scan over :func:`row_update`.

    Twin of ``poasta_tpu``'s XLA ``_scores_exec``, independent of the fill
    kernels and their plain versions, so it can serve as their oracle.
    """
    end_M = None
    for r, M, _, _ in _scan_rows(dg, qshift, costs, dg.n_nodes):
        if r == dg.end_rank_i:
            end_M = M
    return end_M.gather(1, lengths.long().view(-1, 1))[:, 0]


def dp_fill_full(dg: DeviceGraph, qshift: torch.Tensor, lengths: torch.Tensor,
                 costs):
    """Full fill for the host backtrace: (scores (B,), M, I, D each
    (Np, B, L) int32).  Twin of ``poasta_tpu``'s XLA ``dp_fill_full``
    (global spans): the same scan over every padded rank, keeping each
    rank's rows.  Plain PyTorch on any device; its tables feed
    :func:`backtrace_dense` only on shapes under the mapper's dense-table
    budget."""
    if getattr(costs, "is_two_piece", False):
        raise NotImplementedError(
            "dp_fill_full implements the one-piece recurrence; two-piece "
            "costs are not ported yet")
    B, L = qshift.shape
    shape = (dg.n_nodes_padded, B, L)
    M = torch.empty(shape, dtype=torch.int32, device=qshift.device)
    I = torch.empty_like(M)
    D = torch.empty_like(M)
    for r, m, i, d in _scan_rows(dg, qshift, costs, dg.n_nodes_padded):
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


def dp_fill_scores(dg: DeviceGraph, qshift: torch.Tensor,
                   lengths: torch.Tensor, costs) -> torch.Tensor:
    """(B,) optimal global alignment scores by the full-width fill.

    On a CUDA tensor the fill kernel runs (or raises); on a CPU tensor its
    plain PyTorch version does.
    """
    if getattr(costs, "is_two_piece", False):
        raise NotImplementedError("two-piece costs are not ported yet")
    return fill_scores(dg, qshift, lengths, costs)


def query_end_lo(aln_type: EndsFree, lengths_np: np.ndarray) -> np.ndarray:
    """(B,) lowest query offset at which a read may end under
    ``aln_type.qry_free_end``: the permitted end offsets are [jlo, n]
    (empty when the bound cannot be met).  The unbounded case keeps the
    exact engine's offset > 0 rule (an empty read ends at 0).  The one
    place this bound is lowered; host and device users share it."""
    li = np.asarray(lengths_np).astype(np.int64)
    kind, val = aln_type.qry_free_end
    if kind == "unbounded":
        jlo = np.minimum(li, 1)
    elif kind == "included":
        jlo = np.maximum(li - val, 0)
    else:
        jlo = np.maximum(li - val + 1, 0)
    return jlo.astype(np.int32)


def ends_free_device_params(flat: FlatGraph, aln_type: EndsFree,
                            lengths: torch.Tensor, n_nodes_padded: int):
    """Lower an ``EndsFree`` span to what the bounded fills take:
    ``(free_start, end_ok, jlo)`` on ``lengths``' device.

    * ``free_start``: graph_free_begin is unbounded (a bounded free begin
      degenerates to the start node, as in the exact engine).
    * ``end_ok``: (Np,) int32, rank may end the alignment by the
      graph_free_end bound on its min distance to the end node.  No rank is
      excluded by kind: the virtual end rank (distance 0) passes every
      bound but excluded(0).
    * ``jlo``: (B,) int32, :func:`query_end_lo`.
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
    jlo = query_end_lo(aln_type, lengths.cpu().numpy())
    dev = lengths.device
    return (aln_type.graph_free_begin[0] == "unbounded",
            torch.as_tensor(end_ok, device=dev),
            torch.as_tensor(jlo, device=dev))


def dp_fill_scores_ends_free(dg: DeviceGraph, flat: FlatGraph,
                             qshift: torch.Tensor, lengths: torch.Tensor,
                             costs, aln_type: EndsFree,
                             max_run: int = 0) -> torch.Tensor:
    """(B,) optimal ends-free scores by the full-width bounded fill, with
    included/excluded/unbounded bounds on the graph and query free ends.
    ``max_run`` caps the insertion scan (scores are then upper bounds; see
    ``aligner.banded.run_capped_ladder``).

    On a CUDA tensor the bounded fill kernel runs (or raises); on a CPU
    tensor its plain PyTorch version does.
    """
    if getattr(costs, "is_two_piece", False):
        raise NotImplementedError("two-piece costs are not ported yet")
    free_start, end_ok, jlo = ends_free_device_params(
        flat, aln_type, lengths, dg.n_nodes_padded)
    return bounded_scores(dg, qshift, lengths, costs, free_start, end_ok, jlo,
                          max_run=max_run)
