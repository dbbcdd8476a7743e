"""Device-side traceback: a pointer-emitting corridor refill and a decode.

Port of ``poasta_tpu/ops/pallas_trace.py``: global spans (the anchor is the
virtual end rank at the read's length) and ends-free spans (a per-read
anchor, the end state the scoring fill found; with a free graph begin the
origin lies at every rank but the end rank).  Given a batch of reads with
certified exact scores:

1. :func:`build_trace_schedule` derives, per read, a monotone 128-lane
   window-start schedule over the ranks that covers every cell a path of
   cost <= the read's gap budget can visit (same bounds as the
   reference, in torch with ``torch.cummax``).
2. :func:`trace_fill` refills each read's corridor (tilted coordinates,
   as the banded fill) and writes one int32 pointer word per cell into
   (Np, B, Wb) planes, plus the anchor cell's value.  The anchor value
   equal to the certified score proves the corridor holds an optimal
   path.  An anchored read walks only the ranks a path of cost <= its
   score can pass (:func:`trace_ranges`).  On a CUDA tensor it launches
   ``csrc/trace_kernel.cu``'s ``trace_fill_kernel``; on a CPU tensor it
   runs :func:`trace_fill_plain`.
3. :func:`trace_decode` walks each verified read's pointer chain from the
   anchor and emits ``rank<<4 | op`` step words (CUDA:
   ``csrc/decode_kernel.cu``'s ``decode_warp_kernel``, a warp a read; CPU:
   :func:`decode_plain`).
4. :func:`replay_steps` turns step words into an ``ArrayAlignment``.

:func:`trace_align` drives the width tiers 256 ... 4096.  The pointer
word layout and the priority rules (Match takes diag, then D, then I;
predecessor ties go to the highest CSR column; a gap takes open before
extend) are the reference's, bit for bit, so the alignments equal the
native engine's backtrace.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np
import torch

from ..utils import build, spans
from ..utils.device import resolve_device
from .cuda_fill import _check_operands, _prefix_min, register_plan
from .dp_rows import INF

# pointer-word layout (int32), as poasta_tpu/ops/pallas_trace.py:67-73:
#   bits 0-1  msrc: 0 diag / 1 from-D / 2 from-I / 3 origin (stop)
#   bits 2-6  diagonal predecessor column (same-j column at the end rank)
#   bit  7    isrc: 0 gap-open / 1 extend
#   bit  8    dsrc: 0 gap-open / 1 extend
#   bits 9-13 deletion predecessor column
MSRC_DIAG, MSRC_D, MSRC_I, MSRC_ORIGIN = 0, 1, 2, 3
PMAX = 32  # pointer pred fields are 5 bits

# decode step words: rank<<4 | op
OP_STOP, OP_DIAG, OP_DEL, OP_INS, OP_HOP = 0, 1, 2, 3, 4

TIER_WIDTHS = (256, 512, 1024, 2048, 4096)


def trace_enabled() -> bool:
    """Whether the device traceback runs: always, unless
    ``POASTA_DEVICE_TRACE=0`` sends every read to the native host
    backtrace.  On a CPU tensor the trace runs its plain versions."""
    return os.environ.get("POASTA_DEVICE_TRACE", "") != "0"


# --------------------------------------------------------------------------
# Schedule
# --------------------------------------------------------------------------

def _sched_potentials(flat, Np: int, device):
    """(Np,) int64 min/max distance-from-start potentials, zero-padded."""
    n = flat.n_nodes
    dmin = np.zeros((Np,), np.int64)
    dmax = np.zeros((Np,), np.int64)
    dmin[:n] = flat.min_dist_from_start[:n]
    dmax[:n] = flat.max_dist_from_start[:n]
    return (torch.as_tensor(dmin, device=device),
            torch.as_tensor(dmax, device=device))


def _corridor_bounds(dmin, dmax, lengths, k, aj, a_dmin, a_dmax,
                     n_real: int):
    """(lo, hi (B, R), nonempty (B, R) bool): the offsets a path of gap
    budget ``k`` through each of the R ranks of ``dmin`` towards the anchor
    can consume (:func:`build_trace_schedule`'s lemma, in the operands'
    integer type), and where they are not empty."""
    K = k.clamp(min=0).view(-1, 1)
    ajc = aj.view(-1, 1)
    lo = ajc - (a_dmax.view(-1, 1) - dmax.view(1, -1)) - K
    hi = torch.minimum(ajc - (a_dmin.view(-1, 1) - dmin.view(1, -1)) + K,
                       lengths.view(-1, 1))
    ridx = torch.arange(dmin.shape[0], dtype=torch.int64,
                        device=dmin.device).view(1, -1)
    return lo, hi, (ridx < n_real) & (lo <= hi) & (hi >= 0)


def _schedule_body(dmin, dmax, lengths, k, aj, a_dmin, a_dmax, n_real: int,
                   Wb: int):
    """Per-read slope-limited 128-quantized window starts (int64 math).

    Returns (steps (B, Np) bool, ok (B,) bool, start (B, Np) int64: the
    schedule's own window starts, and the corridor's rank range: r_lo,
    r_hi (B,) int64, the first and last rank whose bounds are not empty,
    and has (B,) bool, whether any rank's are)."""
    Np = dmin.shape[0]
    lo, hi, nonempty = _corridor_bounds(dmin, dmax, lengths, k, aj, a_dmin,
                                        a_dmax, n_real)
    ridx = torch.arange(Np, dtype=torch.int64, device=dmin.device).view(1, -1)
    need = torch.where(nonempty, hi - (Wb - 1), 0)
    A = (need.clamp(min=0) + 127) // 128
    t = A - ridx
    # step early: the minimal slope-limited schedule covering every later
    # need is a reverse running max of A[r] - r, monotonised forward
    req = torch.flip(torch.cummax(torch.flip(t, [1]), 1).values, [1]) + ridx
    s = torch.cummax(req.clamp(min=0), 1).values
    start = torch.where(ridx < n_real, s * 128, 0)
    viol = nonempty & ((start > lo.clamp(min=0)) | (start + Wb - 1 < hi))
    ok = ~viol.any(dim=1)
    prev = torch.cat([torch.zeros_like(start[:, :1]), start[:, :-1]], dim=1)
    has = nonempty.any(dim=1)
    seen = nonempty.to(torch.int8)
    r_lo = torch.argmax(seen, dim=1)
    r_hi = Np - 1 - torch.argmax(torch.flip(seen, [1]), dim=1)
    return (start - prev) > 0, ok, start, r_lo, r_hi, has


def build_trace_schedule(flat, lengths_np, k_np, Wb: int, Np: int,
                         device=None, anchor_r_np=None, anchor_j_np=None):
    """Per-read monotone 128-quantized window-start schedule towards each
    read's anchor: (``anchor_r_np``, ``anchor_j_np``), or by default the
    global one (the virtual end rank at j = the read's length).

    For any path of cost <= ub_b through rank r that ends at the anchor
    (ar, aj) (min/max_dist_from_start change by <= 1 / >= 1 per edge), the
    consumed offset j satisfies
      aj - (dmax[ar] - dmax[r]) - K <= j <= aj - (dmin[ar] - dmin[r]) + K
    with K = the gap budget ``k_np``.  Returns steps (B, Np) bool on
    ``device`` (None: the card) (the window steps 128 lanes at that rank)
    and host ok (B,) bool: False where width ``Wb`` provably cannot cover
    the read's bounds.
    """
    device = resolve_device(device)
    steps, ok = _schedule_body(
        *_anchored_operands(flat, lengths_np, k_np, Np, device, anchor_r_np,
                            anchor_j_np), flat.n_nodes, Wb)[:2]
    return steps, ok.cpu().numpy()


def _anchored_operands(flat, lengths_np, k_np, Np: int, device, anchor_r_np,
                       anchor_j_np):
    """(dmin, dmax, lengths, k, aj, a_dmin, a_dmax) on ``device``, the
    operands of :func:`_corridor_bounds` towards each read's anchor (None:
    the global one)."""
    n = flat.n_nodes
    B = lengths_np.shape[0]

    def put(v):
        return torch.as_tensor(np.asarray(v, dtype=np.int64), device=device)

    dmin, dmax = flat.min_dist_from_start, flat.max_dist_from_start
    if anchor_r_np is None:
        aj = lengths_np
        a_dmin = np.full((B,), dmin[n - 1])
        a_dmax = np.full((B,), dmax[n - 1])
    else:
        ar = np.asarray(anchor_r_np).astype(np.int64)
        aj = anchor_j_np
        a_dmin, a_dmax = dmin[ar], dmax[ar]
    return (*_sched_potentials(flat, Np, device), put(lengths_np), put(k_np),
            put(aj), put(a_dmin), put(a_dmax))


def trace_ranges(flat, lengths_np, k_full_np, Np: int, device, anchor_r_np,
                 anchor_j_np, free_start: bool):
    """(r_begin, r_end) (B,) int32 on ``device``: the ranks an anchored
    read's trace fill walks.  ``r_end`` is the anchor rank (a later rank
    cannot reach it); ``r_begin`` is, with ``free_start``, the first rank
    whose corridor bounds at the proven budget ``k_full_np`` are not empty,
    else rank 0 (the one origin).

    By :func:`build_trace_schedule`'s lemma with ub = the read's score and
    K = its proven budget, every path of cost <= the score that ends at
    the anchor lies in this range.  So the fill verifies the same reads
    and decodes the same chains as a walk of every rank: a cell on an
    optimal chain keeps its value, and every other candidate of its
    pointer word can only rise, which keeps every tie as it was."""
    device = resolve_device(device)
    return _rank_range(
        _anchored_operands(flat, lengths_np, k_full_np, Np, device,
                           anchor_r_np, anchor_j_np) if free_start else None,
        anchor_r_np, flat.n_nodes, device)


def _rank_range(operands, anchor_r_np, n_real: int, device):
    """:func:`trace_ranges` from :func:`_anchored_operands` at the proven
    budgets (None: no free graph begin, every read from rank 0).  The
    bounds are taken in int32 and only up to the last anchor rank."""
    r_end = torch.as_tensor(np.asarray(anchor_r_np, np.int32), device=device)
    if operands is None or not r_end.numel():
        return torch.zeros_like(r_end), r_end
    stop = int(np.max(anchor_r_np)) + 1
    dmin, dmax, *per_read = (t.to(torch.int32) for t in operands)
    nonempty = _corridor_bounds(dmin[:stop], dmax[:stop], *per_read,
                                n_real)[2]
    # the anchor's own rank is never empty, so the first one lies at or
    # before it
    r_begin = torch.argmax(nonempty.to(torch.int8), dim=1)
    return r_begin.to(torch.int32).contiguous(), r_end


def window_starts(steps: torch.Tensor) -> torch.Tensor:
    """(B, Np) int32 start of each rank's window as the fill walks it: the
    window moves at most one 128-lane step per rank.  The schedule's own
    starts, less the read's start at rank 0, which is 0 for every read that
    can verify (an origin at j = 0 must lie in its rank's window)."""
    return (torch.cumsum(steps.to(torch.int32), dim=1) * 128).to(torch.int32)


# --------------------------------------------------------------------------
# Trace fill (B18)
# --------------------------------------------------------------------------

def trace_plan(W: int, Wb: int) -> dict:
    """Launch shape, body and working-set placement of the trace kernel for
    a ring of W rows of Wb lanes: ``threads``, ``lanes_per_thread`` (each
    thread holds that many lanes of a rank in registers),
    ``barriers_per_rank``, ``smem_bytes``, ``placement`` (needs the card)."""
    return register_plan("poasta_trace_plan", W, Wb)


def _roll1(t: torch.Tensor) -> torch.Tensor:
    """Lane roll by one: lane i takes lane i-1, lane 0 takes the last."""
    return torch.roll(t, 1, dims=-1)


def trace_fill_plain(dg, qpad: torch.Tensor, wstarts: torch.Tensor,
                     anchor_r: torch.Tensor, anchor_j: torch.Tensor, costs,
                     Wb: int, free_start: bool = False,
                     r_begin: torch.Tensor | None = None,
                     r_end: torch.Tensor | None = None):
    """Plain PyTorch version of the trace kernel.

    ``qpad``: (B, LQ) packed reads, LQ >= Wb + 128 (lanes past LQ read as
    0).  ``wstarts``: (B, Np) window starts (:func:`window_starts`).
    ``free_start``: the origin (a forced 0 at j = 0, and the pointer word
    that stops the walk) lies at every rank but the end rank, not only at
    rank 0.  ``r_begin`` / ``r_end``: (B,) the first and last rank each
    read walks (:func:`trace_ranges`); None walks every rank.
    Returns (aval (B,) int32: min of the untilted M at the anchor cell, or
    INF; ptr (Np, B, Wb) int32 pointer planes, rows past the last rank and
    outside a read's range 0).

    It walks the ranks as the reference kernel does: when a read's window
    steps, its query row and every ring row shift left by 128 lanes
    (INF, or 0 for the query, coming in on the right).  A read outside its
    range at a rank writes neither its ring slot nor its pointer row.
    """
    o, e, x = costs.gap_open, costs.gap_extend, costs.mismatch
    B, LQ = qpad.shape
    dev = qpad.device
    Np, n, W = dg.n_nodes_padded, dg.n_nodes, dg.window
    P = int(dg.pred_slots.shape[1])
    ptr = torch.zeros((Np, B, Wb), dtype=torch.int32, device=dev)
    aval = torch.full((B,), INF, dtype=torch.int32, device=dev)
    m_ring = torch.full((W, B, Wb), INF, dtype=torch.int32, device=dev)
    d_ring = torch.full_like(m_ring, INF)
    qcur = qpad[:, :Wb].clone()
    lane = torch.arange(Wb, dtype=torch.int32, device=dev).view(1, -1)
    inf_col = torch.full((B, 128), INF, dtype=torch.int32, device=dev)
    ar = anchor_r.view(-1, 1)
    aj = anchor_j.view(-1, 1)
    symbols = dg.symbols.tolist()
    slots = dg.pred_slots.tolist()
    valid = dg.pred_valid_flat.view(-1, P).tolist()
    wslots = dg.write_slots.tolist()
    prev = torch.zeros((B,), dtype=torch.int32, device=dev)
    ranks = range(n)
    if r_begin is not None:
        ranks = range(int(r_begin.min()) if B else 0,
                      min(int(r_end.max()) + 1, n) if B else 0)
    for r in ranks:
        # a walk that starts past rank 0 finds its first window where the
        # steps before put it: the query row is gathered afresh there, and
        # the rings hold INF alone until a read's range begins
        w_r = wstarts[:, r]
        stepped = (w_r > prev).view(-1, 1)
        if bool(stepped.any()):
            qidx = (w_r.view(-1, 1) + lane).long()
            qnew = qpad.gather(1, qidx.clamp(max=LQ - 1))
            qcur = torch.where(stepped, torch.where(qidx < LQ, qnew, 0), qcur)
            m_ring = torch.where(stepped, torch.cat(
                [m_ring[:, :, 128:], inf_col.expand(W, B, 128)], dim=2),
                m_ring)
            d_ring = torch.where(stepped, torch.cat(
                [d_ring[:, :, 128:], inf_col.expand(W, B, 128)], dim=2),
                d_ring)
        prev = w_r
        j = w_r.view(-1, 1) + lane

        # predecessor min + argmin; ties go to the highest column
        min_pm, min_pd = m_ring[slots[r][0]], d_ring[slots[r][0]]
        pmidx = torch.zeros((B, Wb), dtype=torch.int32, device=dev)
        pdidx = torch.zeros_like(pmidx)
        for p in range(1, P):
            if valid[r][p] == 1:
                am, ad = m_ring[slots[r][p]], d_ring[slots[r][p]]
            else:
                am = ad = torch.full_like(min_pm, INF)
            pmidx = torch.where(am <= min_pm, p, pmidx)
            pdidx = torch.where(ad <= min_pd, p, pdidx)
            min_pm = torch.minimum(min_pm, am)
            min_pd = torch.minimum(min_pd, ad)

        d_open = min_pm + (o + e)
        D = torch.minimum(d_open, min_pd + e)
        is_open = D == d_open
        dsrc = torch.where(is_open, 0, 1)
        dpidx = torch.where(is_open, pmidx, pdidx)

        diag_src = torch.cat([inf_col[:, :1], min_pm[:, :-1]], dim=1)
        diag = diag_src + torch.where(qcur == symbols[r], -e, x - e)
        A = torch.minimum(diag, D)
        origin = r != dg.end_rank_i if free_start else r == 0
        if origin:
            A = torch.minimum(A, torch.where(j == 0, 0, INF))

        pref = _prefix_min(A, Wb)
        pref_m1 = torch.cat([inf_col[:, :1], pref[:, :-1]], dim=1)
        I = torch.clamp(pref_m1 + o, max=INF)
        M = torch.minimum(A, I)

        msrc = torch.where(M == diag, MSRC_DIAG,
                           torch.where(M == D, MSRC_D, MSRC_I))
        if origin:
            msrc = torch.where((j == 0) & (M == 0), MSRC_ORIGIN, msrc)
        isrc = torch.where(I == _roll1(M) + o, 0, 1)
        if r == dg.end_rank_i:
            # virtual end rank: zero-cost same-offset hop from the best pred
            msrc = torch.zeros_like(msrc)
            didx = pmidx
            M_final = min_pm
            D_store = torch.full_like(D, INF)
        else:
            didx = _roll1(pmidx)
            M_final = M
            D_store = D
        word = (msrc | (didx << 2) | (isrc << 7) | (dsrc << 8)
                | (dpidx << 9)).to(torch.int32)
        matched = (ar == r) & (j == aj)
        ws = wslots[r]
        if r_begin is not None:
            walked = ((r_begin <= r) & (r <= r_end)).view(-1, 1)
            word = torch.where(walked, word, 0)
            matched = matched & walked
            M_final = torch.where(walked, M_final, m_ring[ws])
            D_store = torch.where(walked, D_store, d_ring[ws])
        ptr[r] = word

        # anchor extraction (untilted: rows carry X(j) - e*j)
        cand = torch.where(matched, M_final + e * j, INF).min(dim=1).values
        aval = torch.minimum(aval, cand)
        m_ring[ws] = M_final
        d_ring[ws] = D_store
    return aval, ptr


def _launch_trace(dg, qpad, wstarts, anchor_r, anchor_j, costs, Wb,
                  free_start=False, r_begin=None, r_end=None):
    lib = build.load()
    dev = qpad.device
    B, LQ = qpad.shape
    Np = dg.n_nodes_padded
    operands = {"qpad": qpad, "wstarts": wstarts, "anchor_r": anchor_r,
                "anchor_j": anchor_j, "symbols": dg.symbols,
                "pred_slots": dg.pred_slots_flat,
                "pred_valid": dg.pred_valid_flat,
                "write_slots": dg.write_slots}
    if (r_begin is None) != (r_end is None):
        raise ValueError("a rank range needs both r_begin and r_end")
    if r_begin is not None:
        operands.update(r_begin=r_begin, r_end=r_end)
        if tuple(r_begin.shape) != (B,) or tuple(r_end.shape) != (B,):
            raise ValueError(f"rank ranges must have shape ({B},)")
    _check_operands(dev, **operands)
    if tuple(wstarts.shape) != (B, Np):
        raise ValueError(f"wstarts {tuple(wstarts.shape)} != {(B, Np)}")
    if Wb % 128 or Wb > 4096 or LQ < Wb + 128 or LQ % 4:
        raise ValueError(f"trace tier Wb {Wb} with query row {LQ}")
    if int(dg.pred_slots.shape[1]) > PMAX:
        raise ValueError("in-degree past the pointer word's 5-bit field")
    ptr = torch.empty((Np, B, Wb), dtype=torch.int32, device=dev)
    aval = torch.empty((B,), dtype=torch.int32, device=dev)
    ptr[dg.n_nodes:].zero_()
    if B == 0:
        return aval, ptr
    with torch.cuda.device(dev):
        plan = trace_plan(dg.window, Wb)
        gws = torch.empty(max(plan["global_ints_per_read"] * B, 1),
                          dtype=torch.int32, device=dev)
        code = lib.poasta_trace_fill(
            dg.symbols.data_ptr(), dg.pred_slots_flat.data_ptr(),
            dg.pred_valid_flat.data_ptr(), dg.write_slots.data_ptr(),
            qpad.data_ptr(), wstarts.data_ptr(), anchor_r.data_ptr(),
            anchor_j.data_ptr(),
            None if r_begin is None else r_begin.data_ptr(),
            None if r_end is None else r_end.data_ptr(), B, LQ, Np,
            dg.n_nodes, dg.end_rank_i,
            dg.window, int(dg.pred_slots.shape[1]), Wb, costs.gap_open,
            costs.gap_extend, costs.mismatch, int(free_start), ptr.data_ptr(),
            aval.data_ptr(), gws.data_ptr(), gws.numel(),
            torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, code, "trace fill kernel launch")
    trace_fill.launches += 1
    return aval, ptr


def trace_fill(dg, qpad: torch.Tensor, wstarts: torch.Tensor,
               anchor_r: torch.Tensor, anchor_j: torch.Tensor, costs,
               Wb: int, free_start: bool = False,
               r_begin: torch.Tensor | None = None,
               r_end: torch.Tensor | None = None):
    """(aval (B,), ptr (Np, B, Wb)): the kernel on a CUDA tensor, the
    plain version on a CPU tensor (see :func:`trace_fill_plain`).

    ``r_begin`` / ``r_end``: (B,) int32 the first and last rank each read
    walks (:func:`trace_ranges`), or None for every rank.  The kernel
    leaves the pointer rows outside a read's range unwritten (what the
    allocator gave); the plain version leaves them 0.

    Counts the cells it is handed, ranks (Np) x reads x Wb, as
    ``cells.trace_fill``.
    """
    spans.count("cells.trace_fill",
                dg.n_nodes_padded * int(qpad.shape[0]) * Wb)
    if qpad.device.type == "cuda":
        fn = _launch_trace
    elif qpad.device.type == "cpu":
        fn = trace_fill_plain
    else:
        raise ValueError(f"no trace fill for device {qpad.device}")
    return fn(dg, qpad, wstarts, anchor_r, anchor_j, costs, Wb, free_start,
              r_begin, r_end)


trace_fill.launches = 0


# --------------------------------------------------------------------------
# Decode
# --------------------------------------------------------------------------

def decode_plain(ptr: torch.Tensor, pred_ranks: torch.Tensor,
                 wstarts: torch.Tensor, anchor_r: torch.Tensor,
                 anchor_j: torch.Tensor, end_rank: int, active: torch.Tensor,
                 t_max: int):
    """Plain PyTorch version of the decode kernel: the whole batch walks
    its pointer chains in lockstep for ``t_max`` steps.

    ``pred_ranks``: (Np * P,) int32 predecessor ranks; ``active``: (B,)
    bool, the reads to walk.  Returns (ops (B, t_max) int32 step words
    ``rank<<4 | op``, zero after the walk stops; done (B,) bool).
    """
    Np, B, Wb = ptr.shape
    P = pred_ranks.shape[0] // Np
    dev = ptr.device
    bidx = torch.arange(B, device=dev)
    r = anchor_r.to(torch.int64).clone()
    j = anchor_j.to(torch.int64).clone()
    st = torch.zeros((B,), dtype=torch.int64, device=dev)
    done = ~active
    ops = torch.zeros((B, t_max), dtype=torch.int32, device=dev)
    pr = pred_ranks.to(torch.int64)
    ws = wstarts.to(torch.int64)
    for t in range(t_max):
        if bool(done.all()):
            break
        lane = (j - ws[bidx, r]).clamp(0, Wb - 1)
        word = ptr[r, bidx, lane].to(torch.int64)
        msrc = word & 3
        mp = (word >> 2) & 31
        isrc = (word >> 7) & 1
        dsrc = (word >> 8) & 1
        dp = (word >> 9) & 31
        is_hop = (r == end_rank) & (t == 0)
        act = torch.where(st == 0, msrc,
                          torch.where(st == 1, MSRC_D, MSRC_I))
        op = torch.where(
            is_hop, OP_HOP,
            torch.where(act == MSRC_DIAG, OP_DIAG,
                        torch.where(act == MSRC_D, OP_DEL,
                                    torch.where(act == MSRC_I, OP_INS,
                                                OP_STOP))))
        diag_move = is_hop | (act == MSRC_DIAG)
        new_r = torch.where(diag_move, pr[r * P + mp],
                            torch.where(act == MSRC_D, pr[r * P + dp], r))
        consumes = ~is_hop & ((act == MSRC_DIAG) | (act == MSRC_I))
        new_j = torch.where(consumes, j - 1, j)
        new_st = torch.where(diag_move, 0,
                             torch.where(act == MSRC_D, dsrc, 2 * isrc))
        ops[:, t] = torch.where(done, 0, (r << 4) | op).to(torch.int32)
        new_done = done | (act == MSRC_ORIGIN) | (new_r == 0)
        r = torch.where(done, r, new_r)
        j = torch.where(done, j, new_j)
        st = torch.where(done, st, new_st)
        done = new_done
    return ops, done


def decode_plan(B: int, P: int) -> dict:
    """Launch shape of the decode kernel for B reads of pred field P:
    ``warps_per_block``, ``reads_per_warp`` (1) and ``blocks`` (needs the
    card)."""
    lib = build.load()
    outs = [ctypes.c_int() for _ in range(3)]
    build.check(lib, lib.poasta_decode_plan(B, P, *map(ctypes.byref, outs)),
                "poasta_decode_plan")
    wpb, rpw, blocks = (o.value for o in outs)
    return {"warps_per_block": wpb, "reads_per_warp": rpw, "blocks": blocks}


def _launch_decode(ptr, pred_ranks, wstarts, anchor_r, anchor_j, end_rank,
                   active, t_max):
    lib = build.load()
    dev = ptr.device
    Np, B, Wb = ptr.shape
    act = active.to(torch.int32).contiguous()
    operands = {"ptr": ptr, "pred_ranks": pred_ranks, "wstarts": wstarts,
                "anchor_r": anchor_r, "anchor_j": anchor_j, "active": act}
    _check_operands(dev, **operands)
    if pred_ranks.shape[0] % Np or tuple(wstarts.shape) != (B, Np):
        raise ValueError("decode operands disagree on the rank count")
    ops = torch.zeros((B, t_max), dtype=torch.int32, device=dev)
    done = torch.empty((B,), dtype=torch.int32, device=dev)
    if B == 0:
        return ops, done.bool()
    with torch.cuda.device(dev):
        code = lib.poasta_trace_decode(
            ptr.data_ptr(), pred_ranks.data_ptr(), wstarts.data_ptr(),
            anchor_r.data_ptr(), anchor_j.data_ptr(), act.data_ptr(), B, Np,
            Wb, pred_ranks.shape[0] // Np, end_rank, t_max, ops.data_ptr(),
            done.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, code, "trace decode kernel launch")
    trace_decode.launches += 1
    return ops, done.bool()


def trace_decode(ptr: torch.Tensor, pred_ranks: torch.Tensor,
                 wstarts: torch.Tensor, anchor_r: torch.Tensor,
                 anchor_j: torch.Tensor, end_rank: int, active: torch.Tensor,
                 t_max: int):
    """(ops (B, t_max), done (B,)): the kernel on a CUDA tensor, the plain
    version on a CPU tensor (see :func:`decode_plain`)."""
    if ptr.device.type == "cuda":
        return _launch_decode(ptr, pred_ranks, wstarts, anchor_r, anchor_j,
                              end_rank, active, t_max)
    if ptr.device.type == "cpu":
        return decode_plain(ptr, pred_ranks, wstarts, anchor_r, anchor_j,
                            end_rank, active, t_max)
    raise ValueError(f"no trace decode for device {ptr.device}")


trace_decode.launches = 0


def replay_steps(ops_row, anchor_j, node_of_rank):
    """One read's decode step words -> (rpos, qpos) int32 arrays
    (ArrayAlignment layout: -1 encodes None).  Numpy twin of
    ``poasta_tpu.ops.pallas_trace.replay_steps``."""
    opcode = ops_row & 15
    nz = np.nonzero(opcode == 0)[0]
    end = int(nz[0]) if nz.size else len(ops_row)
    opcode = opcode[:end]
    rank = (ops_row[:end] >> 4).astype(np.int64)
    consumes = (opcode == OP_DIAG) | (opcode == OP_INS)
    # j BEFORE each step: anchor_j minus chars consumed by prior steps
    j_before = anchor_j - np.concatenate(
        ([0], np.cumsum(consumes)[:-1]))
    emit = opcode != OP_HOP
    rpos = np.where(opcode == OP_INS, -1,
                    node_of_rank[rank]).astype(np.int32)
    qpos = np.where(opcode == OP_DEL, -1, j_before - 1).astype(np.int32)
    # decode walks end -> start; pairs are emitted forward
    return rpos[emit][::-1].copy(), qpos[emit][::-1].copy()


# --------------------------------------------------------------------------
# Tiers
# --------------------------------------------------------------------------

def _potential_spread(flat) -> int:
    n = flat.n_nodes
    return int((flat.max_dist_from_start[:n].astype(np.int64)
                - flat.min_dist_from_start[:n]).max()) if n else 0


def gap_budgets(flat, scores_np, costs, Wb: int):
    """(k_tier, k_full) per read: the proven gap budget K_full = (score -
    o) / e + 1 and the largest budget a Wb-wide tier fits, K = (Wb -
    potential spread - 160) / 2 (at least 16), capped at K_full."""
    k_full = (np.maximum(np.asarray(scores_np, np.int64) - costs.gap_open, 0)
              // max(costs.gap_extend, 1) + 1)
    k_tier = np.minimum(
        k_full, np.maximum((Wb - _potential_spread(flat) - 160) // 2, 16))
    return k_tier, k_full


def pred_rank_table(dg, device) -> torch.Tensor:
    """(Np * P,) int32 predecessor ranks, the decode's walk table."""
    P = int(dg.pred_slots.shape[1])
    pr = np.zeros((dg.n_nodes_padded, P), np.int32)
    pr[:dg.pred_ranks_np.shape[0]] = dg.pred_ranks_np
    return torch.as_tensor(pr.reshape(-1), device=device)


def tier_inputs(dg, flat, qshift, lengths_np, k_np, Wb: int,
                anchor_r_np=None, anchor_j_np=None, k_full_np=None,
                free_start: bool = False):
    """The trace fill's inputs for a batch at tier width ``Wb`` with gap
    budgets ``k_np`` and per-read anchors (default: the global anchor):
    ({qpad, wstarts, anchor_r, anchor_j} on the batch's device, host ok
    (B,)).  With anchors and the proven budgets ``k_full_np`` they hold
    each read's rank range too, r_begin and r_end (:func:`trace_ranges`),
    from the same operands as the schedule."""
    dev = qshift.device
    B, L = int(qshift.shape[0]), int(qshift.shape[1])
    operands = _anchored_operands(flat, lengths_np, k_np, dg.n_nodes_padded,
                                  dev, anchor_r_np, anchor_j_np)
    steps, ok = _schedule_body(*operands, flat.n_nodes, Wb)[:2]
    LQ = max(L, Wb + 128)
    ranged = anchor_r_np is not None and k_full_np is not None
    if anchor_r_np is None:
        anchor_r_np = np.full((B,), dg.end_rank_i)
        anchor_j_np = lengths_np
    inp = {
        "qpad": torch.nn.functional.pad(qshift, (0, LQ - L)).contiguous(),
        "wstarts": window_starts(steps).contiguous(),
        "anchor_r": torch.as_tensor(
            np.asarray(anchor_r_np, np.int32), device=dev),
        "anchor_j": torch.as_tensor(
            np.asarray(anchor_j_np, np.int32), device=dev),
    }
    if ranged:
        k_full = torch.as_tensor(np.asarray(k_full_np, np.int64), device=dev)
        inp["r_begin"], inp["r_end"] = _rank_range(
            (*operands[:3], k_full, *operands[4:]) if free_start else None,
            anchor_r_np, flat.n_nodes, dev)
    return inp, ok.cpu().numpy()


def free_bytes(dev) -> int:
    """Bytes the device holding a batch can still hand out: the card's
    free memory plus what PyTorch's allocator holds unused, or the host's
    available memory for a CPU tensor."""
    if dev.type == "cuda":
        free, _ = torch.cuda.mem_get_info(dev)
        return int(free + torch.cuda.memory_reserved(dev)
                   - torch.cuda.memory_allocated(dev))
    return os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")


def tier_bytes_per_read(dg, Wb: int) -> int:
    """Device bytes one read takes at tier width ``Wb``: its pointer
    planes, window starts, and the working set the kernel may place in its
    global slab (csrc/trace_kernel.cu: the rings, the warp words and the
    slot starts)."""
    return 4 * (dg.n_nodes_padded * (Wb + 1) + 2 * dg.window * Wb + 32
                + -(-dg.window // 4) * 4)


def sub_batch_count(n_reads: int, per_read: int, free: int) -> int:
    """Sub-batches that ``n_reads`` pending reads of ``per_read`` device
    bytes each take when their buffers may use half of ``free`` bytes; 0
    where one read's buffers alone pass that."""
    cap = free // 2 // per_read
    return -(-n_reads // cap) if cap else 0


def _cells_walked(dg, inp, Wb: int) -> int:
    """The cells a trace fill on ``inp`` walks: each read's rank range
    (both ends) x Wb, or every rank's where it has none."""
    if "r_begin" not in inp:
        return dg.n_nodes_padded * int(inp["qpad"].shape[0]) * Wb
    span = (inp["r_end"].cpu().numpy().astype(np.int64)
            - inp["r_begin"].cpu().numpy() + 1)
    return int(span.clip(min=0).sum()) * Wb


def trace_align(dg, flat, qshift, lengths, costs, scores, anchor_r=None,
                anchor_j=None, free_start: bool = False):
    """Batched device alignments inside score-certified corridors.

    ``scores``: (B,) the batch's verified exact scores.  ``anchor_r`` /
    ``anchor_j``: (B,) each read's end state (rank, offset) under an
    ends-free span, ``free_start`` whether its graph begin is free; None
    means the global anchor.  Returns a list of
    ``ArrayAlignment | None``; None marks reads no tier verified (anchor
    value != score), INF scores and empty reads, which the caller aligns
    on the host.  A verified read's pointer chain costs exactly its score.

    Tiers widen 256 ... 4096 lanes, each with :func:`gap_budgets`'s
    budget, and run only the reads still pending, in sub-batches whose
    buffers take at most half of :func:`free_bytes`
    (:func:`sub_batch_count`).  A read whose buffers
    alone pass that stops the tiers (it stays None).  With anchors, each
    read's fill walks only the ranks of its corridor
    (:func:`trace_ranges`); the global span's walks every rank.
    """
    from ..aligner.alignment import ArrayAlignment

    B = int(qshift.shape[0])
    if int(dg.pred_slots.shape[1]) > PMAX:
        return [None] * B
    dev = qshift.device
    lengths_np = lengths.cpu().numpy()
    scores_np = np.asarray(scores).astype(np.int64)
    ar_np = None if anchor_r is None else np.asarray(anchor_r, np.int64)
    aj_np = lengths_np if anchor_j is None \
        else np.asarray(anchor_j, np.int64)

    out = [None] * B
    # INF scores (unalignable) and empty reads stay on the host path
    pending = np.arange(B)[(scores_np < INF) & (lengths_np > 0)]
    pred_ranks = None  # uploaded once, on first decode

    for Wb in TIER_WIDTHS:
        if pending.size == 0:
            break
        n_sub = sub_batch_count(pending.size, tier_bytes_per_read(dg, Wb),
                                free_bytes(dev))
        if n_sub == 0:
            break  # one read's planes pass the device's memory
        k_tier, k_full = gap_budgets(flat, scores_np[pending], costs, Wb)
        at_k_full = bool((k_tier >= k_full).all())
        still = []
        for s_i, idx in enumerate(np.array_split(np.arange(pending.size),
                                                 n_sub)):
            with spans.span("trace.sub_batch", wb=Wb, sub=s_i):
                sub = pending[idx]
                with spans.span("trace.inputs"):
                    q_sub = qshift.index_select(
                        0, torch.as_tensor(sub, device=dev))
                    # an anchored read walks only its rank range
                    inp, ok = tier_inputs(
                        dg, flat, q_sub, lengths_np[sub], k_tier[idx], Wb,
                        None if ar_np is None else ar_np[sub],
                        None if ar_np is None else aj_np[sub],
                        k_full[idx], free_start)
                    # read before the launch, beside ok's own download
                    walked = _cells_walked(dg, inp, Wb) if spans.active() \
                        else 0
                if not ok.any():
                    still.extend(sub)  # this width covers nobody here
                    continue
                with spans.span("trace.fill"):
                    aval, ptr = trace_fill(dg, **inp, costs=costs, Wb=Wb,
                                           free_start=free_start)
                    spans.count("trace.cells_walked", walked)
                    verified = (aval.cpu().numpy() == scores_np[sub]) & ok
                if not verified.any():
                    still.extend(sub)
                    continue
                t_max = int(-(-(int(lengths_np[sub].max())
                                + int(k_full[idx].max()) + 8) // 512) * 512)
                with spans.span("trace.decode"):
                    if pred_ranks is None:
                        pred_ranks = pred_rank_table(dg, dev)
                    ops, done = trace_decode(
                        ptr, pred_ranks, inp["wstarts"], inp["anchor_r"],
                        inp["anchor_j"], dg.end_rank_i,
                        torch.as_tensor(verified, device=dev), t_max)
                    del ptr
                    ops_np = ops.cpu().numpy()
                    done_np = done.cpu().numpy()
                with spans.span("trace.replay"):
                    for i, b in enumerate(sub):
                        if verified[i] and done_np[i]:
                            rpos, qpos = replay_steps(
                                ops_np[i], int(aj_np[b]), flat.node_of_rank)
                            out[b] = ArrayAlignment(rpos, qpos)
                        else:
                            still.append(b)
        pending = np.asarray(still, dtype=np.int64)
        if at_k_full:
            break  # proven budgets already; wider tiers can't help
    return out
