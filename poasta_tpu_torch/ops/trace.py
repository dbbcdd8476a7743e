"""Device-side traceback: a pointer-emitting corridor refill and a decode.

Port of ``poasta_tpu/ops/pallas_trace.py`` (global spans).  Given a batch
of reads with certified exact scores:

1. :func:`build_trace_schedule` derives, per read, a monotone 128-lane
   window-start schedule over the ranks that covers every cell a path of
   cost <= the read's gap budget can visit (same bounds as the
   reference, in torch with ``torch.cummax``).
2. :func:`trace_fill` refills each read's corridor (tilted coordinates,
   as the banded fill) and writes one int32 pointer word per cell into
   (Np, B, Wb) planes, plus the anchor cell's value.  The anchor value
   equal to the certified score proves the corridor holds an optimal
   path.  On a CUDA tensor it launches ``csrc/trace_kernel.cu``'s
   ``trace_fill_kernel``; on a CPU tensor it runs :func:`trace_fill_plain`.
3. :func:`trace_decode` walks each verified read's pointer chain from the
   anchor and emits ``rank<<4 | op`` step words (CUDA:
   ``trace_decode_kernel``; CPU: :func:`decode_plain`).
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

from ..utils import build
from ..utils.device import resolve_device
from .cuda_fill import PLACEMENTS, _check_operands, _prefix_min
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


def _schedule_body(dmin, dmax, lengths, k, aj, a_dmin, a_dmax, n_real: int,
                   Wb: int):
    """Per-read slope-limited 128-quantized window starts (int64 math).

    Returns (steps (B, Np) bool, ok (B,) bool)."""
    Np = dmin.shape[0]
    K = k.clamp(min=0).view(-1, 1)
    nb = lengths.view(-1, 1)
    ajc = aj.view(-1, 1)
    lo = ajc - (a_dmax.view(-1, 1) - dmax.view(1, -1)) - K
    hi = torch.minimum(ajc - (a_dmin.view(-1, 1) - dmin.view(1, -1)) + K, nb)
    ridx = torch.arange(Np, dtype=torch.int64, device=dmin.device).view(1, -1)
    nonempty = (ridx < n_real) & (lo <= hi) & (hi >= 0)
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
    return (start - prev) > 0, ok


def build_trace_schedule(flat, lengths_np, k_np, Wb: int, Np: int,
                         device=None):
    """Per-read monotone 128-quantized window-start schedule for global
    anchors (the virtual end rank at j = the read's length).

    For any path of cost <= ub_b through rank r (min/max_dist_from_start
    change by <= 1 / >= 1 per edge), the consumed offset j satisfies
      n - (dmax[end] - dmax[r]) - K <= j <= n - (dmin[end] - dmin[r]) + K
    with K = the gap budget ``k_np``.  Returns steps (B, Np) bool on
    ``device`` (None: the card) (the window steps 128 lanes at that rank)
    and host ok (B,) bool: False where width ``Wb`` provably cannot cover
    the read's bounds.
    """
    device = resolve_device(device)
    n = flat.n_nodes
    B = lengths_np.shape[0]
    dmin_d, dmax_d = _sched_potentials(flat, Np, device)

    def put(v):
        return torch.as_tensor(np.asarray(v, dtype=np.int64), device=device)

    end_dmin = int(flat.min_dist_from_start[n - 1])
    end_dmax = int(flat.max_dist_from_start[n - 1])
    steps, ok = _schedule_body(
        dmin_d, dmax_d, put(lengths_np), put(k_np), put(lengths_np),
        put(np.full((B,), end_dmin)), put(np.full((B,), end_dmax)), n, Wb)
    return steps, ok.cpu().numpy()


def window_starts(steps: torch.Tensor) -> torch.Tensor:
    """(B, Np) int32 start of each rank's window as the fill walks it: the
    window moves at most one 128-lane step per rank.  The schedule's own
    starts, less the read's start at rank 0, which is 0 for every read that
    can verify (rank 0's origin at j = 0 must lie in its window)."""
    return (torch.cumsum(steps.to(torch.int32), dim=1) * 128).to(torch.int32)


# --------------------------------------------------------------------------
# Trace fill (B18)
# --------------------------------------------------------------------------

def trace_plan(W: int, Wb: int) -> dict:
    """Launch shape and working-set placement of the trace kernel for a
    ring of W rows of Wb lanes (needs the card)."""
    lib = build.load()
    threads, mode, smem = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    gints = ctypes.c_longlong()
    build.check(lib, lib.poasta_trace_plan(
        W, Wb, ctypes.byref(threads), ctypes.byref(mode), ctypes.byref(smem),
        ctypes.byref(gints)), "poasta_trace_plan")
    return {"threads": threads.value, "placement": PLACEMENTS[mode.value],
            "smem_bytes": smem.value, "global_ints_per_read": gints.value}


def _roll1(t: torch.Tensor) -> torch.Tensor:
    """Lane roll by one: lane i takes lane i-1, lane 0 takes the last."""
    return torch.roll(t, 1, dims=-1)


def trace_fill_plain(dg, qpad: torch.Tensor, wstarts: torch.Tensor,
                     anchor_r: torch.Tensor, anchor_j: torch.Tensor, costs,
                     Wb: int):
    """Plain PyTorch version of the trace kernel.

    ``qpad``: (B, LQ) packed reads, LQ >= Wb + 128 (lanes past LQ read as
    0).  ``wstarts``: (B, Np) window starts (:func:`window_starts`).
    Returns (aval (B,) int32: min of the untilted M at the anchor cell, or
    INF; ptr (Np, B, Wb) int32 pointer planes, rows past the last rank 0).

    It walks the ranks as the reference kernel does: when a read's window
    steps, its query row and every ring row shift left by 128 lanes
    (INF, or 0 for the query, coming in on the right).
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
    for r in range(n):
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
        if r == 0:
            A = torch.minimum(A, torch.where(j == 0, 0, INF))

        pref = _prefix_min(A, Wb)
        pref_m1 = torch.cat([inf_col[:, :1], pref[:, :-1]], dim=1)
        I = torch.clamp(pref_m1 + o, max=INF)
        M = torch.minimum(A, I)

        msrc = torch.where(M == diag, MSRC_DIAG,
                           torch.where(M == D, MSRC_D, MSRC_I))
        if r == 0:
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
        ptr[r] = (msrc | (didx << 2) | (isrc << 7) | (dsrc << 8)
                  | (dpidx << 9)).to(torch.int32)

        # anchor extraction (untilted: rows carry X(j) - e*j)
        matched = (ar == r) & (j == aj)
        cand = torch.where(matched, M_final + e * j, INF).min(dim=1).values
        aval = torch.minimum(aval, cand)
        m_ring[wslots[r]] = M_final
        d_ring[wslots[r]] = D_store
    return aval, ptr


def _launch_trace(dg, qpad, wstarts, anchor_r, anchor_j, costs, Wb):
    lib = build.load()
    dev = qpad.device
    B, LQ = qpad.shape
    Np = dg.n_nodes_padded
    operands = {"qpad": qpad, "wstarts": wstarts, "anchor_r": anchor_r,
                "anchor_j": anchor_j, "symbols": dg.symbols,
                "pred_slots": dg.pred_slots_flat,
                "pred_valid": dg.pred_valid_flat,
                "write_slots": dg.write_slots}
    _check_operands(dev, **operands)
    if tuple(wstarts.shape) != (B, Np):
        raise ValueError(f"wstarts {tuple(wstarts.shape)} != {(B, Np)}")
    if Wb % 128 or Wb > 4096 or LQ < Wb + 128:
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
            anchor_j.data_ptr(), B, LQ, Np, dg.n_nodes, dg.end_rank_i,
            dg.window, int(dg.pred_slots.shape[1]), Wb, costs.gap_open,
            costs.gap_extend, costs.mismatch, ptr.data_ptr(),
            aval.data_ptr(), gws.data_ptr(), gws.numel(),
            torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, code, "trace fill kernel launch")
    trace_fill.launches += 1
    return aval, ptr


def trace_fill(dg, qpad: torch.Tensor, wstarts: torch.Tensor,
               anchor_r: torch.Tensor, anchor_j: torch.Tensor, costs,
               Wb: int):
    """(aval (B,), ptr (Np, B, Wb)): the kernel on a CUDA tensor, the
    plain version on a CPU tensor (see :func:`trace_fill_plain`)."""
    if qpad.device.type == "cuda":
        return _launch_trace(dg, qpad, wstarts, anchor_r, anchor_j, costs,
                             Wb)
    if qpad.device.type == "cpu":
        return trace_fill_plain(dg, qpad, wstarts, anchor_r, anchor_j, costs,
                                Wb)
    raise ValueError(f"no trace fill for device {qpad.device}")


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


def tier_inputs(dg, flat, qshift, lengths_np, k_np, Wb: int):
    """The trace fill's inputs for a batch at tier width ``Wb`` with gap
    budgets ``k_np``: ({qpad, wstarts, anchor_r, anchor_j} on the batch's
    device, host ok (B,))."""
    dev = qshift.device
    B, L = int(qshift.shape[0]), int(qshift.shape[1])
    steps, ok = build_trace_schedule(
        flat, lengths_np, k_np, Wb, dg.n_nodes_padded, device=dev)
    LQ = max(L, Wb + 128)
    return {
        "qpad": torch.nn.functional.pad(qshift, (0, LQ - L)).contiguous(),
        "wstarts": window_starts(steps).contiguous(),
        "anchor_r": torch.full((B,), dg.end_rank_i, dtype=torch.int32,
                               device=dev),
        "anchor_j": torch.as_tensor(
            np.asarray(lengths_np, np.int32), device=dev),
    }, ok


TRACE_SCRATCH_ROWS = 7  # csrc/trace_kernel.cu TRACE_ROWS


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
    planes, window starts, and the ring slab the kernel may place in
    global memory."""
    return 4 * (dg.n_nodes_padded * (Wb + 1)
                + (2 * dg.window + TRACE_SCRATCH_ROWS) * Wb + dg.window)


def trace_align(dg, flat, qshift, lengths, costs, scores):
    """Batched device alignments inside score-certified corridors (global).

    ``scores``: (B,) the batch's verified exact scores.  Returns a list of
    ``ArrayAlignment | None``; None marks reads no tier verified (anchor
    value != score), INF scores and empty reads, which the caller aligns
    on the host.  A verified read's pointer chain costs exactly its score.

    Tiers widen 256 ... 4096 lanes, each with :func:`gap_budgets`'s
    budget, and run only the reads still pending, in sub-batches whose
    buffers take at most half of :func:`free_bytes`.  A read whose buffers
    alone pass that stops the tiers (it stays None).
    """
    from ..aligner.alignment import ArrayAlignment

    B = int(qshift.shape[0])
    if int(dg.pred_slots.shape[1]) > PMAX:
        return [None] * B
    dev = qshift.device
    lengths_np = lengths.cpu().numpy()
    scores_np = np.asarray(scores).astype(np.int64)

    out = [None] * B
    # INF scores (unalignable) and empty reads stay on the host path
    pending = np.arange(B)[(scores_np < INF) & (lengths_np > 0)]
    pred_ranks = None  # uploaded once, on first decode

    for Wb in TIER_WIDTHS:
        if pending.size == 0:
            break
        per_read = tier_bytes_per_read(dg, Wb)
        cap = free_bytes(dev) // 2 // per_read
        if cap == 0:
            break  # one read's planes pass the device's memory
        k_tier, k_full = gap_budgets(flat, scores_np[pending], costs, Wb)
        at_k_full = bool((k_tier >= k_full).all())
        n_sub = -(-pending.size // cap)
        still = []
        for idx in np.array_split(np.arange(pending.size), n_sub):
            sub = pending[idx]
            q_sub = qshift.index_select(0, torch.as_tensor(sub, device=dev))
            inp, ok = tier_inputs(dg, flat, q_sub, lengths_np[sub],
                                  k_tier[idx], Wb)
            if not ok.any():
                still.extend(sub)  # this width covers nobody here
                continue
            aval, ptr = trace_fill(dg, **inp, costs=costs, Wb=Wb)
            verified = (aval.cpu().numpy() == scores_np[sub]) & ok
            if not verified.any():
                still.extend(sub)
                continue
            t_max = int(-(-(int(lengths_np[sub].max())
                            + int(k_full[idx].max()) + 8) // 512) * 512)
            if pred_ranks is None:
                pred_ranks = pred_rank_table(dg, dev)
            ops, done = trace_decode(
                ptr, pred_ranks, inp["wstarts"], inp["anchor_r"],
                inp["anchor_j"], dg.end_rank_i,
                torch.as_tensor(verified, device=dev), t_max)
            del ptr
            ops_np = ops.cpu().numpy()
            done_np = done.cpu().numpy()
            for i, b in enumerate(sub):
                if verified[i] and done_np[i]:
                    rpos, qpos = replay_steps(ops_np[i], int(lengths_np[b]),
                                              flat.node_of_rank)
                    out[b] = ArrayAlignment(rpos, qpos)
                else:
                    still.append(b)
        pending = np.asarray(still, dtype=np.int64)
        if at_k_full:
            break  # proven budgets already; wider tiers can't help
    return out
