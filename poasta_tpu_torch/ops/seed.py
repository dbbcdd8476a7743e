"""Seeded corridor scorer: the ends-free fill of each read inside a window
schedule built around its k-mer hit cluster, with the read's end state.

Port of ``poasta_tpu/ops/pallas_seed.py``.  TPU kernel -> wrapper here:

* B8 ``_seed_kernel`` -> ``seed_end_states`` (csrc/seed_kernel.cu)

For free-graph-begin (mapping) spans, where a seed pass
(:mod:`..aligner.seeds`) has bracketed each read's locus: the fill pays
the read's own rank span times a corridor width instead of every rank
times the whole row.  Exactness rides the seeds' certificate: the windows
only raise DP values, so a score that verifies (<= ub) and certifies is
the full fill's score with the identical end state.

:func:`seed_scores` builds the schedule (the trace's
:func:`..ops.trace._schedule_body`, anchored at the hit diagonals instead
of an end state), gives each read its own rank range and per-rank window
starts, and reads (score, end rank, end offset) off the kernel's (or, on
a CPU tensor, the plain version's) end states.
"""

from __future__ import annotations

import numpy as np
import torch

from ..aligner.banded import ins_run_cap
from ..utils import build, spans
from .cuda_fill import _check_operands, _prefix_min, _scan_cap, register_plan
from .dp_rows import INF, _shift_right
from .trace import _sched_potentials, _schedule_body

WB_MAX = 4096  # corridor width budget; wider reads use the full fill
NO_RANK = 1 << 30  # the end rank of a read whose range holds no rank


def seed_plan(W: int, Wb: int) -> dict:
    """Launch shape, body and working-set placement of the seed kernel for
    a ring of W rows of Wb lanes, as :func:`..ops.trace.trace_plan` gives
    them (needs the card)."""
    return register_plan("poasta_seed_plan", W, Wb)


def corridor_width(costs, alpha_min, beta_max, ub_np) -> int:
    """Lanes a batch's corridors need: the hit-diagonal spread, both gap
    margins and the window steps' quantization slack, rounded up to a
    multiple of 512 (at least 256).  The caller compares it with
    :data:`WB_MAX`."""
    k_np = ub_np // max(costs.gap_extend, 1) + 1
    spread = np.maximum(beta_max - alpha_min, 0)
    need = int((spread + 2 * k_np).max()) + 1 if len(ub_np) else 0
    return max(256, -(-(need + 160) // 512) * 512)


def seed_schedule(flat, lengths_np, k_np, alpha_min, beta_max, Wb: int,
                  Np: int, device):
    """The corridor schedule of a batch, on ``device``: (steps (B, Np) bool,
    ok (B,) bool, start (B, Np) int64, r_lo, r_hi (B,) int64, has (B,)
    bool) as :func:`..ops.trace._schedule_body` returns them, with the
    bounds anchored at the hit diagonals: a cell at rank r of a path
    through the cluster consumes
      alpha_min + dmax[r] - K <= j <= beta_max + dmin[r] + K."""
    dmin_d, dmax_d = _sched_potentials(flat, Np, device)

    def put(v):
        return torch.as_tensor(np.asarray(v, dtype=np.int64), device=device)

    B = len(lengths_np)
    return _schedule_body(
        dmin_d, dmax_d, put(lengths_np), put(k_np),
        put(np.zeros((B,), np.int64)), put(-np.asarray(beta_max)),
        put(-np.asarray(alpha_min)), flat.n_nodes, Wb)


def range_window_starts(steps, start, r_begin) -> torch.Tensor:
    """(B, Np) int32 window start of each rank as a fill that enters at
    ``r_begin`` (B,) walks it: the schedule's own start at the rank before
    (0 at rank 0), then one 128-lane step per step bit.  Ranks before
    ``r_begin`` hold no meaning."""
    cs = torch.cumsum(steps.to(torch.int64), dim=1)
    prev = (r_begin - 1).clamp(min=0).view(-1, 1)
    entered = r_begin.view(-1, 1) > 0
    sig0 = torch.where(entered, start.gather(1, prev), 0)
    base = torch.where(entered, cs.gather(1, prev), 0)
    return (sig0 + 128 * (cs - base)).to(torch.int32)


def seed_end_states_plain(dg, qshift: torch.Tensor, wstarts: torch.Tensor,
                          lengths: torch.Tensor, jlo: torch.Tensor,
                          r_begin: torch.Tensor, r_end: torch.Tensor, costs,
                          free_start: bool, end_ok: torch.Tensor, Wb: int,
                          max_run: int = 0) -> torch.Tensor:
    """Plain PyTorch version of the seed kernel: (B, 3) int32 end states
    (value, end offset, end rank), the least over each read's cells under
    (value ascending, offset descending, rank ascending); (INF, -1,
    :data:`NO_RANK`) for a read whose range holds no rank.

    Each ring slot remembers, per read, the window start it was written
    at; a read outside its range at a rank neither writes nor competes.
    """
    o, e, x = costs.gap_open, costs.gap_extend, costs.mismatch
    B, L = qshift.shape
    dev = qshift.device
    W = dg.window
    P = int(dg.pred_slots.shape[1])
    m_ring = torch.full((W, B, Wb), INF, dtype=torch.int32, device=dev)
    d_ring = torch.full_like(m_ring, INF)
    sstart = torch.zeros((W, B, 1), dtype=torch.int64, device=dev)
    lane = torch.arange(Wb, dtype=torch.int64, device=dev).view(1, -1)
    cap = _scan_cap(Wb, max_run)
    best_v = torch.full((B,), INF, dtype=torch.int64, device=dev)
    best_j = torch.full((B,), -1, dtype=torch.int64, device=dev)
    best_r = torch.full((B,), NO_RANK, dtype=torch.int64, device=dev)
    symbols = dg.symbols.tolist()
    slots = dg.pred_slots.tolist()
    valid = dg.pred_valid_flat.view(-1, P).tolist()
    wslots = dg.write_slots.tolist()
    permitted = end_ok.tolist()
    n_b = lengths.to(torch.int64).view(-1, 1)
    jlo_b = jlo.to(torch.int64).view(-1, 1)
    inf_t = torch.tensor(INF, dtype=torch.int32, device=dev)
    lo = int(r_begin.min()) if B else 0
    hi = int(r_end.max()) if B else 0
    for r in range(lo, hi):
        active = ((r_begin <= r) & (r < r_end)).view(-1, 1)
        if not bool(active.any()):
            continue
        w_r = wstarts[:, r].to(torch.int64).view(-1, 1)
        j = w_r + lane

        def shifted(ring, s):
            k = lane + w_r - sstart[s]
            row = ring[s].gather(1, k.clamp(0, Wb - 1))
            return torch.where(k < Wb, row, inf_t)

        # p = 0 is unconditional (rank 0 reads an all-INF row)
        min_pm, min_pd = shifted(m_ring, slots[r][0]), \
            shifted(d_ring, slots[r][0])
        for p in range(1, P):
            if valid[r][p] == 1:
                min_pm = torch.minimum(min_pm, shifted(m_ring, slots[r][p]))
                min_pd = torch.minimum(min_pd, shifted(d_ring, slots[r][p]))
        D = torch.minimum(min_pm + (o + e), min_pd + e)
        qwin = torch.where(j < L, qshift.gather(1, j.clamp(max=L - 1)), 0)
        diag = _shift_right(min_pm) + torch.where(
            qwin == symbols[r], -e, x - e).to(torch.int32)
        A = torch.minimum(diag, D)
        is_end = r == dg.end_rank_i
        if (not is_end) if free_start else r == 0:
            A = torch.where(j == 0, torch.clamp(A, max=0), A)
        if is_end:
            M = min_pm
            D = torch.full_like(D, INF)
        else:
            I = torch.clamp(_shift_right(_prefix_min(A, cap)) + o, max=INF)
            M = torch.minimum(A, I)
        ws = wslots[r]
        m_ring[ws] = torch.where(active, M, m_ring[ws])
        d_ring[ws] = torch.where(active, D, d_ring[ws])
        sstart[ws] = torch.where(active, w_r, sstart[ws])

        elig = (j >= jlo_b) & (j <= n_b) \
            if (is_end or permitted[r] == 1) else torch.zeros_like(j, dtype=bool)
        cand = torch.where(elig, torch.clamp(M.to(torch.int64) + e * j,
                                             max=INF), INF)
        # the row's least (value, -offset): the lowest value at its largest
        # offset; the rank only breaks ties against earlier ranks, which win
        row_v = cand.min(dim=1).values
        row_j = torch.where(cand == row_v.view(-1, 1), j, -1).max(dim=1).values
        better = active.view(-1) & (
            (row_v < best_v) | ((row_v == best_v) & (row_j > best_j)))
        best_v = torch.where(better, row_v, best_v)
        best_j = torch.where(better, row_j, best_j)
        best_r = torch.where(better, r, best_r)
    return torch.stack([best_v, best_j, best_r], dim=1).to(torch.int32)


def _launch_seed(dg, qshift, wstarts, lengths, jlo, r_begin, r_end, costs,
                 free_start, end_ok, Wb, max_run=0) -> torch.Tensor:
    lib = build.load()
    dev = qshift.device
    B, L = qshift.shape
    Np = dg.n_nodes_padded
    operands = {"qshift": qshift, "wstarts": wstarts, "lengths": lengths,
                "jlo": jlo, "r_begin": r_begin, "r_end": r_end,
                "end_ok": end_ok, "symbols": dg.symbols,
                "pred_slots": dg.pred_slots_flat,
                "pred_valid": dg.pred_valid_flat,
                "write_slots": dg.write_slots}
    _check_operands(dev, **operands)
    if tuple(wstarts.shape) != (B, Np):
        raise ValueError(f"wstarts {tuple(wstarts.shape)} != {(B, Np)}")
    for name in ("lengths", "jlo", "r_begin", "r_end"):
        if tuple(operands[name].shape) != (B,):
            raise ValueError(f"{name} must have shape ({B},)")
    if Wb % 128 or Wb < 128 or Wb > WB_MAX:
        raise ValueError(f"seed corridor width {Wb}")
    if L % 4:
        raise ValueError(f"seed query rows of {L} lanes (a multiple of 4)")
    out = torch.empty((B, 3), dtype=torch.int32, device=dev)
    if B == 0:
        return out
    if int(r_begin.min()) < 0 or int(r_end.max()) > dg.n_nodes:
        raise ValueError("a rank range leaves the graph")
    with torch.cuda.device(dev):
        plan = seed_plan(dg.window, Wb)
        gws = torch.empty(max(plan["global_ints_per_read"] * B, 1),
                          dtype=torch.int32, device=dev)
        code = lib.poasta_seed_fill(
            dg.symbols.data_ptr(), dg.pred_slots_flat.data_ptr(),
            dg.pred_valid_flat.data_ptr(), dg.write_slots.data_ptr(),
            end_ok.data_ptr(), qshift.data_ptr(), wstarts.data_ptr(),
            lengths.data_ptr(), jlo.data_ptr(), r_begin.data_ptr(),
            r_end.data_ptr(), B, L, Np, dg.end_rank_i, dg.window,
            int(dg.pred_slots.shape[1]), Wb, costs.gap_open,
            costs.gap_extend, costs.mismatch, _scan_cap(Wb, max_run),
            int(free_start), out.data_ptr(), gws.data_ptr(), gws.numel(),
            torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, code, "seed fill kernel launch")
    seed_end_states.launches += 1
    return out


def seed_end_states(dg, qshift: torch.Tensor, wstarts: torch.Tensor,
                    lengths: torch.Tensor, jlo: torch.Tensor,
                    r_begin: torch.Tensor, r_end: torch.Tensor, costs,
                    free_start: bool, end_ok: torch.Tensor, Wb: int,
                    max_run: int = 0) -> torch.Tensor:
    """(B, 3) int32 end states (value, end offset, end rank) of the seeded
    corridor fill: the kernel on a CUDA tensor, the plain version on a CPU
    tensor (see :func:`seed_end_states_plain`).

    ``qshift``: (B, L) packed reads; ``wstarts``: (B, Np) window start per
    rank (:func:`range_window_starts`); ``r_begin``/``r_end``: (B,) each
    read's rank range; all int32.  Counts the cells it is handed, each
    read's ranks x Wb, as ``cells.seed_fill``.
    """
    if qshift.device.type == "cuda":
        fn = _launch_seed
    elif qshift.device.type == "cpu":
        fn = seed_end_states_plain
    else:
        raise ValueError(f"no seed fill for device {qshift.device}")
    out = fn(dg, qshift, wstarts, lengths, jlo, r_begin, r_end, costs,
             free_start, end_ok, Wb, max_run)
    if spans.active():
        # read after the launch: the caller waits for the kernel next
        spans.count("cells.seed_fill",
                    int((r_end - r_begin).clamp(min=0).sum()) * Wb)
    return out


seed_end_states.launches = 0


def _seed_scores(states_fn, dg, flat, qshift, lengths, costs, free_start,
                 end_ok, jlo, alpha_min, beta_max, ub_np, ranges):
    B = int(qshift.shape[0])
    dev = qshift.device
    Np = dg.n_nodes_padded
    e = costs.gap_extend
    ub_np = np.asarray(ub_np, np.int64)
    alpha_min = np.asarray(alpha_min, np.int64)
    beta_max = np.asarray(beta_max, np.int64)
    Wb = corridor_width(costs, alpha_min, beta_max, ub_np)
    if Wb > WB_MAX:
        return None
    lengths_np = np.asarray(
        lengths.cpu() if isinstance(lengths, torch.Tensor) else lengths,
        np.int64)
    jlo_np = np.asarray(jlo.cpu() if isinstance(jlo, torch.Tensor) else jlo,
                        np.int64)
    steps, ok, start, r_lo, r_hi, has = seed_schedule(
        flat, lengths_np, ub_np // max(e, 1) + 1, alpha_min, beta_max, Wb, Np,
        dev)
    if ranges is None:
        r_begin = torch.where(has, r_lo, 0)
        r_end = torch.where(has, r_hi + 1, 0)
    else:
        r_begin, r_end = (torch.as_tensor(np.asarray(v, np.int64), device=dev)
                          for v in ranges)

    def i32(t):
        return t.to(torch.int32).contiguous()

    states = states_fn(
        dg, qshift, range_window_starts(steps, start, r_begin).contiguous(),
        i32(torch.as_tensor(lengths_np, device=dev)),
        i32(torch.as_tensor(jlo_np, device=dev)), i32(r_begin), i32(r_end),
        costs, bool(free_start), end_ok, Wb,
        ins_run_cap(costs, int(ub_np.max()), Wb))
    st = states.cpu().numpy().astype(np.int64)
    ok_np = ok.cpu().numpy()
    # a read whose bounds no schedule of this width covers comes back INF
    sc = np.where(ok_np, np.minimum(st[:, 0], INF), INF)
    return sc, st[:, 2], st[:, 1], ok_np


def seed_scores(dg, flat, qshift: torch.Tensor, lengths, costs,
                free_start: bool, end_ok: torch.Tensor, jlo, alpha_min,
                beta_max, ub_np, ranges=None):
    """(scores, end_ranks, end_offsets, ok), numpy (B,), by the seeded
    corridor fill; None when the corridors need more than :data:`WB_MAX`
    lanes (the caller then runs the full fill).

    ``alpha_min`` / ``beta_max``: per-read hit-diagonal cluster bounds
    (``aligner.seeds.propose_clusters``); ``ub_np``: the per-read score
    upper bounds the corridor margin is sized for (callers verify
    ``score <= ub`` and the seeds' certificate afterwards).  ``ok[b]``
    False marks a read whose bounds the schedule cannot cover at this
    width; its score is INF.  ``ranges``: (r_begin, r_end) per read, the
    ranks to fill; None means each read's own corridor span (ranks outside
    it have empty bounds).  ``end_ok``: (Np,) int32 on ``qshift``'s device.

    On a CUDA tensor the seed kernel runs (or raises); on a CPU tensor its
    plain PyTorch version does.
    """
    return _seed_scores(seed_end_states, dg, flat, qshift, lengths, costs,
                        free_start, end_ok, jlo, alpha_min, beta_max, ub_np,
                        ranges)


def seed_scores_plain(dg, flat, qshift, lengths, costs, free_start, end_ok,
                      jlo, alpha_min, beta_max, ub_np, ranges=None):
    return _seed_scores(seed_end_states_plain, dg, flat, qshift, lengths,
                        costs, free_start, end_ok, jlo, alpha_min, beta_max,
                        ub_np, ranges)
