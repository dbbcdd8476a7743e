"""The two fills of the scoring path: the banded fill (every ladder tier)
and the full-width fill (the ladder's last resort).

Port of ``poasta_tpu/ops/pallas_fill.py``'s ``_banded_kernel`` /
``pallas_banded_scores`` / ``prepare_banded`` and ``_fill_kernel`` /
``pallas_fill_scores`` (global variant).  Each fill has:

* a kernel wrapper (``banded_end_rows``, ``fill_end_rows``): on a CUDA
  tensor it launches the hand-written kernel from ``csrc/`` or raises; on
  a CPU tensor it runs the plain version.  ``<wrapper>.launches`` counts
  kernel launches, and nothing else;
* a plain PyTorch version (``*_plain``): a loop over ranks on (B, lanes)
  int32 tensors with the kernel's tilt, truncation and INF rules, so the
  end rows agree bit for bit;
* a scores function that reads each read's score off the end row.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..utils import build
from .dp_rows import INF, _shift_right

PLACEMENTS = ("smem", "rings-global", "global")


def _prefix_min(t: torch.Tensor, cap: int) -> torch.Tensor:
    """What the kernels' Hillis–Steele rounds k < ``cap`` give: the min over
    lanes [j - w + 1, j] (w = the first power of two >= cap), lanes left of
    0 counting as INF.  A window covering the row is INF-clamped cummin."""
    if cap >= t.shape[1]:
        return torch.clamp(torch.cummin(t, dim=1).values, max=INF)
    k = 1
    while k < cap:
        t = torch.minimum(t, _shift_right(t, k))
        k <<= 1
    return t


def _check_operand(t: torch.Tensor, device: torch.device, name: str) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.int32 or not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous int32, got {t.dtype}")


def _plan(fn, *args) -> dict:
    lib = build.load()
    threads, mode, smem = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    gints = ctypes.c_longlong()
    build.check(lib, getattr(lib, fn)(*args, ctypes.byref(threads),
                                      ctypes.byref(mode), ctypes.byref(smem),
                                      ctypes.byref(gints)), fn)
    return {"threads": threads.value, "placement": PLACEMENTS[mode.value],
            "smem_bytes": smem.value, "global_ints_per_read": gints.value}


def banded_plan(W: int, width: int, margin: int) -> dict:
    """Launch shape and working-set placement of the banded kernel for a
    ring of W rows of ``width + 2*margin`` lanes (needs the card)."""
    return _plan("poasta_banded_plan", W, width, margin)


def fill_plan(W: int, L: int) -> dict:
    """Launch shape and working-set placement of the full-fill kernel."""
    return _plan("poasta_fill_plan", W, L)


# --------------------------------------------------------------------------
# Banded fill (B1)
# --------------------------------------------------------------------------

def _clamp_windows_to_row(wstarts_np, width: int, L: int):
    """Clamp a window layout to the packed query row: lanes past L hold
    no real offsets, so shrink the width to the row and shift starts left
    (every real cell the original window covered stays covered)."""
    width = min(width, (L // 128) * 128)
    clamp = max(((L - width) // 128) * 128, 0)
    return width, np.minimum(wstarts_np, clamp).astype(np.int32)


def prepare_banded(dg, costs, wstarts_np, width: int, L: int) -> dict:
    """The banded fill's per-rank window tables and margin for a window
    layout, placed on the graph's device.  Callers cache the result."""
    width, wstarts_np = _clamp_windows_to_row(wstarts_np, width, L)
    ws = np.zeros(dg.n_nodes_padded, dtype=np.int32)
    ws[: wstarts_np.shape[0]] = wstarts_np
    pw = np.take(ws, dg.pred_ranks_np, axis=0).astype(np.int32)

    # margin covers the largest window shift between a rank and a valid
    # predecessor
    n = min(wstarts_np.shape[0], dg.pred_ranks_np.shape[0])
    pr = dg.pred_ranks_np[:n]
    valid = dg.pred_valid_np[:n]
    deltas = []
    for i in range(pr.shape[1]):
        d = np.abs(ws[:n] - ws[pr[:, i]])
        deltas.append(np.where(valid[:, i], d, 0).max() if n else 0)
    margin = int(max(deltas)) if deltas else 0
    margin = max(((margin + 127) // 128) * 128, 128)

    def put(a):
        return torch.as_tensor(a, device=dg.device)

    return {
        "margin": margin,
        "width": width,
        "L": L,
        "pred_wstarts": put(pw.reshape(-1)),
        "wstarts": put(ws),
        "w_end": int(ws[dg.end_rank_i]),
        "wstarts_max": int(ws.max()),
    }


def _scan_cap(width: int, max_run: int) -> int:
    return min(width, max_run) if max_run else width


def banded_end_rows_plain(dg, qshift: torch.Tensor, costs, prep: dict,
                          max_run: int = 0) -> torch.Tensor:
    """Plain PyTorch version of the banded kernel: the (B, Wb) tilted end
    row (X'(j) = X(j) - e*j at j = w_end + lane)."""
    o, e, x = costs.gap_open, costs.gap_extend, costs.mismatch
    B = qshift.shape[0]
    Wb, margin = prep["width"], prep["margin"]
    dev = qshift.device
    m_ring = torch.full((dg.window, B, Wb + 2 * margin), INF,
                        dtype=torch.int32, device=dev)
    d_ring = torch.full_like(m_ring, INF)
    cap = _scan_cap(Wb, max_run)
    P = dg.pred_slots.shape[1]
    symbols = dg.symbols.tolist()
    slots = dg.pred_slots.tolist()
    valid = dg.pred_valid_flat.view(-1, P).tolist()
    wstarts = prep["wstarts"].tolist()
    pw = prep["pred_wstarts"].view(-1, P).tolist()
    wslots = dg.write_slots.tolist()
    end_row = None
    for r in range(dg.n_nodes):
        w_r = wstarts[r]

        def window(p):
            start = margin + min(max(w_r - pw[r][p], -margin), margin)
            return (m_ring[slots[r][p], :, start:start + Wb],
                    d_ring[slots[r][p], :, start:start + Wb])

        # p = 0 is unconditional (rank 0 reads an all-INF row)
        min_pm, min_pd = window(0)
        for p in range(1, P):
            if valid[r][p] == 1:
                am, ad = window(p)
                min_pm = torch.minimum(min_pm, am)
                min_pd = torch.minimum(min_pd, ad)
        D = torch.minimum(min_pm + (o + e), min_pd + e)
        qwin = qshift[:, w_r:w_r + Wb]
        diag = _shift_right(min_pm) + torch.where(
            qwin == symbols[r], -e, x - e).to(torch.int32)
        A = torch.minimum(diag, D)
        if r == 0 and w_r == 0:
            A[:, 0] = torch.clamp(A[:, 0], max=0)
        if r == dg.end_rank_i:
            M = end_row = min_pm.clone()
            D = torch.full_like(D, INF)
        else:
            I = torch.clamp(_shift_right(_prefix_min(A, cap)) + o, max=INF)
            M = torch.minimum(A, I)
            D = torch.clamp(D, max=INF)
        m_ring[wslots[r], :, margin:margin + Wb] = M
        d_ring[wslots[r], :, margin:margin + Wb] = D
    return end_row


def _launch_banded(dg, qshift, costs, prep, max_run):
    lib = build.load()
    dev = qshift.device
    B, Lq = qshift.shape
    Wb, margin = prep["width"], prep["margin"]
    if prep["wstarts_max"] + Wb > Lq:
        raise ValueError(f"windows reach lane {prep['wstarts_max'] + Wb} "
                         f"past the query row ({Lq})")
    operands = {"qshift": qshift, "symbols": dg.symbols,
                "pred_slots": dg.pred_slots_flat,
                "pred_valid": dg.pred_valid_flat,
                "pred_wstarts": prep["pred_wstarts"],
                "wstarts": prep["wstarts"], "write_slots": dg.write_slots}
    for name, t in operands.items():
        _check_operand(t, dev, name)
    end_row = torch.empty((B, Wb), dtype=torch.int32, device=dev)
    if B == 0:
        return end_row
    with torch.cuda.device(dev):
        plan = banded_plan(dg.window, Wb, margin)
        gws = torch.empty(max(plan["global_ints_per_read"] * B, 1),
                          dtype=torch.int32, device=dev)
        code = lib.poasta_banded_fill(
            dg.symbols.data_ptr(), dg.pred_slots_flat.data_ptr(),
            dg.pred_valid_flat.data_ptr(), prep["pred_wstarts"].data_ptr(),
            prep["wstarts"].data_ptr(), dg.write_slots.data_ptr(),
            qshift.data_ptr(), B, Lq, dg.n_nodes, dg.end_rank_i, dg.window,
            int(dg.pred_slots.shape[1]), Wb, margin, costs.gap_open,
            costs.gap_extend, costs.mismatch, _scan_cap(Wb, max_run),
            end_row.data_ptr(), gws.data_ptr(), gws.numel(),
            torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, code, "banded fill kernel launch")
    banded_end_rows.launches += 1
    return end_row


def banded_end_rows(dg, qshift: torch.Tensor, costs, prep: dict,
                    max_run: int = 0) -> torch.Tensor:
    """(B, Wb) tilted end rows of the banded fill: the kernel on a CUDA
    tensor, the plain version on a CPU tensor.

    ``qshift``: (B, Lq) packed reads, Lq >= every window's end.
    ``max_run``: insertion-run cap (``aligner.banded.ins_run_cap``); 0
    scans the whole window.
    """
    if qshift.device.type == "cuda":
        return _launch_banded(dg, qshift, costs, prep, max_run)
    if qshift.device.type == "cpu":
        return banded_end_rows_plain(dg, qshift, costs, prep, max_run)
    raise ValueError(f"no banded fill for device {qshift.device}")


banded_end_rows.launches = 0


def _untilt_scores(end_row, lengths, w_end: int, e: int) -> torch.Tensor:
    """Each read's score at offset = its length: un-tilt by +e*length;
    eroded-INF lanes (INF walked down by at most e per rank) map to INF,
    as do reads whose length lies outside the end rank's window."""
    Wb = end_row.shape[1]
    li = lengths.to(torch.int32)
    idx = li - w_end
    in_range = (idx >= 0) & (idx < Wb)
    at = end_row.gather(1, idx.clamp(0, Wb - 1).long().view(-1, 1))[:, 0]
    at = torch.where(at >= INF // 2, INF, at + e * li)
    return torch.where(in_range, at, INF).to(torch.int32)


def banded_scores(dg, qshift: torch.Tensor, lengths: torch.Tensor, costs,
                  prep: dict, max_run: int = 0) -> torch.Tensor:
    """(B,) banded global scores (upper bounds; exact where the band
    covers the optimal path, which the caller verifies)."""
    return _untilt_scores(banded_end_rows(dg, qshift, costs, prep, max_run),
                          lengths, prep["w_end"], costs.gap_extend)


def banded_scores_plain(dg, qshift: torch.Tensor, lengths: torch.Tensor,
                        costs, prep: dict, max_run: int = 0) -> torch.Tensor:
    return _untilt_scores(
        banded_end_rows_plain(dg, qshift, costs, prep, max_run),
        lengths, prep["w_end"], costs.gap_extend)


# --------------------------------------------------------------------------
# Full-width fill (B2)
# --------------------------------------------------------------------------

def fill_end_rows_plain(dg, qshift: torch.Tensor, costs) -> torch.Tensor:
    """Plain PyTorch version of the full-fill kernel: the (B, L) untilted
    end row (global alignment)."""
    o, e, x = costs.gap_open, costs.gap_extend, costs.mismatch
    B, L = qshift.shape
    dev = qshift.device
    m_ring = torch.full((dg.window, B, L), INF, dtype=torch.int32, device=dev)
    d_ring = torch.full_like(m_ring, INF)
    ej = e * torch.arange(L, dtype=torch.int32, device=dev)
    P = dg.pred_slots.shape[1]
    symbols = dg.symbols.tolist()
    slots = dg.pred_slots.tolist()
    valid = dg.pred_valid_flat.view(-1, P).tolist()
    wslots = dg.write_slots.tolist()
    end_row = None
    for r in range(dg.n_nodes):
        # p = 0 is unconditional (rank 0 reads an all-INF row)
        min_pm, min_pd = m_ring[slots[r][0]], d_ring[slots[r][0]]
        for p in range(1, P):
            if valid[r][p] == 1:
                min_pm = torch.minimum(min_pm, m_ring[slots[r][p]])
                min_pd = torch.minimum(min_pd, d_ring[slots[r][p]])
        D = torch.minimum(min_pm + (o + e), min_pd + e)
        diag = _shift_right(min_pm) + torch.where(
            qshift == symbols[r], 0, x).to(torch.int32)
        A = torch.minimum(diag, D)
        if r == 0:
            A[:, 0] = torch.clamp(A[:, 0], max=0)
        if r == dg.end_rank_i:
            M = end_row = min_pm.clone()
            D = torch.full_like(D, INF)
        else:
            pref = _prefix_min(A - ej, L)
            I = torch.clamp(_shift_right(pref) + o + ej, max=INF)
            M = torch.minimum(A, I)
            D = torch.clamp(D, max=INF)
        m_ring[wslots[r]] = M
        d_ring[wslots[r]] = D
    return end_row


def _launch_fill(dg, qshift, costs):
    lib = build.load()
    dev = qshift.device
    B, L = qshift.shape
    operands = {"qshift": qshift, "symbols": dg.symbols,
                "pred_slots": dg.pred_slots_flat,
                "pred_valid": dg.pred_valid_flat,
                "write_slots": dg.write_slots}
    for name, t in operands.items():
        _check_operand(t, dev, name)
    end_row = torch.empty((B, L), dtype=torch.int32, device=dev)
    if B == 0:
        return end_row
    with torch.cuda.device(dev):
        plan = fill_plan(dg.window, L)
        gws = torch.empty(max(plan["global_ints_per_read"] * B, 1),
                          dtype=torch.int32, device=dev)
        code = lib.poasta_full_fill(
            dg.symbols.data_ptr(), dg.pred_slots_flat.data_ptr(),
            dg.pred_valid_flat.data_ptr(), dg.write_slots.data_ptr(),
            qshift.data_ptr(), B, L, dg.n_nodes, dg.end_rank_i, dg.window,
            int(dg.pred_slots.shape[1]), costs.gap_open, costs.gap_extend,
            costs.mismatch, end_row.data_ptr(), gws.data_ptr(), gws.numel(),
            torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, code, "full fill kernel launch")
    fill_end_rows.launches += 1
    return end_row


def fill_end_rows(dg, qshift: torch.Tensor, costs) -> torch.Tensor:
    """(B, L) end rows of the full-width fill: the kernel on a CUDA
    tensor, the plain version on a CPU tensor."""
    if qshift.device.type == "cuda":
        return _launch_fill(dg, qshift, costs)
    if qshift.device.type == "cpu":
        return fill_end_rows_plain(dg, qshift, costs)
    raise ValueError(f"no full fill for device {qshift.device}")


fill_end_rows.launches = 0


def _at_lengths(end_row, lengths) -> torch.Tensor:
    return end_row.gather(1, lengths.long().view(-1, 1))[:, 0]


def fill_scores(dg, qshift: torch.Tensor, lengths: torch.Tensor,
                costs) -> torch.Tensor:
    """(B,) exact global scores by the full-width fill."""
    return _at_lengths(fill_end_rows(dg, qshift, costs), lengths)


def fill_scores_plain(dg, qshift: torch.Tensor, lengths: torch.Tensor,
                      costs) -> torch.Tensor:
    return _at_lengths(fill_end_rows_plain(dg, qshift, costs), lengths)
