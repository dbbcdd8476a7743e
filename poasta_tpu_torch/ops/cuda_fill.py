"""The fills of the scoring path, each a hand-written kernel beside its
plain PyTorch version.

Port of ``poasta_tpu/ops/pallas_fill.py``.  TPU kernel -> wrapper here
(source under ``csrc/``):

* B1 ``_banded_kernel`` -> ``banded_end_rows`` (banded_kernel.cu)
* B2 ``_fill_kernel``, global -> ``fill_end_rows`` (fill_kernel.cu)
* B3 ``_banded_kernel_drift`` -> ``drift_end_rows`` (banded_kernel.cu)
* B4 ``_fill_kernel_bounded`` -> ``bounded_best_rows`` (fill_kernel.cu)
* B5 ``_banded_kernel_ef`` -> ``ef_best_rows`` (banded_kernel.cu)
* B6 ``_banded_kernel_drift_ef`` -> ``drift_ef_best_rows``
  (banded_kernel.cu)

``banded_kernel.cu`` and ``fill_kernel.cu`` each hold one kernel template;
the variants are its compile-time instantiations.

Each fill has:

* a kernel wrapper: on a CUDA tensor it launches the kernel or raises; on
  a CPU tensor it runs the plain version.  ``<wrapper>.launches`` counts
  kernel launches, and nothing else;
* a plain PyTorch version (``*_plain``): a loop over ranks on (B, lanes)
  int32 tensors with the kernel's tilt, truncation, INF and frame-roll
  rules, so the raw rows agree bit for bit;
* a scores function that reads each read's score off the raw row.  The
  un-tilt and the ``[jlo, n]`` windowed min are torch ops here, as they
  are XLA ops outside the Pallas kernels.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..utils import build
from .dp_rows import INF, _shift_right

PLACEMENTS = ("smem", "rings-global", "global")
# variant codes of csrc/banded_kernel.cu
VARIANT_GLOBAL, VARIANT_DRIFT, VARIANT_EF, VARIANT_DRIFT_EF = 1, 3, 5, 6


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


def _check_operands(device: torch.device, **operands) -> None:
    for name, t in operands.items():
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(
                f"{name} must be contiguous int32, got {t.dtype}")


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
    """Launch shape and working-set placement of the banded kernel (B1)
    for a ring of W rows of ``width + 2*margin`` lanes (needs the card)."""
    return variant_plan(VARIANT_GLOBAL, W, width, margin, 0)


def fill_plan(W: int, L: int) -> dict:
    """Launch shape and working-set placement of the full-fill kernel."""
    return _plan("poasta_fill_plan", 0, W, L)


def bounded_plan(W: int, L: int) -> dict:
    """Launch shape and placement of the bounded full-fill kernel (B4)."""
    return _plan("poasta_fill_plan", 1, W, L)


def variant_plan(variant: int, W: int, width: int, margin: int,
                 Lq: int) -> dict:
    """Launch shape and placement of a banded variant (``VARIANT_GLOBAL``,
    ``VARIANT_DRIFT``, ``VARIANT_EF``, ``VARIANT_DRIFT_EF``) on query rows
    of ``Lq`` lanes (only the ends-free variants' placement depends on it)."""
    return _plan("poasta_banded_plan", variant, W, width, margin, Lq)


def _workspace(plan: dict, B: int, dev) -> torch.Tensor:
    return torch.empty(max(plan["global_ints_per_read"] * B, 1),
                       dtype=torch.int32, device=dev)


def _dispatch(kernel, plain, q: torch.Tensor, what: str):
    """The kernel for a CUDA tensor, the plain version for a CPU tensor;
    any other device raises."""
    if q.device.type == "cuda":
        return kernel
    if q.device.type == "cpu":
        return plain
    raise ValueError(f"no {what} for device {q.device}")


# --------------------------------------------------------------------------
# Window tables
# --------------------------------------------------------------------------

def _clamp_windows_to_row(wstarts_np, width: int, L: int):
    """Clamp a window layout to the packed query row: lanes past L hold
    no real offsets, so shrink the width to the row and shift starts left
    (every real cell the original window covered stays covered)."""
    width = min(width, (L // 128) * 128)
    clamp = max(((L - width) // 128) * 128, 0)
    return width, np.minimum(wstarts_np, clamp).astype(np.int32)


def _window_tables(dg, wstarts_np):
    """(ws (Np,), pred window starts (Np, P), margin): the margin covers
    the largest window shift between a rank and a valid predecessor."""
    ws = np.zeros(dg.n_nodes_padded, dtype=np.int32)
    ws[: wstarts_np.shape[0]] = wstarts_np
    pw = np.take(ws, dg.pred_ranks_np, axis=0).astype(np.int32)
    n = min(wstarts_np.shape[0], dg.pred_ranks_np.shape[0])
    pr = dg.pred_ranks_np[:n]
    valid = dg.pred_valid_np[:n]
    deltas = [0]
    for i in range(pr.shape[1]):
        d = np.abs(ws[:n] - ws[pr[:, i]])
        deltas.append(int(np.where(valid[:, i], d, 0).max()) if n else 0)
    margin = max(((max(deltas) + 127) // 128) * 128, 128)
    return ws, pw, margin


def prepare_banded(dg, costs, wstarts_np, width: int, L: int) -> dict:
    """The banded fill's per-rank window tables and margin for a window
    layout, placed on the graph's device.  Callers cache the result."""
    width, wstarts_np = _clamp_windows_to_row(wstarts_np, width, L)
    ws, pw, margin = _window_tables(dg, wstarts_np)
    return {
        "margin": margin,
        "width": width,
        "L": L,
        "pred_wstarts": torch.as_tensor(pw.reshape(-1), device=dg.device),
        "wstarts": torch.as_tensor(ws, device=dg.device),
        "w_end": int(ws[dg.end_rank_i]),
        "wstarts_max": int(ws.max()),
    }


def prepare_banded_drift(dg, costs, wstarts_np, width: int, s_ranks_np,
                         S: int, L: int) -> dict:
    """:func:`prepare_banded` for drifting windows: frame starts as they
    are (they may be negative), the step schedule, and the query's left
    pad ``mq`` that covers negative starts.  ``S`` is a power of two."""
    if S <= 0 or S & (S - 1):
        raise ValueError(f"drift step count {S} is not a power of two")
    ws, pw, margin = _window_tables(dg, wstarts_np)
    n = s_ranks_np.shape[0]
    sr = np.zeros(dg.n_nodes_padded, dtype=np.int32)
    sr[:n] = s_ranks_np
    sp = np.zeros(dg.n_nodes_padded, dtype=np.int32)
    sp[1:n] = s_ranks_np[:-1]
    return {
        "margin": margin,
        "width": width,
        "mq": ((max(0, -int(wstarts_np.min())) + 127) // 128) * 128,
        "S": S,
        "L": L,
        "pred_wstarts": torch.as_tensor(pw.reshape(-1), device=dg.device),
        "wstarts": torch.as_tensor(ws, device=dg.device),
        "s_ranks": torch.as_tensor(sr, device=dg.device),
        "s_prev": torch.as_tensor(sp, device=dg.device),
        "w_end": int(ws[dg.end_rank_i]),
        "wstarts_min": int(ws.min()),
        "wstarts_max": int(ws.max()),
    }


def drift_units(lengths: torch.Tensor, n_min: int) -> torch.Tensor:
    """(B,) int32 drift units nbs_b = max(n_b - n_min + 64, 0) // 128: read
    b's window ends 128 * nbs_b lanes right of the shared frame."""
    return (torch.clamp(lengths.to(torch.int32) - n_min + 64, min=0)
            // 128).to(torch.int32)


def _scan_cap(width: int, max_run: int) -> int:
    return min(width, max_run) if max_run else width


# --------------------------------------------------------------------------
# Banded fills: one plain rank loop for B1, B3, B5 and B6
# --------------------------------------------------------------------------

def _roll_left_128(t: torch.Tensor, fill: int) -> torch.Tensor:
    pad = torch.full(t.shape[:-1] + (128,), fill, dtype=t.dtype,
                     device=t.device)
    return torch.cat([t[..., 128:], pad], dim=-1)


def _banded_plain(dg, q: torch.Tensor, costs, prep: dict, max_run: int,
                  nbs=None, free_start: bool = False, end_ok=None,
                  end_window=None) -> torch.Tensor:
    """The banded kernels' plain version, in tilted coordinates
    (X'(j) = X(j) - e*j).

    ``nbs`` (B,): drifting frames.  At a rank where a read's shift
    sigma_b = 128 * (nbs_b * s_r // S) advances, its query row and every
    ring row roll 128 lanes left, literally, as the TPU kernel does.
    ``end_ok`` (Np,): instead of the end rank's row, return the running min
    of M' over the permitted ranks: a (B, Lq) row positional in the global
    offset, still tilted, or, with ``end_window = (jlo, lengths)``, a
    (B, Wb) tile of un-tilted values gated per lane by jlo <= j <= n.
    """
    o, e, x = costs.gap_open, costs.gap_extend, costs.mismatch
    B = q.shape[0]
    Wb, margin = prep["width"], prep["margin"]
    dev = q.device
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
    col = torch.arange(Wb, dtype=torch.int32, device=dev)
    drift = nbs is not None
    if drift:
        s_ranks, s_prev = prep["s_ranks"].tolist(), prep["s_prev"].tolist()
        S, mq = prep["S"], prep["mq"]
    best = None
    if end_ok is not None:
        permitted = end_ok.tolist()
        if end_window is not None:
            jlo = end_window[0].to(torch.int32).view(-1, 1)
            n_b = end_window[1].to(torch.int32).view(-1, 1)
        best = torch.full((B, Wb if end_window is not None else q.shape[1]),
                          INF, dtype=torch.int32, device=dev)
    end_row = None
    for r in range(dg.n_nodes):
        w_r = wstarts[r]
        if drift:
            sig = 128 * ((nbs * s_ranks[r]) // S)
            if s_ranks[r] > s_prev[r]:
                stepped = sig > 128 * ((nbs * s_prev[r]) // S)
                q = torch.where(stepped.view(-1, 1), _roll_left_128(q, 0), q)
                step3 = stepped.view(1, -1, 1)
                m_ring = torch.where(step3, _roll_left_128(m_ring, INF),
                                     m_ring)
                d_ring = torch.where(step3, _roll_left_128(d_ring, INF),
                                     d_ring)
            j32 = w_r + col.view(1, -1) + sig.view(-1, 1)
            qwin = q[:, w_r + mq:w_r + mq + Wb]
        else:
            j32 = (w_r + col).view(1, -1)
            qwin = q[:, w_r:w_r + Wb]

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
        diag = _shift_right(min_pm) + torch.where(
            qwin == symbols[r], -e, x - e).to(torch.int32)
        A = torch.minimum(diag, D)
        is_end = r == dg.end_rank_i
        if r == 0 or (free_start and not is_end):
            A = torch.where(j32 == 0, torch.clamp(A, max=0), A)
        if is_end:
            M = end_row = min_pm.clone()
            D = torch.full_like(D, INF)
        else:
            I = torch.clamp(_shift_right(_prefix_min(A, cap)) + o, max=INF)
            M = torch.minimum(A, I)
            D = torch.clamp(D, max=INF)
        m_ring[wslots[r], :, margin:margin + Wb] = M
        d_ring[wslots[r], :, margin:margin + Wb] = D
        if best is not None and permitted[r] == 1:
            if end_window is not None:
                allowed = (j32 >= jlo) & (j32 <= n_b)
                best = torch.minimum(
                    best, torch.where(allowed, M + e * j32, INF))
            else:
                best[:, w_r:w_r + Wb] = torch.minimum(
                    best[:, w_r:w_r + Wb], M)
    return end_row if best is None else best


def _launch_variant(variant: int, wrapper, dg, q, costs, prep, max_run,
                    out_lanes: int, nbs=None, free_start=False, end_ok=None,
                    jlo=None, lengths=None) -> torch.Tensor:
    """Launch csrc/banded_kernel.cu's ``variant`` on (B, Lq) query rows;
    returns its (B, out_lanes) rows and counts the launch on ``wrapper``."""
    lib = build.load()
    dev = q.device
    B, Lq = q.shape
    Wb, margin = prep["width"], prep["margin"]
    mq = prep.get("mq", 0)
    if prep["wstarts_max"] + mq + Wb > Lq:
        raise ValueError(f"windows reach lane {prep['wstarts_max'] + mq + Wb}"
                         f" past the query row ({Lq})")
    if prep.get("wstarts_min", 0) + mq < 0:
        raise ValueError("a window starts left of the query's pad")
    operands = {"qshift": q, "symbols": dg.symbols,
                "pred_slots": dg.pred_slots_flat,
                "pred_valid": dg.pred_valid_flat,
                "pred_wstarts": prep["pred_wstarts"],
                "wstarts": prep["wstarts"], "write_slots": dg.write_slots}
    if nbs is not None:
        operands.update(nbs=nbs, s_ranks=prep["s_ranks"],
                        s_prev=prep["s_prev"])
    if end_ok is not None:
        operands["end_ok"] = end_ok
    if jlo is not None:
        operands.update(jlo=jlo, lengths=lengths)
    _check_operands(dev, **operands)
    for name in ("nbs", "jlo", "lengths"):
        if name in operands and operands[name].shape != (B,):
            raise ValueError(f"{name} must have shape ({B},)")
    out = torch.empty((B, out_lanes), dtype=torch.int32, device=dev)
    if B == 0:
        return out

    def ptr(t):
        return t.data_ptr() if t is not None else None

    with torch.cuda.device(dev):
        plan = variant_plan(variant, dg.window, Wb, margin, Lq)
        gws = _workspace(plan, B, dev)
        code = lib.poasta_banded_fill(
            variant, dg.symbols.data_ptr(), dg.pred_slots_flat.data_ptr(),
            dg.pred_valid_flat.data_ptr(), prep["pred_wstarts"].data_ptr(),
            prep["wstarts"].data_ptr(), dg.write_slots.data_ptr(),
            ptr(prep.get("s_ranks")), ptr(prep.get("s_prev")), ptr(end_ok),
            q.data_ptr(), ptr(nbs), ptr(jlo), ptr(lengths), B, Lq, mq,
            prep.get("S", 1).bit_length() - 1, dg.n_nodes, dg.end_rank_i,
            dg.window, int(dg.pred_slots.shape[1]), Wb, margin,
            costs.gap_open, costs.gap_extend, costs.mismatch,
            _scan_cap(Wb, max_run), int(free_start), out.data_ptr(),
            gws.data_ptr(), gws.numel(),
            torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, code, f"banded fill kernel (variant {variant}) launch")
    wrapper.launches += 1
    return out


def _untilt_at(rows, idx, lengths, e: int) -> torch.Tensor:
    """Each read's score from lane ``idx`` of its tilted row: un-tilt by
    +e*length; eroded-INF lanes (INF walked down by at most e per rank) map
    to INF, as do reads whose lane lies outside the row."""
    Wb = rows.shape[1]
    in_range = (idx >= 0) & (idx < Wb)
    at = rows.gather(1, idx.clamp(0, Wb - 1).long().view(-1, 1))[:, 0]
    at = torch.where(at >= INF // 2, INF, at + e * lengths.to(torch.int32))
    return torch.where(in_range, at, INF).to(torch.int32)


def _windowed_min(rows, lengths, jlo) -> torch.Tensor:
    """(B,) min of each (un-tilted, positional) row over its read's
    permitted end offsets [jlo, n]; INF for an empty window."""
    col = torch.arange(rows.shape[1], dtype=torch.int32,
                       device=rows.device).view(1, -1)
    win = (col >= jlo.to(torch.int32).view(-1, 1)) \
        & (col <= lengths.to(torch.int32).view(-1, 1))
    return torch.where(win, rows, INF).min(dim=1).values.to(torch.int32)


# ---- B1: shared windows, global span -------------------------------------

def banded_end_rows_plain(dg, qshift: torch.Tensor, costs, prep: dict,
                          max_run: int = 0) -> torch.Tensor:
    """Plain PyTorch version of the banded kernel: the (B, Wb) tilted end
    row (X'(j) = X(j) - e*j at j = w_end + lane)."""
    return _banded_plain(dg, qshift, costs, prep, max_run)


def _launch_banded(dg, qshift, costs, prep, max_run):
    return _launch_variant(VARIANT_GLOBAL, banded_end_rows, dg, qshift, costs,
                           prep, max_run, prep["width"])


def banded_end_rows(dg, qshift: torch.Tensor, costs, prep: dict,
                    max_run: int = 0) -> torch.Tensor:
    """(B, Wb) tilted end rows of the banded fill: the kernel on a CUDA
    tensor, the plain version on a CPU tensor.

    ``qshift``: (B, Lq) packed reads, Lq >= every window's end.
    ``max_run``: insertion-run cap (``aligner.banded.ins_run_cap``); 0
    scans the whole window.
    """
    fn = _dispatch(_launch_banded, banded_end_rows_plain, qshift,
                   "banded fill")
    return fn(dg, qshift, costs, prep, max_run)


banded_end_rows.launches = 0


def _banded_scores_from(end_row, lengths, prep, costs) -> torch.Tensor:
    return _untilt_at(end_row, lengths.to(torch.int32) - prep["w_end"],
                      lengths, costs.gap_extend)


def banded_scores(dg, qshift: torch.Tensor, lengths: torch.Tensor, costs,
                  prep: dict, max_run: int = 0) -> torch.Tensor:
    """(B,) banded global scores (upper bounds; exact where the band
    covers the optimal path, which the caller verifies)."""
    return _banded_scores_from(
        banded_end_rows(dg, qshift, costs, prep, max_run), lengths, prep,
        costs)


def banded_scores_plain(dg, qshift: torch.Tensor, lengths: torch.Tensor,
                        costs, prep: dict, max_run: int = 0) -> torch.Tensor:
    return _banded_scores_from(
        banded_end_rows_plain(dg, qshift, costs, prep, max_run), lengths,
        prep, costs)


# ---- B3: drifting windows, global span -----------------------------------

def drift_end_rows_plain(dg, qpad: torch.Tensor, nbs: torch.Tensor, costs,
                         prep: dict, max_run: int = 0) -> torch.Tensor:
    """Plain version of the drift kernel: the (B, Wb) tilted end row in
    each read's own frame (lane i is j = w_end + 128*nbs_b + i)."""
    return _banded_plain(dg, qpad, costs, prep, max_run, nbs=nbs)


def _launch_drift(dg, qpad, nbs, costs, prep, max_run):
    return _launch_variant(VARIANT_DRIFT, drift_end_rows, dg, qpad, costs,
                           prep, max_run, prep["width"], nbs=nbs)


def drift_end_rows(dg, qpad: torch.Tensor, nbs: torch.Tensor, costs,
                   prep: dict, max_run: int = 0) -> torch.Tensor:
    """(B, Wb) tilted end rows of the drifting-window fill.

    ``qpad``: (B, mq + L) packed reads with ``prep['mq']`` zero lanes on
    the left; ``nbs``: :func:`drift_units`; ``prep``:
    :func:`prepare_banded_drift`.
    """
    fn = _dispatch(_launch_drift, drift_end_rows_plain, qpad, "drift fill")
    return fn(dg, qpad, nbs, costs, prep, max_run)


drift_end_rows.launches = 0


def _drift_scores(rows_fn, dg, qpad, lengths, costs, prep, n_min, max_run):
    nbs = drift_units(lengths, n_min)
    end_row = rows_fn(dg, qpad, nbs, costs, prep, max_run)
    idx = lengths.to(torch.int32) - prep["w_end"] - 128 * nbs
    return _untilt_at(end_row, idx, lengths, costs.gap_extend)


def drift_scores(dg, qpad: torch.Tensor, lengths: torch.Tensor, costs,
                 prep: dict, n_min: int, max_run: int = 0) -> torch.Tensor:
    """(B,) banded global scores on drifting windows (upper bounds)."""
    return _drift_scores(drift_end_rows, dg, qpad, lengths, costs, prep,
                         n_min, max_run)


def drift_scores_plain(dg, qpad, lengths, costs, prep: dict, n_min: int,
                       max_run: int = 0) -> torch.Tensor:
    return _drift_scores(drift_end_rows_plain, dg, qpad, lengths, costs,
                         prep, n_min, max_run)


# ---- B5: shared windows, ends-free span ----------------------------------

def ef_best_rows_plain(dg, qshift: torch.Tensor, costs, prep: dict,
                       free_start: bool, end_ok: torch.Tensor,
                       max_run: int = 0) -> torch.Tensor:
    """Plain version of the ends-free banded kernel: the (B, Lq) best row,
    positional in the global offset and still tilted."""
    return _banded_plain(dg, qshift, costs, prep, max_run,
                         free_start=free_start, end_ok=end_ok)


def _launch_ef(dg, qshift, costs, prep, free_start, end_ok, max_run):
    return _launch_variant(VARIANT_EF, ef_best_rows, dg, qshift, costs, prep,
                           max_run, int(qshift.shape[1]),
                           free_start=free_start, end_ok=end_ok)


def ef_best_rows(dg, qshift: torch.Tensor, costs, prep: dict,
                 free_start: bool, end_ok: torch.Tensor,
                 max_run: int = 0) -> torch.Tensor:
    """(B, Lq) tilted best rows of the ends-free banded fill: the min of
    M' over the ranks ``end_ok`` permits, a free graph begin seeding j = 0
    at every rank when ``free_start``."""
    fn = _dispatch(_launch_ef, ef_best_rows_plain, qshift,
                   "ends-free banded fill")
    return fn(dg, qshift, costs, prep, free_start, end_ok, max_run)


ef_best_rows.launches = 0


def _ef_scores(rows_fn, dg, qshift, lengths, costs, prep, free_start, end_ok,
               jlo, max_run):
    best = rows_fn(dg, qshift, costs, prep, free_start, end_ok, max_run)
    col = torch.arange(best.shape[1], dtype=torch.int32, device=best.device)
    best = torch.where(best >= INF // 2, INF, best + costs.gap_extend * col)
    return _windowed_min(best, lengths, jlo)


def ef_scores(dg, qshift: torch.Tensor, lengths: torch.Tensor, costs,
              prep: dict, free_start: bool, end_ok: torch.Tensor,
              jlo: torch.Tensor, max_run: int = 0) -> torch.Tensor:
    """(B,) banded ends-free scores on shared windows (upper bounds)."""
    return _ef_scores(ef_best_rows, dg, qshift, lengths, costs, prep,
                      free_start, end_ok, jlo, max_run)


def ef_scores_plain(dg, qshift, lengths, costs, prep: dict, free_start: bool,
                    end_ok, jlo, max_run: int = 0) -> torch.Tensor:
    return _ef_scores(ef_best_rows_plain, dg, qshift, lengths, costs, prep,
                      free_start, end_ok, jlo, max_run)


# ---- B6: drifting windows, bounded ends-free span ------------------------

def drift_ef_best_rows_plain(dg, qpad: torch.Tensor, nbs: torch.Tensor,
                             lengths: torch.Tensor, jlo: torch.Tensor, costs,
                             prep: dict, end_ok: torch.Tensor,
                             max_run: int = 0) -> torch.Tensor:
    """Plain version of the drift x ends-free kernel: the (B, Wb) best
    tile of un-tilted values (lanes carry no position)."""
    return _banded_plain(dg, qpad, costs, prep, max_run, nbs=nbs,
                         end_ok=end_ok, end_window=(jlo, lengths))


def _launch_drift_ef(dg, qpad, nbs, lengths, jlo, costs, prep, end_ok,
                     max_run):
    return _launch_variant(VARIANT_DRIFT_EF, drift_ef_best_rows, dg, qpad,
                           costs, prep, max_run, prep["width"], nbs=nbs,
                           end_ok=end_ok, jlo=jlo, lengths=lengths)


def drift_ef_best_rows(dg, qpad: torch.Tensor, nbs: torch.Tensor,
                       lengths: torch.Tensor, jlo: torch.Tensor, costs,
                       prep: dict, end_ok: torch.Tensor,
                       max_run: int = 0) -> torch.Tensor:
    """(B, Wb) best tiles of the drifting-window fill under a bounded
    ends-free span (no free graph begin): per lane, the min over permitted
    ranks of M at the offsets jlo_b <= j <= n_b."""
    fn = _dispatch(_launch_drift_ef, drift_ef_best_rows_plain, qpad,
                   "drift ends-free fill")
    return fn(dg, qpad, nbs, lengths, jlo, costs, prep, end_ok, max_run)


drift_ef_best_rows.launches = 0


def _drift_ef_scores(rows_fn, dg, qpad, lengths, costs, prep, n_min, end_ok,
                     jlo, max_run):
    li = lengths.to(torch.int32).contiguous()
    best = rows_fn(dg, qpad, drift_units(li, n_min), li,
                   jlo.to(torch.int32).contiguous(), costs, prep, end_ok,
                   max_run)
    out = best.min(dim=1).values
    return torch.where(out >= INF // 2, INF, out).to(torch.int32)


def drift_ef_scores(dg, qpad: torch.Tensor, lengths: torch.Tensor, costs,
                    prep: dict, n_min: int, end_ok: torch.Tensor,
                    jlo: torch.Tensor, max_run: int = 0) -> torch.Tensor:
    """(B,) banded bounded-ends-free scores on drifting windows (upper
    bounds)."""
    return _drift_ef_scores(drift_ef_best_rows, dg, qpad, lengths, costs,
                            prep, n_min, end_ok, jlo, max_run)


def drift_ef_scores_plain(dg, qpad, lengths, costs, prep: dict, n_min: int,
                          end_ok, jlo, max_run: int = 0) -> torch.Tensor:
    return _drift_ef_scores(drift_ef_best_rows_plain, dg, qpad, lengths,
                            costs, prep, n_min, end_ok, jlo, max_run)


# --------------------------------------------------------------------------
# Full-width fills: one plain rank loop for B2 and B4
# --------------------------------------------------------------------------

def _fill_plain(dg, qshift: torch.Tensor, costs, free_start: bool = False,
                end_ok=None, max_run: int = 0) -> torch.Tensor:
    """The full-width kernels' plain version (untilted).  With ``end_ok``
    (Np,): the running min of M over the permitted ranks instead of the
    end rank's row, a free graph begin seeding j = 0 at every rank but the
    end rank, and the insertion scan truncated to ``max_run`` lanes."""
    o, e, x = costs.gap_open, costs.gap_extend, costs.mismatch
    B, L = qshift.shape
    dev = qshift.device
    m_ring = torch.full((dg.window, B, L), INF, dtype=torch.int32, device=dev)
    d_ring = torch.full_like(m_ring, INF)
    ej = e * torch.arange(L, dtype=torch.int32, device=dev)
    cap = _scan_cap(L, max_run)
    P = dg.pred_slots.shape[1]
    symbols = dg.symbols.tolist()
    slots = dg.pred_slots.tolist()
    valid = dg.pred_valid_flat.view(-1, P).tolist()
    wslots = dg.write_slots.tolist()
    best = None
    if end_ok is not None:
        permitted = end_ok.tolist()
        best = torch.full((B, L), INF, dtype=torch.int32, device=dev)
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
        is_end = r == dg.end_rank_i
        if r == 0 or (free_start and not is_end):
            A[:, 0] = torch.clamp(A[:, 0], max=0)
        if is_end:
            M = end_row = min_pm.clone()
            D = torch.full_like(D, INF)
        else:
            pref = _prefix_min(A - ej, cap)
            I = torch.clamp(_shift_right(pref) + o + ej, max=INF)
            M = torch.minimum(A, I)
            D = torch.clamp(D, max=INF)
        m_ring[wslots[r]] = M
        d_ring[wslots[r]] = D
        if best is not None and permitted[r] == 1:
            best = torch.minimum(best, M)
    return end_row if best is None else best


def _at_lengths(end_row, lengths) -> torch.Tensor:
    return end_row.gather(1, lengths.long().view(-1, 1))[:, 0]


# ---- B2: global span -----------------------------------------------------

def fill_end_rows_plain(dg, qshift: torch.Tensor, costs) -> torch.Tensor:
    """Plain PyTorch version of the full-fill kernel: the (B, L) untilted
    end row (global alignment)."""
    return _fill_plain(dg, qshift, costs)


def _launch_full_fill(wrapper, dg, qshift, costs, free_start=False,
                      end_ok=None, max_run=0) -> torch.Tensor:
    """Launch csrc/fill_kernel.cu on (B, L) query rows: the global fill, or
    with ``end_ok`` the bounded one; returns its (B, L) rows and counts the
    launch on ``wrapper``."""
    lib = build.load()
    dev = qshift.device
    B, L = qshift.shape
    bounded = end_ok is not None
    operands = {"qshift": qshift, "symbols": dg.symbols,
                "pred_slots": dg.pred_slots_flat,
                "pred_valid": dg.pred_valid_flat,
                "write_slots": dg.write_slots}
    if bounded:
        operands["end_ok"] = end_ok
    _check_operands(dev, **operands)
    out = torch.empty((B, L), dtype=torch.int32, device=dev)
    if B == 0:
        return out
    with torch.cuda.device(dev):
        plan = _plan("poasta_fill_plan", int(bounded), dg.window, L)
        gws = _workspace(plan, B, dev)
        code = lib.poasta_full_fill(
            int(bounded), dg.symbols.data_ptr(),
            dg.pred_slots_flat.data_ptr(), dg.pred_valid_flat.data_ptr(),
            dg.write_slots.data_ptr(),
            end_ok.data_ptr() if bounded else None, qshift.data_ptr(), B, L,
            dg.n_nodes, dg.end_rank_i, dg.window,
            int(dg.pred_slots.shape[1]), costs.gap_open, costs.gap_extend,
            costs.mismatch, _scan_cap(L, max_run), int(free_start),
            out.data_ptr(), gws.data_ptr(), gws.numel(),
            torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, code, "full fill kernel launch")
    wrapper.launches += 1
    return out


def _launch_fill(dg, qshift, costs):
    return _launch_full_fill(fill_end_rows, dg, qshift, costs)


def fill_end_rows(dg, qshift: torch.Tensor, costs) -> torch.Tensor:
    """(B, L) end rows of the full-width fill: the kernel on a CUDA
    tensor, the plain version on a CPU tensor."""
    fn = _dispatch(_launch_fill, fill_end_rows_plain, qshift, "full fill")
    return fn(dg, qshift, costs)


fill_end_rows.launches = 0


def fill_scores(dg, qshift: torch.Tensor, lengths: torch.Tensor,
                costs) -> torch.Tensor:
    """(B,) exact global scores by the full-width fill."""
    return _at_lengths(fill_end_rows(dg, qshift, costs), lengths)


def fill_scores_plain(dg, qshift: torch.Tensor, lengths: torch.Tensor,
                      costs) -> torch.Tensor:
    return _at_lengths(fill_end_rows_plain(dg, qshift, costs), lengths)


# ---- B4: ends-free span --------------------------------------------------

def bounded_best_rows_plain(dg, qshift: torch.Tensor, costs,
                            free_start: bool, end_ok: torch.Tensor,
                            max_run: int = 0) -> torch.Tensor:
    """Plain version of the bounded full-fill kernel: the (B, L) untilted
    best row (min of M over the ranks ``end_ok`` permits)."""
    return _fill_plain(dg, qshift, costs, free_start, end_ok, max_run)


def _launch_bounded(dg, qshift, costs, free_start, end_ok, max_run):
    return _launch_full_fill(bounded_best_rows, dg, qshift, costs, free_start,
                             end_ok, max_run)


def bounded_best_rows(dg, qshift: torch.Tensor, costs, free_start: bool,
                      end_ok: torch.Tensor, max_run: int = 0) -> torch.Tensor:
    """(B, L) best rows of the full-width fill under an ends-free span:
    the kernel on a CUDA tensor, the plain version on a CPU tensor.
    ``max_run`` truncates the insertion scan (0: the whole row)."""
    fn = _dispatch(_launch_bounded, bounded_best_rows_plain, qshift,
                   "bounded fill")
    return fn(dg, qshift, costs, free_start, end_ok, max_run)


bounded_best_rows.launches = 0


def bounded_scores(dg, qshift: torch.Tensor, lengths: torch.Tensor, costs,
                   free_start: bool, end_ok: torch.Tensor, jlo: torch.Tensor,
                   max_run: int = 0) -> torch.Tensor:
    """(B,) ends-free scores by the full-width fill: exact with
    ``max_run = 0``, upper bounds under a cap."""
    return _windowed_min(
        bounded_best_rows(dg, qshift, costs, free_start, end_ok, max_run),
        lengths, jlo)


def bounded_scores_plain(dg, qshift, lengths, costs, free_start: bool,
                         end_ok, jlo, max_run: int = 0) -> torch.Tensor:
    return _windowed_min(
        bounded_best_rows_plain(dg, qshift, costs, free_start, end_ok,
                                max_run), lengths, jlo)
