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
* B7 ``_fill_kernel_bounded_ends`` (and its streamed twin B10) ->
  ``bounded_end_rows`` (fill_kernel.cu)
* B12 ``_fill_kernel_2p``, global -> ``fill_end_rows_2p`` (fill_kernel.cu)
* B13 ``_fill_kernel_bounded_2p`` -> ``bounded_best_rows_2p``
  (fill_kernel.cu)
* B14 ``_fill_kernel_bounded_2p_ends`` (and its streamed twin B15) ->
  ``bounded_end_rows_2p`` (fill_kernel.cu)
* B2f and B12f, ``_fill_kernel`` and ``_fill_kernel_2p`` with
  ``free_start``/``free_end`` -> ``free_fill_rows`` and
  ``free_fill_rows_2p``: B4 and B13 under :func:`free_end_mask`
* B16 ``_banded_kernel_2p`` -> ``banded_end_rows_2p`` (banded_kernel.cu)
* B17 ``_banded_kernel_drift_2p`` -> ``drift_end_rows_2p``
  (banded_kernel.cu)

``banded_kernel.cu`` and ``fill_kernel.cu`` each hold one kernel template;
the variants are its compile-time instantiations.

Two-piece costs (B12-B17) run the same recurrence with a third ring
(D2) and one more scratch row.  Only M = min(A, I1, I2) enters a ring, and
``GapAffine2Piece`` has e1 >= e2, so a run of k >= 1 inserted lanes costs
o1 + e1 + (k - 1) * e2 at best (switch to piece 2 at once, never reopen):
min(I1, I2) is the one-piece insertion row with slope e2 and open
o1 + e1 - e2, one truncated prefix-min of A - e2*lane, not the TPU kernels'
coupled 2x2 min-plus scan (:func:`fill_constants`;
``tests/test_torch_two_piece.py`` holds the two equal, capped and not).
Two-piece rows are stored untilted, as the TPU's two-piece kernels store
them: with drift a ring margin keeps values a roll left behind (ROADMAP
C7), and a tilted row would read those at another offset's tilt.

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
# variant codes of csrc/banded_kernel.cu (the TPU kernels' B numbers)
VARIANT_GLOBAL, VARIANT_DRIFT, VARIANT_EF, VARIANT_DRIFT_EF = 1, 3, 5, 6
VARIANT_GLOBAL_2P, VARIANT_DRIFT_2P = 16, 17
# variant codes of csrc/fill_kernel.cu
FILL_GLOBAL, FILL_BOUNDED, FILL_BOUNDED_ENDS, FILL_GLOBAL_2P = 0, 1, 2, 3
FILL_BOUNDED_2P, FILL_BOUNDED_ENDS_2P = 4, 5


def fill_constants(costs):
    """``(o, e, ed, x)``, the constants every fill kernel takes.

    Insertions: I(j) = min over the look-back window i < j of
    A(i) + o + e*(j - i), one prefix-min of A tilted by the slope ``e``
    (the one-piece banded rows are stored tilted; the full fills and the
    two-piece banded rows tilt A by e*lane for the scan and back).
    Deletions: D = min(M_pred + o + e, D_pred + ``ed``).  One-piece costs
    give (o, e, e, x).  Two-piece costs give (o1 + e1 - e2, e2, e1, x): with
    e1 >= e2 a run of k >= 1 inserted lanes costs o1 + e1 + (k - 1) * e2 at
    best, which is the one-piece insertion with slope e2 and open
    o1 + e1 - e2; D1 opens at o1 + e1 = o + e and extends at e1, and the
    kernels add D2 = min(D1_pred, D2_pred) + e.
    """
    if not costs.is_two_piece:
        return (costs.gap_open, costs.gap_extend, costs.gap_extend,
                costs.mismatch)
    o1, e1, e2 = costs.gap_open, costs.gap_extend, costs.gap_extend2
    if e1 < e2:
        raise ValueError(f"two-piece costs need gap_extend >= gap_extend2, "
                         f"got {e1} < {e2}")
    return o1 + e1 - e2, e2, e1, costs.mismatch


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


def banded_plan(W: int, width: int, margin: int,
                two_piece: bool = False) -> dict:
    """Launch shape and working-set placement of the banded kernel (B1, or
    B16 with ``two_piece``) for a ring of W rows of ``width + 2*margin``
    lanes (needs the card)."""
    return variant_plan(VARIANT_GLOBAL_2P if two_piece else VARIANT_GLOBAL,
                        W, width, margin, 0)


def fill_plan(W: int, L: int, two_piece: bool = False) -> dict:
    """Launch shape and working-set placement of the full-fill kernel (B2,
    or B12 with ``two_piece``)."""
    return _plan("poasta_fill_plan",
                 FILL_GLOBAL_2P if two_piece else FILL_GLOBAL, W, L)


def _fill_variant(bounded: bool, ends: bool, two_piece: bool) -> int:
    if ends:
        return FILL_BOUNDED_ENDS_2P if two_piece else FILL_BOUNDED_ENDS
    if bounded:
        return FILL_BOUNDED_2P if two_piece else FILL_BOUNDED
    return FILL_GLOBAL_2P if two_piece else FILL_GLOBAL


def bounded_plan(W: int, L: int, ends: bool = False,
                 two_piece: bool = False) -> dict:
    """Launch shape and placement of the bounded full-fill kernel (B4, or
    B13 with ``two_piece``), or with ``ends`` of the one that also keeps
    the end ranks (B7, B14)."""
    return _plan("poasta_fill_plan", _fill_variant(True, ends, two_piece),
                 W, L)


def variant_plan(variant: int, W: int, width: int, margin: int,
                 Lq: int) -> dict:
    """Launch shape and placement of a banded variant (``VARIANT_GLOBAL``,
    ``VARIANT_DRIFT``, ``VARIANT_EF``, ``VARIANT_DRIFT_EF``,
    ``VARIANT_GLOBAL_2P``, ``VARIANT_DRIFT_2P``) on query rows of ``Lq``
    lanes (only the ends-free variants' placement depends on it)."""
    return _plan("poasta_banded_plan", variant, W, width, margin, Lq)


def _workspace(plan: dict, B: int, dev) -> torch.Tensor:
    return torch.empty(max(plan["global_ints_per_read"] * B, 1),
                       dtype=torch.int32, device=dev)


def _dispatch(kernel, plain, q: torch.Tensor, what: str, costs,
              two_piece: bool = False):
    """The kernel for a CUDA tensor, the plain version for a CPU tensor;
    any other device, or costs of the other model, raises."""
    if costs.is_two_piece != two_piece:
        raise ValueError(f"the {what} takes "
                         f"{'two' if two_piece else 'one'}-piece costs")
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


def _row_tilt(costs) -> int:
    """The slope e of the banded rows' tilt X'(j) = X(j) - e*j: the
    one-piece rows are tilted, the two-piece rows are not."""
    return 0 if costs.is_two_piece else costs.gap_extend


def _banded_plain(dg, q: torch.Tensor, costs, prep: dict, max_run: int,
                  nbs=None, free_start: bool = False, end_ok=None,
                  end_window=None) -> torch.Tensor:
    """The banded kernels' plain version, in coordinates tilted by
    :func:`_row_tilt`.  Two-piece costs keep a third ring (D2), untilted.

    ``nbs`` (B,): drifting frames.  At a rank where a read's shift
    sigma_b = 128 * (nbs_b * s_r // S) advances, its query row and every
    ring row roll 128 lanes left, literally, as the TPU kernel does.
    ``end_ok`` (Np,): instead of the end rank's row, return the running min
    of M' over the permitted ranks: a (B, Lq) row positional in the global
    offset, still tilted, or, with ``end_window = (jlo, lengths)``, a
    (B, Wb) tile of un-tilted values gated per lane by jlo <= j <= n.
    """
    o, e, ed, x = fill_constants(costs)
    tilt = _row_tilt(costs)
    two_piece = costs.is_two_piece
    B = q.shape[0]
    Wb, margin = prep["width"], prep["margin"]
    dev = q.device
    # M, D (D1) and, for two-piece costs, D2
    rings = [torch.full((dg.window, B, Wb + 2 * margin), INF,
                        dtype=torch.int32, device=dev)
             for _ in range(3 if two_piece else 2)]
    cap = _scan_cap(Wb, max_run)
    P = dg.pred_slots.shape[1]
    symbols = dg.symbols.tolist()
    slots = dg.pred_slots.tolist()
    valid = dg.pred_valid_flat.view(-1, P).tolist()
    wstarts = prep["wstarts"].tolist()
    pw = prep["pred_wstarts"].view(-1, P).tolist()
    wslots = dg.write_slots.tolist()
    col = torch.arange(Wb, dtype=torch.int32, device=dev)
    e_lane = e * col
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
                rings = [torch.where(step3, _roll_left_128(rg, INF), rg)
                         for rg in rings]
            j32 = w_r + col.view(1, -1) + sig.view(-1, 1)
            qwin = q[:, w_r + mq:w_r + mq + Wb]
        else:
            j32 = (w_r + col).view(1, -1)
            qwin = q[:, w_r:w_r + Wb]

        def window(p):
            start = margin + min(max(w_r - pw[r][p], -margin), margin)
            return [rg[slots[r][p], :, start:start + Wb] for rg in rings]

        # p = 0 is unconditional (rank 0 reads an all-INF row)
        mins = window(0)
        for p in range(1, P):
            if valid[r][p] == 1:
                mins = [torch.minimum(a, b) for a, b in zip(mins, window(p))]
        min_pm, min_pd = mins[0], mins[1]
        Ds = [torch.minimum(min_pm + (o + e), min_pd + ed)]
        if two_piece:
            Ds.append(torch.minimum(min_pd, mins[2]) + e)
        diag = _shift_right(min_pm) + torch.where(
            qwin == symbols[r], -tilt, x - tilt).to(torch.int32)
        A = diag
        for D in Ds:
            A = torch.minimum(A, D)
        is_end = r == dg.end_rank_i
        if r == 0 or (free_start and not is_end):
            A = torch.where(j32 == 0, torch.clamp(A, max=0), A)
        if is_end:
            M = end_row = min_pm.clone()
            Ds = [torch.full_like(D, INF) for D in Ds]
        else:
            if two_piece:
                # untilted rows: the scan runs on A tilted by e over the
                # lane (offsets differ from lanes by one constant a rank,
                # and A - e*lane never passes INF), and returns
                pref = _prefix_min(A - e_lane, cap) + e_lane
                I = torch.clamp(_shift_right(pref) + (o + e), max=INF)
            else:
                I = torch.clamp(_shift_right(_prefix_min(A, cap)) + o,
                                max=INF)
            M = torch.minimum(A, I)
            Ds = [torch.clamp(D, max=INF) for D in Ds]
        for rg, row in zip(rings, [M] + Ds):
            rg[wslots[r], :, margin:margin + Wb] = row
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
            *fill_constants(costs), _scan_cap(Wb, max_run), int(free_start),
            out.data_ptr(),
            gws.data_ptr(), gws.numel(),
            torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, code, f"banded fill kernel (variant {variant}) launch")
    wrapper.launches += 1
    return out


def _untilt_at(rows, idx, lengths, costs) -> torch.Tensor:
    """Each read's score from lane ``idx`` of its row: un-tilt by
    +e*length (:func:`_row_tilt`); eroded-INF lanes (INF walked down by at
    most e per rank) map to INF, as do reads whose lane lies outside the
    row."""
    e = _row_tilt(costs)
    Wb = rows.shape[1]
    in_range = (idx >= 0) & (idx < Wb)
    at = rows.gather(1, idx.clamp(0, Wb - 1).long().view(-1, 1))[:, 0]
    at = torch.where(at >= INF // 2, INF, at + e * lengths.to(torch.int32))
    return torch.where(in_range, at, INF).to(torch.int32)


def _end_window(rows, lengths, jlo) -> torch.Tensor:
    """``rows`` with every lane outside its read's permitted end offsets
    [jlo, n] set to INF."""
    col = torch.arange(rows.shape[1], dtype=torch.int32,
                       device=rows.device).view(1, -1)
    win = (col >= jlo.to(torch.int32).view(-1, 1)) \
        & (col <= lengths.to(torch.int32).view(-1, 1))
    return torch.where(win, rows, INF)


def _windowed_min(rows, lengths, jlo) -> torch.Tensor:
    """(B,) min of each (un-tilted, positional) row over its read's
    permitted end offsets [jlo, n]; INF for an empty window."""
    return _end_window(rows, lengths, jlo).min(dim=1).values.to(torch.int32)


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
                   "banded fill", costs)
    return fn(dg, qshift, costs, prep, max_run)


banded_end_rows.launches = 0


def _banded_scores_from(end_row, lengths, prep, costs) -> torch.Tensor:
    return _untilt_at(end_row, lengths.to(torch.int32) - prep["w_end"],
                      lengths, costs)


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
    fn = _dispatch(_launch_drift, drift_end_rows_plain, qpad, "drift fill",
                   costs)
    return fn(dg, qpad, nbs, costs, prep, max_run)


drift_end_rows.launches = 0


def _drift_scores(rows_fn, dg, qpad, lengths, costs, prep, n_min, max_run):
    nbs = drift_units(lengths, n_min)
    end_row = rows_fn(dg, qpad, nbs, costs, prep, max_run)
    idx = lengths.to(torch.int32) - prep["w_end"] - 128 * nbs
    return _untilt_at(end_row, idx, lengths, costs)


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
                   "ends-free banded fill", costs)
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
                   "drift ends-free fill", costs)
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


# ---- B16: shared windows, global span, two-piece costs -------------------

def banded_end_rows_2p_plain(dg, qshift: torch.Tensor, costs, prep: dict,
                             max_run: int = 0) -> torch.Tensor:
    """Plain version of the two-piece banded kernel: the (B, Wb) untilted
    end row (lane i at offset w_end + i)."""
    return _banded_plain(dg, qshift, costs, prep, max_run)


def _launch_banded_2p(dg, qshift, costs, prep, max_run):
    return _launch_variant(VARIANT_GLOBAL_2P, banded_end_rows_2p, dg, qshift,
                           costs, prep, max_run, prep["width"])


def banded_end_rows_2p(dg, qshift: torch.Tensor, costs, prep: dict,
                       max_run: int = 0) -> torch.Tensor:
    """(B, Wb) untilted end rows of the two-piece banded fill: the kernel
    on a CUDA tensor, the plain version on a CPU tensor.  Arguments as for
    :func:`banded_end_rows`; ``costs`` is a ``GapAffine2Piece``."""
    fn = _dispatch(_launch_banded_2p, banded_end_rows_2p_plain, qshift,
                   "two-piece banded fill", costs, two_piece=True)
    return fn(dg, qshift, costs, prep, max_run)


banded_end_rows_2p.launches = 0


def banded_scores_2p(dg, qshift: torch.Tensor, lengths: torch.Tensor, costs,
                     prep: dict, max_run: int = 0) -> torch.Tensor:
    """(B,) two-piece banded global scores (upper bounds)."""
    return _banded_scores_from(
        banded_end_rows_2p(dg, qshift, costs, prep, max_run), lengths, prep,
        costs)


def banded_scores_2p_plain(dg, qshift, lengths, costs, prep: dict,
                           max_run: int = 0) -> torch.Tensor:
    return _banded_scores_from(
        banded_end_rows_2p_plain(dg, qshift, costs, prep, max_run), lengths,
        prep, costs)


# ---- B17: drifting windows, global span, two-piece costs -----------------

def drift_end_rows_2p_plain(dg, qpad: torch.Tensor, nbs: torch.Tensor, costs,
                            prep: dict, max_run: int = 0) -> torch.Tensor:
    """Plain version of the two-piece drift kernel: all three rings roll
    with the read's frame; the (B, Wb) end row is untilted (lane i at
    offset w_end + 128*nbs_b + i)."""
    return _banded_plain(dg, qpad, costs, prep, max_run, nbs=nbs)


def _launch_drift_2p(dg, qpad, nbs, costs, prep, max_run):
    return _launch_variant(VARIANT_DRIFT_2P, drift_end_rows_2p, dg, qpad,
                           costs, prep, max_run, prep["width"], nbs=nbs)


def drift_end_rows_2p(dg, qpad: torch.Tensor, nbs: torch.Tensor, costs,
                      prep: dict, max_run: int = 0) -> torch.Tensor:
    """(B, Wb) untilted end rows of the two-piece drifting-window fill;
    arguments as for :func:`drift_end_rows`."""
    fn = _dispatch(_launch_drift_2p, drift_end_rows_2p_plain, qpad,
                   "two-piece drift fill", costs, two_piece=True)
    return fn(dg, qpad, nbs, costs, prep, max_run)


drift_end_rows_2p.launches = 0


def drift_scores_2p(dg, qpad: torch.Tensor, lengths: torch.Tensor, costs,
                    prep: dict, n_min: int, max_run: int = 0) -> torch.Tensor:
    """(B,) two-piece banded global scores on drifting windows (upper
    bounds)."""
    return _drift_scores(drift_end_rows_2p, dg, qpad, lengths, costs, prep,
                         n_min, max_run)


def drift_scores_2p_plain(dg, qpad, lengths, costs, prep: dict, n_min: int,
                          max_run: int = 0) -> torch.Tensor:
    return _drift_scores(drift_end_rows_2p_plain, dg, qpad, lengths, costs,
                         prep, n_min, max_run)


# --------------------------------------------------------------------------
# Full-width fills: one plain rank loop for B2, B4, B7 and B12-B14
# --------------------------------------------------------------------------

def _fill_plain(dg, qshift: torch.Tensor, costs, free_start: bool = False,
                end_ok=None, max_run: int = 0, ends: bool = False):
    """The full-width kernels' plain version (untilted).  With ``end_ok``
    (Np,): the running min of M over the permitted ranks instead of the
    end rank's row, a free graph begin seeding j = 0 at every rank but the
    end rank, and the insertion scan truncated to ``max_run`` lanes.  With
    ``ends``: (best, ranks), ranks (B, L) holding the first rank that
    reached each best value (0 where none did).  Two-piece costs keep a
    third ring (D2)."""
    o, e, ed, x = fill_constants(costs)
    two_piece = costs.is_two_piece
    B, L = qshift.shape
    dev = qshift.device
    # M, D (D1) and, for two-piece costs, D2
    rings = [torch.full((dg.window, B, L), INF, dtype=torch.int32,
                        device=dev) for _ in range(3 if two_piece else 2)]
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
        bestr = torch.zeros((B, L), dtype=torch.int32, device=dev)
    end_row = None
    for r in range(dg.n_nodes):
        # p = 0 is unconditional (rank 0 reads an all-INF row)
        mins = [rg[slots[r][0]] for rg in rings]
        for p in range(1, P):
            if valid[r][p] == 1:
                mins = [torch.minimum(a, rg[slots[r][p]])
                        for a, rg in zip(mins, rings)]
        min_pm, min_pd = mins[0], mins[1]
        Ds = [torch.minimum(min_pm + (o + e), min_pd + ed)]
        if two_piece:
            Ds.append(torch.minimum(min_pd, mins[2]) + e)
        A = _shift_right(min_pm) + torch.where(
            qshift == symbols[r], 0, x).to(torch.int32)
        for D in Ds:
            A = torch.minimum(A, D)
        is_end = r == dg.end_rank_i
        if r == 0 or (free_start and not is_end):
            A[:, 0] = torch.clamp(A[:, 0], max=0)
        if is_end:
            M = end_row = min_pm.clone()
            Ds = [torch.full_like(D, INF) for D in Ds]
        else:
            pref = _prefix_min(A - ej, cap)
            I = torch.clamp(_shift_right(pref) + o + ej, max=INF)
            M = torch.minimum(A, I)
            Ds = [torch.clamp(D, max=INF) for D in Ds]
        for rg, row in zip(rings, [M] + Ds):
            rg[wslots[r]] = row
        if best is not None and permitted[r] == 1:
            if ends:
                bestr = torch.where(M < best, r, bestr).to(torch.int32)
            best = torch.minimum(best, M)
    if ends:
        return best, bestr
    return end_row if best is None else best


def _at_lengths(end_row, lengths) -> torch.Tensor:
    return end_row.gather(1, lengths.long().view(-1, 1))[:, 0]


# ---- B2: global span -----------------------------------------------------

def fill_end_rows_plain(dg, qshift: torch.Tensor, costs) -> torch.Tensor:
    """Plain PyTorch version of the full-fill kernel: the (B, L) untilted
    end row (global alignment)."""
    return _fill_plain(dg, qshift, costs)


def _launch_full_fill(wrapper, dg, qshift, costs, free_start=False,
                      end_ok=None, max_run=0, ends=False):
    """Launch csrc/fill_kernel.cu on (B, L) query rows: the global fill, or
    with ``end_ok`` the bounded one; returns its (B, L) rows (with ``ends``
    the pair (best rows, end ranks)) and counts the launch on ``wrapper``."""
    bounded = end_ok is not None
    if ends and not bounded:
        raise ValueError("end ranks need an ends-free span (end_ok)")
    variant = _fill_variant(bounded, ends, costs.is_two_piece)
    lib = build.load()
    dev = qshift.device
    B, L = qshift.shape
    operands = {"qshift": qshift, "symbols": dg.symbols,
                "pred_slots": dg.pred_slots_flat,
                "pred_valid": dg.pred_valid_flat,
                "write_slots": dg.write_slots}
    if bounded:
        operands["end_ok"] = end_ok
    _check_operands(dev, **operands)
    out = torch.empty((B, L), dtype=torch.int32, device=dev)
    ranks = torch.empty_like(out) if ends else None
    if B == 0:
        return (out, ranks) if ends else out
    with torch.cuda.device(dev):
        plan = _plan("poasta_fill_plan", variant, dg.window, L)
        gws = _workspace(plan, B, dev)
        code = lib.poasta_full_fill(
            variant, dg.symbols.data_ptr(),
            dg.pred_slots_flat.data_ptr(), dg.pred_valid_flat.data_ptr(),
            dg.write_slots.data_ptr(),
            end_ok.data_ptr() if bounded else None, qshift.data_ptr(), B, L,
            dg.n_nodes, dg.end_rank_i, dg.window,
            int(dg.pred_slots.shape[1]), *fill_constants(costs),
            _scan_cap(L, max_run), int(free_start),
            out.data_ptr(), ranks.data_ptr() if ends else None,
            gws.data_ptr(), gws.numel(),
            torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, code, "full fill kernel launch")
    wrapper.launches += 1
    return (out, ranks) if ends else out


def _launch_fill(dg, qshift, costs):
    return _launch_full_fill(fill_end_rows, dg, qshift, costs)


def fill_end_rows(dg, qshift: torch.Tensor, costs) -> torch.Tensor:
    """(B, L) end rows of the full-width fill: the kernel on a CUDA
    tensor, the plain version on a CPU tensor."""
    fn = _dispatch(_launch_fill, fill_end_rows_plain, qshift, "full fill",
                   costs)
    return fn(dg, qshift, costs)


fill_end_rows.launches = 0


def fill_scores(dg, qshift: torch.Tensor, lengths: torch.Tensor,
                costs) -> torch.Tensor:
    """(B,) exact global scores by the full-width fill."""
    return _at_lengths(fill_end_rows(dg, qshift, costs), lengths)


def fill_scores_plain(dg, qshift: torch.Tensor, lengths: torch.Tensor,
                      costs) -> torch.Tensor:
    return _at_lengths(fill_end_rows_plain(dg, qshift, costs), lengths)


# ---- B12: global span, two-piece costs ------------------------------------

def fill_end_rows_2p_plain(dg, qshift: torch.Tensor, costs) -> torch.Tensor:
    """Plain version of the two-piece full-fill kernel: the (B, L) untilted
    end row (global alignment)."""
    return _fill_plain(dg, qshift, costs)


def _launch_fill_2p(dg, qshift, costs):
    return _launch_full_fill(fill_end_rows_2p, dg, qshift, costs)


def fill_end_rows_2p(dg, qshift: torch.Tensor, costs) -> torch.Tensor:
    """(B, L) end rows of the two-piece full-width fill: the kernel on a
    CUDA tensor, the plain version on a CPU tensor."""
    fn = _dispatch(_launch_fill_2p, fill_end_rows_2p_plain, qshift,
                   "two-piece full fill", costs, two_piece=True)
    return fn(dg, qshift, costs)


fill_end_rows_2p.launches = 0


def fill_scores_2p(dg, qshift: torch.Tensor, lengths: torch.Tensor,
                   costs) -> torch.Tensor:
    """(B,) exact two-piece global scores by the full-width fill."""
    return _at_lengths(fill_end_rows_2p(dg, qshift, costs), lengths)


def fill_scores_2p_plain(dg, qshift: torch.Tensor, lengths: torch.Tensor,
                         costs) -> torch.Tensor:
    return _at_lengths(fill_end_rows_2p_plain(dg, qshift, costs), lengths)


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
                   "bounded fill", costs)
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


# ---- B7: ends-free span, with each read's end state ----------------------

def bounded_end_rows_plain(dg, qshift: torch.Tensor, costs, free_start: bool,
                           end_ok: torch.Tensor, max_run: int = 0):
    """Plain version of the bounded full-fill kernel with end ranks: the
    (B, L) untilted best row and, per lane, the first rank that reached it."""
    return _fill_plain(dg, qshift, costs, free_start, end_ok, max_run,
                       ends=True)


def _launch_bounded_ends(dg, qshift, costs, free_start, end_ok, max_run):
    return _launch_full_fill(bounded_end_rows, dg, qshift, costs, free_start,
                             end_ok, max_run, ends=True)


def bounded_end_rows(dg, qshift: torch.Tensor, costs, free_start: bool,
                     end_ok: torch.Tensor, max_run: int = 0):
    """((B, L) best rows, (B, L) end ranks) of the full-width fill under an
    ends-free span: the kernel on a CUDA tensor, the plain version on a CPU
    tensor.  ``max_run`` truncates the insertion scan (0: the whole row)."""
    fn = _dispatch(_launch_bounded_ends, bounded_end_rows_plain, qshift,
                   "bounded fill with end ranks", costs)
    return fn(dg, qshift, costs, free_start, end_ok, max_run)


bounded_end_rows.launches = 0


def windowed_argmin(rows, lengths, jlo):
    """(score (B,), end offset (B,)) of (un-tilted, positional) rows over
    each read's permitted end offsets [jlo, n]: the min and, among its
    ties, the largest offset.  An empty window gives (INF, last lane)."""
    masked = _end_window(rows, lengths, jlo)
    score = masked.min(dim=1).values.to(torch.int32)
    last = masked.shape[1] - 1
    end_j = (last - torch.argmin(torch.flip(masked, [1]), dim=1)).to(
        torch.int32)
    return score, end_j


def _with_ends_from(best, ranks, lengths, jlo):
    score, end_j = windowed_argmin(best, lengths, jlo)
    end_r = ranks.gather(1, end_j.long().view(-1, 1))[:, 0]
    return score, end_r, end_j


def bounded_with_ends(dg, qshift: torch.Tensor, lengths: torch.Tensor, costs,
                      free_start: bool, end_ok: torch.Tensor,
                      jlo: torch.Tensor, max_run: int = 0):
    """(scores, end ranks, end offsets), each (B,) int32, by the full-width
    fill under an ends-free span.  Ties go to the largest offset, then to
    the lowest rank.  Exact with ``max_run = 0``; under a cap the scores
    are upper bounds, and a score the caller verifies against its bound
    comes with the exact end state."""
    best, ranks = bounded_end_rows(dg, qshift, costs, free_start, end_ok,
                                   max_run)
    return _with_ends_from(best, ranks, lengths, jlo)


def bounded_with_ends_plain(dg, qshift, lengths, costs, free_start: bool,
                            end_ok, jlo, max_run: int = 0):
    best, ranks = bounded_end_rows_plain(dg, qshift, costs, free_start,
                                         end_ok, max_run)
    return _with_ends_from(best, ranks, lengths, jlo)


# ---- B13: ends-free span, two-piece costs --------------------------------

def bounded_best_rows_2p_plain(dg, qshift: torch.Tensor, costs,
                               free_start: bool, end_ok: torch.Tensor,
                               max_run: int = 0) -> torch.Tensor:
    """Plain version of the two-piece bounded full-fill kernel: the (B, L)
    untilted best row."""
    return _fill_plain(dg, qshift, costs, free_start, end_ok, max_run)


def _launch_bounded_2p(dg, qshift, costs, free_start, end_ok, max_run):
    return _launch_full_fill(bounded_best_rows_2p, dg, qshift, costs,
                             free_start, end_ok, max_run)


def bounded_best_rows_2p(dg, qshift: torch.Tensor, costs, free_start: bool,
                         end_ok: torch.Tensor,
                         max_run: int = 0) -> torch.Tensor:
    """(B, L) best rows of the two-piece full-width fill under an ends-free
    span: the kernel on a CUDA tensor, the plain version on a CPU tensor.
    Arguments as for :func:`bounded_best_rows`; ``costs`` is a
    ``GapAffine2Piece``."""
    fn = _dispatch(_launch_bounded_2p, bounded_best_rows_2p_plain, qshift,
                   "two-piece bounded fill", costs, two_piece=True)
    return fn(dg, qshift, costs, free_start, end_ok, max_run)


bounded_best_rows_2p.launches = 0


def bounded_scores_2p(dg, qshift: torch.Tensor, lengths: torch.Tensor, costs,
                      free_start: bool, end_ok: torch.Tensor,
                      jlo: torch.Tensor, max_run: int = 0) -> torch.Tensor:
    """(B,) two-piece ends-free scores by the full-width fill: exact with
    ``max_run = 0``, upper bounds under a cap."""
    return _windowed_min(
        bounded_best_rows_2p(dg, qshift, costs, free_start, end_ok, max_run),
        lengths, jlo)


def bounded_scores_2p_plain(dg, qshift, lengths, costs, free_start: bool,
                            end_ok, jlo, max_run: int = 0) -> torch.Tensor:
    return _windowed_min(
        bounded_best_rows_2p_plain(dg, qshift, costs, free_start, end_ok,
                                   max_run), lengths, jlo)


# ---- B14: ends-free span, two-piece costs, with each read's end state -----

def bounded_end_rows_2p_plain(dg, qshift: torch.Tensor, costs,
                              free_start: bool, end_ok: torch.Tensor,
                              max_run: int = 0):
    """Plain version of the two-piece bounded full-fill kernel with end
    ranks: the (B, L) untilted best row and the first rank that reached
    it."""
    return _fill_plain(dg, qshift, costs, free_start, end_ok, max_run,
                       ends=True)


def _launch_bounded_ends_2p(dg, qshift, costs, free_start, end_ok, max_run):
    return _launch_full_fill(bounded_end_rows_2p, dg, qshift, costs,
                             free_start, end_ok, max_run, ends=True)


def bounded_end_rows_2p(dg, qshift: torch.Tensor, costs, free_start: bool,
                        end_ok: torch.Tensor, max_run: int = 0):
    """((B, L) best rows, (B, L) end ranks) of the two-piece full-width fill
    under an ends-free span: the kernel on a CUDA tensor, the plain version
    on a CPU tensor.  The rank tables are read from global memory at any
    graph size (the TPU streamed them past its scalar-prefetch budget,
    B15)."""
    fn = _dispatch(_launch_bounded_ends_2p, bounded_end_rows_2p_plain, qshift,
                   "two-piece bounded fill with end ranks", costs,
                   two_piece=True)
    return fn(dg, qshift, costs, free_start, end_ok, max_run)


bounded_end_rows_2p.launches = 0


def bounded_with_ends_2p(dg, qshift: torch.Tensor, lengths: torch.Tensor,
                         costs, free_start: bool, end_ok: torch.Tensor,
                         jlo: torch.Tensor, max_run: int = 0):
    """:func:`bounded_with_ends` under two-piece costs."""
    best, ranks = bounded_end_rows_2p(dg, qshift, costs, free_start, end_ok,
                                      max_run)
    return _with_ends_from(best, ranks, lengths, jlo)


def bounded_with_ends_2p_plain(dg, qshift, lengths, costs, free_start: bool,
                               end_ok, jlo, max_run: int = 0):
    best, ranks = bounded_end_rows_2p_plain(dg, qshift, costs, free_start,
                                            end_ok, max_run)
    return _with_ends_from(best, ranks, lengths, jlo)


# ---- B2f and B12f: free graph ends of the global fill ----------------------

_END_MASKS: dict = {}  # (id(dg), free_end) -> (dg, mask); the dg pins the id


def free_end_mask(dg, free_end: bool) -> torch.Tensor:
    """(Np,) int32 ``end_ok`` that turns the bounded fills (B4, B13) into
    the global fill's free graph end: ranks 1 .. n_nodes - 1 when
    ``free_end`` (every real rank and the virtual end rank, whose M is the
    min of its predecessors', so the best row is _fill_kernel's min of the
    real ranks' running min and the end row), else the end rank alone.
    Cached per graph."""
    key = (id(dg), bool(free_end))
    hit = _END_MASKS.get(key)
    if hit is not None and hit[0] is dg:
        return hit[1]
    mask = np.zeros(dg.n_nodes_padded, dtype=np.int32)
    if free_end:
        mask[1:dg.n_nodes] = 1
    else:
        mask[dg.end_rank_i] = 1
    out = torch.as_tensor(mask, device=dg.device)
    _END_MASKS[key] = (dg, out)
    while len(_END_MASKS) > 8:
        _END_MASKS.pop(next(iter(_END_MASKS)))
    return out


def free_fill_rows_plain(dg, qshift: torch.Tensor, costs, free_start: bool,
                         free_end: bool) -> torch.Tensor:
    """Plain version of the free-end full fill, one- or two-piece: the
    bounded fill's plain version under :func:`free_end_mask`, uncapped."""
    return _fill_plain(dg, qshift, costs, free_start,
                       free_end_mask(dg, free_end))


def _launch_free_fill(dg, qshift, costs, free_start, free_end):
    wrapper = free_fill_rows_2p if costs.is_two_piece else free_fill_rows
    return _launch_full_fill(wrapper, dg, qshift, costs, free_start,
                             free_end_mask(dg, free_end))


def free_fill_rows(dg, qshift: torch.Tensor, costs, free_start: bool,
                   free_end: bool) -> torch.Tensor:
    """(B, L) end rows of the one-piece global fill with a free graph begin
    and/or end (B2f): B4's kernel under :func:`free_end_mask` on a CUDA
    tensor, the plain version on a CPU tensor.  Lane n is a read of length
    n's score."""
    fn = _dispatch(_launch_free_fill, free_fill_rows_plain, qshift,
                   "free-end full fill", costs)
    return fn(dg, qshift, costs, free_start, free_end)


free_fill_rows.launches = 0


def free_fill_rows_2p(dg, qshift: torch.Tensor, costs, free_start: bool,
                      free_end: bool) -> torch.Tensor:
    """:func:`free_fill_rows` under two-piece costs (B12f), on B13's
    kernel."""
    fn = _dispatch(_launch_free_fill, free_fill_rows_plain, qshift,
                   "two-piece free-end full fill", costs, two_piece=True)
    return fn(dg, qshift, costs, free_start, free_end)


free_fill_rows_2p.launches = 0


def free_fill_scores(dg, qshift: torch.Tensor, lengths: torch.Tensor, costs,
                     free_start: bool, free_end: bool) -> torch.Tensor:
    """(B,) exact scores of the global fill with free graph ends, one- or
    two-piece."""
    rows = free_fill_rows_2p if costs.is_two_piece else free_fill_rows
    return _at_lengths(rows(dg, qshift, costs, free_start, free_end), lengths)


def free_fill_scores_plain(dg, qshift, lengths, costs, free_start: bool,
                           free_end: bool) -> torch.Tensor:
    return _at_lengths(free_fill_rows_plain(dg, qshift, costs, free_start,
                                            free_end), lengths)
