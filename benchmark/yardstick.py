"""Frozen arithmetic of the benchmark: the card's peaks, the operations a
fill needs per cell, percentiles, the union of busy intervals (of all rows
and of each card's) and the read padding rule.  Copies, so that a later
change to the program cannot move the yardstick; each names its origin.
"""

from __future__ import annotations

import numpy as np

# chip_smoke.py: one H100 SXM from NVIDIA's data sheet, 3.35 TB/s of HBM3
# and 67 TFLOP/s of fp32 outside the tensor cores; an SM starts 64 int32
# add/min/compare a cycle beside 128 fp32 FMAs (which count as two), so the
# int32 rate is a quarter of the fp32 figure.  Derived, not published.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12 / 4

# chip_smoke.py RECURRENCE_OPS, SCAN_OPS, PRED_OPS: integer operations per
# lane and rank that the one-piece recurrence needs, whatever a kernel
# spends (D: add, add, min; the diagonal: compare-select, add; A: min; I:
# add, clamp; M: min; the stored D's clamp), a truncated prefix-min's three
# mins (van Herk / Gil-Werman), and per predecessor row after a rank's
# first a min each for M and D.
RECURRENCE_OPS = 10
SCAN_OPS = 3
PRED_OPS = 2


def fill_bound_s(cells: float, extra_pred_rows: int, n_ranks: int) -> float:
    """The least time, in seconds, the card could take for ``cells`` cells
    of a one-piece fill over a graph of ``n_ranks`` ranks with
    ``extra_pred_rows`` predecessor rows past each rank's first (chip_smoke
    ``fill_bound`` and ``_bound``, counted per cell).  Bytes: each cell's
    row read once and written once, int32."""
    ops = cells * (RECURRENCE_OPS + SCAN_OPS
                   + PRED_OPS * extra_pred_rows / max(n_ranks, 1))
    bytes_moved = 4 * 2 * cells / max(n_ranks, 1)
    return max(ops / INT32_OPS_PER_S, bytes_moved / HBM_BYTES_PER_S)


def padded_len(max_read: int) -> int:
    """poasta_tpu_torch ``pack_queries``' row width: the longest read plus
    one, rounded up to a multiple of 128."""
    return ((max_read + 1 + 127) // 128) * 128


def percentile(values, q: float) -> float:
    """The q-th percentile of every value (numpy's linear rule)."""
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


def busy_union(spans) -> float:
    """Total length of the union of (start, end) intervals: chip_profile.py
    ``_report``'s device busy time."""
    busy, reach = 0.0, float("-inf")
    for start, end in sorted(spans):
        if end > reach:
            busy += end - max(start, reach)
            reach = end
    return busy


def busy_per_card(device_by_card, window) -> dict:
    """Each card's busy time in ``window`` (lo, hi): the union of that
    card's (name, start, end) rows, each clipped to the window."""
    lo, hi = window
    return {card: busy_union([(max(s, lo), min(e, hi)) for _, s, e in rows
                              if e > lo and s < hi])
            for card, rows in device_by_card.items()}


def mean_busy(device_by_card, cards, window) -> float:
    """The mean over ``cards`` of each card's busy time in ``window``
    (:func:`busy_per_card`; a card without rows is idle throughout): the
    harness's ``busy_s`` and the ``device_idle_pct`` readers' rule."""
    busy = busy_per_card(device_by_card, window)
    return sum(busy.get(c, 0.0) for c in cards) / max(len(cards), 1)


def idle_gaps(spans, lo: float, hi: float):
    """The (start, end) gaps in [lo, hi] that no interval of ``spans``
    covers."""
    gaps, reach = [], lo
    for start, end in sorted(spans):
        if start > reach:
            gaps.append((reach, min(start, hi)))
        reach = max(reach, end)
        if reach >= hi:
            break
    if reach < hi:
        gaps.append((reach, hi))
    return [(a, b) for a, b in gaps if b > a]
