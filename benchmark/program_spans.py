"""The port's own spans and counters (``poasta_tpu_torch.utils.spans``), as
a traced run's readers see them.

The recorder records while the profiler runs, so a traced run's window
holds the spans the port opened inside it.  This module takes them from
``sys.modules`` after the window and never loads the port itself: where
the port has no recorder (an older checkout) or the run is untraced, every
reader here returns None.  The spans are timed on the host clock
(``perf_counter_ns``); a span's time t maps onto the profiler's clock as
t - (the window's last call's end) + (the window span's end), since the
harness leaves its window span just after that call returns.  (The
window's start is no anchor: the first ``record_function`` of a profiler
session stamps its start about 1 ms before it returns to the caller.)
"""

from __future__ import annotations

import bisect
import re
import sys

from .yardstick import idle_gaps

RECORDER = "poasta_tpu_torch.utils.spans"

# the host stages of seeding and of the trace driver
SEED_HOST = ("seed.hits", "seed.clusters", "seed.certify")
TRACE_HOST = ("trace.inputs", "trace.replay")


def recorded(run):
    """``{"spans": [(name, id, parent, thread, start, end)], "counts":
    {name: n}}``, the spans on the profiler's clock in seconds; None when
    the port has no recorder or the run was not traced.  Drained once, kept
    on the run for the other readers."""
    if run.trace_window is None:
        return None
    cached = getattr(run, "_program_spans", None)
    if cached is not None:
        return cached
    mod = sys.modules.get(RECORDER)
    if mod is None:
        return None
    raw = mod.drain()
    shift = run.trace_window[1] - run.calls[-1][1]
    out = {"spans": [(s.name, s.id, s.parent, s.thread,
                      s.start_ns * 1e-9 + shift, s.end_ns * 1e-9 + shift)
                     for s in raw["spans"]],
           "counts": dict(raw["counts"])}
    run._program_spans = out
    return out


def merged(intervals):
    """The union of (start, end) intervals as sorted disjoint ones."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [tuple(iv) for iv in out]


def overlap(xs, ys) -> float:
    """Length of the intersection of two sorted disjoint interval lists."""
    total, i, j = 0.0, 0, 0
    while i < len(xs) and j < len(ys):
        lo, hi = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        total += max(hi - lo, 0.0)
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def leaves(rec):
    """The recorded spans that no recorded span names as its parent."""
    parents = {s[2] for s in rec["spans"]}
    return [s for s in rec["spans"] if s[1] not in parents]


def device_idle(run):
    """The window's gaps that no device interval covers, sorted."""
    lo, hi = run.trace_window
    return idle_gaps([(s, e) for _, s, e in run.device], lo, hi)


def idle_explained_pct(run):
    """The share of the window's device-idle time that the union over
    threads of the port's leaf spans covers, %."""
    rec = recorded(run)
    if rec is None or not rec["spans"]:
        return None
    gaps = device_idle(run)
    idle = sum(b - a for a, b in gaps)
    if idle <= 0:
        return None
    covered = merged((s[4], s[5]) for s in leaves(rec))
    return 100.0 * overlap(gaps, covered) / idle


def seconds(rec, names) -> float:
    """Host seconds of the spans named ``names``, summed."""
    return sum(s[5] - s[4] for s in rec["spans"] if s[0] in names)


def ms_per_read(run, names):
    """Host ms of the spans named ``names`` per read of the window."""
    rec = recorded(run)
    if rec is None or not rec["spans"] or not run.reads:
        return None
    return seconds(rec, names) * 1e3 / run.reads


def ms_per_span(run, names, per):
    """Host ms of the spans named ``names`` per span named ``per``."""
    rec = recorded(run)
    n = 0 if rec is None else sum(s[0] == per for s in rec["spans"])
    return seconds(rec, names) * 1e3 / n if n else None


def ns_per_cell(run, kernel: str, counter: str):
    """The profiler's device time of the kernels whose name matches
    ``kernel`` (a regular expression) over the cells the port counted
    under ``counter``, ns a cell."""
    rec = recorded(run)
    cells = 0 if rec is None else rec["counts"].get(counter, 0)
    pat = re.compile(kernel)
    busy = sum(e - s for name, s, e in run.device if pat.search(name))
    return busy * 1e9 / cells if cells and busy > 0 else None


def idle_by_span(run):
    """The window's device-idle time by where the port was, s: for each
    leaf span name, the idle time its spans cover (spans of two threads
    may cover the same gap, so the names may sum past the whole); for each
    other span name, the idle time its spans' self time covers (the span
    less its children) and no leaf does; under ``"none"`` the idle time no
    span covers."""
    rec = recorded(run)
    if rec is None:
        return None
    gaps = device_idle(run)
    leaf = leaves(rec)
    out = {}
    for name in sorted({s[0] for s in leaf}):
        out[name] = overlap(gaps, merged((s[4], s[5]) for s in leaf
                                         if s[0] == name))
    rest = _minus(gaps, merged((s[4], s[5]) for s in leaf))
    starts = [a for a, _ in rest]
    kids = {}
    for s in rec["spans"]:
        kids.setdefault(s[2], []).append((s[4], s[5]))
    for s in rec["spans"]:
        if s[1] in kids:
            own = _minus([(s[4], s[5])], merged(kids[s[1]]))
            near = rest[max(bisect.bisect_right(starts, s[4]) - 1, 0):
                        bisect.bisect_left(starts, s[5])]
            out[s[0]] = out.get(s[0], 0.0) + overlap(near, own)
    every = merged((s[4], s[5]) for s in rec["spans"])
    out["none"] = sum(b - a for a, b in _minus(gaps, every))
    return out


def _minus(xs, ys):
    """Sorted disjoint ``xs`` less sorted disjoint ``ys``."""
    out, j = [], 0
    for a, b in xs:
        while j < len(ys) and ys[j][1] <= a:
            j += 1
        k, lo = j, a
        while k < len(ys) and ys[k][0] < b:
            if ys[k][0] > lo:
                out.append((lo, ys[k][0]))
            lo = max(lo, ys[k][1])
            k += 1
        if lo < b:
            out.append((lo, b))
    return out
