"""Banded wavefront scoring with verify-and-retry: port of the
single-device part of ``poasta_tpu/aligner/banded.py`` (shared and
drifting windows under global and ends-free spans, one- and two-piece
costs; two-piece costs under an ends-free span take the bounded full fill,
as in ``poasta_tpu``, which has no banded kernel for them).

Every rank fills only a window of offsets chosen so that all states whose
completion-cost lower bound is <= ub lie inside it (min/max graph distance
from the start and to the end bound the gaps before and after).  A banded
score S <= ub is therefore exact; reads above ub retry at a wider band,
and the full-width fill is the last resort.  Windows are shared across a
read batch via its min/max lengths; a batch whose lengths spread wide
gets per-read drifting windows instead, so the width stops paying the
spread.

Only the fill primitives look at the device: the ladder always lays its
windows out as the accelerator kernels need them (128-aligned starts,
width + 128), so a CPU run walks the same tiers as a run on the card.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..graphs.flat import FlatGraph
from ..ops.cuda_fill import (
    banded_scores,
    banded_scores_2p,
    drift_ef_scores,
    drift_scores,
    drift_scores_2p,
    ef_scores,
    prepare_banded,
    prepare_banded_drift,
)
from ..ops.dp_rows import INF
from ..utils import spans
from ..utils.mesh import check_mesh, dp_shards
from .costs import EndsFree
from .wavefront import (
    NODE_BUCKET,
    DeviceGraph,
    _round_up,
    dp_fill_scores,
    dp_fill_scores_ends_free,
    ends_free_device_params,
)


def _pad_to_pow2_blocks(rows: int, block: int = 64) -> int:
    """A row count padded up to a power-of-two number of 64-row blocks.
    The tier cost model keeps the reference's padding so that the ladder
    reaches the same ub hints."""
    if rows <= 0:
        return 0
    blocks = 1
    while blocks * block < rows:
        blocks <<= 1
    return blocks * block


def _free_allowances(aln_type) -> Tuple[bool, int, int]:
    """(free_start, qv, gv): whether the graph begin is free, and the
    largest free query suffix / graph-end distance an alignment span
    allows (False, 0, 0 for a global span)."""
    BIG = 1 << 30
    if not isinstance(aln_type, EndsFree):
        return False, 0, 0
    free_start = aln_type.graph_free_begin[0] == "unbounded"
    qk, qval = aln_type.qry_free_end
    qv = BIG if qk == "unbounded" else (
        qval if qk == "included" else max(qval - 1, 0))
    gk, gval = aln_type.graph_free_end
    gv = BIG if gk == "unbounded" else (
        gval if gk == "included" else max(gval - 1, 0))
    return free_start, qv, gv


def _gap_budget(costs, ub: int) -> int:
    """The longest gap a path of cost <= ub can hold.  Two-piece costs
    count every gap at e2: a long gap opens on piece 1 and extends on
    piece 2, and e2 <= e1 only over-covers the window (more work, never
    less exactness)."""
    o = costs.gap_open
    e = costs.gap_extend2 if costs.is_two_piece else costs.gap_extend
    return max((ub - o) // e, 0) if ub >= o + e else 0


def band_windows(flat: FlatGraph, n_min: int, n_max: int, costs, ub: int,
                 aln_type=None
                 ) -> Tuple[np.ndarray, int, np.ndarray, np.ndarray]:
    """Per-rank window starts + width covering all bound <= ub cells.

    ``aln_type``: None or Global for the global corridor; an ``EndsFree``
    span relaxes the bound terms: a free graph begin drops the
    deletions-before requirement, a free query suffix of qv lowers the
    insertions-after requirement (n -> n - qv), and a free graph end
    within distance gv lowers the deletions-after requirement
    (de_min -> de_min - gv).  Relaxed terms only widen the window, so it
    still covers every bound <= ub cell.

    Returns (wstart (N,), width, lo, hi)."""
    K = _gap_budget(costs, ub)
    free_start, qv, gv = _free_allowances(aln_type)

    ds_min = flat.min_dist_from_start.astype(np.int64)
    ds_max = flat.max_dist_from_start.astype(np.int64)
    de_min = flat.min_dist_to_end.astype(np.int64)
    de_max = flat.max_dist_to_end.astype(np.int64)

    lo_terms = [
        np.zeros_like(ds_min),
        (n_min - qv - de_max + 1) - K,
    ]
    if not free_start:
        # with a free graph begin a path may enter at any node
        lo_terms.append(ds_min - K)
    lo = np.maximum.reduce(lo_terms)
    hi = np.minimum.reduce([
        np.full_like(ds_min, n_max),
        ds_max + K,
        (n_max - np.maximum(de_min - gv, 0) + 1) + K,
    ])
    hi = np.maximum(hi, lo)  # degenerate ranks keep a 1-wide window

    # one column left: the kernels substitute INF for local column 0's
    # diagonal predecessor, which is sound only if that column is
    # infeasible (global j = 0 has no diagonal predecessor at all)
    lo = np.maximum(lo - 1, 0)

    width = int((hi - lo + 1).max())
    width = _round_up(max(width, 128), 128)
    wstart = np.minimum(lo, np.maximum(hi - width + 1, 0)).astype(np.int32)
    return wstart, width, lo, hi


def drift_steps_for(n_min: int, n_max: int) -> int:
    """Number of 128-lane drift steps for a batch's length spread, rounded
    up to a power of two (the kernels divide by it with a shift)."""
    S = (max(n_max - n_min, 0) + 127) // 128
    if S <= 0:
        return 0
    p = 1
    while p < S:
        p <<= 1
    return p


def band_windows_drift(flat: FlatGraph, n_min: int, n_max: int, costs,
                       ub: int, S: int, aln_type=None):
    """Per-rank window starts + width + step schedule for drifting windows.

    Each read's window is the shared per-rank frame shifted right by its
    own drift sigma_b(r) = 128 * floor(nbs_b * s_r / S), where
    nbs_b = round((n_b - n_min) / 128) and s_r is the cumulative step count
    at rank r (0 at rank 0, S at the end rank).  The drift absorbs the
    batch's length spread, so the width no longer pays n_max - n_min.

    Soundness: the drifted corridor is evaluated at every 128-length level,
    which are exactly the kernels' drift levels.  Within a level all reads
    share sigma, their lengths vary by <= 64 and every lo/hi term has slope
    in [0, 1] in n, so a +-160 pad covers the level; levels infeasible by
    more than 192 are left out (a clamped corridor for reads that cannot
    visit a rank would drag the union wide).  Windows, width and schedule
    depend only on (n_min, n_max, ub), so callers cache them.

    ``aln_type``: an ``EndsFree`` span relaxes the same terms as in
    :func:`band_windows`.  A free graph begin is refused: it anchors the
    corridors at a corner, not on a diagonal, and drift cannot narrow them.

    Returns (wstart (N,) int32 multiples of 128, which are frame
    coordinates and may be negative, width multiple of 128, s_ranks (N,)
    int32)."""
    K = _gap_budget(costs, ub)
    free_start, qv, gv = _free_allowances(aln_type)
    if free_start:
        raise ValueError("drifting windows do not take a free graph begin")
    N = flat.n_nodes

    ds_min = flat.min_dist_from_start.astype(np.int64)
    ds_max = flat.max_dist_from_start.astype(np.int64)
    de_min = flat.min_dist_to_end.astype(np.int64)
    de_max = flat.max_dist_to_end.astype(np.int64)

    ranks = np.arange(N, dtype=np.int64)
    s_ranks = (S * ranks) // max(N - 1, 1)
    s_ranks[-1] = S  # the end rank carries the full drift
    nbs_max = (n_max - n_min + 64) // 128

    levels = np.arange(nbs_max + 1, dtype=np.int64)  # (G,)
    n_rep = n_min + 128 * levels  # representative length per level
    sig = 128 * ((levels[:, None] * s_ranks[None, :]) // max(S, 1))  # (G, N)

    lo_g = np.maximum.reduce([
        -sig,
        ds_min[None, :] - K - sig,
        (n_rep[:, None] - qv - de_max[None, :] + 1) - K - sig,
    ])
    hi_g = np.minimum.reduce([
        n_rep[:, None] - sig,
        ds_max[None, :] + K - sig,
        (n_rep[:, None] - np.maximum(de_min[None, :] - gv, 0) + 1) + K - sig,
    ])
    valid = (lo_g - hi_g) <= 192
    BIG = 1 << 40
    lo = np.where(valid, np.minimum(lo_g, hi_g) - 160, BIG).min(axis=0)
    hi = np.where(valid, np.maximum(lo_g, hi_g) + 160, -BIG).max(axis=0)
    # ranks on no level's corridor never carry finite scores: any 1-wide
    # window will do
    none_valid = ~valid.any(axis=0)
    fallback = np.clip(ds_min - K, 0, None)
    lo = np.where(none_valid, fallback, lo)
    hi = np.where(none_valid, fallback, hi)
    lo -= 1  # local column 0's INF diagonal substitute (see band_windows)
    hi = np.maximum(hi, lo)

    # a read's global window is wstart + sigma_b >= 0; cells at global
    # j < 0 stay INF by induction (the origin seed at j == 0 is the only
    # source), and the query carries a left pad of -min(wstart) zero lanes
    width = int((hi - lo + 1).max())
    # +128 absorbs the floor-to-128 of wstart below
    width = _round_up(max(width, 128), 128) + 128
    wstart = np.floor_divide(lo, 128) * 128
    return wstart.astype(np.int32), width, s_ranks.astype(np.int32)


def ins_run_cap(costs, ub: int, width: int) -> int:
    """Power-of-two cap on insertion-run length for an <= ub fill, or 0
    when the cap would not be narrower than the band.

    A path of cost <= ub spends at most K = (ub - o) // e on one insertion
    run, so the insertion scan only needs to look back 2^ceil(log2 K)
    lanes.  Under two-piece costs a run opens at o1 + e1 and every further
    lane costs at least min(e1, e2) (piece 2 is entered from piece 1 at
    e2, not at gap_open2), so K = (ub - o1) // min(e1, e2).  Truncation
    only removes candidate predecessors: the fill still only
    over-estimates, and a score <= ub is still exact.
    """
    o, e = costs.gap_open, costs.gap_extend
    if costs.is_two_piece:
        e = min(e, costs.gap_extend2)
    K = max((ub - o) // e, 1) if ub >= o + e else 1
    cap = 1
    while cap < K:
        cap <<= 1
    return cap if cap < width else 0


# after a capped ladder falls through on INF (unalignable) rows, callers
# skip the ladder for this many calls of that shape before probing again
LADDER_INF_SKIP = 8


def run_capped_ladder(costs, L: int, ub0: int, fill_capped, fill_plain):
    """Verify-and-retry ladder over the insertion-run cap (exactness
    argument in :func:`ins_run_cap`).

    ``fill_capped(cap)`` and ``fill_plain()`` return a tuple whose first
    element is the numpy score array; an error from either propagates.
    Scores above ub (or INF rows, which the cap may have caused) retry the
    whole batch at 4x until the cap stops binding, then the plain fill
    runs.  Returns ``(result, hint)``:

    * positive int: every row verified; the max score (at least 1), to
      seed the next call's ub;
    * ``0``: fell through to the plain fill and the exact result holds INF
      rows.  No ub can verify those, so a caller that scores similar
      batches again should go straight to the plain fill for a while;
    * ``None``: fell through with all-finite scores (the first ub guess
      was low); callers seed their hint from the result's max.
    """
    ub = ub0
    while True:
        cap = ins_run_cap(costs, ub, L)
        if cap == 0:
            break  # cap no narrower than the row: plain fill
        with spans.span("ladder.tier", ub=ub, cap=cap):
            out = fill_capped(cap)
            verified = bool((out[0] <= ub).all())
        if verified:
            return out, max(int(out[0].max()), 1)
        ub *= 4
    out = fill_plain()
    return out, (0 if (np.asarray(out[0]) >= INF).any() else None)


class BandedScorer:
    """Exact banded scorer with tiered verify-and-retry, under one-piece
    (``GapAffine``) or two-piece (``GapAffine2Piece``) costs.

    Usage: ``BandedScorer(flat, costs, aln_type=span).scores(qshift,
    lengths)`` with the batch from :func:`..wavefront.pack_queries`.
    ``device``: where the graph is laid out when no ``dg`` is given (None:
    the card, or the mesh's first device), its rank rows padded to a
    multiple of ``node_bucket``.  ``aln_type``: None or Global for global
    alignment; an ``EndsFree`` span scores through the ends-free fills; with
    two-piece costs every batch takes the bounded full fill under the
    capped ladder.

    ``mesh``: a port mesh (:mod:`..utils.mesh`) splits every fill's reads
    over its dp axis, each shard's fill (B1, B3, B16, B17, and the full
    fill B2 or B12) launched on the first device of its mesh row with the
    graph and the window tables replicated there once; the sp axis
    replicates, as it does for the reference's banded fills.  As in the
    reference, a tier that leaves reads unverified refills the whole batch
    (no sub-batch), and a mesh does not take an ends-free span.  A shard's
    error reaches the caller.
    """

    # modelled fixed cost of one fill, in cells: biases the tier choice
    # toward fewer fills unless the band savings are substantial
    TIER_OVERHEAD_CELLS = 1_000_000_000
    # least batch length spread at which drifting windows can pay: their
    # layout carries ~384 lanes of soundness padding over the shared one
    DRIFT_MIN_SPREAD = 512

    def __init__(self, flat: FlatGraph, costs,
                 node_bucket: int = NODE_BUCKET, mesh=None,
                 dg: Optional[DeviceGraph] = None, aln_type=None, *,
                 device=None):
        check_mesh(mesh)
        self.flat = flat
        self.costs = costs
        self.mesh = mesh
        self.aln_type = aln_type
        self.ends_free = isinstance(aln_type, EndsFree)
        if self.ends_free and mesh is not None:
            raise NotImplementedError(
                "ends-free banded scoring does not shard over a mesh yet; "
                "use mesh=None (or dp_fill_scores_ends_free for full "
                "fills)")
        if device is None and mesh is not None:
            device = mesh.first
        self.dg = dg.placed() if dg is not None \
            else DeviceGraph.build(flat, node_bucket, device=device)
        # window layouts + their device tables, per (n_min, n_max, ub, L)
        # (shared) or ("drift", n_min, n_max, ub, L); plus the span's
        # static end_ok mask and the per-profile ("fullfill", ...) marks
        self._prep_cache: dict = {}
        # last ub that verified, per (n_min, n_max); the capped full
        # fill's hints live under ("ef_full_ub", ...)
        self._ub_hint: dict = {}
        self.stats = {"fills": 0, "cells_filled": 0, "tiers": 0,
                      "fullfill_fallbacks": 0}
        self.last_attempts = 0
        self._last_fill_width = 0
        self._last_fill_exact = False

    def reset_stats(self) -> None:
        for k in self.stats:
            self.stats[k] = 0

    def _filled(self, cells: int) -> None:
        """Add ``cells`` to ``stats["cells_filled"]`` and to the
        ``cells.ladder`` counter."""
        self.stats["cells_filled"] += cells
        spans.count("cells.ladder", cells)

    def _ef_params(self, lengths):
        """(free_start, end_ok, jlo) of the scorer's span for a batch;
        end_ok is static per scorer."""
        fs, end_ok, jlo = ends_free_device_params(
            self.flat, self.aln_type, lengths, self.dg.n_nodes_padded,
            self.costs.is_two_piece)
        end_ok = self._prep_cache.setdefault(("ef_static",), end_ok)
        return fs, end_ok, jlo

    def _full_scores(self, qshift, lengths, len_key=None) -> np.ndarray:
        """Full-width scores.  An ends-free span runs the bounded fill
        under the insertion-run-capped ladder (:func:`run_capped_ladder`),
        its ub hint kept per ``len_key`` (the batch's (n_min, n_max); a
        retry tail is keyed by its row width)."""
        if not self.ends_free:
            with spans.span("ladder.full_fill"):
                return self._on_shards(None, dp_fill_scores, qshift, lengths)
        costs = self.costs
        L = int(qshift.shape[1])

        def fill(cap=0):
            with spans.span("ladder.full_fill", cap=cap):
                return (dp_fill_scores_ends_free(
                    self.dg, self.flat, qshift, lengths, costs,
                    self.aln_type, max_run=cap).cpu().numpy(),)

        key = ("ef_full_ub",) + (len_key if len_key is not None else (L,))
        hint = self._ub_hint.get(key)
        if hint is not None and hint <= 0:
            # INF rows seen lately at this shape: no ub can verify them,
            # so skip the ladder, and probe again after the countdown
            if hint < 0:
                self._ub_hint[key] = hint + 1
            else:
                self._ub_hint.pop(key)
            return fill()[0]
        ub = hint or ((costs.gap_open + costs.gap_extend) * 4
                      + costs.mismatch * max(L // 16, 4))
        out, vmax = run_capped_ladder(costs, L, ub, fill, fill)
        if vmax == 0:
            self._ub_hint[key] = -LADDER_INF_SKIP
        elif vmax is None:
            finite = out[0][out[0] < INF]
            if finite.size:
                self._ub_hint[key] = max(int(finite.max()), 1)
        else:
            self._ub_hint[key] = vmax
        return out[0]

    def _fill_once_drift(self, qshift, lengths, ub, n_min, n_max):
        """One banded fill with per-read drifting windows: its (possibly
        over-estimated) scores, or None when drift does not apply (graph
        shorter than the length spread, a free graph begin, or a layout no
        narrower than the shared one or than the row)."""
        costs = self.costs
        S = drift_steps_for(n_min, n_max)
        # frames move 128 lanes per stepping rank, so the schedule may
        # step at most once a rank: S <= N - 1
        if S == 0 or S > self.flat.n_nodes - 1:
            return None
        if self.ends_free and _free_allowances(self.aln_type)[0]:
            return None
        L = int(qshift.shape[1])
        key = ("drift", n_min, n_max, ub, L)
        cached = self._prep_cache.get(key)
        if cached is None:
            with spans.span("ladder.prep", drift=True):
                cached = self._prep_drift(n_min, n_max, ub, S, L)
            self._prep_cache[key] = cached
        width, prep = cached
        if width is None:
            return None
        self._last_fill_width = width
        q_in = torch.nn.functional.pad(
            qshift, (prep["mq"], max(prep["L"] - L, 0)))
        max_run = ins_run_cap(costs, ub, width)
        with spans.span("ladder.fill", drift=True):
            if self.ends_free:
                # a bounded span is anchored on a diagonal like the global
                # corridor, so drift applies unchanged; only the end rules
                # differ
                _, end_ok, jlo = self._ef_params(lengths)
                return drift_ef_scores(self.dg, q_in, lengths, costs, prep,
                                       n_min, end_ok, jlo,
                                       max_run=max_run).cpu().numpy()
            fill = drift_scores_2p if costs.is_two_piece else drift_scores
            return self._on_shards(key, fill, q_in, lengths, prep, n_min,
                                   max_run=max_run)

    def _prep_drift(self, n_min, n_max, ub, S, L):
        """(width, the drift tables) of a drifting layout, or (None, None)
        where it is no narrower than the shared one or than the row."""
        costs = self.costs
        wstart, width, s_ranks = band_windows_drift(
            self.flat, n_min, n_max, costs, ub, S, aln_type=self.aln_type)
        # the shared layout runs the same fill at the same speed per cell:
        # drift pays only when it is narrower
        shared_width = band_windows(self.flat, n_min, n_max, costs, ub,
                                    aln_type=self.aln_type)[1] + 128
        if width + 128 < shared_width and width < L:
            req = _round_up(int(wstart.max()) + width, 128)
            return width, prepare_banded_drift(
                self.dg, costs, wstart, width, s_ranks, S, max(L, req))
        return None, None

    def _fill_once(self, qshift, lengths, ub, n_min, n_max) -> np.ndarray:
        """One banded fill of the batch on shared windows at ``ub``: its
        (possibly over-estimated) scores."""
        costs = self.costs
        L = int(qshift.shape[1])
        key = (n_min, n_max, ub, L)
        cached = self._prep_cache.get(key)
        if cached is None:
            with spans.span("ladder.prep"):
                wstart, width, _, _ = band_windows(self.flat, n_min, n_max,
                                                   costs, ub,
                                                   aln_type=self.aln_type)
                # 128-aligned starts keep the kernels' window reads aligned
                wstart = (wstart // 128) * 128
                width += 128
                if width >= L:
                    # as wide as the row: every offset is in the window, so
                    # the fill is exact with zeroed starts
                    wstart = np.zeros_like(wstart)
                    width = L
                q_len = max(L, _round_up(int(wstart.max()) + width, 128))
                prep = prepare_banded(self.dg, costs, wstart, width, q_len)
            cached = (wstart, width, q_len, prep)
            self._prep_cache[key] = cached
        wstart, width, q_len, prep = cached
        self._last_fill_width = width
        # full-width windows compute every cell: the caller may accept the
        # scores without the <= ub check, so the scan must not be capped
        # here (poasta_tpu still caps this tier; see ROADMAP fault C1)
        self._last_fill_exact = width >= L and int(wstart.max()) == 0
        max_run = 0 if self._last_fill_exact \
            else ins_run_cap(costs, ub, width)
        with spans.span("ladder.fill"):
            q_in = qshift
            if q_len > L:
                q_in = torch.nn.functional.pad(qshift, (0, q_len - L))
            if self.ends_free:
                fs, end_ok, jlo = self._ef_params(lengths)
                return ef_scores(self.dg, q_in, lengths, costs, prep, fs,
                                 end_ok, jlo, max_run=max_run).cpu().numpy()
            fill = banded_scores_2p if costs.is_two_piece else banded_scores
            return self._on_shards(key, fill, q_in, lengths, prep,
                                   max_run=max_run)

    def _on_shards(self, key, fill, q, lengths, *args,
                   **kwargs) -> np.ndarray:
        """``fill(dg, q, lengths, costs, *args, **kwargs)`` on each dp
        shard of the mesh (without one, on the graph's device): the graph
        and a window layout's tables (``args[0]``, kept under ``key``)
        replicated once per device, the reads split.  Every shard is
        launched before any is read back, so shards on distinct cards
        overlap; the scores are gathered on the host."""
        outs = []
        for dev, rows in dp_shards(self.mesh, int(q.shape[0]),
                                   self.dg.device):
            shard_args = args
            if key is not None and dev != self.dg.device:
                pkey = key + ("on", dev)
                prep = self._prep_cache.get(pkey)
                if prep is None:
                    prep = {k: v.to(dev) if torch.is_tensor(v) else v
                            for k, v in args[0].items()}
                    self._prep_cache[pkey] = prep
                shard_args = (prep,) + args[1:]
            outs.append(fill(self.dg.on(dev), q[rows].to(dev),
                             lengths[rows].to(dev), self.costs, *shard_args,
                             **kwargs))
        return np.concatenate([o.cpu().numpy() for o in outs])

    def scores(self, qshift, lengths, ub: Optional[int] = None,
               max_retries: int = 4) -> np.ndarray:
        """Exact scores with tiered verify-and-retry.

        Reads whose banded score verifies at the current ub are done; only
        the unresolved reads re-fill at a wider band, so per-read work
        scales with that read's own score.
        """
        costs = self.costs
        lengths_np = lengths.cpu().numpy()
        n_min, n_max = int(lengths_np.min()), int(lengths_np.max())
        if (costs.is_two_piece and self.ends_free) \
                or self._prep_cache.get(("fullfill", n_min, n_max)):
            # no banded or drift kernel serves two-piece costs under an
            # ends-free span (nor does poasta_tpu have one); otherwise
            # banding already proved unprofitable for this length profile
            self.stats["fills"] += 1
            self._filled(self.flat.n_nodes * int(qshift.shape[1])
                         * int(qshift.shape[0]))
            return self._full_scores(qshift, lengths, (n_min, n_max))

        # drift serves global spans and bounded ends-free spans; a free
        # graph begin stays on shared windows
        drift_ok = not (self.ends_free
                        and _free_allowances(self.aln_type)[0])
        drift_eligible = drift_ok \
            and n_max - n_min >= self.DRIFT_MIN_SPREAD
        if ub is None:
            guess = ((costs.gap_open + costs.gap_extend) * 4
                     + costs.mismatch * max(n_max // 16, 4))
            if not drift_eligible and not self.ends_free:
                # shared windows absorb the batch's length spread in the
                # band, so the score guess carries it; drifting windows do
                # not, and free ends absorb a length mismatch at no cost
                guess += costs.gap_extend * (n_max - n_min)
            ub = self._ub_hint.get((n_min, n_max)) or guess

        B = int(qshift.shape[0])
        # under a mesh a tier that leaves reads unverified refills the whole
        # batch, as the reference's does: no sub-batch gathers, no quantile
        # tier
        use_mesh = self.mesh is not None
        out = np.empty(B, dtype=np.int32)
        resolved = np.zeros(B, dtype=bool)
        map_idx = np.arange(B)  # out positions of the current sub-batch
        q_cur, l_cur = qshift, lengths
        tiers = []  # (ub, newly_resolved) per attempt
        self.last_attempts = 0
        # retry tails re-derive their own length bounds, so their windows
        # do not pay the whole batch's length spread
        cur_n_min, cur_n_max = n_min, n_max
        for attempt in range(max_retries):
            with spans.span("ladder.tier", attempt=attempt, ub=ub):
                done, sub = self._tier(q_cur, l_cur, ub, cur_n_min,
                                       cur_n_max, drift_ok)
                with spans.span("ladder.verify"):
                    out[map_idx[done]] = sub[done]
                    new_mask = np.zeros(B, dtype=bool)
                    new_mask[map_idx[done]] = True
                    tiers.append((ub, int((new_mask & ~resolved).sum())))
                    resolved |= new_mask
            # the next call's first tier, or this call's next one
            with spans.span("ladder.plan"):
                if done.all():
                    self._ub_hint[(n_min, n_max)] = self._cheapest_tier(
                        tiers, n_min, n_max, B)
                    return out
                rem = map_idx[~done]
                # banded scores are upper bounds: ub = the max remaining
                # score is sure to verify those reads next time, but a
                # too-narrow band over-estimates wildly, so grow
                # geometrically, capped by it
                finite = sub[~done][sub[~done] < INF]
                grown = max(ub * 2, ub + 256)
                ub = min(int(finite.max()), grown) if finite.size \
                    else grown * 2
                if use_mesh:
                    continue
                # when the tail's scores spread wide, stopping this tier at
                # a score quantile (the narrow bulk verifies now, the wide
                # residue pays one more fill) may beat one max-width fill
                if finite.size >= 4 and attempt + 3 <= max_retries:
                    ub = self._quantile_ub(finite, ub, grown, len(rem),
                                           cur_n_min, cur_n_max)
                idx_dev = torch.as_tensor(rem, device=qshift.device)
                q_cur = qshift.index_select(0, idx_dev)
                l_cur = lengths.index_select(0, idx_dev)
                map_idx = rem
                cur_n_min = int(lengths_np[rem].min())
                cur_n_max = int(lengths_np[rem].max())

        self.stats["fullfill_fallbacks"] += 1
        if self.last_attempts > 0 and len(map_idx) < B:
            # the band resolved most of the batch: full-fill only the tail,
            # and start future calls at the tier that resolved the most
            self._ub_hint[(n_min, n_max)] = max(tiers, key=lambda t: t[1])[0]
            self._filled(
                self.flat.n_nodes * int(q_cur.shape[1]) * int(q_cur.shape[0]))
            out[map_idx] = self._full_scores(q_cur, l_cur)
            return out

        self._prep_cache[("fullfill", n_min, n_max)] = True
        self._filled(self.flat.n_nodes * int(qshift.shape[1]) * B)
        scores = self._full_scores(qshift, lengths, (n_min, n_max))
        # the first guess may have been so loose that the band was wider
        # than the row; with the true max score known, re-enable banding
        # if a band built from it is narrower
        finite = scores[scores < INF]
        if finite.size:
            tight = int(finite.max())
            width = self._width(n_min, n_max, tight)
            if drift_eligible:
                S = drift_steps_for(n_min, n_max)
                if 0 < S <= self.flat.n_nodes - 1:
                    width = min(width, band_windows_drift(
                        self.flat, n_min, n_max, costs, tight, S,
                        aln_type=self.aln_type)[1])
            if width + 128 < int(qshift.shape[1]):
                self._ub_hint[(n_min, n_max)] = tight
                del self._prep_cache[("fullfill", n_min, n_max)]
        return scores

    def _tier(self, q, lengths, ub, n_min, n_max, drift_ok):
        """One attempt of the ladder: (done, scores) of the reads ``q``,
        done where a score verifies at ``ub`` (every read of an exact
        full-width layout)."""
        sub = None
        self._last_fill_exact = False  # set only by _fill_once
        if drift_ok and n_max - n_min >= self.DRIFT_MIN_SPREAD:
            sub = self._fill_once_drift(q, lengths, ub, n_min, n_max)
        if sub is None:
            sub = self._fill_once(q, lengths, ub, n_min, n_max)
        self.last_attempts += 1
        self.stats["fills"] += 1
        self.stats["tiers"] += 1
        self._filled(self.flat.n_nodes * self._last_fill_width
                     * int(q.shape[0]))
        if self._last_fill_exact:
            return np.ones_like(sub, dtype=bool), sub
        return sub <= ub, sub

    def _width(self, n_min: int, n_max: int, ub: int) -> int:
        return band_windows(self.flat, n_min, n_max, self.costs, ub,
                            aln_type=self.aln_type)[1]

    def _cheapest_tier(self, tiers, n_min: int, n_max: int, B: int) -> int:
        """The starting tier for future calls, by modelled cost: the tier-i
        fill runs the whole batch and each later observed tier refills its
        (padded) unresolved tail, plus a per-fill overhead."""
        ov = self.TIER_OVERHEAD_CELLS / max(self.flat.n_nodes, 1)
        widths = [self._width(n_min, n_max, t) for t, _ in tiers]
        counts = [c for _, c in tiers]
        best_ub, best_cost = tiers[-1][0], None
        for i in range(len(tiers)):
            cum = sum(counts[: i + 1])
            cost = widths[i] * B + ov
            for j in range(i + 1, len(tiers)):
                cost += widths[j] * _pad_to_pow2_blocks(B - cum) + ov
                cum += counts[j]
            if best_cost is None or cost < best_cost:
                best_ub, best_cost = tiers[i][0], cost
        return best_ub

    def _quantile_ub(self, finite, ub: int, grown: int, n_rem: int,
                     n_min: int, n_max: int) -> int:
        """The next tier's ub: the tail's 75th-percentile score when one
        fill there plus a wider one for the residue models cheaper than a
        single fill at the tail's max score."""
        fs = np.sort(finite.astype(np.int64))
        cand_q = int(fs[int(len(fs) * 0.75)])
        top = int(fs[-1])
        if not (cand_q > ub // 2 and cand_q < top):
            return ub
        n_above = int((fs > cand_q).sum())
        t_all = _pad_to_pow2_blocks(n_rem)
        t_abv = _pad_to_pow2_blocks(n_above)
        ov = self.TIER_OVERHEAD_CELLS / max(self.flat.n_nodes, 1)
        cost_max = self._width(n_min, n_max, min(top, grown)) * t_all + ov
        cost_q = (self._width(n_min, n_max, cand_q) * t_all + ov
                  + self._width(n_min, n_max, min(top, grown * 2)) * t_abv
                  + ov)
        return cand_q if cost_q < cost_max else ub
