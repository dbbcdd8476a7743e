"""Banded wavefront scoring with verify-and-retry: port of the global
one-piece part of ``poasta_tpu/aligner/banded.py``.

Every rank fills only a window of offsets chosen so that all states whose
completion-cost lower bound is <= ub lie inside it (min/max graph distance
from the start and to the end bound the gaps before and after).  A banded
score S <= ub is therefore exact; reads above ub retry at a wider band,
and the full-width fill is the last resort.  Windows are shared across a
read batch via its min/max lengths.

Only the fill primitive looks at the device: the ladder always lays its
windows out as the accelerator kernels need them (128-aligned starts,
width + 128), so a CPU run walks the same tiers as a run on the card.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from poasta_tpu.graphs.flat import FlatGraph

from ..ops.cuda_fill import banded_scores, prepare_banded
from ..ops.dp_rows import INF
from .wavefront import DeviceGraph, _round_up, dp_fill_scores


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


def band_windows(flat: FlatGraph, n_min: int, n_max: int, costs, ub: int
                 ) -> Tuple[np.ndarray, int, np.ndarray, np.ndarray]:
    """Per-rank window starts + width covering all bound <= ub cells of
    the global corridor.  Returns (wstart (N,), width, lo, hi)."""
    o, e = costs.gap_open, costs.gap_extend
    K = max((ub - o) // e, 0) if ub >= o + e else 0

    ds_min = flat.min_dist_from_start.astype(np.int64)
    ds_max = flat.max_dist_from_start.astype(np.int64)
    de_min = flat.min_dist_to_end.astype(np.int64)
    de_max = flat.max_dist_to_end.astype(np.int64)

    lo = np.maximum.reduce([
        np.zeros_like(ds_min),
        (n_min - de_max + 1) - K,
        ds_min - K,
    ])
    hi = np.minimum.reduce([
        np.full_like(ds_min, n_max),
        ds_max + K,
        (n_max - np.maximum(de_min, 0) + 1) + K,
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


def ins_run_cap(costs, ub: int, width: int) -> int:
    """Power-of-two cap on insertion-run length for an <= ub fill, or 0
    when the cap would not be narrower than the band.

    A path of cost <= ub spends at most K = (ub - o) // e on one insertion
    run, so the insertion scan only needs to look back 2^ceil(log2 K)
    lanes.  Truncation only removes candidate predecessors: the fill
    still only over-estimates, and a score <= ub is still exact.
    """
    o, e = costs.gap_open, costs.gap_extend
    K = max((ub - o) // e, 1) if ub >= o + e else 1
    cap = 1
    while cap < K:
        cap <<= 1
    return cap if cap < width else 0


class BandedScorer:
    """Exact banded scorer with tiered verify-and-retry, for global
    one-piece costs.

    Usage: ``BandedScorer(flat, costs, device="cuda").scores(qshift,
    lengths)`` with the batch from :func:`..wavefront.pack_queries`.
    """

    # modelled fixed cost of one fill, in cells: biases the tier choice
    # toward fewer fills unless the band savings are substantial
    TIER_OVERHEAD_CELLS = 1_000_000_000

    def __init__(self, flat: FlatGraph, costs,
                 dg: Optional[DeviceGraph] = None, device="cpu"):
        if getattr(costs, "is_two_piece", False):
            raise NotImplementedError("two-piece costs are not ported yet")
        self.flat = flat
        self.costs = costs
        self.dg = dg if dg is not None \
            else DeviceGraph.build(flat, device=device)
        # per (n_min, n_max, ub, L): window layout + its device tables
        self._prep_cache: dict = {}
        # last ub that verified, per (n_min, n_max)
        self._ub_hint: dict = {}
        self.stats = {"fills": 0, "cells_filled": 0, "tiers": 0,
                      "fullfill_fallbacks": 0}
        self.last_attempts = 0
        self._last_fill_width = 0
        self._last_fill_exact = False

    def reset_stats(self) -> None:
        for k in self.stats:
            self.stats[k] = 0

    def _full_scores(self, qshift, lengths) -> np.ndarray:
        return dp_fill_scores(self.dg, qshift, lengths,
                              self.costs).cpu().numpy()

    def _fill_once(self, qshift, lengths, ub, n_min, n_max) -> np.ndarray:
        """One banded fill of the batch at ``ub``: its (possibly
        over-estimated) scores."""
        costs = self.costs
        L = int(qshift.shape[1])
        key = (n_min, n_max, ub, L)
        cached = self._prep_cache.get(key)
        if cached is None:
            wstart, width, _, _ = band_windows(self.flat, n_min, n_max,
                                               costs, ub)
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
        q_in = qshift
        if q_len > L:
            q_in = torch.nn.functional.pad(qshift, (0, q_len - L))
        return banded_scores(self.dg, q_in, lengths, costs, prep,
                             max_run=max_run).cpu().numpy()

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
        if ub is None:
            # shared windows absorb the batch's length spread, so the
            # score guess carries it
            guess = ((costs.gap_open + costs.gap_extend) * 4
                     + costs.mismatch * max(n_max // 16, 4)
                     + costs.gap_extend * (n_max - n_min))
            ub = self._ub_hint.get((n_min, n_max)) or guess

        if self._prep_cache.get(("fullfill", n_min, n_max)):
            # banding already proved unprofitable for this length profile
            self.stats["fills"] += 1
            self.stats["cells_filled"] += (
                self.flat.n_nodes * int(qshift.shape[1]) * int(qshift.shape[0]))
            return self._full_scores(qshift, lengths)

        B = int(qshift.shape[0])
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
            sub = self._fill_once(q_cur, l_cur, ub, cur_n_min, cur_n_max)
            self.last_attempts += 1
            self.stats["fills"] += 1
            self.stats["tiers"] += 1
            self.stats["cells_filled"] += (
                self.flat.n_nodes * self._last_fill_width * int(q_cur.shape[0]))
            if self._last_fill_exact:
                done = np.ones_like(sub, dtype=bool)
            else:
                done = sub <= ub
            out[map_idx[done]] = sub[done]
            new_mask = np.zeros(B, dtype=bool)
            new_mask[map_idx[done]] = True
            tiers.append((ub, int((new_mask & ~resolved).sum())))
            resolved |= new_mask
            if done.all():
                self._ub_hint[(n_min, n_max)] = self._cheapest_tier(
                    tiers, n_min, n_max, B)
                return out
            rem = map_idx[~done]
            # banded scores are upper bounds: ub = the max remaining score
            # is sure to verify those reads next time, but a too-narrow
            # band over-estimates wildly, so grow geometrically, capped by it
            finite = sub[~done][sub[~done] < INF]
            grown = max(ub * 2, ub + 256)
            ub = min(int(finite.max()), grown) if finite.size else grown * 2
            # when the tail's scores spread wide, stopping this tier at a
            # score quantile (the narrow bulk verifies now, the wide
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
            self.stats["cells_filled"] += (
                self.flat.n_nodes * int(q_cur.shape[1]) * int(q_cur.shape[0]))
            out[map_idx] = self._full_scores(q_cur, l_cur)
            return out

        self._prep_cache[("fullfill", n_min, n_max)] = True
        self.stats["cells_filled"] += self.flat.n_nodes * int(qshift.shape[1]) * B
        scores = self._full_scores(qshift, lengths)
        # the first guess may have been so loose that the band was wider
        # than the row; with the true max score known, re-enable banding
        # if a band built from it is narrower
        finite = scores[scores < INF]
        if finite.size:
            tight = int(finite.max())
            if self._width(n_min, n_max, tight) + 128 < int(qshift.shape[1]):
                self._ub_hint[(n_min, n_max)] = tight
                del self._prep_cache[("fullfill", n_min, n_max)]
        return scores

    def _width(self, n_min: int, n_max: int, ub: int) -> int:
        return band_windows(self.flat, n_min, n_max, self.costs, ub)[1]

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
