"""k-mer seeding + post-hoc optimality certificates for mapping fills.

The free-begin bounded fill pays ``n_ranks x L`` cells per read because
every rank can start an alignment — on a 50k-rank pangenome each 5 kb
read fills the *whole graph* even though it maps to one ~5 kb locus
(the round-3 long pole: the fill kernel is at its measured VPU roofline,
so the only lever left is filling fewer cells).  The reference has no
analogue — its A* explores near the best path by heuristic
(``src/aligner/astar.rs`` upstream); this module is the batch
equivalent: guess each read's locus from exact k-mer hits, fill only a
corridor around it, then PROVE post hoc that no alignment outside the
corridor can match the corridor's score.

Why post hoc: round 4's a-priori certificate required every cost<=ub
alignment to contain a k-mer hit with ``E = ub // min(mismatch,
extend)`` edited characters — at mapping-grade divergence (the bench's
1.5%, ub ~2100 on 5 kb reads) that bound admits guaranteed exact runs
of only ~4 bp, so the certificate never engaged and the corridor path
was provably inert on its own target workload (round-4 VERDICT).  Two
changes fix it:

1. **Count interruptions, not edited characters.**  An exact query run
   (consecutive query chars matching a contiguous graph path) is broken
   only by an *interruption event*: one mismatched char (cost >=
   mismatch) or one maximal gap run (cost >= gap_open + gap_extend,
   however long).  A cost<=c alignment therefore has at most
   ``I = c // min(mismatch, open+extend)`` interruptions and loses at
   most ``R = c // min(mismatch, extend)`` query chars to mismatches /
   insertions, so its >= ``jlo - R`` exact-matched chars sit in
   <= ``I + 1`` runs.  Packing runs at length k-1 leaves
   ``T = (jlo - R) - (I + 1)(k - 1)`` chars that MUST extend runs past
   k: every cost<=c alignment contains **at least T distinct k-mer
   hits** (all inside one diagonal window of width ``K = c // extend``
   — two cells of one alignment drift by at most its gap chars).
   At the bench operating point (jlo=5000, c~1650, costs 4/6/2, k=10)
   T ~ 450; round 4's per-character bound said "no guarantee".
2. **Certify with the achieved score, not the a-priori ub.**  The
   corridor fill is exact inside the corridor and windows only raise DP
   values, so its returned score ``s >= s_true``.  Run the step-1
   counting at ``c = s``: if every diagonal window of width K that
   intersects >= T of the read's hits lies inside the corridor, then
   any alignment with cost <= s lives entirely inside the corridor
   (each of its cells is within the gap budget of its own hits), so the
   corridor saw it: ``s = s_true``, and every true-tie end state was
   compared, so the (largest-offset, lowest-rank) end choice is
   identical to the full fill's.  Reads that fail the check (or return
   score > ub) fall back to the full fill — the certificate gates
   *savings*, never correctness.

Exterior-window check, concretely: hits whose potential interval lies
inside the proposal cluster ``[A*, B*]`` (with slack ``K_ub - K``)
already imply corridor containment for any alignment through them; only
*exterior* hits can carry an all-exterior alignment, and such an
alignment needs >= T exterior hits co-windowed within width K.  So the
check is a max-overlap sweep over exterior hit intervals
``[alpha_h - K, beta_h]`` — pass iff the max count < T.

Soundness requirements (checked, not assumed): query chars and all
real graph symbols must be ACGT (a non-ACGT exact match would not be in
the index); ``min(mismatch, extend) > 0``; query offsets start at 0
(``qry_free_begin`` is parsed-but-ignored, as in the reference) and
>= jlo chars are consumed.

Engagement envelope: T > 0 requires
``c < (jlo - (k-1)) / (1/c_rm + (k-1)/c_int)`` — for 5 kb reads at
costs 4/6/2 and k=10 that is c < ~1815, i.e. ~2% divergence; higher-
divergence reads fall back (and the index k adapts down on small
graphs / up on huge ones via :func:`k_for_graph`).

Reference behavioral parity: the corridor path returns bit-identical
(score, end_rank, end_offset) to ``dp_fill_ends_free_with_ends``
(ties resolve to the largest offset, then the lowest rank — the
reference's end-state convention, ``gap_affine.rs:219-241``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np

# byte -> 2-bit code; 255 marks non-ACGT (virtual '#'/'$' ranks, padding,
# ambiguity codes) — any k-window touching one never produces a hit
CODE = np.full(256, 255, dtype=np.uint8)
for _i, _ch in enumerate(b"ACGT"):
    CODE[_ch] = _i

SEED_K = 14      # largest index k (tiny graphs: ~0 spurious hits)
SEED_K_MIN = 8   # smallest: 4^8 = 65k keeps spurious hits bounded


def k_for_graph(n_nodes: int) -> int:
    """Index k for a graph of ``n_nodes``: the smallest k in
    [SEED_K_MIN, SEED_K] with ``4^k >= 8 * n_nodes`` — expected spurious
    hits per read stay ~L/8 while T (which shrinks as k grows) stays as
    large as possible.  The certificate is sound at ANY k; this only
    tunes the engagement envelope."""
    k = SEED_K_MIN
    while (1 << (2 * k)) < 8 * max(n_nodes, 1) and k < SEED_K:
        k += 1
    return k


class SeedHits(NamedTuple):
    """All exact k-mer hits of a read batch, grouped by read.

    ``alpha/beta``: per-hit potential interval ``[j - dmax[r],
    j - dmin[r]]`` (j = consumed query chars at the hit's end cell,
    r its end rank).  ``start[b]:start[b+1]`` slices read b's hits.
    ``clean[b]``: read b is all-ACGT over its consumed span (a
    certificate prerequisite — a non-ACGT char could exact-match a
    same-byte graph symbol without appearing in the index).
    """

    alpha: np.ndarray   # (H,) int64
    beta: np.ndarray    # (H,) int64
    start: np.ndarray   # (B+1,) int64 — CSR offsets per read
    clean: np.ndarray   # (B,) bool


class KmerIndex:
    """All k-length graph paths, as a sorted (kmer -> end-rank) table.

    ``ok`` is False when the graph is unsupported: a path-count blowup
    past ``budget_factor * n_nodes`` aborts the build (seeding then
    stays disabled for this graph), and ``all_acgt`` records whether
    every real node symbol is ACGT — required by the certificate (a
    non-ACGT graph symbol could exact-match a query byte without being
    enumerated here).
    """

    def __init__(self, flat, k: Optional[int] = None,
                 budget_factor: int = 64):
        self.k = k if k is not None else k_for_graph(flat.n_nodes)
        k = self.k
        self.ok = False
        self.all_acgt = False
        n = flat.n_nodes
        if n < k + 2:
            return
        codes = CODE[flat.symbols]
        real = np.nonzero(codes != 255)[0].astype(np.int64)
        if real.size == 0:
            return
        # ranks 0 / end_rank are the virtual '#'/'$'; every other rank
        # must be ACGT for exact-match enumeration to be exhaustive
        self.all_acgt = real.size >= n - 2
        succ_ptr = flat.succ_ptr.astype(np.int64)
        succ_idx = flat.succ_idx.astype(np.int64)
        budget = budget_factor * n
        cur = real
        km = codes[cur].astype(np.int64)
        for _ in range(k - 1):
            cnt = succ_ptr[cur + 1] - succ_ptr[cur]
            total = int(cnt.sum())
            if total > budget:
                return  # bubbly blowup: leave ok=False
            rep = np.repeat(np.arange(cur.size, dtype=np.int64), cnt)
            off = (np.arange(total, dtype=np.int64)
                   - np.repeat(np.cumsum(cnt) - cnt, cnt))
            nxt = succ_idx[succ_ptr[cur][rep] + off]
            c2 = codes[nxt].astype(np.int64)
            keep = c2 != 255
            cur = nxt[keep]
            km = (km[rep][keep] << 2) | c2[keep]
            if cur.size == 0:
                return
        order = np.argsort(km, kind="stable")
        self.kmers = km[order]
        dmin = flat.min_dist_from_start.astype(np.int64)
        dmax = flat.max_dist_from_start.astype(np.int64)
        self.post_dmin = dmin[cur[order]]
        self.post_dmax = dmax[cur[order]]
        self.n_paths = int(cur.size)
        # direct-address range table: lookups become two O(1) gathers
        # instead of searchsorted (measured 0.10 s/batch -> ~1 ms at
        # pangenome shapes); 4^k+1 int64 entries = 8.4 MB at k=10
        self.start_tab = None
        if k <= 11:
            counts = np.bincount(self.kmers, minlength=1 << (2 * k))
            tab = np.zeros((1 << (2 * k)) + 1, dtype=np.int64)
            np.cumsum(counts, out=tab[1:])
            self.start_tab = tab
        self.ok = True

    def seed_hits(self, q_np: np.ndarray, lengths_np: np.ndarray,
                  max_hits: int = 8_000_000) -> Optional[SeedHits]:
        """Every exact k-mer hit of every read, grouped by read.

        ``q_np`` is the ``pack_queries`` layout (column j holds
        ``q[j-1]``; column 0 and padding are 0 -> code 255, so windows
        into padding never match).  Returns None when the batch's total
        hit count exceeds ``max_hits`` (repeat blowup — caller falls
        back to the full fill).
        """
        k = self.k
        B, L = q_np.shape
        codes = CODE[np.asarray(q_np, dtype=np.uint8)
                     if q_np.dtype == np.uint8
                     else np.clip(q_np, 0, 255).astype(np.uint8)]
        bad = codes == 255
        # consumed span is columns 1..n_b; column 0 / padding are 255
        cum_bad = np.zeros((B, L + 1), dtype=np.int64)
        np.cumsum(bad, axis=1, out=cum_bad[:, 1:])
        nidx = np.clip(lengths_np.astype(np.int64), 0, L - 1)
        rows = np.arange(B)
        clean = (cum_bad[rows, nidx + 1] - cum_bad[rows, 1]) == 0
        # rolling k-mer build: k shifted adds over (B, nwin) slices
        # instead of materializing a (B, L, k) window tensor (the
        # window-sum form cost ~0.14 s/batch at pangenome shapes)
        nwin = L - k + 1
        qk = np.zeros((B, nwin), dtype=np.int64)
        c64 = codes.astype(np.int64)
        for i in range(k):
            qk += c64[:, i:i + nwin] << (2 * (k - 1 - i))
        good = (cum_bad[:, k:] - cum_bad[:, :nwin]) == 0
        rid, s = np.nonzero(good)
        flat_q = qk[rid, s]
        j_end = (s + k - 1).astype(np.int64)  # consumed chars at the hit

        if self.start_tab is not None:
            lo = self.start_tab[flat_q]
            cnt = self.start_tab[flat_q + 1] - lo
        else:
            lo = np.searchsorted(self.kmers, flat_q, "left")
            cnt = np.searchsorted(self.kmers, flat_q, "right") - lo
        total = int(cnt.sum())
        if total > max_hits:
            return None
        rep = np.repeat(np.arange(flat_q.size, dtype=np.int64), cnt)
        off = (np.arange(total, dtype=np.int64)
               - np.repeat(np.cumsum(cnt) - cnt, cnt))
        pidx = lo[rep] + off
        alpha = j_end[rep] - self.post_dmax[pidx]
        beta = j_end[rep] - self.post_dmin[pidx]

        # per-read counts via bincount (np.add.at was ~0.45 s/batch at
        # 512 x 5 kb — scattered adds); rows come out of np.nonzero in
        # row-major order, so per-read hit slices are contiguous
        per_read = (np.bincount(rid, weights=cnt, minlength=B)
                    .astype(np.int64) if total else
                    np.zeros(B, dtype=np.int64))
        start = np.zeros(B + 1, dtype=np.int64)
        np.cumsum(per_read, out=start[1:])
        return SeedHits(alpha, beta, start, clean)

    def seed_bounds(self, q_np: np.ndarray, lengths_np: np.ndarray,
                    max_hits: int = 8_000_000):
        """Per-read (alpha_min, beta_max, nhits) over ALL hits — the
        round-4 surface, kept for tests/tools; production proposal uses
        :func:`propose_clusters` (all-hit bounds degrade to the whole
        graph once spurious hits exist)."""
        hits = self.seed_hits(q_np, lengths_np, max_hits)
        if hits is None:
            return None
        B = hits.start.shape[0] - 1
        alpha_min = np.full(B, np.iinfo(np.int64).max, dtype=np.int64)
        beta_max = np.full(B, np.iinfo(np.int64).min, dtype=np.int64)
        nhits = hits.start[1:] - hits.start[:-1]
        nz = np.nonzero(nhits > 0)[0]
        if nz.size:
            alpha_min[nz] = np.minimum.reduceat(hits.alpha, hits.start[nz])
            beta_max[nz] = np.maximum.reduceat(hits.beta, hits.start[nz])
        return alpha_min, beta_max, nhits


def interruption_costs(costs):
    """(c_rm, c_int): minimum cost per removed query char / per run
    interruption, or None when the cost model gives no guarantee
    (free mismatches or free gap extensions)."""
    if getattr(costs, "is_two_piece", False):
        # a long gap's per-char cost drops to extend2; one maximal gap
        # still costs >= open + min extend as one interruption
        c_rm = min(costs.mismatch, costs.gap_extend2)
        c_int = min(costs.mismatch,
                    costs.gap_open + min(costs.gap_extend,
                                         costs.gap_extend2),
                    costs.gap_open2 + costs.gap_extend2)
    else:
        c_rm = min(costs.mismatch, costs.gap_extend)
        c_int = min(costs.mismatch, costs.gap_open + costs.gap_extend)
    if c_rm <= 0 or c_int <= 0:
        return None
    return c_rm, c_int


def guaranteed_hits(jlo: int, c: int, k: int, costs) -> int:
    """T: every alignment of cost <= c consuming >= jlo query chars
    contains at least T distinct exact k-mer hits (<=0: no guarantee).

    Counting argument (module docstring step 1): removed chars
    R <= c // c_rm, interruptions I <= c // c_int, so >= jlo - R exact
    chars sit in <= I + 1 runs; runs capped at k-1 cover at most
    (I+1)(k-1) of them, and each char beyond that extends some run past
    k, adding one distinct hit position."""
    ci = interruption_costs(costs)
    if ci is None:
        return 0
    c_rm, c_int = ci
    R = c // c_rm
    I = c // c_int
    return int((jlo - R) - (I + 1) * (k - 1))


def k_condition_holds(n_aligned_min: int, ub: int, costs, k: int) -> bool:
    """Round-4 surface: whether every cost<=ub alignment of
    >= ``n_aligned_min`` aligned query chars must contain an exact
    k-mer hit.  Now the T>=1 case of :func:`guaranteed_hits` (the
    interruption-counting bound, which engages at far higher ub than
    the per-character bound this used to apply)."""
    return guaranteed_hits(n_aligned_min, ub, k, costs) >= 1


def propose_clusters(hits: SeedHits, K_u: np.ndarray):
    """Dominant hit cluster per read: the max-count diagonal window of
    width ``K_u[b]`` over the read's hit intervals, extended to every
    hit intersecting it.

    Returns ``(A_star, B_star, n_cluster)`` int64 arrays; reads with no
    hits have n_cluster == 0 and undefined bounds.  This is a GUESS (it
    needs no soundness — :func:`certify_reads` is the proof); windows
    keep scattered spurious hits from degrading the corridor to the
    whole graph the way all-hit min/max bounds do.
    """
    B = hits.start.shape[0] - 1
    A_star = np.zeros(B, dtype=np.int64)
    B_star = np.zeros(B, dtype=np.int64)
    n_cluster = np.zeros(B, dtype=np.int64)
    for b in range(B):
        s, e = int(hits.start[b]), int(hits.start[b + 1])
        if e == s:
            continue
        a = hits.alpha[s:e]
        t = hits.beta[s:e]
        w = int(K_u[b])
        # window-start d qualifies hit h iff d in [a_h - w, t_h]
        starts = np.sort(a - w)
        ends = np.sort(t)
        ev = np.concatenate([starts, ends + 1])
        dv = np.concatenate([np.ones(e - s, np.int64),
                             np.full(e - s, -1, np.int64)])
        order = np.argsort(ev, kind="stable")
        run = np.cumsum(dv[order])
        best = int(np.argmax(run))
        d_star = int(ev[order][best])
        inc = (a - w <= d_star) & (t >= d_star)
        ca = np.sort(a[inc])
        ct = np.sort(t[inc])
        m = ca.size
        # 2%-trimmed bounds: a handful of spurious hits inside the
        # window would otherwise stretch the corridor by up to the
        # window width.  Trimming can only narrow the GUESS — if it ever
        # clips the optimum, the fill scores high, the certificate sees
        # the clipped hits as a dense exterior window and refuses, and
        # the read falls back (exactness unaffected).
        cut = m // 50 if m >= 50 else 0
        A_star[b] = ca[cut]
        B_star[b] = ct[m - 1 - cut]
        n_cluster[b] = m
    return A_star, B_star, n_cluster


def certify_reads(hits: SeedHits, A_star, B_star, scores, K_u, k: int,
                  jlo, costs, all_acgt: bool):
    """Post-hoc corridor-optimality certificate (module docstring
    step 2).  ``scores``: the corridor fill's returned scores (already
    verified <= the per-read ub that sized the corridor margin
    ``K_u``); ``A_star/B_star``: the proposal cluster the corridor was
    built from.  Returns (certified bool (B,), T int64 (B,)).

    PASS for read b means: every alignment with cost <= scores[b] lies
    entirely inside the corridor, so the corridor's score and
    (largest-offset, lowest-rank) end state equal the full fill's.
    """
    B = hits.start.shape[0] - 1
    scores = np.asarray(scores, dtype=np.int64)
    jlo = np.asarray(jlo, dtype=np.int64)
    K_u = np.asarray(K_u, dtype=np.int64)
    out = np.zeros(B, dtype=bool)
    T_out = np.zeros(B, dtype=np.int64)
    ci = interruption_costs(costs)
    e_min = (min(costs.gap_extend, costs.gap_extend2)
             if getattr(costs, "is_two_piece", False) else costs.gap_extend)
    if ci is None or e_min <= 0 or not all_acgt:
        return out, T_out
    c_rm, c_int = ci
    for b in range(B):
        c = int(scores[b])
        if c < 0:
            continue
        if not hits.clean[b]:
            continue
        R = c // c_rm
        I = c // c_int
        T = int(jlo[b]) - R - (I + 1) * (k - 1)
        T_out[b] = T
        if T <= 0:
            continue
        K_c = c // e_min
        slack = int(K_u[b]) - K_c
        if slack < 0:
            continue  # corridor margin too narrow for this score
        s, e = int(hits.start[b]), int(hits.start[b + 1])
        a = hits.alpha[s:e]
        t = hits.beta[s:e]
        ext = (a < A_star[b] - slack) | (t > B_star[b] + slack)
        n_ext = int(ext.sum())
        if n_ext < T:
            out[b] = True  # even all exterior hits can't carry one
            continue
        # max-overlap sweep over exterior intervals [a_h - K_c, t_h]
        ae = a[ext]
        te = t[ext]
        ev = np.concatenate([np.sort(ae - K_c), np.sort(te) + 1])
        dv = np.concatenate([np.ones(n_ext, np.int64),
                             np.full(n_ext, -1, np.int64)])
        order = np.argsort(ev, kind="stable")
        out[b] = int(np.cumsum(dv[order]).max()) < T
    return out, T_out


def subset_hits(hits: SeedHits, idx: np.ndarray) -> SeedHits:
    """Row-subset of a hit set (for retry tails): gathers each selected
    read's CSR slice; duplicate rows (pow-of-two padding) are fine."""
    counts = (hits.start[1:] - hits.start[:-1])[idx]
    start = np.zeros(idx.size + 1, dtype=np.int64)
    np.cumsum(counts, out=start[1:])
    total = int(start[-1])
    src = np.repeat(hits.start[idx], counts) + (
        np.arange(total, dtype=np.int64)
        - np.repeat(start[:-1], counts))
    return SeedHits(hits.alpha[src], hits.beta[src], start,
                    hits.clean[idx])
