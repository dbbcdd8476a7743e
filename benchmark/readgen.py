"""The benchmark's one read generator: a traffic mix's parameters, the
graph's sequences and a seed in, batches of reads out.

A read is drawn from a haplotype (``source: haplotypes``) or from a
uniform locus of the backbone (``source: loci``, ``read_bases`` long),
then mutated with the edits ``poasta_tpu_torch/bench.py``'s ``_mutate``
makes on average (a frozen copy of its rates: deletions d, changed bases
1.125 d, insertions d), at fixed counts, so that every seed gives reads of
the same divergence and only the positions and bases move.  With
``divergence_spread: binomial`` a batch's reads spread in divergence as
independent reads do, as one fixed set of counts in the seed's order
(``binomial_scales``).  Then each read is cut to ``cut_to`` bases if that
is given.  Every ``tail_every``-th read of a batch is mutated at
``tail_divergence`` instead.  Haplotypes are drawn equally often.
"""

from __future__ import annotations

from statistics import NormalDist

import numpy as np

from .graphgen import ACGT, STREAM_READS, rng_for

CODE = np.zeros(256, dtype=np.int64)
CODE[ACGT] = np.arange(4)


def mutate(rng, seq: np.ndarray, d: float, cut_to=None,
           scale: float = 1.0) -> np.ndarray:
    """``_mutate``'s expected edits at fixed counts, on a uint8 array of
    ACGT bytes of length m: round(d m) bases deleted, round(1.125 d m)
    replaced by another base (``_mutate`` draws a random base for 1.5 d of
    them), and after round(d (m - deleted)) kept bases a random base
    inserted, each count times ``scale``; the positions and bases from
    ``rng``."""
    m = seq.shape[0]
    d = d * scale
    k_del, k_sub = round(d * m), round(1.125 * d * m)
    pick = _smallest(rng.random(m), k_del + k_sub)
    keep = np.ones(m, dtype=bool)
    keep[pick[:k_del]] = False
    ch = seq.copy()
    sub = pick[k_del:]
    ch[sub] = ACGT[(CODE[seq[sub]] + rng.integers(1, 4, sub.shape[0])) % 4]
    kept = np.flatnonzero(keep)
    ins = np.zeros(m, dtype=bool)
    ins[kept[_smallest(rng.random(kept.shape[0]),
                       round(d * kept.shape[0]))]] = True
    count = keep.astype(np.int64) + ins
    at = np.cumsum(count) - count
    out = np.empty(int(count.sum()), dtype=np.uint8)
    out[at[keep]] = ch[keep]
    out[at[ins] + 1] = ACGT[rng.integers(0, 4, int(ins.sum()))]
    if cut_to is not None:
        out = out[:cut_to]
    return out if out.size else ACGT[:1].copy()


def binomial_scales(rng, n: int, d: float, m: int) -> np.ndarray:
    """(n,) edit-count scales whose totals are the quantiles (i + 0.5) / n
    of the total edits ``_mutate`` makes in a read of m bases at d (normal
    approximation), in an order drawn from ``rng``: per-read divergence
    spread as independent reads have it, and the same set on every seed."""
    mean = m * d * (1 + 1.125 + (1 - d))
    var = m * (2 * d * (1 - d) + 1.125 * d * (1 - 1.125 * d))
    z = np.asarray([NormalDist().inv_cdf((i + 0.5) / n) for i in range(n)])
    return np.maximum(1 + z[rng.permutation(n)] * np.sqrt(var) / mean, 0.0)


def _smallest(u: np.ndarray, k: int) -> np.ndarray:
    """Indices of the k smallest values of ``u``, smallest first."""
    if k <= 0:
        return np.zeros(0, dtype=np.int64)
    if k >= u.shape[0]:
        return np.argsort(u)
    idx = np.argpartition(u, k - 1)[:k]
    return idx[np.argsort(u[idx])]


def make_batches(mix: dict, haplotypes, backbone: bytes, seed: int):
    """``mix["batches"]`` batches of ``mix["batch_reads"]`` reads, and a
    warm-up batch of ``mix.get("warmup_reads", 0)``: (batches, warm-up,
    origins), where origins[k][i] is read i's (haplotype, locus,
    divergence)."""
    rng = rng_for(seed, STREAM_READS)
    haps = [np.frombuffer(h, dtype=np.uint8) for h in haplotypes]
    bb = np.frombuffer(backbone, dtype=np.uint8)
    every = int(mix.get("tail_every", 0))

    def one_batch(n):
        div = np.full(n, float(mix["divergence"]))
        if every:
            div[::every] = float(mix["tail_divergence"])
        if mix["source"] == "loci":
            span = int(mix["read_bases"])
            hap = np.zeros(n, dtype=np.int64)
            loc = rng.integers(0, bb.shape[0] - span, n)
            srcs = [bb[a:a + span] for a in loc.tolist()]
        else:
            # every haplotype as often, in an order of the seed's
            hap = rng.permutation(np.arange(n) % len(haps))
            loc = np.zeros(n, dtype=np.int64)
            srcs = [haps[h] for h in hap.tolist()]
        scale = np.ones(n)
        if mix.get("divergence_spread") == "binomial":
            for dv in np.unique(div):
                at = np.flatnonzero(div == dv)
                scale[at] = binomial_scales(
                    rng, at.shape[0], float(dv),
                    int(np.mean([srcs[i].shape[0] for i in at])))
        reads = [mutate(rng, src, float(dv), mix.get("cut_to"), float(sc))
                 for src, dv, sc in zip(srcs, div, scale)]
        return ([r.tobytes() for r in reads],
                list(zip(hap.tolist(), loc.tolist(), div.tolist())))

    n_warm = int(mix.get("warmup_reads", 0))
    warm = one_batch(n_warm)[0] if n_warm else []
    made = [one_batch(int(mix["batch_reads"]))
            for _ in range(int(mix["batches"]))]
    return [r for r, _ in made], warm, [o for _, o in made]
