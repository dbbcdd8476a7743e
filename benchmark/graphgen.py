"""The benchmark's one graph generator: a configuration's ``graph`` block
and a seed in, GFA text and the haplotype sequences out.

A graph is a random backbone of ``backbone_bases`` bases, the first
haplotype.  Each further haplotype carries variants drawn along the
backbone, ``divergence`` times the rates of ``variants`` a base (SNPs,
insertions and deletions of 1 to ``indel_max`` bases), at fixed counts
and lengths in random slots, so that every seed gives a graph of about
the same size; equal variants of two haplotypes share their nodes, so
each becomes a bubble.  With
``skip_every`` > 0 an edge v -> v + ``skip_span`` joins the backbone every
``skip_every`` bases (``scripts/pangenome_200k.py``'s graph shape).
Unbranching runs of nodes are written as segments, in topological order.
"""

from __future__ import annotations

import numpy as np

ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)
# one independent stream per purpose, from the run's seed
STREAM_GRAPH, STREAM_READS, STREAM_SAMPLE = 1, 2, 3


def rng_for(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([int(seed), stream]))


def _haplotype_path(rng, backbone, d, variants):
    """One haplotype's node keys, and its sequence.  Keys sort in
    topological order: (position, 0, 0, 0) a backbone node, (position, 1,
    base, 0) a SNP's base, (position, 2, insertion, t) the t-th base of an
    insertion after that position."""
    n = backbone.shape[0]
    kmax = int(variants["indel_max"])
    counts = [round(variants[v] * d * n)
              for v in ("snp", "insertion", "deletion")]
    # one variant in each of sum(counts) equal slots, never overlapping the
    # next; kinds and indel lengths a fixed multiset in the seed's order
    slot = n // sum(counts)
    at = np.arange(sum(counts)) * slot + rng.integers(0, slot - kmax,
                                                      sum(counts))
    kinds = rng.permutation(np.repeat([0, 1, 2], counts))
    kind = np.full(n, 3)  # 0 snp 1 ins 2 del 3 none
    kind[at] = kinds
    lens = np.ones(n, dtype=np.int64)
    for k in (1, 2):
        lens[at[kinds == k]] = rng.permutation(
            np.resize(np.arange(1, kmax + 1), counts[k]))
    alt = (backbone + rng.integers(1, 4, n)) % 4
    ins_bases = rng.integers(0, 4, (n, kmax))
    keys, seq = [], []
    i = 0
    while i < n:
        k = kind[i]
        if k == 2:
            i += int(lens[i])
            continue
        if k == 0:
            keys.append((i, 1, int(alt[i]), 0))
            seq.append(int(alt[i]))
        else:
            keys.append((i, 0, 0, 0))
            seq.append(int(backbone[i]))
        if k == 1:
            bases = tuple(int(b) for b in ins_bases[i, :lens[i]])
            for t, b in enumerate(bases):
                keys.append((i, 2, bases, t))
                seq.append(b)
        i += 1
    return keys, np.asarray(seq, dtype=np.int64)


def build_graph(spec: dict, seed: int):
    """(GFA text, haplotype sequences as bytes, backbone as bytes)."""
    rng = rng_for(seed, STREAM_GRAPH)
    n = int(spec["backbone_bases"])
    backbone = rng.integers(0, 4, n)
    paths = [_haplotype_path(rng, backbone, float(spec["divergence"]),
                             spec["variants"])
             for _ in range(int(spec.get("haplotypes", 1)) - 1)]
    # the variants' own nodes in key order; backbone node i precedes every
    # variant node at position i, and follows those before it
    alt = sorted({k for keys, _ in paths for k in keys if k[1]},
                 key=lambda k: (k[0], k[1], k[2] if k[1] == 1 else 0,
                                k[2] if k[1] == 2 else (), k[3]))
    alt_pos = np.asarray([k[0] for k in alt], dtype=np.int64)
    bb_id = np.arange(n) + np.searchsorted(alt_pos, np.arange(n), "left")
    alt_id = np.arange(len(alt)) + alt_pos + 1
    node_of = {k: int(v) for k, v in zip(alt, alt_id)}
    sym = np.empty(n + len(alt), dtype=np.int64)
    sym[bb_id] = backbone
    sym[alt_id] = [k[2] if k[1] == 1 else k[2][k[3]] for k in alt]
    edges = [np.stack([bb_id[:-1], bb_id[1:]], axis=1)]
    for keys, _ in paths:
        ids = [int(bb_id[k[0]]) if k[1] == 0 else node_of[k] for k in keys]
        edges.append(np.asarray(list(zip(ids[:-1], ids[1:])),
                                dtype=np.int64).reshape(-1, 2))
    every = int(spec.get("skip_every", 0))
    if every:
        v = np.arange(0, n - int(spec["skip_span"]), every)
        edges.append(np.stack([bb_id[v], bb_id[v + int(spec["skip_span"])]],
                              axis=1))
    edges = np.unique(np.concatenate(edges), axis=0)
    gfa = _write_gfa(sym.shape[0], sym, edges)
    haps = [ACGT[backbone].tobytes()] + [ACGT[seq].tobytes()
                                         for _, seq in paths]
    return gfa, haps, haps[0]


def _write_gfa(n_nodes, sym, edges) -> str:
    src, dst = edges[:, 0], edges[:, 1]
    indeg = np.bincount(dst, minlength=n_nodes)
    outdeg = np.bincount(src, minlength=n_nodes)
    # v continues v-1's segment iff its one in-edge is v-1's one out-edge
    chain = np.zeros(n_nodes, dtype=bool)
    step = (dst == src + 1) & (indeg[dst] == 1) & (outdeg[src] == 1)
    chain[dst[step]] = True
    seg_of = np.cumsum(~chain) - 1
    starts = np.flatnonzero(~chain)
    ends = np.r_[starts[1:], n_nodes]
    letters = ACGT[sym].tobytes().decode()
    lines = ["H\tVN:Z:1.0"]
    lines += [f"S\t{s + 1}\t{letters[a:b]}"
              for s, (a, b) in enumerate(zip(starts.tolist(), ends.tolist()))]
    between = ~step
    lines += [f"L\t{a + 1}\t+\t{b + 1}\t+\t0M"
              for a, b in zip(seg_of[src[between]].tolist(),
                              seg_of[dst[between]].tolist())]
    return "\n".join(lines) + "\n"
