"""A GFA v1 parser of the reference's own: segments become chains of
one-base nodes, links join a segment's last node to the next one's first.

Forward links only (a ``-`` strand raises): the benchmark writes no other.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class RefGraph:
    """A DAG of one-base nodes in topological order (rank = node index).

    ``seg_names``, ``seg_seqs``: segments in topological order; ``seg_first``
    the rank of each one's first node; ``seg_preds`` the segments linked
    into each; ``links`` the (from, to) segment-name pairs."""

    seg_names: list
    seg_seqs: list
    seg_first: np.ndarray
    seg_preds: list
    links: set
    symbols: np.ndarray  # (n,) uint8, rank order
    depth: np.ndarray    # (n,) longest path in nodes from a source, 1-based

    @property
    def n_nodes(self) -> int:
        return int(self.symbols.shape[0])

    def seg_index(self) -> dict:
        return {name: i for i, name in enumerate(self.seg_names)}


def parse_gfa(text: str) -> RefGraph:
    seqs, order, links = {}, [], []
    for line in text.splitlines():
        parts = line.rstrip("\n").split("\t")
        if parts[0] == "S":
            if parts[1] in seqs:
                raise ValueError(f"segment {parts[1]!r} given twice")
            seqs[parts[1]] = parts[2].upper()
            order.append(parts[1])
        elif parts[0] == "L":
            if parts[2] != "+" or parts[4] != "+":
                raise ValueError("reverse-strand links are not handled")
            links.append((parts[1], parts[3]))
    succ = {name: [] for name in order}
    indeg = {name: 0 for name in order}
    preds = {name: [] for name in order}
    for a, b in links:
        if a not in seqs or b not in seqs:
            raise ValueError(f"link {a}->{b} names an undefined segment")
        succ[a].append(b)
        preds[b].append(a)
        indeg[b] += 1
    # Kahn over segments, sources in file order
    ready = [name for name in order if indeg[name] == 0]
    topo = []
    while ready:
        nxt = []
        for name in ready:
            topo.append(name)
            for s in succ[name]:
                indeg[s] -= 1
                if indeg[s] == 0:
                    nxt.append(s)
        ready = nxt
    if len(topo) != len(order):
        raise ValueError("the GFA's links form a cycle")
    ix = {name: i for i, name in enumerate(topo)}
    lens = np.array([len(seqs[name]) for name in topo], dtype=np.int64)
    first = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int64)
    symbols = np.frombuffer("".join(seqs[n] for n in topo).encode(),
                            dtype=np.uint8).copy()
    depth = np.empty(int(lens.sum()), dtype=np.int64)
    last_depth = np.zeros(len(topo), dtype=np.int64)
    seg_preds = []
    for i, name in enumerate(topo):
        ps = [ix[p] for p in preds[name]]
        seg_preds.append(ps)
        d0 = max((last_depth[p] for p in ps), default=0) + 1
        depth[first[i]:first[i] + lens[i]] = d0 + np.arange(lens[i])
        last_depth[i] = d0 + lens[i] - 1
    return RefGraph(seg_names=topo, seg_seqs=[seqs[n] for n in topo],
                    seg_first=first, seg_preds=seg_preds, links=set(links),
                    symbols=symbols, depth=depth)
