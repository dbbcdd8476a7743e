"""Exact gap-affine scores of reads against a ``RefGraph``, in plain PyTorch.

The recurrence (Gotoh over a DAG, one-piece costs; x mismatch, o open,
e extend, a gap of k costs o + k*e):

    E(r, j) = min over preds p of min(H(p, j) + o + e, E(p, j) + e)
    F(r, j) = min(H(r, j-1) + o + e, F(r, j-1) + e)
    H(r, j) = min(H(p, j-1) + (0 if sym(r) == q[j-1] else x), E, F)

with a virtual start row H(s, 0) = 0, H(s, j) = o + j*e.  A global score
is min over sinks of H(sink, n); with free graph ends (the read mapping
span: the whole read, any start and end in the graph) H(r, 0) = 0 at
every node and the score is min over all nodes of H(r, n).

Rows are kept tilted (H - e*j), so the insertion chain is one running
minimum per row: F + H = min(A, cummin(A) shifted by one column + o) with
A = min(diagonal, E).  One rank is about ten tensor operations over
(reads, offsets); reads and offsets are vectorised, ranks are a loop, and
on the card each rank's operations replay as one captured CUDA graph.

``band`` restricts every row to |j - c_b(r)| <= w with c_b(r) = depth(r) *
scale_b - offset_b: the static band of the benchmark's control, which
breaks the exactness the configurations state.
"""

from __future__ import annotations

import numpy as np
import torch

INF = 1 << 29
PAD = 255  # a query byte that matches no graph symbol


class _Rows:
    """Two row slots and the buffers of one rank's step, at fixed addresses,
    so that on the card each (slot, symbol) step is captured once as a CUDA
    graph and replayed: a rank then costs one launch, not ten."""

    def __init__(self, B, L, dev, costs, free_ends, mm):
        self.o, self.e = costs["gap_open"], costs["gap_extend"]
        self.free_ends, self.mm, self.L = free_ends, mm, L
        i32 = dict(dtype=torch.int32, device=dev)
        # a row is (B, L + 2): column 0 a constant 0 under column -1, so
        # that row[:, :L+1] is the row shifted by one offset
        self.h = [torch.zeros((B, L + 2), **i32) for _ in range(2)]
        self.x = [torch.zeros((B, L + 1), **i32) for _ in range(2)]
        self.a, self.e_row, self.t, self.cv = (
            torch.empty((B, L + 1), **i32) for _ in range(4))
        self.ci = torch.empty((B, L + 1), dtype=torch.int64, device=dev)
        self.shift = torch.full((B, L + 1), INF, **i32)
        self.best = torch.full((B, L + 1), INF, **i32)
        self.graphs = {}

    def step(self, p, s, outside=None):
        """The rank after slot p, of symbol s, into slot 1 - p."""
        L, o = self.L, self.o
        h_p, x_p, h_n, x_n = self.h[p], self.x[p], self.h[1 - p], self.x[1 - p]
        torch.add(h_p[:, :L + 1], self.mm[s], out=self.a)
        torch.add(x_p, self.e, out=self.e_row)
        torch.minimum(self.a, self.e_row, out=self.a)
        if outside is not None:
            self.a.masked_fill_(outside, INF)
        torch.cummin(self.a, 1, out=(self.cv, self.ci))
        torch.add(self.cv[:, :-1], o, out=self.shift[:, 1:])
        torch.minimum(self.a, self.shift, out=h_n[:, 1:])
        if outside is not None:
            h_n[:, 1:].masked_fill_(outside, INF)
        torch.add(h_n[:, 1:], o, out=self.t)
        torch.minimum(self.t, self.e_row, out=x_n)
        if self.free_ends:
            torch.minimum(self.best, h_n[:, 1:], out=self.best)

    def capture(self):
        """One CUDA graph per (slot, symbol) step; the buffers are reset
        after the warm-up steps capture needs."""
        keys = [(p, s) for p in (0, 1) for s in self.mm]
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for key in keys:
                self.step(*key)
        torch.cuda.current_stream().wait_stream(side)
        for key in keys:
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                self.step(*key)
            self.graphs[key] = g
        self.best.fill_(INF)

    def run(self, p, s):
        g = self.graphs.get((p, s))
        if g is None:
            self.step(p, s)
        else:
            g.replay()


def best_scores(graph, reads, costs: dict, free_ends: bool, device="cpu",
                band=None) -> np.ndarray:
    """(B,) int64 optimal scores of ``reads`` (byte strings) against
    ``graph`` under ``costs`` ({"mismatch", "gap_open", "gap_extend"})."""
    x, o, e = costs["mismatch"], costs["gap_open"], costs["gap_extend"]
    B = len(reads)
    lengths = np.fromiter((len(r) for r in reads), dtype=np.int64, count=B)
    L = int(lengths.max())
    q = np.full((B, L), PAD, dtype=np.uint8)
    for b, r in enumerate(reads):
        q[b, :len(r)] = np.frombuffer(bytes(r), dtype=np.uint8)
    dev = torch.device(device)
    qt = torch.as_tensor(q, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    # diagonal term per graph symbol, tilted: mm(s, q[j-1]) - e at j >= 1;
    # column 0 starts an alignment at any node (free ends) or at none
    mm = {}
    for s in np.unique(graph.symbols).tolist():
        t = torch.empty((B, L + 1), **i32)
        t[:, 0] = 0 if free_ends else INF
        t[:, 1:] = torch.where(qt == s, -e, x - e).to(torch.int32)
        mm[s] = t
    rows = _Rows(B, L, dev, costs, free_ends, mm)
    if dev.type == "cuda" and band is None:
        rows.capture()
    start_h = torch.full((B, L + 2), o, **i32)
    start_h[:, :2] = 0
    start_x = start_h[:, 1:] + o
    if band is not None:
        half, scale, offset = band
        jgrid = torch.arange(L + 1, **i32).view(1, -1)
        scale = torch.as_tensor(np.asarray(scale, dtype=np.float64),
                                device=dev).view(-1, 1)
        offset = torch.as_tensor(np.asarray(offset, dtype=np.float64),
                                 device=dev).view(-1, 1)

    n_seg = len(graph.seg_seqs)
    left = np.zeros(n_seg, dtype=np.int64)  # successors not yet filled
    for ps in graph.seg_preds:
        for p in ps:
            left[p] += 1
    ends = {}  # segment -> (row, X) of its last node
    symbols = graph.symbols.tolist()
    depth = graph.depth.tolist()
    p = 0
    for si in range(n_seg):
        preds = graph.seg_preds[si]
        if preds:
            h0, x0 = ends[preds[0]]
            rows.h[p].copy_(h0)
            rows.x[p].copy_(x0)
            for k in preds[1:]:
                torch.minimum(rows.h[p], ends[k][0], out=rows.h[p])
                torch.minimum(rows.x[p], ends[k][1], out=rows.x[p])
            for k in preds:
                left[k] -= 1
                if left[k] == 0:
                    del ends[k]
        else:
            rows.h[p].copy_(start_h)
            rows.x[p].copy_(start_x)
        r0 = int(graph.seg_first[si])
        for r in range(r0, r0 + len(graph.seg_seqs[si])):
            if band is None:
                rows.run(p, symbols[r])
            else:
                centre = depth[r] * scale - offset
                rows.step(p, symbols[r],
                          outside=(jgrid - centre).abs() > half)
            p = 1 - p
        if left[si] > 0:
            ends[si] = (rows.h[p].clone(), rows.x[p].clone())
        elif not free_ends:  # a sink: the global span ends here
            torch.minimum(rows.best, rows.h[p][:, 1:], out=rows.best)
    at = torch.as_tensor(lengths, device=dev).view(-1, 1)
    tilted = rows.best.gather(1, at).view(-1).to(torch.int64).cpu().numpy()
    return tilted + e * lengths
