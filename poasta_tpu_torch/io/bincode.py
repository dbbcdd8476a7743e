"""Rust-poasta ``.poasta`` (bincode) graph interop.

The reference checkpoints its growing MSA graph with
``bincode::serialize_into`` of a ``POAGraphWithIx`` (reference:
``src/io/graph.rs:24-34``; type: ``src/graphs/poa.rs:482-489``).  This
module parses (and emits) that byte layout so a user's existing graphs
resume here directly, closing the interop gap where previously only a
detect-and-explain error existed.

Layout (bincode 1.x legacy config: little-endian, fixed-width ints,
``u64`` sequence lengths, 1-byte ``Option`` tags):

* ``POAGraphWithIx`` enum: ``u32`` variant index — 0=U8, 1=U16, 2=U32,
  3=USIZE — selecting the petgraph node-index width (1/2/4/8 bytes).
* ``POAGraph`` struct fields in declaration order
  (``src/graphs/poa.rs:84-96``): the petgraph ``StableDiGraph``, then
  ``sequences``, ``topological_sorted``, ``start_node``, ``end_node``.
* petgraph (de)serializes ``StableDiGraph`` in its ``Graph``-compatible
  form: ``nodes`` (occupied node weights in index order), ``node_holes``
  (vacant node indices), ``edge_property`` (enum; directed), ``edges``
  (per edge *slot*, ``Option<(source, target, weight)>`` with ``None``
  marking vacant slots — slot order preserved, which our GFA L-line
  emitter depends on).
* Node weight ``POANodeData`` = ``symbol: u8`` + ``aligned_nodes:
  Vec<Ix>``; edge weight ``POAEdgeData`` = ``weight: usize(u64)`` +
  ``sequence_ids: Vec<usize(u64)>``; ``Sequence`` = ``String`` (u64 len
  + UTF-8) + start node ``Ix``.

Environment note: no Rust toolchain exists in this container, so the
layout is reconstructed from the serde/bincode/petgraph sources rather
than validated against reference-produced bytes; the round-trip tests
pin self-consistency and the documented layout.  Adjacency iteration
order after import matches petgraph's deserialization (each edge slot
re-linked at its endpoints' list heads in slot order), which is exactly
this package's ``_out``/``_in`` insertion order with reversed iteration.
"""

from __future__ import annotations

import io
import struct
from typing import IO, List, Optional

from ..graphs.poa import POAGraph, SequenceInfo, _Edge

_IX_SIZE = {0: 1, 1: 2, 2: 4, 3: 8}
_IX_VARIANT = {1: 0, 2: 1, 4: 2, 8: 3}


class _Reader:
    def __init__(self, data: bytes):
        self._d = data
        self._p = 0

    def take(self, n: int) -> bytes:
        if self._p + n > len(self._d):
            raise ValueError(
                f"truncated bincode stream: wanted {n} bytes at offset "
                f"{self._p}, have {len(self._d) - self._p}"
            )
        out = self._d[self._p : self._p + n]
        self._p += n
        return out

    def u8(self) -> int:
        return self.take(1)[0]

    def u32(self) -> int:
        return struct.unpack("<I", self.take(4))[0]

    def u64(self) -> int:
        return struct.unpack("<Q", self.take(8))[0]

    def length(self) -> int:
        n = self.u64()
        # Sanity bound: lengths are counts of >=1-byte items.
        if n > len(self._d):
            raise ValueError(f"implausible bincode length {n} at offset {self._p - 8}")
        return n

    def ix(self, size: int) -> int:
        return int.from_bytes(self.take(size), "little")

    def string(self) -> str:
        return self.take(self.length()).decode("utf-8")

    def done(self) -> bool:
        return self._p == len(self._d)


def load_rust_poasta(data: bytes) -> POAGraph:
    """Parse a reference-format bincode graph into a :class:`POAGraph`."""
    r = _Reader(data)
    variant = r.u32()
    if variant not in _IX_SIZE:
        raise ValueError(f"unknown POAGraphWithIx variant {variant}")
    isz = _IX_SIZE[variant]

    # -- StableDiGraph ------------------------------------------------
    n_nodes = r.length()
    symbols: List[int] = []
    aligned: List[List[int]] = []
    for _ in range(n_nodes):
        symbols.append(r.u8())
        aligned.append([r.ix(isz) for _ in range(r.length())])

    n_holes = r.length()
    holes = [r.ix(isz) for _ in range(n_holes)]
    if holes:
        # The reference never removes nodes (only start/end *edges* are
        # rewired, poa.rs:323-363), so holes indicate external surgery we
        # cannot represent with dense indices without renumbering — which
        # would break byte-parity of emissions.
        raise ValueError(
            f"graph has {len(holes)} vacant node slots; node holes are "
            "not supported (the reference aligner never produces them)"
        )

    edge_property = r.u32()
    if edge_property > 1:
        raise ValueError(f"bad edge_property variant {edge_property}")

    n_edge_slots = r.length()
    edges: List[Optional[_Edge]] = []
    for _ in range(n_edge_slots):
        tag = r.u8()
        if tag == 0:
            edges.append(None)
        elif tag == 1:
            s = r.ix(isz)
            t = r.ix(isz)
            weight = r.u64()
            seq_ids = [r.u64() for _ in range(r.length())]
            if s >= n_nodes or t >= n_nodes:
                raise ValueError(f"edge endpoint {max(s, t)} out of range")
            edges.append(_Edge(s, t, weight, seq_ids))
        else:
            raise ValueError(f"bad Option tag {tag} in edge list")

    # -- POAGraph fields ----------------------------------------------
    sequences = [SequenceInfo(r.string(), r.ix(isz)) for _ in range(r.length())]
    topo = [r.ix(isz) for _ in range(r.length())]
    start_node = r.ix(isz)
    end_node = r.ix(isz)
    if not r.done():
        raise ValueError(f"trailing bytes after graph (offset {r._p}/{len(r._d)})")
    if n_nodes and (start_node >= n_nodes or end_node >= n_nodes):
        raise ValueError("start/end node out of range")

    g = POAGraph.__new__(POAGraph)
    g.symbols = symbols
    g.aligned_nodes = aligned
    g._edges = edges
    # petgraph reuses vacant slots through a free-list head that, after
    # deserialization, links vacancies in slot order — reuse takes the
    # lowest-index vacancy first, so our LIFO stack gets them reversed.
    g._free_edges = [i for i, e in reversed(list(enumerate(edges))) if e is None]
    g._out = [[] for _ in range(n_nodes)]
    g._in = [[] for _ in range(n_nodes)]
    for eid, e in enumerate(edges):
        if e is not None:
            g._out[e.source].append(eid)
            g._in[e.target].append(eid)
    g.sequences = sequences
    g.topological_sorted = topo
    g.start_node = start_node
    g.end_node = end_node
    return g


def dump_rust_poasta(graph: POAGraph, out: IO[bytes], ix_bytes: int = 4) -> None:
    """Serialize in the reference's bincode layout (``U32`` arm default).

    The mirror of :func:`load_rust_poasta`; lets graphs built here be
    opened by the reference binary (``poasta align -I``, ``poasta view``).
    """
    if ix_bytes not in _IX_VARIANT:
        raise ValueError(f"ix_bytes must be 1/2/4/8, got {ix_bytes}")
    n_nodes = len(graph.symbols)
    if n_nodes >= (1 << (8 * ix_bytes)) - 1:  # petgraph reserves Ix::MAX
        raise ValueError(f"{n_nodes} nodes do not fit {ix_bytes}-byte indices")

    w = out.write

    def ix(v: int) -> None:
        w(int(v).to_bytes(ix_bytes, "little"))

    def u64(v: int) -> None:
        w(struct.pack("<Q", v))

    w(struct.pack("<I", _IX_VARIANT[ix_bytes]))
    u64(n_nodes)
    for n in range(n_nodes):
        w(bytes([graph.symbols[n]]))
        u64(len(graph.aligned_nodes[n]))
        for a in graph.aligned_nodes[n]:
            ix(a)
    u64(0)  # node_holes
    w(struct.pack("<I", 1))  # EdgeProperty::Directed
    u64(len(graph._edges))
    for e in graph._edges:
        if e is None:
            w(b"\x00")
        else:
            w(b"\x01")
            ix(e.source)
            ix(e.target)
            u64(e.weight)
            u64(len(e.sequence_ids))
            for sid in e.sequence_ids:
                u64(sid)
    u64(len(graph.sequences))
    for s in graph.sequences:
        name = s.name.encode("utf-8")
        u64(len(name))
        w(name)
        ix(s.start_node)
    u64(len(graph.topological_sorted))
    for n in graph.topological_sorted:
        ix(n)
    ix(graph.start_node)
    ix(graph.end_node)


def dumps_rust_poasta(graph: POAGraph, ix_bytes: int = 4) -> bytes:
    buf = io.BytesIO()
    dump_rust_poasta(graph, buf, ix_bytes)
    return buf.getvalue()
