"""POA graph serialization and DOT emitters.

``save_graph``/``load_graph`` implement the ``.poasta`` role (checkpoint /
resume of a growing MSA graph; reference: ``src/io/graph.rs:24-34``).  The
container is a versioned, zlib-compressed JSON encoding of the *exact*
internal graph state — including edge-slot layout and adjacency insertion
order — so a round-trip preserves byte-identical downstream emissions.
(The reference's bincode container is Rust-specific; the format here is the
framework's own, with the same role and resume semantics.)

Two DOT emitters mirror the reference:
``format_as_dot`` (library-style; used by the align CLI's dot output,
reference: ``src/io/graph.rs:229-243``) and ``graph_to_dot`` (the annotated
visualization format used by the view CLI, ``src/io/graph.rs:504-598``).
"""

from __future__ import annotations

import json
import math
import zlib
from typing import IO, Dict

from ..graphs.poa import POAGraph, SequenceInfo, _Edge

MAGIC = b"POASTATPU"
VERSION = 1


def save_graph(graph: POAGraph, out: IO[bytes]) -> None:
    payload = {
        "symbols": graph.symbols,
        "aligned_nodes": graph.aligned_nodes,
        "edges": [
            None if e is None else [e.source, e.target, e.weight, e.sequence_ids]
            for e in graph._edges
        ],
        "free_edges": graph._free_edges,
        "out": graph._out,
        "in": graph._in,
        "sequences": [[s.name, s.start_node] for s in graph.sequences],
        "topological_sorted": graph.topological_sorted,
        "start_node": graph.start_node,
        "end_node": graph.end_node,
    }
    blob = zlib.compress(json.dumps(payload).encode())
    out.write(MAGIC)
    out.write(bytes([VERSION]))
    out.write(len(blob).to_bytes(8, "little"))
    out.write(blob)


def load_graph(inp: IO[bytes]) -> POAGraph:
    magic = inp.read(len(MAGIC))
    if magic != MAGIC:
        # The Rust reference's .poasta files are bincode: a u32 LE variant
        # index (0..=3, the POAGraphWithIx arm — reference
        # ``io/graph.rs:24-34``, ``graphs/poa.rs:482-489``) leads the
        # stream, so the first 4 bytes decode to a tiny integer.  Parse
        # those through the bincode interop layer.
        if len(magic) >= 4 and int.from_bytes(magic[:4], "little") < 4:
            from .bincode import load_rust_poasta

            return load_rust_poasta(magic + inp.read())
        raise ValueError("not a poasta-tpu graph file")
    version = inp.read(1)[0]
    if version != VERSION:
        raise ValueError(f"unsupported graph file version {version}")
    size = int.from_bytes(inp.read(8), "little")
    payload = json.loads(zlib.decompress(inp.read(size)).decode())

    graph = POAGraph.__new__(POAGraph)
    graph.symbols = payload["symbols"]
    graph.aligned_nodes = payload["aligned_nodes"]
    graph._edges = [
        None if e is None else _Edge(e[0], e[1], e[2], e[3]) for e in payload["edges"]
    ]
    graph._free_edges = payload["free_edges"]
    graph._out = payload["out"]
    graph._in = payload["in"]
    graph.sequences = [SequenceInfo(n, s) for n, s in payload["sequences"]]
    graph.topological_sorted = payload["topological_sorted"]
    graph.start_node = payload["start_node"]
    graph.end_node = payload["end_node"]
    return graph


def load_graph_from_fasta_msa(path) -> POAGraph:
    """Import a columnar FASTA MSA as a POA graph.

    Column symbols are deduplicated into aligned-node cliques
    (reference: ``src/io/graph.rs:36-103``).
    """
    from .fasta import read_fasta

    graph = POAGraph()
    nodes_per_col: list[list[int]] = []
    for seq_id, (name, seq) in enumerate(read_fasta(path)):
        if len(seq) > len(nodes_per_col):
            nodes_per_col.extend([] for _ in range(len(seq) - len(nodes_per_col)))

        prev_node = None
        for col, c in enumerate(seq):
            if c == ord("-"):
                continue
            node_ix = None
            for v in nodes_per_col[col]:
                if graph.symbols[v] == c:
                    node_ix = v
                    break
            if node_ix is None:
                node_ix = graph.add_node(c)
                for other in nodes_per_col[col]:
                    graph.aligned_nodes[other].append(node_ix)
                    graph.aligned_nodes[node_ix].append(other)
                nodes_per_col[col].append(node_ix)

            if prev_node is not None:
                graph.add_edge(prev_node, node_ix, seq_id, 2)
            else:
                graph.sequences.append(SequenceInfo(name, node_ix))
            prev_node = node_ix

        if prev_node is None:
            # All-gap/empty row: register it anchored at the virtual start
            # (the same treatment fusion gives empty sequences) so later
            # rows' sequence ids stay aligned with their edge tags.  The
            # reference drops the row here and desynchronizes every
            # following id (graph.rs:90-95) — our own emitter writes
            # all-gap rows for empty sequences, so the importer must
            # handle them.
            graph.sequences.append(SequenceInfo(name, graph.start_node))

    graph.post_process()
    return graph


# -- DOT --------------------------------------------------------------------


def _escape(s: str) -> str:
    return s.replace("\\", "\\\\").replace('"', '\\"')


def format_as_dot(graph: POAGraph, out: IO[str]) -> None:
    """Library-style DOT (node/edge labels only).

    Mirrors the layout of the graph library's default DOT printer the
    reference leans on for its ``Display`` impl.
    """
    out.write("digraph {\n")
    for n in graph.all_nodes():
        label = f"'{graph.get_symbol_char(n)}' ({n})"
        out.write(f"    {n} [ label = \"{_escape(label)}\" ]\n")
    for e in graph.edge_references():
        label = f"{e.weight}, {e.sequence_ids!r}"
        out.write(f"    {e.source} -> {e.target} [ label = \"{_escape(label)}\" ]\n")
    out.write("}\n")
    out.write("\n")


def _graphviz_node_color(symbol: int) -> str:
    return {
        ord("A"): "#80BC42",
        ord("C"): "#006DB6",
        ord("G"): "#F36C3E",
        ord("T"): "#B12028",
    }.get(symbol, "#939393")


def graph_to_dot(graph: POAGraph, out: IO[str]) -> None:
    """Annotated DOT for visualization (reference: ``src/io/graph.rs:504-598``)."""
    seq_names = "\t".join(f"{s.name}:{s.start_node}" for s in graph.sequences)
    out.write(f"# seq:\t{seq_names}\n")
    out.write("digraph {\n")
    out.write('rankdir="LR"\n')
    out.write('node [shape=square, style=filled, fillcolor="#e3e3e3", penwidth=0]\n')
    out.write("\n")

    for n in graph.all_nodes():
        out.write(
            f'{n} [label="{graph.get_symbol_char(n)}"; '
            f'fontcolor="{_graphviz_node_color(graph.get_symbol(n))}"]\n'
        )

    processed = set()
    for n in graph.all_nodes():
        if n in processed:
            continue
        node_list = [n] + list(graph.aligned_nodes[n])
        if len(node_list) > 1:
            node_list_str = "; ".join(str(v) for v in node_list)
            out.write(f"{{rank=same; {node_list_str}}}\n")
        processed.update(node_list)

    max_num_seq = max(
        (len(e.sequence_ids) for e in graph.edge_references()), default=1
    )
    if max_num_seq == 0:
        max_num_seq = 1
    min_weight, max_weight = 1.0, 40.0
    min_penwidth, max_penwidth = 0.5, 3.5

    for e in graph.edge_references():
        seq_list_str = " ".join(f"s{v}" for v in e.sequence_ids)
        num_seq = len(e.sequence_ids)
        frac = num_seq / max_num_seq
        # round-half-away-from-zero, matching the reference's rounding
        scaled_weight = int(math.floor(min_weight + frac * (max_weight - min_weight) + 0.5))
        scaled_penwidth = min_penwidth + frac * (max_penwidth - min_penwidth)
        out.write(
            f"{e.source} -> {e.target} [weight={scaled_weight}; "
            f"penwidth={_fmt_float(scaled_penwidth)}; label={num_seq}; "
            f'class="{seq_list_str}"]\n'
        )

    out.write("}\n")


def _fmt_float(v: float) -> str:
    """Rust's `{}` float formatting: shortest representation, keeps `.0`."""
    s = repr(v)
    return s
