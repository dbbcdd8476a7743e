"""FASTA/FASTQ ingest and FASTA-MSA export.

The MSA exporter assigns each graph node an output column by DFS postorder
honoring ``aligned_nodes`` cliques, then walks each sequence's edge chain —
byte-identical to the reference (``src/io/fasta.rs:19-156``).
"""

from __future__ import annotations

import gzip
from typing import IO, Iterator, List, Tuple


def _open_maybe_gz(path: str):
    if str(path).endswith(".gz"):
        return gzip.open(path, "rt")
    return open(path, "rt")


def read_fasta(path) -> Iterator[Tuple[str, bytes]]:
    """Yield (name, sequence) records; name is the first whitespace token."""
    with _open_maybe_gz(path) as fh:
        name = None
        chunks: List[str] = []
        for line in fh:
            line = line.rstrip("\n").rstrip("\r")
            if line.startswith(">"):
                if name is not None:
                    yield name, "".join(chunks).encode()
                tokens = line[1:].split()
                name = tokens[0] if tokens else ""
                chunks = []
            else:
                chunks.append(line.strip())
        if name is not None:
            yield name, "".join(chunks).encode()


def read_fastq(path) -> Iterator[Tuple[str, bytes]]:
    with _open_maybe_gz(path) as fh:
        while True:
            header = fh.readline()
            if not header:
                return
            header = header.strip()
            if not header:
                continue
            seq = fh.readline().strip()
            fh.readline()  # +
            fh.readline()  # quals
            name = header[1:].split()[0] if len(header) > 1 else ""
            yield name, seq.encode()


def is_fasta_path(path: str) -> bool:
    exts = (".fa", ".fa.gz", ".fna", ".fna.gz", ".fasta", ".fasta.gz")
    return any(str(path).endswith(e) for e in exts)


# -- MSA export --------------------------------------------------------------


def _fasta_aln_for_seq(graph, node_to_column, seq_id: int, start_node: int) -> bytes:
    seq = bytearray()
    curr = start_node
    while curr is not None:
        node_col = node_to_column.get(curr)
        if node_col is None:
            return b""  # empty sequence: start node not in the alignment

        # Every node lands at exactly its column index, so all rows share
        # the same width (matches the published truth MSAs).
        seq.extend(b"-" * (node_col - len(seq)))
        seq.append(graph.get_symbol(curr))

        nxt = None
        for edge in graph.out_edges(curr):
            if seq_id in edge.sequence_ids:
                nxt = edge.target
        curr = nxt

    if node_to_column:
        max_col = max(node_to_column.values())
        seq.extend(b"-" * (max_col + 1 - len(seq)))

    return bytes(seq)


def poa_graph_to_fasta(graph, out: IO[str]) -> None:
    """Write the graph as a columnar FASTA MSA (reference: ``fasta.rs:69-156``)."""
    node_to_column = {}

    # DFS postorder with aligned-node grouping; successor stacks are popped
    # from the back of a collected list (i.e. oldest edge first).
    stack: List[Tuple[int, List[int]]] = [
        (graph.start_node, list(graph.successors(graph.start_node)))
    ]
    visited = set()
    rev_postorder: List[int] = []

    while stack:
        _, succ_list = stack[-1]
        child = None
        while succ_list:
            c = succ_list.pop()
            if c not in visited:
                child = c
                break
        if child is not None:
            visited.add(child)
            successors = list(graph.successors(child))
            for aln_node in graph.get_aligned_nodes(child):
                if aln_node not in visited:
                    visited.add(aln_node)
                    successors.extend(graph.successors(aln_node))
            stack.append((child, successors))
        else:
            rev_postorder.append(stack.pop()[0])

    rev_postorder.reverse()

    curr_col = 0
    for n in rev_postorder:
        if n in (graph.start_node, graph.end_node):
            continue
        if n not in node_to_column:
            node_to_column[n] = curr_col
            for aligned in graph.get_aligned_nodes(n):
                node_to_column[aligned] = curr_col
            curr_col += 1

    for seq_id, seq_info in enumerate(graph.sequences):
        row = _fasta_aln_for_seq(graph, node_to_column, seq_id, seq_info.start_node)
        out.write(f">{seq_info.name}\n")
        out.write(row.decode() + "\n")
