"""Extract a sequence-coordinate region of a POA graph from annotated DOT.

Our implementation of the capability of the reference's
``contrib/poasta_tools/poasta_graphviz_region.py`` (reference behavior at
``poasta_graphviz_region.py:68-207``): given an annotated DOT file (the
``poasta view -O dot`` / debug output with the ``# seq:`` header and
per-edge ``class="s<i> ..."`` sequence tags), extract the subgraph
spanned by ``seq_name:start-stop`` (1-based by default, see
``--pos-offset``) plus every aligned node in that window, and print it
as DOT, optionally highlighting the paths of chosen sequences.

Usage:
    python -m poasta_tpu.tools.graphviz_region GRAPH_DOT seq1:10-25 \
        [-H seq2:red] [-p 1]
"""

from __future__ import annotations

import argparse
import re
import sys
from pathlib import Path

SEQ_HEADER = re.compile(r"^#\s*seq:\s*(.*)$")
NODE = re.compile(r'^\s*(\d+)\s*\[label="(.)";?\s*(.*)\]')
EDGE = re.compile(r'^\s*(\d+)\s*->\s*(\d+)\s*\[(.*)\]')
RANKSAME = re.compile(r"^\{rank=same;\s*([0-9;\s]+)\}")
CLASS_ATTR = re.compile(r'class="([^"]*)"')


def parse_annotated_dot(path):
    """Returns (sequences {name: start_node}, nodes {ix: symbol},
    edges [(u, v, seq_ids, attrs)], aligned {ix: set(ix)})."""
    sequences = {}
    nodes = {}
    edges = []
    aligned = {}
    with open(path) as fh:
        for line in fh:
            if (m := SEQ_HEADER.match(line)) is not None:
                for item in m.group(1).split("\t"):
                    item = item.strip()
                    if not item:
                        continue
                    name, _, start = item.rpartition(":")
                    sequences[name] = int(start)
            elif (m := EDGE.match(line)) is not None:
                u, v, attrs = int(m.group(1)), int(m.group(2)), m.group(3)
                cm = CLASS_ATTR.search(attrs)
                seq_ids = set()
                if cm:
                    for tok in cm.group(1).split():
                        if tok.startswith("s") and tok[1:].isdigit():
                            seq_ids.add(int(tok[1:]))
                edges.append((u, v, seq_ids, attrs))
            elif (m := NODE.match(line)) is not None:
                nodes[int(m.group(1))] = m.group(2)
            elif (m := RANKSAME.match(line.strip())) is not None:
                group = [int(t) for t in m.group(1).replace(";", " ").split()]
                for n in group:
                    aligned.setdefault(n, set()).update(
                        x for x in group if x != n
                    )
    return sequences, nodes, edges, aligned


def sequence_path(sequences, edges, seq_name):
    """Ordered node list of a sequence's path through the graph."""
    names = list(sequences)
    if seq_name not in sequences:
        raise SystemExit(f"unknown sequence {seq_name!r}; have {names}")
    seq_id = names.index(seq_name)
    nexts = {}
    for u, v, ids, _ in edges:
        if seq_id in ids:
            nexts[u] = v
    node = sequences[seq_name]
    path = [node]
    while node in nexts:
        node = nexts[node]
        path.append(node)
    return path


def extract_region(path, aligned, start, stop):
    """Nodes of path[start:stop] (0-based, stop exclusive) plus their
    aligned-node cliques."""
    core = path[max(start, 0):max(stop, 0)]
    keep = set(core)
    for n in core:
        keep.update(aligned.get(n, ()))
    return keep


def emit_dot(nodes, edges, aligned, keep, highlights, out):
    out.write("digraph {\n")
    out.write('rankdir="LR"\n')
    out.write('node [shape=square, style=filled, fillcolor="#e3e3e3"]\n')
    for n in sorted(keep):
        out.write(f'{n} [label="{nodes.get(n, "?")}"]\n')
    done = set()
    for n in sorted(keep):
        if n in done:
            continue
        clique = [n] + sorted(x for x in aligned.get(n, ()) if x in keep)
        if len(clique) > 1:
            out.write("{rank=same; " + "; ".join(map(str, clique)) + "}\n")
        done.update(clique)
    for u, v, ids, _ in edges:
        if u in keep and v in keep:
            color = "black"
            penwidth = 1.0
            for seq_id, col in highlights.items():
                if seq_id in ids:
                    color = col
                    penwidth = 2.5
                    break
            out.write(
                f'{u} -> {v} [color="{color}"; penwidth={penwidth}; '
                f'label={len(ids)}]\n'
            )
    out.write("}\n")


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Extract and visualize a subgraph of the POA graph.")
    parser.add_argument("poasta_dot", type=Path,
                        help="annotated POA graph in DOT format")
    parser.add_argument("region",
                        help="region to extract: seq_name:start-stop")
    parser.add_argument("-p", "--pos-offset", type=int, default=1,
                        help="base position of sequences in the graph")
    parser.add_argument("-H", "--highlight", type=str, action="append",
                        default=None,
                        help="highlight a sequence path: seq_name:color "
                             "(repeatable)")
    args = parser.parse_args(argv)

    seq_name, _, rng = args.region.rpartition(":")
    try:
        start_s, stop_s = rng.split("-")
        start, stop = int(start_s), int(stop_s)
    except ValueError:
        raise SystemExit("region must be seq_name:start-stop")

    sequences, nodes, edges, aligned = parse_annotated_dot(args.poasta_dot)
    path = sequence_path(sequences, edges, seq_name)
    # reference semantics (poasta_graphviz_region.py:113-151): walk from
    # curr_pos = pos_offset-1 keeping start-1 <= curr_pos < stop, i.e. the
    # stop position is INCLUSIVE in the user's coordinate system
    keep = extract_region(path, aligned,
                          start - args.pos_offset,
                          stop - args.pos_offset + 1)

    highlights = {}
    names = list(sequences)
    for spec in args.highlight or ():
        hname, _, color = spec.rpartition(":")
        if hname not in sequences:
            print(f"unknown highlight sequence {hname!r}", file=sys.stderr)
            continue
        highlights[names.index(hname)] = color or "red"

    emit_dot(nodes, edges, aligned, keep, highlights, sys.stdout)


if __name__ == "__main__":
    main()
