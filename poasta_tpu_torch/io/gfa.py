"""GFA v1/v1.1 parsing and emission.

Emitters compress unbranching node runs into segments via BFS from the start
node and write L-links in edge-slot order plus per-sequence W-walks (v1.1) or
P-lines (v1) — byte-identical to the reference
(``src/io/graph.rs:245-502``, parser: ``src/io/gfa.rs:29-358``).
"""

from __future__ import annotations

import gzip
from collections import deque
from dataclasses import dataclass, field
from typing import IO, Dict, List, Optional, Tuple

from ..graphs.poa import POAGraph
from ..utils.errors import GraphError


@dataclass
class Segment:
    sid: str
    sequence: Optional[str]


@dataclass
class Link:
    sid1: str
    strand1: str
    sid2: str
    strand2: str
    overlap: Optional[str]


@dataclass
class GraphSegments:
    names: List[str] = field(default_factory=list)
    start_nodes: List[int] = field(default_factory=list)
    end_nodes: List[int] = field(default_factory=list)
    segment_lengths: List[int] = field(default_factory=list)
    # per-entry strand: '+' for a forward copy, '-' for a
    # reverse-complement copy (doubled-graph mode); GAF paths render
    # '-' entries as '<name'.  May be shorter than names for segments
    # tables built before doubling existed — treated as '+'.
    orientations: List[str] = field(default_factory=list)


def parse_gfa_line(line: str):
    parts = line.rstrip().split("\t")
    kind = parts[0]
    if kind == "S":
        if len(parts) < 3:
            raise ValueError("segment line missing fields")
        seq = parts[2].upper() if parts[2] != "*" else None
        return Segment(parts[1], seq)
    if kind == "L":
        if len(parts) < 6:
            raise ValueError("link line missing fields")
        overlap = None if parts[5] == "*" else parts[5]
        return Link(parts[1], parts[2], parts[3], parts[4], overlap)
    return None


# full IUPAC complement (both cases): passing an ambiguity code through
# uncomplemented would give the rc copy silently wrong bases
_RC_TABLE = bytes.maketrans(b"ACGTRYSWKMBDHVNacgtryswkmbdhvn",
                            b"TGCAYRSWMKVHDBNtgcayrswmkvhdbn")


def reverse_complement(seq: bytes) -> bytes:
    return seq.translate(_RC_TABLE)[::-1]


def load_graph_from_gfa(path, reverse_links: str = "reject"
                        ) -> Tuple[POAGraph, GraphSegments]:
    """Build a POA graph from GFA segments + links.

    ``reverse_links``:

    * ``"reject"`` (default) — error on any ``-`` orientation, exactly
      like the reference (``src/io/graph.rs:176-180``).
    * ``"double"`` — EXTENSION beyond the reference: materialize a
      reverse-complement node chain per segment and close the link set
      under strand complementation, so walks may traverse either strand
      of any segment (standard bidirected-to-DAG doubling).  GAF paths
      render reverse entries as ``<name``.  Cycles introduced by the
      links (e.g. palindromic loops) still error — POA requires a DAG.

    Reference: ``src/io/graph.rs:125-227``.
    """
    if reverse_links not in ("reject", "double"):
        raise ValueError("reverse_links must be 'reject' or 'double'")
    double = reverse_links == "double"
    opener = gzip.open if str(path).endswith(".gz") else open
    graph = POAGraph()
    segments = GraphSegments()
    name_to_ix: Dict[str, int] = {}
    links: List[Link] = []
    seen_edges: set = set()

    def add_chain(sid: str, seq: bytes, orientation: str) -> None:
        weights = [1] * len(seq)
        res = graph.add_nodes_for_sequence(seq, weights, 0, len(seq))
        if res is None:
            raise GraphError(f"empty segment {sid}")
        start, end = res
        segments.names.append(sid)
        segments.start_nodes.append(start)
        segments.end_nodes.append(end)
        segments.segment_lengths.append(len(seq))
        segments.orientations.append(orientation)

    with opener(path, "rt") as fh:
        for raw in fh:
            line = raw.strip()
            if not line:
                continue
            try:
                parsed = parse_gfa_line(line)
            except ValueError as exc:
                # unknown record types are skipped per the GFA spec, but a
                # malformed S/L line means the file is broken — fail loudly
                # instead of silently building a partial graph
                raise GraphError(f"malformed GFA line: {line[:80]!r} ({exc})")
            if isinstance(parsed, Segment):
                if parsed.sequence is None:
                    continue
                seq = parsed.sequence.encode()
                name_to_ix[parsed.sid] = len(segments.names)
                add_chain(parsed.sid, seq, "+")
                if double:
                    # rc copy rides at forward ix + 1
                    add_chain(parsed.sid, reverse_complement(seq), "-")
            elif isinstance(parsed, Link):
                if not double and (parsed.strand1 == "-"
                                   or parsed.strand2 == "-"):
                    raise GraphError(
                        "reverse-strand GFA links are not supported "
                        "(pass reverse_links='double' / lasagna "
                        "--reverse-links double to enable the "
                        "doubled-graph extension)")
                # resolvable links add their edges inline (edge insertion
                # order feeds the topo sort, which downstream emitters'
                # byte parity rides on); forward references defer
                if (parsed.sid1 in name_to_ix
                        and parsed.sid2 in name_to_ix):
                    _apply_link(graph, segments, name_to_ix, parsed,
                                double, seen_edges)
                else:
                    links.append(parsed)

    for link in links:
        _apply_link(graph, segments, name_to_ix, link, double, seen_edges)

    graph.post_process()
    return graph, segments


def _apply_link(graph, segments, name_to_ix, link, double, seen) -> None:
    """Add a link's edge (plus its strand-complement in double mode).

    ``seen``: (source, target) pairs already added — the complement
    closure must not duplicate edges (a palindromic self-link coincides
    with its own complement)."""
    def chain_ix(sid: str, strand: str) -> int:
        if sid not in name_to_ix:
            # silently dropping a link to an undefined segment would
            # build a disconnected graph with no warning — fail like
            # malformed lines do
            raise GraphError(
                f"GFA link references undefined segment {sid!r}")
        return name_to_ix[sid] + (1 if double and strand == "-" else 0)

    def add_edge(s1, o1, s2, o2):
        frm = segments.end_nodes[chain_ix(s1, o1)]
        to = segments.start_nodes[chain_ix(s2, o2)]
        if double:
            # dedup only under the closure; reject mode keeps the
            # reference's behavior for repeated L lines verbatim
            if (frm, to) in seen:
                return
            seen.add((frm, to))
        graph.add_edge(frm, to, 0, 1)

    add_edge(link.sid1, link.strand1, link.sid2, link.strand2)
    if double:
        # strand-complement closure: traversing the locus on the other
        # strand crosses this link in the opposite direction with both
        # orientations flipped
        flip = {"+": "-", "-": "+"}
        add_edge(link.sid2, flip[link.strand2],
                 link.sid1, flip[link.strand1])


# -- emission ---------------------------------------------------------------


def _compress_segments(graph: POAGraph):
    """BFS segment compression shared by the GFA v1/v1.1 emitters.

    Returns (segment_sequences, node_to_segment, segment_starts,
    segment_ends, segment_lengths).  Replicates the reference's traversal
    order and its seg-pos assignment (``src/io/graph.rs:249-315``).
    """
    visited = {graph.start_node}
    queue = deque([graph.start_node])

    node_to_segment: Dict[int, Tuple[int, int]] = {}
    segment_starts: Dict[int, int] = {}
    segment_ends: Dict[int, int] = {}
    segment_lengths: Dict[int, int] = {}
    segment_seqs: List[bytes] = []
    curr_segment_id = 0

    while queue:
        front = queue.popleft()
        if front == graph.start_node:
            for succ in graph.successors(front):
                if succ not in visited:
                    queue.append(succ)
                    visited.add(succ)
        else:
            segment = bytearray([graph.get_symbol(front)])
            curr_node = front
            curr_out_degree = graph.out_degree(front)

            seg_pos = 0
            node_to_segment[front] = (curr_segment_id, seg_pos)
            segment_starts[front] = curr_segment_id
            while curr_out_degree == 1:
                next_node = next(graph.successors(curr_node))
                if graph.in_degree(next_node) == 1 and next_node != graph.end_node:
                    segment.append(graph.get_symbol(next_node))
                    node_to_segment[next_node] = (curr_segment_id, seg_pos)
                else:
                    break
                curr_node = next_node
                curr_out_degree = graph.out_degree(curr_node)
                seg_pos += 1

            segment_seqs.append(bytes(segment))
            segment_ends[curr_node] = curr_segment_id
            segment_lengths[curr_segment_id] = len(segment)
            visited.add(curr_node)

            for succ in graph.successors(curr_node):
                if succ not in visited and succ != graph.end_node:
                    visited.add(succ)
                    queue.append(succ)

            curr_segment_id += 1

    return segment_seqs, node_to_segment, segment_starts, segment_ends, segment_lengths


def _seq_walk(graph: POAGraph, seq_id: int, start_node: int, node_to_segment):
    """Follow a sequence's edge chain; returns (segments, last_pos)."""
    curr = start_node
    prev_segment, _ = node_to_segment[start_node]
    walk_segments = [prev_segment]
    last_pos = 0

    while curr is not None:
        node_segment, last_pos = node_to_segment[curr]
        if node_segment != prev_segment:
            walk_segments.append(node_segment)
        nxt = None
        for edge in graph.out_edges(curr):
            if seq_id in edge.sequence_ids:
                nxt = edge.target
        prev_segment = node_segment
        curr = nxt

    return walk_segments, last_pos


def graph_to_gfa(graph: POAGraph, out: IO[str]) -> None:
    """GFA v1.1 with W-lines (reference: ``src/io/graph.rs:245-372``)."""
    out.write("H\tVN:Z:1.1\n")
    seqs, node_to_segment, seg_starts, seg_ends, seg_lengths = _compress_segments(graph)
    for sid, seq in enumerate(seqs):
        out.write(f"S\ts{sid}\t{seq.decode()}\n")

    for edge in graph.edge_references():
        if edge.source in seg_ends and edge.target in seg_starts:
            out.write(f"L\ts{seg_ends[edge.source]}\t+\ts{seg_starts[edge.target]}\t+\t0M\n")

    for seq_id, seq_info in enumerate(graph.sequences):
        start_segment, start_pos = node_to_segment[seq_info.start_node]
        walk_segments, last_pos = _seq_walk(graph, seq_id, seq_info.start_node, node_to_segment)
        total = sum(seg_lengths[s] for s in walk_segments)
        end_pos = total - seg_lengths[walk_segments[-1]] + last_pos
        path = "".join(f">s{s}" for s in walk_segments)
        out.write(f"W\t*\t0\t{seq_info.name}\t{start_pos}\t{end_pos}\t{path}\n")


def graph_to_gfav1(graph: POAGraph, out: IO[str]) -> None:
    """GFA v1 with P-lines (reference: ``src/io/graph.rs:374-502``)."""
    out.write("H\tVN:Z:1.1\n")
    seqs, node_to_segment, seg_starts, seg_ends, seg_lengths = _compress_segments(graph)
    for sid, seq in enumerate(seqs):
        out.write(f"S\t{sid + 1}\t{seq.decode()}\n")

    for edge in graph.edge_references():
        if edge.source in seg_ends and edge.target in seg_starts:
            out.write(f"L\t{seg_ends[edge.source] + 1}\t+\t{seg_starts[edge.target] + 1}\t+\t0M\n")

    for seq_id, seq_info in enumerate(graph.sequences):
        walk_segments, _ = _seq_walk(graph, seq_id, seq_info.start_node, node_to_segment)
        names = ",".join(f"{s + 1}+" for s in walk_segments)
        out.write(f"P\t{seq_info.name}\t{names}\t*\n")
