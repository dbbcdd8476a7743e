"""GAF record emission for read-to-graph alignment.

Output is byte-identical to the reference (``src/io/gaf.rs:119-304``).
``NodeSegmentResolver`` here precomputes a node -> (segment, position) table
once — O(nodes) total — fixing the reference's O(graph)-per-node linear
rescan (``src/io/gaf.rs:32-54``), a known scaling weakness in its read
mapper hot loop.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..aligner.alignment import Alignment, ArrayAlignment
from .gfa import GraphSegments


class NodeSegmentResolver:
    """Node -> (segment, position-in-segment) table.

    Built once in O(nodes); also keeps dense numpy arrays (node-indexed,
    -1 = not in any segment) so the GAF emitter's vectorized fast path
    can gather per-pair segments without a Python loop per node."""

    def __init__(self, graph, segments: GraphSegments) -> None:
        self._table: Dict[int, Tuple[int, int]] = {}
        n_ids = graph.node_count_with_start_and_end()
        self.seg_ix_arr = np.full(n_ids, -1, dtype=np.int32)
        self.seg_pos_arr = np.full(n_ids, -1, dtype=np.int32)
        self.node_sym_arr = np.asarray(graph.symbols, dtype=np.int32)
        self.end_node = graph.end_node
        for segment_ix, (start, end) in enumerate(
            zip(segments.start_nodes, segments.end_nodes)
        ):
            curr = start
            pos = 0
            while True:
                self._table[curr] = (segment_ix, pos)
                self.seg_ix_arr[curr] = segment_ix
                self.seg_pos_arr[curr] = pos
                if curr == end:
                    break
                curr = next(graph.successors(curr), None)
                if curr is None:
                    break
                pos += 1

    def resolve(self, node: int) -> Optional[Tuple[int, int]]:
        return self._table.get(node)


@dataclass
class GAFRecord:
    query_name: str
    query_length: int
    query_start: int
    query_end: int
    strand: str
    graph_path: str
    path_length: int
    path_aln_start: int
    path_aln_end: int
    num_matches: int
    aln_block_len: int
    mapping_quality: int
    additional_fields: List[Tuple[str, str, str]] = field(default_factory=list)

    def __str__(self) -> str:
        fields_str = "".join(
            f"\t{tag}:{typ}:{val}" for tag, typ, val in self.additional_fields
        ).strip()
        return (
            f"{self.query_name}\t{self.query_length}\t{self.query_start}\t"
            f"{self.query_end}\t{self.strand}\t{self.graph_path}\t"
            f"{self.path_length}\t{self.path_aln_start}\t{self.path_aln_end}\t"
            f"{self.num_matches}\t{self.aln_block_len}\t{self.mapping_quality}\t"
            f"{fields_str}"
        )


_OP_CHARS = ("=", "X", "D", "I")


def _seg_path_entry(graph_segments: GraphSegments, seg_ix: int) -> str:
    """``>name`` for a forward segment copy, ``<name`` for a
    reverse-complement copy (doubled-graph GFA extension)."""
    oris = graph_segments.orientations
    mark = "<" if seg_ix < len(oris) and oris[seg_ix] == "-" else ">"
    return mark + graph_segments.names[seg_ix]


def _alignment_to_gaf_arrays(
    graph_segments: GraphSegments,
    seq_name: str,
    sequence: bytes,
    alignment: ArrayAlignment,
    resolver: NodeSegmentResolver,
) -> Optional[GAFRecord]:
    """Vectorized GAF emission over an :class:`ArrayAlignment`.

    Bit-identical to the scalar path below (fuzz-pinned in
    tests/test_gaf_arrays.py) but runs in numpy over the (rpos, qpos)
    arrays — the scalar per-pair loop costs several ms per 5 kb read,
    which dominates the serving path once alignment itself is fast.
    """
    rp = alignment.rpos_arr
    qp = alignment.qpos_arr
    aligned = (rp >= 0) & (qp >= 0)
    if not aligned.any():
        return None

    first = int(np.argmax(aligned))
    # leading pairs: only (rpos, None) pairs advance query_start
    # (matching the scalar loop's is_insertion() check)
    query_start = int(((rp[:first] >= 0) & (qp[:first] < 0)).sum())

    sub_rp = rp[first:]
    sub_qp = qp[first:]
    al = aligned[first:]
    has_r = sub_rp >= 0

    seg_of_r = resolver.seg_ix_arr[sub_rp[has_r]]
    if seg_of_r.size and int(seg_of_r.min()) < 0:
        raise ValueError("node not found in any segment")

    seq_arr = np.frombuffer(sequence, dtype=np.uint8).astype(np.int32)
    sym_eq = np.zeros(len(sub_rp), dtype=bool)
    # end node matches every symbol (reference: poa.rs:462-465)
    sym_eq[al] = (
        resolver.node_sym_arr[sub_rp[al]] == seq_arr[sub_qp[al]]
    ) | (sub_rp[al] == resolver.end_node)
    # op codes: 0 '=', 1 'X', 2 'D' (graph only), 3 'I' (query only)
    ops = np.where(al, np.where(sym_eq, 0, 1),
                   np.where(has_r, 2, 3)).astype(np.int8)

    # path segments: consecutive-dedup over graph-consuming pairs
    change = np.empty(len(seg_of_r), dtype=bool)
    if len(seg_of_r):
        change[0] = True
        np.not_equal(seg_of_r[1:], seg_of_r[:-1], out=change[1:])
    path_segments = seg_of_r[change]
    # per graph-consuming pair: its index into path_segments
    idx_of_r = np.cumsum(change) - 1
    al_among_r = al[has_r]
    last_match_segment_ix = int(idx_of_r[al_among_r][-1])
    last_aligned_node = int(sub_rp[al][-1])
    last_match_segment_pos = int(resolver.seg_pos_arr[last_aligned_node])

    first_seg_pos = int(resolver.seg_pos_arr[int(sub_rp[0])])
    path_aln_start = first_seg_pos
    num_matches = int((ops == 0).sum())
    query_end = int(sub_qp[al][-1])

    prefix = path_segments[: last_match_segment_ix + 1]
    graph_path = "".join(_seg_path_entry(graph_segments, s)
                         for s in prefix.tolist())
    seg_lengths = np.asarray(graph_segments.segment_lengths, dtype=np.int64)
    path_length = int(seg_lengths[prefix].sum())
    path_aln_end = (
        path_length
        - int(seg_lengths[int(prefix[-1])])
        + last_match_segment_pos
    )

    # RLE over ops; a single trailing indel run dropped (gaf.rs:265-275)
    bounds = np.flatnonzero(np.r_[True, ops[1:] != ops[:-1]])
    run_ops = ops[bounds]
    run_lens = np.diff(np.r_[bounds, len(ops)])
    if len(run_ops) and run_ops[-1] >= 2:
        run_ops = run_ops[:-1]
        run_lens = run_lens[:-1]
    aln_block_len = int(run_lens.sum())
    cigar_string = "".join(
        f"{c}{_OP_CHARS[o]}" for o, c in zip(run_ops.tolist(),
                                             run_lens.tolist())
    )

    return GAFRecord(
        query_name=seq_name,
        query_length=len(sequence),
        query_start=query_start,
        query_end=query_end,
        strand="+",
        graph_path=graph_path,
        path_length=path_length,
        path_aln_start=path_aln_start,
        path_aln_end=path_aln_end,
        num_matches=num_matches,
        aln_block_len=aln_block_len,
        mapping_quality=60,
        additional_fields=[("cg", "Z", cigar_string)],
    )


def alignment_to_gaf(
    graph,
    graph_segments: GraphSegments,
    seq_name: str,
    sequence: bytes,
    alignment: Alignment,
    resolver: NodeSegmentResolver,
) -> Optional[GAFRecord]:
    """Build a GAF record from an alignment (reference: ``gaf.rs:152-304``)."""
    if isinstance(alignment, ArrayAlignment) and len(alignment):
        return _alignment_to_gaf_arrays(
            graph_segments, seq_name, sequence, alignment, resolver)
    if not alignment or not any(p.is_aligned() for p in alignment):
        # no aligned pair: there is no graph path to report (the
        # reference would panic indexing an empty segment list here)
        return None

    query_start = 0
    path_aln_start = 0
    path_segments: List[int] = []
    cigar_ops: List[str] = []

    at_aln_start = True
    last_match_segment_ix = 0
    last_match_segment_pos = 0
    num_matches = 0

    for pair in alignment:
        if at_aln_start:
            if pair.is_insertion():
                query_start += 1
            elif pair.is_aligned():
                seg = resolver.resolve(pair.rpos)
                if seg is None:
                    raise ValueError("node not found in any segment")
                segment_ix, segment_pos = seg
                path_aln_start = segment_pos
                path_segments.append(segment_ix)
                if graph.is_symbol_equal(pair.rpos, sequence[pair.qpos]):
                    num_matches += 1
                    cigar_ops.append("=")
                else:
                    cigar_ops.append("X")
                at_aln_start = False
                last_match_segment_ix = len(path_segments) - 1
                last_match_segment_pos = segment_pos
        else:
            if pair.is_aligned():
                seg = resolver.resolve(pair.rpos)
                if seg is None:
                    raise ValueError("node not found in any segment")
                segment_ix, segment_pos = seg
                if not path_segments or path_segments[-1] != segment_ix:
                    path_segments.append(segment_ix)
                if graph.is_symbol_equal(pair.rpos, sequence[pair.qpos]):
                    num_matches += 1
                    cigar_ops.append("=")
                else:
                    cigar_ops.append("X")
                last_match_segment_ix = len(path_segments) - 1
                last_match_segment_pos = segment_pos
            elif pair.rpos is not None:
                seg = resolver.resolve(pair.rpos)
                if seg is None:
                    raise ValueError("node not found in any segment")
                segment_ix, _ = seg
                if not path_segments or path_segments[-1] != segment_ix:
                    path_segments.append(segment_ix)
                cigar_ops.append("D")
            elif pair.qpos is not None:
                cigar_ops.append("I")

    graph_path = "".join(
        _seg_path_entry(graph_segments, s)
        for s in path_segments[: last_match_segment_ix + 1]
    )
    path_length = sum(
        graph_segments.segment_lengths[s]
        for s in path_segments[: last_match_segment_ix + 1]
    )
    path_aln_end = (
        path_length
        - graph_segments.segment_lengths[path_segments[last_match_segment_ix]]
        + last_match_segment_pos
    )

    query_end = next(p.qpos for p in reversed(alignment) if p.is_aligned())

    # RLE over cigar ops; trailing indel dropped (reference: gaf.rs:265-275)
    cigar_rle: List[Tuple[str, int]] = []
    for op in cigar_ops:
        if cigar_rle and cigar_rle[-1][0] == op:
            cigar_rle[-1] = (op, cigar_rle[-1][1] + 1)
        else:
            cigar_rle.append((op, 1))
    if cigar_rle and cigar_rle[-1][0] in ("I", "D"):
        cigar_rle.pop()

    aln_block_len = sum(count for _, count in cigar_rle)
    cigar_string = "".join(f"{count}{op}" for op, count in cigar_rle)

    return GAFRecord(
        query_name=seq_name,
        query_length=len(sequence),
        query_start=query_start,
        query_end=query_end,
        strand="+",
        graph_path=graph_path,
        path_length=path_length,
        path_aln_start=path_aln_start,
        path_aln_end=path_aln_end,
        num_matches=num_matches,
        aln_block_len=aln_block_len,
        mapping_quality=60,
        additional_fields=[("cg", "Z", cigar_string)],
    )
