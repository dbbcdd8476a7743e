"""Alignment representation shared by the aligner engines and the graph.

Reference: ``src/aligner/alignment.rs``.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional


class AlignedPair(NamedTuple):
    """One column of a pairwise (graph, query) alignment.

    ``rpos`` is a graph node index (or ``None`` for an insertion into the
    graph), ``qpos`` a 0-based query offset (or ``None`` for a deletion).

    NamedTuple rather than a dataclass: serving-path alignments carry
    thousands of pairs per read and tuple construction is ~5x cheaper
    than frozen-dataclass construction (measured on the anchored
    corridor path, where pair materialization briefly dominated).
    """

    rpos: Optional[int]
    qpos: Optional[int]

    def is_aligned(self) -> bool:
        return self.rpos is not None and self.qpos is not None

    def is_indel(self) -> bool:
        return not self.is_aligned()

    def is_deletion(self) -> bool:
        return self.rpos is None and self.qpos is not None

    def is_insertion(self) -> bool:
        return self.rpos is not None and self.qpos is None


Alignment = List[AlignedPair]


class ArrayAlignment:
    """Array-backed alignment: a lazy sequence of :class:`AlignedPair`.

    The native serving path (``NativeAligner.align_anchored`` /
    ``align_banded``) produces alignments as int32 ``(rpos, qpos)``
    arrays with ``-1`` encoding ``None``.  Materializing thousands of
    ``AlignedPair`` tuples per read costs ~2.7 ms at pangenome scale —
    more than the corridor backtrace itself — so this wrapper keeps the
    arrays and only builds tuples when a consumer actually iterates.
    Vectorized consumers (the GAF emitter's fast path,
    ``poasta_tpu.io.gaf``) read ``rpos_arr``/``qpos_arr`` directly.

    Equality (against lists of pairs or other ArrayAlignments) matches
    the materialized list, so tests and callers can mix representations.
    """

    __slots__ = ("rpos_arr", "qpos_arr")

    def __init__(self, rpos_arr, qpos_arr) -> None:
        self.rpos_arr = rpos_arr
        self.qpos_arr = qpos_arr

    def __len__(self) -> int:
        return len(self.rpos_arr)

    def __getitem__(self, i):
        if isinstance(i, slice):
            return ArrayAlignment(self.rpos_arr[i], self.qpos_arr[i])
        r = int(self.rpos_arr[i])
        q = int(self.qpos_arr[i])
        return AlignedPair(r if r >= 0 else None, q if q >= 0 else None)

    def __iter__(self):
        for r, q in zip(self.rpos_arr.tolist(), self.qpos_arr.tolist()):
            yield AlignedPair(r if r >= 0 else None, q if q >= 0 else None)

    def __bool__(self) -> bool:
        return len(self.rpos_arr) > 0

    def __eq__(self, other) -> bool:
        if isinstance(other, ArrayAlignment):
            return (len(self) == len(other)
                    and bool((self.rpos_arr == other.rpos_arr).all())
                    and bool((self.qpos_arr == other.qpos_arr).all()))
        if isinstance(other, (list, tuple)):
            return len(self) == len(other) and all(
                a == b for a, b in zip(self, other))
        return NotImplemented

    def __repr__(self) -> str:
        return f"ArrayAlignment({list(self)!r})"


def print_alignment(graph, sequence: bytes, aln: Alignment) -> str:
    """Three-row pretty printer (reference: ``alignment.rs:42-78``)."""
    graph_chars: List[str] = []
    aln_chars: List[str] = []
    query_chars: List[str] = []

    for pair in aln:
        if pair.is_aligned():
            node = graph.get_symbol_char(pair.rpos)
            qry = chr(sequence[pair.qpos])
            graph_chars.append(node)
            aln_chars.append("|" if node == qry else "·")
            query_chars.append(qry)
        elif pair.rpos is not None:
            graph_chars.append(graph.get_symbol_char(pair.rpos))
            aln_chars.append(" ")
            query_chars.append("-")
        elif pair.qpos is not None:
            graph_chars.append("-")
            aln_chars.append(" ")
            query_chars.append(chr(sequence[pair.qpos]))

    return "{}\n{}\n{}".format("".join(graph_chars), "".join(aln_chars), "".join(query_chars))
