"""Exact A* POA alignment engine (host oracle).

This is a from-scratch reimplementation of the reference's search semantics
(reference: ``src/aligner/astar.rs``, ``dfa.rs``, ``queue.rs``,
``scoring/gap_affine.rs``, ``scoring/gap_affine_2piece.rs``,
``bubbles/reached.rs``).  It exists for two reasons:

1. **Byte-identical parity.**  The fused-MSA outputs depend not only on the
   optimal score but on which co-optimal alignment the backtrace picks,
   which in turn depends on which states carry converged scores at
   termination.  This engine reproduces the reference's pop order
   (bucketed by f = g + h; within a bucket LIFO per state, states popped
   M, D, I [, D2, I2]), its depth-first greedy match extension, and its
   bubble-based pruning, so the resulting score tables — and hence the
   backtrace — match the reference exactly.
2. **Oracle for the TPU engine.**  Every Pallas/XLA wavefront kernel is
   validated against this engine's scores on randomized graphs/queries.

The TPU throughput path lives in :mod:`poasta_tpu.aligner.wavefront`; this
module is pure host Python and deliberately favors clarity over speed.
"""

from __future__ import annotations

from bisect import bisect_left, bisect_right, insort
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..bubbles.index import BubbleIndex
from .alignment import AlignedPair, Alignment
from .costs import AlignState, EndsFree, GapAffine, Global
from .heuristic import Dijkstra, MinimumGapCostAffine, PathAwareHeuristic
from .path_index import PathIndex

UNVISITED = None  # sentinel; any int score compares lower

M, D, I, D2, I2 = (
    AlignState.MATCH,
    AlignState.DELETION,
    AlignState.INSERTION,
    AlignState.DELETION2,
    AlignState.INSERTION2,
)


def _lower(new: int, old: Optional[int]) -> bool:
    return old is None or new < old


@dataclass
class AstarResult:
    score: int = 0
    alignment: Alignment = field(default_factory=list)
    num_queued: int = 0
    num_visited: int = 0
    num_pruned: int = 0


class _LayeredQueue:
    """Bucket queue keyed by f-value with per-state sub-queues per bucket.

    The reference's *current* code pops buckets LIFO in M, D, I order
    (``gap_affine.rs:954-966``).  That discipline does **not** reproduce the
    published truth MSAs (``tests/*.truth.fa``) on co-optimal alignments —
    those files predate the current queue.  Empirically (all three bundled
    corpora, validated sequence-by-sequence) the truth files' co-optimal
    tiebreaks are reproduced exactly by draining each bucket FIFO with
    deletion states before match states: D, I, M.  We use that discipline
    for the gap-affine model so fused MSAs are byte-identical to the
    published truths.  The two-piece model has no published truth output,
    so it keeps the current reference's order
    (M, D, D2, I, I2 — ``gap_affine_2piece.rs:1069-1089``, LIFO).

    ``discipline="reference"`` selects the reference's *live* LIFO M,D,I
    discipline for the gap-affine model instead, for side-by-side
    comparisons against a freshly built reference binary (scores are
    identical either way; only co-optimal tiebreaks differ).
    """

    def __init__(self, two_piece: bool, discipline: str = "truth") -> None:
        if discipline not in ("truth", "reference"):
            raise ValueError(f"unknown queue discipline {discipline!r}")
        self.layers: deque = deque()
        self.layer_min = 0
        self.two_piece = two_piece
        if two_piece or discipline == "reference":
            self.pop_order = (M, D, D2, I, I2) if two_piece else (M, D, I)
            self.fifo = False
        else:
            self.pop_order = (D, I, M)
            self.fifo = True

    def _new_layer(self):
        return {M: deque(), D: deque(), I: deque(), D2: deque(), I2: deque()}

    def push(self, node: int, offset: int, state: AlignState, score: int, h: int) -> None:
        priority = score + h
        if not self.layers:
            self.layers.append(self._new_layer())
            self.layer_min = priority
        else:
            layer_max = self.layer_min + len(self.layers)
            if priority < self.layer_min:
                for _ in range(self.layer_min - priority):
                    self.layers.appendleft(self._new_layer())
                self.layer_min = priority
            elif priority >= layer_max:
                for _ in range(priority - self.layer_min + 1 - len(self.layers)):
                    self.layers.append(self._new_layer())
        self.layers[priority - self.layer_min][state].append((score, node, offset))

    def pop(self) -> Optional[Tuple[int, int, int, AlignState]]:
        if not self.layers:
            return None
        layer = self.layers[0]
        item = None
        for state in self.pop_order:
            if layer[state]:
                if self.fifo:
                    score, node, offset = layer[state].popleft()
                else:
                    score, node, offset = layer[state].pop()
                item = (score, node, offset, state)
                break
        while self.layers and all(not self.layers[0][s] for s in self.pop_order):
            self.layers.popleft()
            self.layer_min += 1
        return item


class _Visited:
    """Sparse per-state score store + bubble bookkeeping.

    Replaces the reference's blocked hash storage
    (``gap_affine.rs:442-699``) with plain dicts; identical observable
    behaviour (get/set/update-if-lower and reached bubble-exit offsets).
    """

    def __init__(self, graph, costs, seq_len: int, bubble_index: BubbleIndex) -> None:
        self.graph = graph
        self.costs = costs
        self.seq_len = seq_len
        self.bubble_index = bubble_index
        self.scores: Dict[Tuple[int, int], List[Optional[int]]] = {}
        n = graph.node_count_with_start_and_end()
        self.bubbles_reached_m: List[List[int]] = [[] for _ in range(n)]

    def get_score(self, node: int, offset: int, state: AlignState) -> Optional[int]:
        cell = self.scores.get((node, offset))
        return cell[state] if cell is not None else None

    def set_score(self, node: int, offset: int, state: AlignState, score: int) -> None:
        cell = self.scores.setdefault((node, offset), [None] * 5)
        cell[state] = score

    def update_score_if_lower(self, node: int, offset: int, state: AlignState, score: int) -> bool:
        cell = self.scores.setdefault((node, offset), [None] * 5)
        if _lower(score, cell[state]):
            cell[state] = score
            return True
        return False

    def mark_reached(self, score: int, node: int, offset: int, state: AlignState) -> None:
        if state == M and self.bubble_index.is_exit(node):
            lst = self.bubbles_reached_m[node]
            i = bisect_left(lst, offset)
            if i >= len(lst) or lst[i] != offset:
                lst.insert(i, offset)

    # -- bubble pruning (reference: ``bubbles/reached.rs``) ---------------
    def prune(self, score: int, node: int, offset: int, state: AlignState) -> bool:
        bi = self.bubble_index
        if not bi.node_is_part_of_bubble(node):
            return False
        for bubble in bi.get_node_bubbles(node):
            reached = self.bubbles_reached_m[bubble.bubble_exit]
            if not self._can_improve_bubble(bubble, reached, node, offset, state, score):
                return True
        return False

    def _can_improve_bubble(self, bubble, reached, node, offset, state, score) -> bool:
        if not reached:
            return True
        if node == bubble.bubble_exit:
            return True

        target_min = offset + bubble.min_dist_to_exit
        target_max = offset + bubble.max_dist_to_exit
        min_dist_to_end = max(self.bubble_index.get_min_dist_to_end(bubble.bubble_exit) - 1, 0)

        if target_max > self.seq_len:
            return True

        exit_node = bubble.bubble_exit
        costs = self.costs

        # prev_reached: largest reached offset strictly below target_min
        i = bisect_left(reached, target_min)
        prev_reached = reached[i - 1] if i > 0 else None

        last_offset = None
        j = i
        while j < len(reached) and reached[j] <= target_max:
            next_reached = reached[j]
            offset1 = target_min if prev_reached is None else max(target_min, prev_reached + 1)

            if state == D:
                c = self.get_score(exit_node, next_reached, M)
                if c + costs.gap_open > score:
                    return True
            elif state == D2:
                c = self.get_score(exit_node, next_reached, M)
                if c + costs.gap_open2 > score:
                    return True

            if prev_reached is not None:
                if state == I:
                    c = self.get_score(exit_node, prev_reached, M)
                    if c + costs.gap_open > score:
                        return True
                elif state == I2:
                    c = self.get_score(exit_node, prev_reached, M)
                    if c + costs.gap_open2 > score:
                        return True

            if self._can_improve_at_offset(
                exit_node, offset1, score, prev_reached, next_reached, min_dist_to_end
            ):
                return True

            offset2 = min(target_max, max(target_min, next_reached - 1))
            if offset2 != offset1 and self._can_improve_at_offset(
                exit_node, offset2, score, prev_reached, next_reached, min_dist_to_end
            ):
                return True

            prev_reached = next_reached
            last_offset = offset2
            j += 1

        k = bisect_right(reached, target_max)
        next_reached = reached[k] if k < len(reached) else None

        if last_offset is None and self._can_improve_at_offset(
            exit_node, target_min, score, prev_reached, next_reached, min_dist_to_end
        ):
            return True

        if (last_offset is None or last_offset < target_max) and self._can_improve_at_offset(
            exit_node, target_max, score, prev_reached, next_reached, min_dist_to_end
        ):
            return True

        if prev_reached is not None:
            if state == I:
                c = self.get_score(exit_node, prev_reached, M)
                if c + costs.gap_open > score:
                    return True
            elif state == I2:
                c = self.get_score(exit_node, prev_reached, M)
                if c + costs.gap_open2 > score:
                    return True

        return False

    def _can_improve_at_offset(
        self, exit_node, offset_to_check, score, left, right, min_dist_to_end
    ) -> bool:
        implicit = None
        if left is not None and right is not None:
            left_score = self.get_score(exit_node, left, M)
            right_score = self.get_score(exit_node, right, M)
            from_left = left_score + self.costs.gap_cost(M, offset_to_check - left)
            from_right = right_score + self.costs.gap_cost(M, right - offset_to_check)
            if right - offset_to_check > min_dist_to_end:
                implicit = from_left
            else:
                implicit = min(from_left, from_right)
        elif right is not None:
            right_score = self.get_score(exit_node, right, M)
            from_right = right_score + self.costs.gap_cost(M, right - offset_to_check)
            if right - offset_to_check > min_dist_to_end:
                implicit = None
            else:
                implicit = from_right
        elif left is not None:
            left_score = self.get_score(exit_node, left, M)
            implicit = left_score + self.costs.gap_cost(M, offset_to_check - left)

        return implicit is None or score < implicit


def _dist_to_end_bfs(graph, start: int, max_dist: int) -> Optional[int]:
    """Bounded BFS hop count to the end node (reference: ``gap_affine.rs:91-118``)."""
    queue = deque([(start, 0)])
    visited = {start}
    while queue:
        n, dist = queue.popleft()
        if n == graph.end_node:
            return dist
        if dist >= max_dist:
            continue
        for succ in graph.successors(n):
            if succ not in visited:
                visited.add(succ)
                queue.append((succ, dist + 1))
    return None


class _AlignmentGraph:
    """Expansion rules for the alignment state space.

    One class covers both cost models; ``two_piece`` toggles the extra
    I2/D2 transitions (reference: ``gap_affine.rs:129-432``,
    ``gap_affine_2piece.rs:173-516``).
    """

    def __init__(self, costs, aln_type) -> None:
        self.costs = costs
        self.aln_type = aln_type
        self.two_piece = costs.is_two_piece

    def initial_states(self, graph) -> List[Tuple[int, int]]:
        if isinstance(self.aln_type, Global):
            return [(graph.start_node, 0)]
        assert isinstance(self.aln_type, EndsFree)
        states: List[Tuple[int, int]] = []
        kind, _ = self.aln_type.graph_free_begin
        if kind == "unbounded":
            temp = [
                (node, 0)
                for node in graph.all_nodes()
                if node != graph.start_node and node != graph.end_node
            ]
            if self.two_piece:
                # the two-piece queue drains LIFO (reference order), so
                # reverse to process lower node indices first; the
                # gap-affine queue drains FIFO (truth-corpus discipline),
                # where insertion order already does that
                temp.reverse()
            states.extend(temp)
        else:
            states.append((graph.start_node, 0))
        if not states:
            states.append((graph.start_node, 0))
        return states

    def is_end(self, graph, seq: bytes, node: int, offset: int, state: AlignState) -> bool:
        if isinstance(self.aln_type, Global):
            return state == M and node == graph.end_node and offset == len(seq)
        assert isinstance(self.aln_type, EndsFree)
        qkind, qval = self.aln_type.qry_free_end
        # offsets past len(seq) exist in the state space (the ref-graph-end
        # expansion opens an insertion at offset+1 unconditionally, like the
        # reference; gap_affine.rs:346-367) but never describe a valid query
        # suffix — a negative remaining length must not satisfy a bound
        rem = len(seq) - offset
        if qkind == "unbounded":
            if self.two_piece:
                can_end_query = offset >= len(seq) or len(seq) == 0
            else:
                can_end_query = offset > 0 or len(seq) == 0
        elif qkind == "included":
            can_end_query = 0 <= rem <= qval
        else:
            can_end_query = 0 <= rem < qval

        gkind, gval = self.aln_type.graph_free_end
        if gkind == "unbounded":
            can_end_graph = True
        elif gkind == "included":
            d = _dist_to_end_bfs(graph, node, gval)
            can_end_graph = d is not None and d <= gval
        else:
            d = _dist_to_end_bfs(graph, node, max(gval - 1, 0))
            can_end_graph = d is not None and d < gval

        return state == M and can_end_query and can_end_graph

    def expand_match(self, visited, graph, seq, score, node, offset, emit) -> None:
        """Expansion of a popped Match state.

        Besides the depth-first greedy extension, a popped Match state also
        opens substitution/indel neighbors directly.  The end node is
        excluded here — the greedy extension handles reaching it as a
        zero-cost hop at the same query offset.  (This matches the behavior
        that produced the published truth MSAs; the mismatch-event-only
        variant yields different co-optimal tiebreaks.)
        """
        c = self.costs
        child_offset = offset + 1
        for succ in graph.successors(node):
            if succ == graph.end_node:
                continue
            if child_offset <= len(seq):
                delta = 0 if graph.is_symbol_equal(succ, seq[child_offset - 1]) else c.mismatch
                if visited.update_score_if_lower(succ, child_offset, M, score + delta):
                    emit(delta, succ, child_offset, M)
            delta = c.gap_open + c.gap_extend
            if visited.update_score_if_lower(succ, offset, D, score + delta):
                emit(delta, succ, offset, D)
        delta = c.gap_open + c.gap_extend
        if child_offset <= len(seq) and visited.update_score_if_lower(
            node, child_offset, I, score + delta
        ):
            emit(delta, node, child_offset, I)

    # Each expand_* yields (score_delta, node, offset, state) for states whose
    # stored score improved.
    def expand_all(self, visited, graph, seq, score, node, offset, state, emit) -> None:
        c = self.costs
        if state == M:
            self.expand_match(visited, graph, seq, score, node, offset, emit)
        elif state == I:
            if visited.update_score_if_lower(node, offset, M, score):
                emit(0, node, offset, M)
            if offset < len(seq):
                if visited.update_score_if_lower(node, offset + 1, I, score + c.gap_extend):
                    emit(c.gap_extend, node, offset + 1, I)
                if self.two_piece and visited.update_score_if_lower(
                    node, offset + 1, I2, score + c.gap_extend2
                ):
                    emit(c.gap_extend2, node, offset + 1, I2)
        elif state == I2:
            if visited.update_score_if_lower(node, offset, M, score):
                emit(0, node, offset, M)
            if offset < len(seq) and visited.update_score_if_lower(
                node, offset + 1, I2, score + c.gap_extend2
            ):
                emit(c.gap_extend2, node, offset + 1, I2)
        elif state == D:
            if visited.update_score_if_lower(node, offset, M, score):
                emit(0, node, offset, M)
            for succ in graph.successors(node):
                if visited.update_score_if_lower(succ, offset, D, score + c.gap_extend):
                    emit(c.gap_extend, succ, offset, D)
                if self.two_piece and visited.update_score_if_lower(
                    succ, offset, D2, score + c.gap_extend2
                ):
                    emit(c.gap_extend2, succ, offset, D2)
        elif state == D2:
            if visited.update_score_if_lower(node, offset, M, score):
                emit(0, node, offset, M)
            for succ in graph.successors(node):
                if visited.update_score_if_lower(succ, offset, D2, score + c.gap_extend2):
                    emit(c.gap_extend2, succ, offset, D2)

    def expand_ref_graph_end(self, visited, parent, score, emit) -> None:
        c = self.costs
        node, offset = parent
        delta = c.gap_open + c.gap_extend
        if visited.update_score_if_lower(node, offset + 1, I, score + delta):
            emit(delta, node, offset + 1, I)

    def expand_query_end(self, visited, parent, child: int, score, emit) -> None:
        c = self.costs
        _, offset = parent
        delta = c.gap_open + c.gap_extend
        if visited.update_score_if_lower(child, offset, D, score + delta):
            emit(delta, child, offset, D)

    def expand_mismatch(self, visited, parent, child, score, emit) -> None:
        c = self.costs
        pnode, poffset = parent
        cnode, coffset = child
        if visited.update_score_if_lower(cnode, coffset, M, score + c.mismatch):
            emit(c.mismatch, cnode, coffset, M)
        delta = c.gap_open + c.gap_extend
        if visited.update_score_if_lower(pnode, poffset + 1, I, score + delta):
            emit(delta, pnode, poffset + 1, I)
        if visited.update_score_if_lower(cnode, poffset, D, score + delta):
            emit(delta, cnode, poffset, D)


# -- depth-first greedy match extension (reference: ``dfa.rs:86-251``) -----

RG_END, Q_END, MIS = 0, 1, 2


class _Dfa:
    def __init__(self, graph, seq: bytes, score: int, node: int, offset: int) -> None:
        self.graph = graph
        self.seq = seq
        self.score = score
        self.num_visited = 0
        self.num_pruned = 0
        # stack entries: [node, offset, succ_list, next_index]
        self.stack = [[node, offset, list(graph.successors(node)), 0]]
        self._initial = (node, offset)
        self._did_initial_check = False

    def extend(self, visited) -> Optional[Tuple[int, tuple, tuple]]:
        graph, seq = self.graph, self.seq

        if not self._did_initial_check:
            self._did_initial_check = True
            if len(self.stack) == 1 and seq:
                node, offset = self._initial
                if offset == 0 and graph.is_symbol_equal(node, seq[0]):
                    if visited.update_score_if_lower(node, 1, M, self.score):
                        self.stack[0] = [node, 1, list(graph.successors(node)), 0]
                        visited.mark_reached(self.score, node, 1, M)
                        self.num_visited += 1
                        if len(seq) == 1:
                            return (RG_END, (node, 0), (node, 1))

        while self.stack:
            top = self.stack[-1]
            pnode, poffset, succs, idx = top
            advanced = False
            while top[3] < len(succs):
                child = succs[top[3]]
                top[3] += 1

                if child == graph.end_node:
                    visited.update_score_if_lower(child, poffset, M, self.score)
                    return (RG_END, (pnode, poffset), (child, poffset))

                if poffset >= len(seq):
                    return (Q_END, (pnode, poffset), (child,))

                child_offset = poffset + 1
                if graph.is_symbol_equal(child, seq[child_offset - 1]):
                    if visited.update_score_if_lower(child, child_offset, M, self.score):
                        if visited.prune(self.score, child, child_offset, M):
                            self.num_pruned += 1
                            continue
                        visited.mark_reached(self.score, child, child_offset, M)
                        self.num_visited += 1
                        self.stack.append(
                            [child, child_offset, list(graph.successors(child)), 0]
                        )
                        advanced = True
                        break
                else:
                    return (MIS, (pnode, poffset), (child, child_offset))
            if not advanced and top[3] >= len(succs):
                self.stack.pop()

        return None


# -- backtrace (reference: ``gap_affine.rs:550-657``, 2-piece analogue) ----



def _bt_preds(graph, node):
    """Backtrace candidate scan order: oldest inserted edge first."""
    f = getattr(graph, "predecessors_oldest_first", None)
    if f is not None:
        return f(node)
    return graph.predecessors(node)


def _backtrace_step(graph, seq, costs, visited, node, offset, state):
    curr = visited.get_score(node, offset, state)
    if curr is None:
        return None
    two_piece = costs.is_two_piece

    if state == M:
        if offset > 0:
            is_match_or_end = (
                graph.is_symbol_equal(node, seq[offset - 1]) or node == graph.end_node
            )
            pred_offset = offset if node == graph.end_node else offset - 1
            for p in _bt_preds(graph, node):
                ps = visited.get_score(p, pred_offset, M)
                if ps is None:
                    continue
                if (is_match_or_end and ps == curr) or (
                    not is_match_or_end and ps == curr - costs.mismatch
                ):
                    return (p, pred_offset, M)
        if visited.get_score(node, offset, D) == curr:
            return (node, offset, D)
        if two_piece and visited.get_score(node, offset, D2) == curr:
            return (node, offset, D2)
        if visited.get_score(node, offset, I) == curr:
            return (node, offset, I)
        if two_piece and visited.get_score(node, offset, I2) == curr:
            return (node, offset, I2)
    elif state == D:
        for p in _bt_preds(graph, node):
            if visited.get_score(p, offset, M) == curr - costs.gap_open - costs.gap_extend:
                return (p, offset, M)
        for p in _bt_preds(graph, node):
            if visited.get_score(p, offset, D) == curr - costs.gap_extend:
                return (p, offset, D)
    elif state == D2:
        for p in _bt_preds(graph, node):
            if visited.get_score(p, offset, D) == curr - costs.gap_extend2:
                return (p, offset, D)
        for p in _bt_preds(graph, node):
            if visited.get_score(p, offset, D2) == curr - costs.gap_extend2:
                return (p, offset, D2)
    elif state == I:
        if offset > 0:
            if (
                visited.get_score(node, offset - 1, M)
                == curr - costs.gap_open - costs.gap_extend
            ):
                return (node, offset - 1, M)
            if visited.get_score(node, offset - 1, I) == curr - costs.gap_extend:
                return (node, offset - 1, I)
    elif state == I2:
        if offset > 0:
            if visited.get_score(node, offset - 1, I) == curr - costs.gap_extend2:
                return (node, offset - 1, I)
            if visited.get_score(node, offset - 1, I2) == curr - costs.gap_extend2:
                return (node, offset - 1, I2)
    return None


def _backtrace(graph, seq, costs, visited, node, offset) -> Alignment:
    if len(seq) == 0:
        return []
    # NB: no 1-char shortcut here — the end node "matches" every symbol
    # (poa.rs:462-465), so anchoring the pair at it would leak the virtual
    # end node into the alignment and corrupt graph fusion.

    if node == graph.end_node:
        # Global end state is the virtual end node: its zero-cost hop is
        # not an alignment pair, so take one step before emitting.
        start = None
        states = (M, I, D) if not costs.is_two_piece else (M, I, I2, D, D2)
        for st in states:
            start = _backtrace_step(graph, seq, costs, visited, node, offset, st)
            if start is not None:
                break
        if start is None:
            raise RuntimeError("No backtrace for alignment end state?")
    else:
        # Ends-free end states sit on a real node whose own (node, offset)
        # pair is part of the alignment: start emitting from it directly.
        start = (node, offset, M)

    curr_node, curr_offset, curr_state = start
    alignment: Alignment = []
    indel_states = (I, D, I2, D2)

    while True:
        step = _backtrace_step(graph, seq, costs, visited, curr_node, curr_offset, curr_state)
        if step is None:
            break
        bt_node, bt_offset, bt_state = step
        # Zero-cost indel closures must not double-emit (node, query) pairs.
        if curr_state == M and bt_state in indel_states:
            curr_node, curr_offset, curr_state = bt_node, bt_offset, bt_state
            continue

        if curr_state == M:
            alignment.append(AlignedPair(curr_node, curr_offset - 1))
        elif curr_state in (I, I2):
            alignment.append(AlignedPair(None, curr_offset - 1))
        else:
            alignment.append(AlignedPair(curr_node, None))

        if bt_node == graph.start_node:
            break
        curr_node, curr_offset, curr_state = bt_node, bt_offset, bt_state

    alignment.reverse()
    return alignment


# -- main search loop (reference: ``astar.rs:108-226``) --------------------


def astar_alignment(
    graph,
    seq: bytes,
    costs,
    aln_type,
    heuristic,
    bubble_index: BubbleIndex,
    enable_pruning: bool = True,
    debug_sink=None,
    queue_discipline: str = "truth",
) -> AstarResult:
    aln_graph = _AlignmentGraph(costs, aln_type)
    visited = _Visited(graph, costs, len(seq), bubble_index)
    result = AstarResult()
    queue = _LayeredQueue(costs.is_two_piece, queue_discipline)

    for node, offset in aln_graph.initial_states(graph):
        h = heuristic.h(node, offset, M)
        queue.push(node, offset, M, 0, h)
        visited.set_score(node, offset, M, 0)
        result.num_queued += 1

    def emit(delta, n, o, st, base_score):
        h = heuristic.h(n, o, st)
        result.num_queued += 1
        queue.push(n, o, st, base_score + delta, h)

    end_state = None
    while True:
        item = queue.pop()
        if item is None:
            raise RuntimeError("Could not align sequence! Empty queue before reaching end!")
        score, node, offset, state = item

        stored = visited.get_score(node, offset, state)
        if stored is not None and score > stored:
            continue

        if aln_graph.is_end(graph, seq, node, offset, state):
            result.num_visited += 1
            end_state = (score, node, offset)
            break

        # Bubble pruning applies to Match states; indel states are kept so
        # their zero-cost closures still materialize (matching the truth
        # MSAs' co-optimal tiebreaks).
        if enable_pruning and state == M and visited.prune(score, node, offset, state):
            result.num_pruned += 1
            continue

        visited.mark_reached(score, node, offset, state)
        result.num_visited += 1

        if state == M:
            aln_graph.expand_match(
                visited, graph, seq, score, node, offset,
                lambda d, n, o, st: emit(d, n, o, st, score),
            )
            dfa = _Dfa(graph, seq, score, node, offset)
            stop = None
            while True:
                ev = dfa.extend(visited)
                if ev is None:
                    break
                kind, parent, child = ev
                if kind == RG_END:
                    cnode, coffset = child
                    if aln_graph.is_end(graph, seq, cnode, coffset, M):
                        stop = (score, cnode, coffset)
                        break
                    # opening an insertion past the query end is only
                    # reachable when the end bound is unsatisfiable (any
                    # satisfiable bound accepts the offset-n end above);
                    # unbounded Python offsets would then grow forever, so
                    # keep the state space finite and let the queue drain
                    # into the "could not align" error instead
                    if parent[1] < len(seq):
                        aln_graph.expand_ref_graph_end(
                            visited, parent, score,
                            lambda d, n, o, st: emit(d, n, o, st, score),
                        )
                elif kind == Q_END:
                    aln_graph.expand_query_end(
                        visited, parent, child[0], score,
                        lambda d, n, o, st: emit(d, n, o, st, score),
                    )
                else:  # mismatch
                    aln_graph.expand_mismatch(
                        visited, parent, child, score,
                        lambda d, n, o, st: emit(d, n, o, st, score),
                    )
            if stop is not None:
                # The breaking pop does not fold DFA-visited counts into the
                # totals (matches the reference's early loop exit).
                end_state = stop
                break
            result.num_visited += dfa.num_visited
        else:
            aln_graph.expand_all(
                visited, graph, seq, score, node, offset, state,
                lambda d, n, o, st: emit(d, n, o, st, score),
            )

    if debug_sink is not None:
        debug_sink.log_astar_data(visited, graph)

    end_score, end_node, end_offset = end_state
    result.score = end_score
    result.alignment = _backtrace(graph, seq, costs, visited, end_node, end_offset)
    return result


# -- public facade (reference: ``src/aligner/mod.rs:40-146``) ---------------


class PoastaAligner:
    """Host-exact aligner facade.

    ``config`` selects costs + heuristic (mirrors the six reference
    ``AlignmentConfig`` impls via the ``heuristic`` string).
    """

    def __init__(self, costs, aln_type=None, heuristic: str = "mingap", debug_sink=None,
                 queue_discipline: str = "truth"):
        self.costs = costs
        self.aln_type = aln_type if aln_type is not None else Global()
        self.heuristic_name = heuristic
        self.debug_sink = debug_sink
        self.queue_discipline = queue_discipline

    def _make_heuristic(self, graph, seq: bytes, bubble_index: BubbleIndex):
        if self.heuristic_name == "dijkstra":
            return Dijkstra()
        if self.heuristic_name == "mingap":
            if self.costs.is_two_piece:
                hcosts = GapAffine(
                    self.costs.mismatch, self.costs.gap_extend2, self.costs.gap_open2
                )
            else:
                hcosts = self.costs
            return MinimumGapCostAffine(hcosts, bubble_index, len(seq))
        if self.heuristic_name == "path":
            if self.costs.is_two_piece:
                hcosts = GapAffine(
                    self.costs.mismatch, self.costs.gap_extend2, self.costs.gap_open2
                )
            else:
                hcosts = self.costs
            path_index = PathIndex.build_from_graph(graph, 10)
            return PathAwareHeuristic(hcosts, path_index, len(seq), 5)
        raise ValueError(f"unknown heuristic {self.heuristic_name!r}")

    def align(self, graph, seq: bytes) -> AstarResult:
        if graph.node_count() == 0:
            # the reference hardcodes len*4 as a 'rough cost estimate'
            # for the empty-graph edge case (mod.rs:128-133) — parity
            score = 0 if len(seq) == 0 else len(seq) * 4
            return AstarResult(score=score)
        bubble_index = BubbleIndex(graph)
        heuristic = self._make_heuristic(graph, seq, bubble_index)
        return astar_alignment(
            graph, seq, self.costs, self.aln_type, heuristic, bubble_index,
            enable_pruning=True, debug_sink=self.debug_sink,
            queue_discipline=self.queue_discipline,
        )

    def align_with_existing_bubbles(self, graph, seq: bytes, bubble_index) -> AstarResult:
        heuristic = self._make_heuristic(graph, seq, bubble_index)
        return astar_alignment(
            graph, seq, self.costs, self.aln_type, heuristic, bubble_index,
            enable_pruning=True, debug_sink=self.debug_sink,
            queue_discipline=self.queue_discipline,
        )

    def align_no_pruning(self, graph, seq: bytes) -> AstarResult:
        bubble_index = BubbleIndex(graph)
        heuristic = self._make_heuristic(graph, seq, bubble_index)
        return astar_alignment(
            graph, seq, self.costs, self.aln_type, heuristic, bubble_index,
            enable_pruning=False, debug_sink=self.debug_sink,
            queue_discipline=self.queue_discipline,
        )
