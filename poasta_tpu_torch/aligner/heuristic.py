"""A* heuristics (reference: ``src/aligner/heuristic.rs``).

All heuristics are admissible lower bounds on the remaining alignment cost;
they change search order only, never the optimal score.  The same bounds
power the TPU engine's wavefront banding (per-rank feasible offset windows).
"""

from __future__ import annotations

from typing import Optional

from .costs import AlignState, GapAffine


class Dijkstra:
    def h(self, node: int, offset: int, state: AlignState) -> int:
        return 0


class MinimumGapCostAffine:
    """Minimum-gap-cost lower bound from bubble distance-to-end bounds.

    Reference: ``heuristic.rs:50-103``.
    """

    def __init__(self, costs: GapAffine, bubble_index, seq_length: int) -> None:
        self.costs = costs
        self.bubble_index = bubble_index
        self.seq_length = seq_length

    def h(self, node: int, offset: int, state: AlignState) -> int:
        min_dist = max(self.bubble_index.get_min_dist_to_end(node) - 1, 0)
        max_dist = max(self.bubble_index.get_max_dist_to_end(node) - 1, 0)

        target_min = offset + min_dist
        target_max = offset + max_dist

        if target_min > self.seq_length:
            min_gap_length = target_min - self.seq_length
            if state != AlignState.DELETION:
                state = AlignState.MATCH
        elif target_max < self.seq_length:
            min_gap_length = self.seq_length - target_max
            if state != AlignState.INSERTION:
                state = AlignState.MATCH
        else:
            min_gap_length = 0

        return self.costs.gap_cost(state, min_gap_length)


class PathAwareHeuristic:
    """Path-aware lower bound over greedy-extracted major paths.

    Reference: ``heuristic.rs:105-185``.
    """

    def __init__(self, costs: GapAffine, path_index, seq_length: int, max_paths: int) -> None:
        self.costs = costs
        self.path_index = path_index
        self.seq_length = seq_length
        self.max_paths = max_paths

    def h(self, node: int, offset: int, state: AlignState) -> int:
        paths = self.path_index.get_paths_through_node(node)

        if not paths:
            remaining = max(self.seq_length - offset, 0)
            if state in (AlignState.DELETION, AlignState.DELETION2):
                mapped = AlignState.DELETION
            elif state in (AlignState.INSERTION, AlignState.INSERTION2):
                mapped = AlignState.INSERTION
            else:
                mapped = AlignState.MATCH
            return self.costs.gap_cost(mapped, remaining)

        min_cost: Optional[int] = None
        for path_id, pos in paths[: self.max_paths]:
            dist_to_end = self.path_index.get_distance_to_end(path_id, pos)
            if dist_to_end is None:
                continue
            path_remaining = dist_to_end
            query_remaining = max(self.seq_length - offset, 0)

            if path_remaining > query_remaining:
                gap = path_remaining - query_remaining
                mapped = (
                    AlignState.DELETION
                    if state in (AlignState.DELETION, AlignState.DELETION2)
                    else AlignState.MATCH
                )
                cost = self.costs.gap_cost(mapped, gap)
            elif query_remaining > path_remaining:
                gap = query_remaining - path_remaining
                mapped = (
                    AlignState.INSERTION
                    if state in (AlignState.INSERTION, AlignState.INSERTION2)
                    else AlignState.MATCH
                )
                cost = self.costs.gap_cost(mapped, gap)
            else:
                cost = 0

            if min_cost is None or cost < min_cost:
                min_cost = cost

        if min_cost is not None:
            return min_cost
        # unreachable in practice (indexed paths always carry distances);
        # fall back to the conservative no-paths estimate rather than a
        # huge sentinel, which would make the bucket queue allocate that
        # many layers (the reference returns usize::MAX here and would
        # blow up the same way)
        remaining = max(self.seq_length - offset, 0)
        return self.costs.gap_cost(AlignState.MATCH, remaining)


HEURISTIC_NAMES = {
    "dijkstra": "dijkstra",
    "mingap": "mingap",
    "minimumgapcost": "mingap",
    "path": "path",
    "pathaware": "path",
}


def parse_heuristic(name: str) -> Optional[str]:
    return HEURISTIC_NAMES.get(name.lower())
