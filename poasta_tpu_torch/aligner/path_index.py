"""Greedy major-path extraction for the path-aware heuristic.

Reference: ``src/aligner/path_index.rs:31-284``.  Host precompute; the
path-aware heuristic consumes per-node (path, position) lists plus
distance-to-end tables, which lower to dense arrays for the device engine.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Set, Tuple


@dataclass
class Path:
    id: int
    name: str
    nodes: List[int]
    length: int


@dataclass
class PathDistanceInfo:
    path_id: int
    forward_distances: List[int]
    backward_distances: List[int]


class PathIndex:
    def __init__(self, max_paths_per_node: int) -> None:
        self.paths: List[Path] = []
        self.node_to_paths: Dict[int, List[Tuple[int, int]]] = {}
        self.path_distances: List[PathDistanceInfo] = []
        self.max_paths_per_node = max_paths_per_node

    @classmethod
    def build_from_graph(cls, graph, max_paths_per_node: int) -> "PathIndex":
        index = cls(max_paths_per_node)
        index._extract_major_paths(graph)
        index._compute_path_distances()
        return index

    def _extract_major_paths(self, graph) -> None:
        visited_edges: Set[Tuple[int, int]] = set()
        path_id = 0

        start_nodes: List[int] = [graph.start_node]
        for node in graph.all_nodes():
            in_degree = graph.in_degree(node)
            out_degree = graph.out_degree(node)
            if in_degree == 0 or (out_degree > 2 and in_degree == 1):
                start_nodes.append(node)

        for start_node in start_nodes:
            if any(frm == start_node for (frm, _) in visited_edges):
                continue
            path = self._extract_path_from(graph, start_node, visited_edges, path_id)
            if len(path.nodes) > 1:
                self._add_path(path)
                path_id += 1

        if len(self.paths) < 10:
            path_id = self._extract_secondary_paths(graph, visited_edges, path_id)

    def _extract_path_from(self, graph, start: int, visited_edges, path_id: int) -> Path:
        nodes = [start]
        current = start
        length = 0

        while current != graph.end_node:
            neighbors = list(graph.successors(current))
            if not neighbors:
                break

            # Prefer unvisited edges; among those pick the max out-degree,
            # breaking ties toward the *last* maximal candidate (the
            # reference's max_by_key semantics), else fall back to the first
            # neighbor.
            next_node = None
            best_key = None
            for n in neighbors:
                if (current, n) in visited_edges:
                    continue
                key = graph.out_degree(n)
                if best_key is None or key >= best_key:
                    best_key = key
                    next_node = n
            if next_node is None:
                next_node = neighbors[0]

            visited_edges.add((current, next_node))
            nodes.append(next_node)
            length += 1
            current = next_node

        return Path(path_id, f"path_{path_id}", nodes, length)

    def _extract_secondary_paths(self, graph, visited_edges, path_id: int) -> int:
        candidates: List[Tuple[int, int]] = []
        for node in graph.all_nodes():
            unvisited_out = sum(
                1 for n in graph.successors(node) if (node, n) not in visited_edges
            )
            if unvisited_out > 0:
                candidates.append((node, unvisited_out))

        candidates.sort(key=lambda t: -t[1])  # stable, descending count

        for start, _ in candidates[:20]:
            path = self._extract_path_from(graph, start, visited_edges, path_id)
            if len(path.nodes) > 3:
                self._add_path(path)
                path_id += 1
        return path_id

    def _add_path(self, path: Path) -> None:
        for pos, node in enumerate(path.nodes):
            entry = self.node_to_paths.setdefault(node, [])
            if len(entry) < self.max_paths_per_node:
                entry.append((path.id, pos))
        self.paths.append(path)

    def _compute_path_distances(self) -> None:
        for path in self.paths:
            n = len(path.nodes)
            forward = list(range(n))
            backward = [n - 1 - i for i in range(n)]
            self.path_distances.append(PathDistanceInfo(path.id, forward, backward))

    # -- queries ---------------------------------------------------------
    def get_paths_through_node(self, node: int) -> List[Tuple[int, int]]:
        return self.node_to_paths.get(node, [])

    def get_distance_to_end(self, path_id: int, position: int):
        # path ids are assigned sequentially in self.paths order, so the
        # list position IS the id (this sits on the path heuristic's
        # hottest loop — no linear scan)
        if 0 <= path_id < len(self.path_distances):
            d = self.path_distances[path_id]
            if d.path_id == path_id and position < len(d.backward_distances):
                return d.backward_distances[position]
        return None

    def num_paths(self) -> int:
        return len(self.paths)
