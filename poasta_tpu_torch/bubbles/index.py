"""Bubble index: per-node bubble membership and distance-to-end bounds.

Host precompute (reference: ``src/bubbles/index.rs:51-156``): a backward BFS
from the end node tracks a stack of "active" bubbles to assign each node the
bubbles it lies in with min distance to exit; a reverse-postorder sweep adds
the max distances.  The ``dist_to_end`` bounds double as the admissible
minimum-gap-cost heuristic inputs, and ship to the device as dense arrays for
wavefront banding.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import List

import numpy as np

from .finder import SuperbubbleFinder


@dataclass
class NodeBubbleMap:
    bubble_exit: int
    min_dist_to_exit: int
    max_dist_to_exit: int


class BubbleIndex:
    def __init__(self, graph) -> None:
        finder = SuperbubbleFinder(graph)
        n = graph.node_count_with_start_and_end()

        self.entrance_of: List[int] = [-1] * n  # exit node if entrance, else -1
        self.exit_of: List[int] = [-1] * n  # entrance node if exit, else -1
        for entrance, exit_ in finder:
            self.entrance_of[entrance] = exit_
            self.exit_of[exit_] = entrance

        self.node_bubble_map: List[List[NodeBubbleMap]] = [[] for _ in range(n)]
        dist_to_end = [[0, 0] for _ in range(n)]

        end_node = graph.end_node
        end_stack = [(0, end_node)] if self.exit_of[end_node] != -1 else []
        queue = deque([(end_node, 0, end_stack)])
        visited = {end_node}

        while queue:
            curr, dist_from_end, bubble_stack = queue.popleft()
            for bubble_dist, bubble_exit in bubble_stack:
                self.node_bubble_map[curr].append(
                    NodeBubbleMap(bubble_exit, dist_from_end - bubble_dist, 0)
                )
            dist_to_end[curr][0] = dist_from_end

            for pred in graph.predecessors(curr):
                if pred not in visited:
                    new_dist = dist_from_end + 1
                    new_stack = list(bubble_stack)
                    if self.entrance_of[pred] != -1:
                        bubble_dist, bubble_exit = new_stack.pop()
                        self.node_bubble_map[pred].append(
                            NodeBubbleMap(bubble_exit, new_dist - bubble_dist, 0)
                        )
                    if self.exit_of[pred] != -1:
                        new_stack.append((new_dist, pred))
                    visited.add(pred)
                    queue.append((pred, new_dist, new_stack))

        # Longest path to end via post-order sweep; also fill bubble max dists.
        for node in reversed(finder.inv_rev_postorder):
            max_dist = 0
            for succ in graph.successors(node):
                max_dist = max(max_dist, dist_to_end[succ][1] + 1)
            dist_to_end[node][1] = max_dist
            for bubble in self.node_bubble_map[node]:
                bubble.max_dist_to_exit = max_dist - dist_to_end[bubble.bubble_exit][1]

        self.dist_to_end = dist_to_end

    # -- queries ---------------------------------------------------------
    def is_entrance(self, node: int) -> bool:
        return self.entrance_of[node] != -1

    def is_exit(self, node: int) -> bool:
        return self.exit_of[node] != -1

    def get_node_bubbles(self, node: int) -> List[NodeBubbleMap]:
        return self.node_bubble_map[node]

    def node_is_part_of_bubble(self, node: int) -> bool:
        return bool(self.node_bubble_map[node])

    def num_bubbles(self) -> int:
        return sum(1 for e in self.entrance_of if e != -1)

    def get_min_dist_to_end(self, node: int) -> int:
        return self.dist_to_end[node][0]

    def get_max_dist_to_end(self, node: int) -> int:
        return self.dist_to_end[node][1]

    # -- device lowering ---------------------------------------------------
    def dist_bounds_arrays(self) -> tuple[np.ndarray, np.ndarray]:
        """(min, max) distance-to-end per node index, as int32 arrays."""
        d = np.asarray(self.dist_to_end, dtype=np.int32)
        return d[:, 0].copy(), d[:, 1].copy()
