"""Superbubble enumeration for DAGs.

Linear-time algorithm after Gärtner, Müller & Stadler, "Superbubbles
Revisited" (Alg. Mol. Biol. 2018) — the same algorithm family the reference
uses (reference: ``src/bubbles/finder.rs:8-14``).  Pure host precompute; the
results ship to the device as dense per-node bound arrays.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Tuple

from ..graphs.tools import rev_postorder_nodes

_NEG_INF = -1
_POS_INF = 2**62


class SuperbubbleFinder:
    def __init__(self, graph) -> None:
        self.graph = graph
        self.inv_rev_postorder: List[int] = rev_postorder_nodes(graph)
        self.rev_postorder: List[int] = [0] * len(self.inv_rev_postorder)
        for postorder, node in enumerate(self.inv_rev_postorder):
            self.rev_postorder[node] = postorder

        # out_parent: min rev-postorder rank over predecessors (-1 if none);
        # out_child: max rank over successors (+inf if none).
        self.out_parent: Dict[int, int] = {}
        self.out_child: Dict[int, int] = {}
        for n in graph.all_nodes():
            preds = [self.rev_postorder[p] for p in graph.predecessors(n)]
            self.out_parent[n] = min(preds) if preds else _NEG_INF
            succs = [self.rev_postorder[s] for s in graph.successors(n)]
            self.out_child[n] = max(succs) if succs else _POS_INF

    def __iter__(self) -> Iterator[Tuple[int, int]]:
        """Yield (entrance, exit) node pairs."""
        out_parent_map: Dict[int, int] = {}
        stack: List[int] = []
        candidate_exit = None

        for curr in range(len(self.inv_rev_postorder) - 1, -1, -1):
            to_return = None
            n = self.inv_rev_postorder[curr]
            furthest_child = self.out_child[n]

            if furthest_child == curr + 1:
                if candidate_exit is not None:
                    stack.append(candidate_exit)
                candidate_exit = self.inv_rev_postorder[curr + 1]
            else:
                while candidate_exit is not None:
                    if furthest_child <= self.rev_postorder[candidate_exit]:
                        break
                    prev_candidate = candidate_exit
                    candidate_exit = stack.pop() if stack else None
                    if candidate_exit is not None:
                        out_parent_map[candidate_exit] = min(
                            out_parent_map[prev_candidate],
                            out_parent_map[candidate_exit],
                        )

            if candidate_exit is not None and out_parent_map[candidate_exit] == curr:
                to_return = (n, candidate_exit)
                prev_candidate = candidate_exit
                candidate_exit = stack.pop() if stack else None
                if candidate_exit is not None:
                    out_parent_map[candidate_exit] = min(
                        out_parent_map[prev_candidate],
                        out_parent_map[candidate_exit],
                    )

            out_parent_map[n] = self.out_parent[n]

            if candidate_exit is not None:
                out_parent_map[candidate_exit] = min(
                    out_parent_map[n], out_parent_map[candidate_exit]
                )

            if to_return is not None:
                yield to_return
