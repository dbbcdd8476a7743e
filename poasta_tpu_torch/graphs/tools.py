"""Graph traversal helpers (reference: ``src/graphs/tools.rs``)."""

from __future__ import annotations

from typing import List


def rev_postorder_nodes(graph) -> List[int]:
    """Reverse-postorder DFS from the start node.

    Successor iteration order matters (newest edge first), matching the
    reference's iterative DFS (reference: ``src/graphs/tools.rs:5-37``).
    """
    ordered: List[int] = []
    visited = set()
    stack = [(graph.start_node, graph.successors(graph.start_node))]

    while stack:
        _, succ_iter = stack[-1]
        child = None
        for c in succ_iter:
            if c not in visited:
                child = c
                break
        if child is not None:
            visited.add(child)
            stack.append((child, graph.successors(child)))
        else:
            ordered.append(stack.pop()[0])

    ordered.reverse()
    return ordered
