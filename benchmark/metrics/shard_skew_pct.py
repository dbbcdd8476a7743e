"""100 x (the busiest card's summed ``mesh.shard`` host time over the mean
card's, less 1), %: how far the card that paces each gather runs ahead of
the others (``benchmark.mesh_spans``; 0 when every card works alike)."""

from benchmark.mesh_spans import shard_seconds


def read(run):
    by_card = shard_seconds(run)
    if not by_card:
        return None
    mean = sum(by_card.values()) / len(by_card)
    return 100.0 * (max(by_card.values()) / mean - 1.0) if mean > 0 else None
