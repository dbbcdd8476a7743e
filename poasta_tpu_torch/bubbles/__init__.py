from .finder import SuperbubbleFinder
from .index import BubbleIndex, NodeBubbleMap

__all__ = ["SuperbubbleFinder", "BubbleIndex", "NodeBubbleMap"]
