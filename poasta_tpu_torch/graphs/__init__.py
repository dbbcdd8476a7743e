from .poa import POAGraph, SequenceInfo, START_SYMBOL, END_SYMBOL
from .flat import FlatGraph
from .tools import rev_postorder_nodes

__all__ = [
    "POAGraph",
    "SequenceInfo",
    "FlatGraph",
    "rev_postorder_nodes",
    "START_SYMBOL",
    "END_SYMBOL",
]
