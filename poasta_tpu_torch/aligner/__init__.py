from .alignment import AlignedPair, Alignment, print_alignment
from .costs import (
    AlignState,
    EndsFree,
    GapAffine,
    GapAffine2Piece,
    Global,
    UNBOUNDED,
    excluded,
    included,
)
from .engine import AstarResult, PoastaAligner, astar_alignment
from .heuristic import parse_heuristic

__all__ = [
    "AlignedPair",
    "Alignment",
    "print_alignment",
    "AlignState",
    "EndsFree",
    "GapAffine",
    "GapAffine2Piece",
    "Global",
    "UNBOUNDED",
    "excluded",
    "included",
    "AstarResult",
    "PoastaAligner",
    "astar_alignment",
    "parse_heuristic",
]
