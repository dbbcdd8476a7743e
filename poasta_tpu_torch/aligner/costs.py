"""Alignment cost models and span configuration.

Reference: ``src/aligner/scoring/mod.rs``, ``gap_affine.rs:20-81``,
``gap_affine_2piece.rs:20-125``.
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import IntEnum
from typing import Optional, Tuple


class AlignState(IntEnum):
    MATCH = 0
    DELETION = 1
    INSERTION = 2
    DELETION2 = 3
    INSERTION2 = 4


# Bound encodings for ends-free spans: (kind, value)
UNBOUNDED: Tuple[str, Optional[int]] = ("unbounded", None)


def included(v: int) -> Tuple[str, Optional[int]]:
    return ("included", v)


def excluded(v: int) -> Tuple[str, Optional[int]]:
    return ("excluded", v)


@dataclass(frozen=True)
class Global:
    pass


@dataclass(frozen=True)
class EndsFree:
    qry_free_begin: Tuple[str, Optional[int]] = UNBOUNDED
    qry_free_end: Tuple[str, Optional[int]] = UNBOUNDED
    graph_free_begin: Tuple[str, Optional[int]] = UNBOUNDED
    graph_free_end: Tuple[str, Optional[int]] = UNBOUNDED

    def __post_init__(self) -> None:
        # reject malformed bounds up front — an unrecognized kind string
        # would otherwise be treated as "excluded" deep inside the engine's
        # end test, silently changing semantics
        for field in ("qry_free_begin", "qry_free_end",
                      "graph_free_begin", "graph_free_end"):
            kind, value = getattr(self, field)
            if kind not in ("unbounded", "included", "excluded"):
                raise ValueError(
                    f"{field}: unknown bound kind {kind!r} "
                    "(use UNBOUNDED / included(v) / excluded(v))"
                )
            if kind == "unbounded":
                if value is not None:
                    raise ValueError(f"{field}: unbounded carries no value")
            elif not isinstance(value, int) or isinstance(value, bool) or value < 0:
                raise ValueError(f"{field}: bound value must be an int >= 0")


AlignmentType = object  # Global | EndsFree


@dataclass(frozen=True)
class GapAffine:
    """Single-piece affine gap costs; a gap of length k costs open + k*extend."""

    mismatch: int
    gap_extend: int
    gap_open: int

    @property
    def is_two_piece(self) -> bool:
        return False

    def gap_cost(self, current_state: AlignState, length: int) -> int:
        if length == 0:
            return 0
        open_cost = 0 if current_state in (AlignState.INSERTION, AlignState.DELETION) else self.gap_open
        return open_cost + length * self.gap_extend

    # Accessors mirroring the reference's trait (``scoring/mod.rs:27-34``)
    @property
    def gap_open2(self) -> int:
        return 0

    @property
    def gap_extend2(self) -> int:
        return 0


@dataclass(frozen=True)
class GapAffine2Piece:
    """Two-piece (convex) affine gaps with 5 alignment states.

    Long gaps switch from (open1, extend1) to the cheaper extend2 piece;
    the switch transition I->I2 / D->D2 costs extend2
    (reference: ``gap_affine_2piece.rs:362-368,402-408``).
    """

    mismatch: int
    gap_extend: int  # piece 1
    gap_open: int  # piece 1
    gap_extend2: int
    gap_open2: int

    def __post_init__(self):
        assert self.gap_extend >= self.gap_extend2, (
            "gap_extend1 must be >= gap_extend2 for the two-piece model"
        )

    @property
    def is_two_piece(self) -> bool:
        return True

    def breakpoint(self) -> int:
        """Gap length where piece 2 becomes cheaper (reference: ``gap_affine_2piece.rs:35-63``)."""
        if self.gap_extend == self.gap_extend2:
            return 2**62 if self.gap_open <= self.gap_open2 else 0
        if self.gap_open2 >= self.gap_open:
            return (self.gap_open2 - self.gap_open) // (self.gap_extend - self.gap_extend2)
        diff = self.gap_open - self.gap_open2
        denom = self.gap_extend - self.gap_extend2
        return (diff + denom - 1) // denom

    def gap_cost(self, current_state: AlignState, length: int) -> int:
        if length == 0:
            return 0
        if current_state in (AlignState.INSERTION, AlignState.DELETION):
            return self.gap_open + length * self.gap_extend
        if current_state in (AlignState.INSERTION2, AlignState.DELETION2):
            return self.gap_open2 + length * self.gap_extend2
        cost1 = self.gap_open + length * self.gap_extend
        cost2 = self.gap_open2 + length * self.gap_extend2
        return min(cost1, cost2)
