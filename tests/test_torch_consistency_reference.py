"""The oracle of the port's cross-engine sweep
(``tests/test_torch_consistency.py``) against the reference's.

The sweep's oracle is the port's copy of the Python exact engine under
Dijkstra.  Here the same draws, made from the same seeds with
``poasta_tpu``'s classes (its graph, native engine and costs), must give
the same reads, and the reference's exact engine under Dijkstra the same
score for every read.  Kept apart from the sweep, which the card's machine
runs without JAX.
"""

from types import SimpleNamespace

import pytest
import test_torch_consistency as sweep

from poasta_tpu.aligner import (
    GapAffine,
    GapAffine2Piece,
    Global,
    PoastaAligner,
)
from poasta_tpu.graphs import POAGraph
from poasta_tpu.native import NativeAligner

REFERENCE = SimpleNamespace(
    POAGraph=POAGraph, NativeAligner=NativeAligner, GapAffine=GapAffine,
    GapAffine2Piece=GapAffine2Piece, PoastaAligner=PoastaAligner,
    Global=Global)
CASES = ([("one-piece", s) for s in sweep.ONE_PIECE_SEEDS]
         + [("two-piece", s) for s in sweep.TWO_PIECE_SEEDS])
DRAWS = {"one-piece": sweep.draw_one_piece, "two-piece": sweep.draw_two_piece}


@pytest.mark.parametrize("kind, seed", CASES)
def test_sweep_oracle_equals_the_reference(kind, seed):
    draw = DRAWS[kind]
    costs, g, queries = draw(seed)
    ref_costs, ref_g, ref_queries = draw(seed, REFERENCE)
    assert ref_queries == queries
    assert sweep.oracle_scores(ref_costs, ref_g, ref_queries, REFERENCE) \
        == sweep.oracle_scores(costs, g, queries)
