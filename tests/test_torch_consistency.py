"""Randomized cross-engine consistency sweep of the port (the twin of
``tests/test_consistency.py``).

For random graphs, reads and one- and two-piece costs, every engine of the
port must agree on every read: the Python exact engine under Dijkstra
(the oracle), the native exact and banded engines, the full-width fill
``dp_fill_scores``, ``BandedScorer.scores`` (twice under two-piece costs,
the second call from the learned ub), and ``BatchMapper.score_batch`` and
``align_batch``, whose every alignment costs its score.  The graphs,
reads and costs are drawn as the reference's sweep draws them from the
same seeds.

On the CPU the fills run their plain versions (``device="cpu"``); the
``cuda``-marked twins run the same checks on the card, and
``run_gpu_tests.py --soak N`` drives :func:`check_one_piece` and
:func:`check_two_piece` there with more seeds.  The oracle itself is held
against the reference's in ``tests/test_torch_consistency_reference.py``,
which makes the same draws with ``poasta_tpu``'s classes.  This module
imports no JAX and nothing of ``poasta_tpu``, so that the card's machine
can run it.
"""

import random
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from poasta_tpu_torch import (
    BandedScorer,
    BatchMapper,
    GapAffine,
    Global,
    NativeAligner,
    POAGraph,
    PoastaAligner,
    pack_queries,
)
from poasta_tpu_torch.aligner import GapAffine2Piece
from poasta_tpu_torch.aligner.wavefront import (
    DeviceGraph,
    alignment_cost,
    dp_fill_scores,
)

torch.set_num_threads(1)

# the classes a sweep draws and scores with (the reference's twin of this
# namespace is in tests/test_torch_consistency_reference.py)
PORT = SimpleNamespace(POAGraph=POAGraph, NativeAligner=NativeAligner,
                       GapAffine=GapAffine, GapAffine2Piece=GapAffine2Piece,
                       PoastaAligner=PoastaAligner, Global=Global)
ONE_PIECE_SEEDS = (101, 202, 303)
TWO_PIECE_SEEDS = (404, 505)


def _random_graph_and_reads(lib, rng, nseq, length, nq, div):
    base = "".join(rng.choice("ACGT") for _ in range(length))

    def mutate(s):
        out = []
        for ch in s:
            r = rng.random()
            if r < div:
                continue
            out.append(rng.choice("ACGT") if r < 2 * div else ch)
            if rng.random() < div:
                out.append(rng.choice("ACGT"))
        return "".join(out) or "A"

    g = lib.POAGraph()
    build_costs = lib.GapAffine(4, 2, 6)
    g.add_alignment_with_weights("s0", base.encode(), None, [1] * length)
    for i in range(1, nseq):
        s = mutate(base).encode()
        _, aln, _ = lib.NativeAligner(g).align(s, build_costs)
        g.add_alignment_with_weights(f"s{i}", s, aln, [1] * len(s))
    return g, [mutate(base).encode() for _ in range(nq)]


def _device_engines(g, queries, costs, device, banded_calls):
    """Every device route's scores of ``queries`` on ``device``, and the
    mapper's alignments."""
    flat = g.flatten()
    dg = DeviceGraph.build(flat, device=device)
    qshift, lengths = pack_queries(queries, device=device)
    out = {"full": dp_fill_scores(dg, qshift, lengths, costs).cpu().numpy()}
    bs = BandedScorer(flat, costs, dg=dg)
    for k in range(banded_calls):
        out[f"banded{k}"] = bs.scores(qshift, lengths)
    mapper = BatchMapper(g, costs, device=device)
    out["score_batch"] = mapper.score_batch(queries)
    aligned = mapper.align_batch(queries)
    out["align_batch"] = np.array([s for s, _ in aligned])
    return out, [aln for _, aln in aligned]


def draw_one_piece(seed, lib=PORT):
    """The reference's one-piece draw at ``seed``: (costs, graph, reads)."""
    rng = random.Random(seed)
    costs = lib.GapAffine(
        mismatch=rng.choice([1, 3, 4, 7]),
        gap_extend=rng.choice([1, 2, 3]),
        gap_open=rng.choice([0, 4, 6, 11]),
    )
    g, queries = _random_graph_and_reads(
        lib, rng, nseq=rng.choice([2, 3, 4]),
        length=rng.choice([50, 90, 140]), nq=5,
        div=rng.choice([0.02, 0.06, 0.12]),
    )
    return costs, g, queries


def draw_two_piece(seed, lib=PORT):
    """The reference's two-piece draw at ``seed``: (costs, graph, reads)."""
    rng = random.Random(seed)
    e2 = rng.choice([1, 2])
    e1 = e2 + rng.choice([1, 2])
    costs = lib.GapAffine2Piece(
        mismatch=rng.choice([3, 4, 6]),
        gap_extend=e1,
        gap_open=rng.choice([4, 8]),
        gap_extend2=e2,
        gap_open2=rng.choice([16, 24]),
    )
    g, queries = _random_graph_and_reads(
        lib, rng, nseq=3, length=rng.choice([60, 110]), nq=4,
        div=rng.choice([0.03, 0.08]),
    )
    return costs, g, queries


def oracle_scores(costs, g, queries, lib=PORT):
    """The scores of ``lib``'s exact engine under Dijkstra, the admissible
    oracle (the two-piece mingap quirk is inadmissible)."""
    py = lib.PoastaAligner(costs, lib.Global(), heuristic="dijkstra")
    return [py.align(g, q).score for q in queries]


def check_one_piece(seed, device):
    """The reference's one-piece sweep at ``seed`` on ``device``."""
    costs, g, queries = draw_one_piece(seed)
    oracles = oracle_scores(costs, g, queries)
    na = NativeAligner(g)
    scores, alns = _device_engines(g, queries, costs, device, 1)
    for i, (q, oracle) in enumerate(zip(queries, oracles)):
        assert na.align(q, costs)[0] == oracle
        assert na.align_banded(q, costs)[0] == oracle
        for route, got in scores.items():
            assert int(got[i]) == oracle, (seed, route, i)
        assert alignment_cost(g, q, alns[i], costs) == oracle


def check_two_piece(seed, device):
    """The reference's two-piece sweep at ``seed`` on ``device``."""
    costs, g, queries = draw_two_piece(seed)
    oracles = oracle_scores(costs, g, queries)
    na = NativeAligner(g)
    scores, alns = _device_engines(g, queries, costs, device, 2)
    for i, (q, oracle) in enumerate(zip(queries, oracles)):
        assert na.align_banded(q, costs)[0] == oracle
        for route, got in scores.items():
            assert int(got[i]) == oracle, (seed, route, i)
        assert alignment_cost(g, q, alns[i], costs) == oracle


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("seed", ONE_PIECE_SEEDS)
def test_all_engines_agree_one_piece(seed):
    check_one_piece(seed, "cpu")


@pytest.mark.parametrize("seed", TWO_PIECE_SEEDS)
def test_all_engines_agree_two_piece(seed):
    check_two_piece(seed, "cpu")


@pytest.mark.cuda
@pytest.mark.parametrize("seed", ONE_PIECE_SEEDS)
def test_all_engines_agree_one_piece_on_card(card, seed):
    check_one_piece(seed, card)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", TWO_PIECE_SEEDS)
def test_all_engines_agree_two_piece_on_card(card, seed):
    check_two_piece(seed, card)
