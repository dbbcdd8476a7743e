"""A search for the drift kernels' stale ring margins reaching a score lane
(ROADMAP C7).

The drift fills (B3 ``_banded_kernel_drift``, B6
``_banded_kernel_drift_ef``, B17 ``_banded_kernel_drift_2p``) roll a read's
ring rows 128 lanes left where its frame steps, and a ring slot that takes a
new rank keeps in its margins what the roll left there from the slot's
previous occupant.  Such a lane can hold a cost below the exact optimum
(``tests/test_torch_two_piece.py::
test_stale_drift_margins_fall_below_the_optimum_left_of_the_end``).  The
tier accepts a score at or under its ub as exact, so a stale lane that
reached a read's score lane under ub would be a wrong answer.

Hypothesis draws drift layouts with large length spreads (a base of 400 to
1,500 bases fused with one deletion allele of 30-60% of it, reads at
0.5-3% from either allele, random one- and two-piece costs in the ranges of
``tests/test_consistency.py``, a random ub) and runs one drifting tier
through the plain versions (``ops/cuda_fill.py``: ``drift_scores_plain``,
``drift_ef_scores_plain`` under ``bench.py``'s bounded span,
``drift_scores_2p_plain``), built as ``BandedScorer._fill_once_drift``
builds it but without its profitability gate: a drift layout must be exact
under its ub whether or not the ladder would choose it.  Every read whose
drift score is at or under ub must equal the exact engine:
``NativeAligner.align`` (global, one-piece), ``align_banded`` (two-piece),
and under the bounded span the reference's dense fill
(``poasta_tpu``'s ``dp_fill_scores_ends_free``, its XLA body on the CPU,
over the same layout built with the reference's classes).  Only that
check imports the reference, and JAX with it.

Tier-1 runs a few derandomized examples per kernel.  A wider search draws
N random examples of the same strategies per kernel (all three, or those
named):

    PYTHONPATH=. python tests/test_torch_drift_search.py N [B3 B6 B17]
"""

import random

import numpy as np
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from poasta_tpu_torch import NativeAligner, POAGraph, pack_queries
from poasta_tpu_torch.aligner import GapAffine, GapAffine2Piece
from poasta_tpu_torch.aligner import banded as tbd
from poasta_tpu_torch.aligner.costs import EndsFree, UNBOUNDED, included
from poasta_tpu_torch.aligner.wavefront import (
    DeviceGraph,
    ends_free_device_params,
)
from poasta_tpu_torch.ops import cuda_fill as tcf

torch.set_num_threads(1)

BUILD_COSTS = GapAffine(4, 2, 6)
# bench.py:273's bounded span
BOUNDED_BOUNDS = (50, 0, 50)
BOUNDED = EndsFree(UNBOUNDED, *map(included, BOUNDED_BOUNDS))
N_READS = 12
SEARCH = settings(max_examples=10, deadline=None, derandomize=True,
                  suppress_health_check=[HealthCheck.too_slow,
                                         HealthCheck.data_too_large])


def _mutate(rng, s, d):
    out = []
    for ch in s:
        r = rng.random()
        if r < d:
            continue
        out.append(rng.choice("ACGT") if r < 2 * d else ch)
        if rng.random() < d:
            out.append(rng.choice("ACGT"))
    return "".join(out) or "A"


# the cost ranges of tests/test_consistency.py:49-53 and :77-85
one_piece = st.builds(GapAffine, mismatch=st.sampled_from([1, 3, 4, 7]),
                      gap_extend=st.sampled_from([1, 2, 3]),
                      gap_open=st.sampled_from([0, 4, 6, 11]))


@st.composite
def two_piece(draw):
    e2 = draw(st.sampled_from([1, 2]))
    return GapAffine2Piece(mismatch=draw(st.sampled_from([3, 4, 6])),
                           gap_extend=e2 + draw(st.sampled_from([1, 2])),
                           gap_open=draw(st.sampled_from([4, 8])),
                           gap_extend2=e2,
                           gap_open2=draw(st.sampled_from([16, 24])))


layouts = st.fixed_dictionaries({
    "seed": st.integers(0, 2 ** 31 - 1),
    "n_base": st.integers(400, 1500),
    "deleted": st.floats(0.3, 0.6),
    "at": st.floats(0.0, 1.0),
    "ub_scale": st.floats(0.25, 3.0),
})


def _case(layout, graph_cls=POAGraph, aligner_cls=NativeAligner,
          build_costs=BUILD_COSTS):
    """The fused SV graph and its reads, from the drawn layout (built with
    the port's classes, or with those given)."""
    rng = random.Random(layout["seed"])
    n = layout["n_base"]
    base = "".join(rng.choice("ACGT") for _ in range(n))
    dl = int(layout["deleted"] * n)
    a = 1 + int(layout["at"] * (n - dl - 2))
    variant = base[:a] + base[a + dl:]
    g = graph_cls()
    g.add_alignment_with_weights("s0", base.encode(), None, [1] * n)
    _, aln, _ = aligner_cls(g).align(variant.encode(), build_costs)
    g.add_alignment_with_weights("s1", variant.encode(), aln,
                                 [1] * len(variant))
    reads = [_mutate(rng, base if i % 2 else variant,
                     rng.uniform(0.005, 0.03)).encode()
             for i in range(N_READS)]
    return g, reads


def _drift_tier(flat, dg, q, lengths, costs, ub, span=None):
    """One drifting tier at ``ub`` through the plain versions, laid out as
    ``BandedScorer._fill_once_drift`` lays it out."""
    ln = lengths.numpy()
    n_min, n_max = int(ln.min()), int(ln.max())
    S = tbd.drift_steps_for(n_min, n_max)
    assert 0 < S <= flat.n_nodes - 1
    ws, width, s_ranks = tbd.band_windows_drift(flat, n_min, n_max, costs,
                                                ub, S, aln_type=span)
    L = int(q.shape[1])
    req = -(-(int(ws.max()) + width) // 128) * 128
    prep = tcf.prepare_banded_drift(dg, costs, ws, width, s_ranks, S,
                                    max(L, req))
    q_in = torch.nn.functional.pad(q, (prep["mq"], max(prep["L"] - L, 0)))
    max_run = tbd.ins_run_cap(costs, ub, width)
    if span is not None:
        _, end_ok, jlo = ends_free_device_params(flat, span, lengths,
                                                 dg.n_nodes_padded)
        return tcf.drift_ef_scores_plain(dg, q_in, lengths, costs, prep,
                                         n_min, end_ok, jlo,
                                         max_run).numpy()
    fill = (tcf.drift_scores_2p_plain if costs.is_two_piece
            else tcf.drift_scores_plain)
    return fill(dg, q_in, lengths, costs, prep, n_min, max_run).numpy()


def _check(layout, costs, span=None):
    g, reads = _case(layout)
    flat = g.flatten()
    dg = DeviceGraph.build(flat, device="cpu")
    q, lengths = pack_queries(reads, device="cpu")
    x = costs.mismatch
    ub = costs.gap_open + costs.gap_extend + max(
        int(layout["ub_scale"] * x * 0.02 * int(lengths.max())), 1)
    got = _drift_tier(flat, dg, q, lengths, costs, ub, span)
    under = np.flatnonzero(got <= ub)
    if span is not None:
        exact = _reference_bounded_scores(layout, reads, costs)[under]
    else:
        na = NativeAligner(g)
        align = na.align_banded if costs.is_two_piece else na.align
        exact = [align(reads[i], costs)[0] for i in under]
    assert [int(got[i]) for i in under] == [int(s) for s in exact], \
        (costs, ub, under)


def _reference_bounded_scores(layout, reads, costs):
    """The reference's exact scores of ``reads`` under the bounded span:
    its dense fill over the same layout built with its own classes."""
    from poasta_tpu.aligner import GapAffine as RefGapAffine
    from poasta_tpu.aligner import costs as jcosts
    from poasta_tpu.aligner import wavefront as jwf
    from poasta_tpu.graphs import POAGraph as RefPOAGraph
    from poasta_tpu.native import NativeAligner as RefNativeAligner

    g, ref_reads = _case(layout, RefPOAGraph, RefNativeAligner,
                         RefGapAffine(4, 2, 6))
    assert ref_reads == reads
    flat = g.flatten()
    q, lengths = jwf.pack_queries(reads)
    span = jcosts.EndsFree(jcosts.UNBOUNDED,
                           *map(jcosts.included, BOUNDED_BOUNDS))
    return np.asarray(jwf.dp_fill_scores_ends_free(
        jwf.DeviceGraph.build(flat), flat, q, lengths,
        RefGapAffine(costs.mismatch, costs.gap_extend, costs.gap_open),
        span))


@SEARCH
@given(layout=layouts, costs=one_piece)
def test_drift_b3_scores_under_ub_are_exact(layout, costs):
    _check(layout, costs)


@SEARCH
@given(layout=layouts, costs=one_piece)
def test_drift_b6_bounded_span_scores_under_ub_are_exact(layout, costs):
    _check(layout, costs, BOUNDED)


@SEARCH
@given(layout=layouts, costs=two_piece())
def test_drift_b17_two_piece_scores_under_ub_are_exact(layout, costs):
    _check(layout, costs)


def test_search_layouts_verify_reads_and_roll_frames():
    """The search is not vacuous: on a draw of its own shape, the tier rolls
    frames (S > 0) and verifies some reads under ub but not all."""
    layout = {"seed": 5, "n_base": 1200, "deleted": 0.5, "at": 0.4,
              "ub_scale": 1.0}
    g, reads = _case(layout)
    flat = g.flatten()
    dg = DeviceGraph.build(flat, device="cpu")
    q, lengths = pack_queries(reads, device="cpu")
    ln = lengths.numpy()
    assert tbd.drift_steps_for(int(ln.min()), int(ln.max())) >= 4
    got = _drift_tier(flat, dg, q, lengths, BUILD_COSTS, 150)
    assert 0 < int((got <= 150).sum()) < N_READS


def search(n: int, names=("B3", "B6", "B17")) -> None:
    """Draw ``n`` random examples per kernel (no example database)."""
    wide = settings(SEARCH, max_examples=n, derandomize=False,
                    database=None)
    for name, costs, span in (("B3", one_piece, None),
                              ("B6", one_piece, BOUNDED),
                              ("B17", two_piece(), None)):
        if name not in names:
            continue

        @wide
        @given(layout=layouts, costs=costs)
        def run(layout, costs):
            _check(layout, costs, span)

        run()
        print(f"{name}: {n} random examples, every score under ub exact",
              flush=True)


if __name__ == "__main__":
    import sys

    search(int(sys.argv[1]), sys.argv[2:] or ("B3", "B6", "B17"))
