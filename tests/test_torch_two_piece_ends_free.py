"""The port's two-piece ends-free scoring and alignment on the CPU against
the JAX package: the bounded full fill (B13 ``_fill_kernel_bounded_2p``),
the same with each read's end state (B14 ``_fill_kernel_bounded_2p_ends``,
whose streamed twin B15 it also stands for), the two-piece end offset rule,
``BandedScorer.scores`` and ``BatchMapper`` under ``EndsFree`` spans with
``GapAffine2Piece`` costs.

Same numpy-seeded inputs through both packages.  The JAX side runs its
Pallas kernels in interpret mode (its accelerator route) and its XLA bodies
on the CPU; the port runs its kernels' plain versions (CPU tensors,
``device="cpu"``).  Every comparison is exact (tolerance 0).
"""

import functools
import random
from contextlib import contextmanager
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from poasta_tpu.aligner import GapAffine
from poasta_tpu.aligner import banded as jbd
from poasta_tpu.aligner import costs as jcosts
from poasta_tpu.aligner import wavefront as jwf
from poasta_tpu.graphs import POAGraph
from poasta_tpu.native import NativeAligner
from poasta_tpu.ops import pallas_fill as jpf
from poasta_tpu.parallel import BatchMapper as JaxMapper
from poasta_tpu_torch import BandedScorer, BatchMapper, PoastaAligner, convert
from poasta_tpu_torch import native as port_native
from poasta_tpu_torch.aligner import costs as tcosts
from poasta_tpu_torch.aligner import wavefront as twf
from poasta_tpu_torch.ops import cuda_fill as tcf
from poasta_tpu_torch.parallel import mapper as tmapper

torch.set_num_threads(1)

INF = tcf.INF
COSTS_1P = GapAffine(4, 2, 6)
# the penalties of poasta align -n 4 -g 8,24 -e 2,1, in each package's class
J2P = jcosts.GapAffine2Piece(4, 2, 8, 1, 24)
T2P = tcosts.GapAffine2Piece(4, 2, 8, 1, 24)
# spans by field; a field left out is unbounded
SPANS = {
    # the CLI's -m semi-global and -m ends-free
    "semi-global": {"qry_free_end": ("included", 0)},
    "ends-free": {},
    # the bench's bounded span (its mixed-length config)
    "bounded": {"qry_free_end": ("included", 50),
                "graph_free_begin": ("included", 0),
                "graph_free_end": ("included", 50)},
}


def _span(mod, name):
    return mod.EndsFree(**SPANS[name])


@contextmanager
def interpret_mode():
    jpf.set_interpret_mode(True)
    try:
        yield
    finally:
        jpf.set_interpret_mode(False)


@contextmanager
def accel_sim():
    """Interpret mode plus a non-"cpu" backend name: the JAX package takes
    its accelerator route (the Pallas kernels under the capped ladder)."""
    with interpret_mode(), mock.patch.object(jax, "default_backend",
                                             lambda: "interpret-sim"):
        yield


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


def _fused_graph(rng, length, costs=COSTS_1P, nseq=3, d=0.05):
    base = "".join(rng.choice("ACGT") for _ in range(length))
    g = POAGraph()
    g.add_alignment_with_weights("s0", base.encode(), None, [1] * length)
    for i in range(1, nseq):
        s = _mutate(rng, base, d).encode()
        _, aln, _ = NativeAligner(g).align(s, costs)
        g.add_alignment_with_weights(f"s{i}", s, aln, [1] * len(s))
    return g, base


def _pack_both(g, reads):
    flat = g.flatten()
    jq, jl = jwf.pack_queries(reads)
    tq, tl = twf.pack_queries(reads, device="cpu")
    return {"graph": g, "flat": flat, "reads": reads,
            "jdg": jwf.DeviceGraph.build(flat),
            "tdg": twf.DeviceGraph.build(flat, device="cpu"),
            "jq": jq, "jl": jl, "tq": tq, "tl": tl}


@pytest.fixture(scope="module")
def case():
    """A fused ~220-node graph and 64 fragments of 120-200 bases at 3%
    (every 16th at 15%), L 256; read 7 carries a 40-base insertion, which
    a scan capped at 16 lanes over-estimates."""
    rng = random.Random(61)
    g, base = _fused_graph(rng, 200)
    reads = []
    for i in range(64):
        a = rng.randrange(0, 30)
        b = a + rng.randrange(120, 170)
        reads.append(_mutate(rng, base[a:b], 0.15 if i % 16 == 3 else 0.03)
                     .encode())
    ins = "".join(rng.choice("ACGT") for _ in range(40))
    reads[7] = (base[20:90] + ins + base[90:170]).encode()
    return _pack_both(g, reads)


def _params(case, name):
    jp = jwf.ends_free_device_params(case["flat"], _span(jcosts, name),
                                     case["jl"], case["jdg"].n_nodes_padded,
                                     two_piece=True)
    tp = convert.ends_free_params_from_reference(
        jp[0], np.asarray(jp[1]), np.asarray(jp[2]), device="cpu")
    return jp, tp


def _assert_triples_equal(got, want, msg=""):
    for name, g_arr, w_arr in zip(("scores", "end ranks", "end offsets"),
                                  got, want):
        np.testing.assert_array_equal(
            g_arr.numpy() if isinstance(g_arr, torch.Tensor) else g_arr,
            np.asarray(w_arr), err_msg=f"{msg} {name}")


def _raw_bounded_2p(case, costs, free_start, end_ok, max_run):
    """The raw (B, L) best row of the Pallas kernel B13 in interpret mode,
    one block over the batch, built as ``_pallas_exec_bounded_2p`` builds
    the call but without the windowed min behind it."""
    jdg = case["jdg"]
    B, L = (int(d) for d in case["jq"].shape)
    W, P = jdg.window, int(jdg.pred_slots.shape[1])

    def vmem():
        return pl.BlockSpec((B, L), lambda i, *_: (i, 0),
                            memory_space=pltpu.VMEM)

    call = pl.pallas_call(
        functools.partial(
            jpf._fill_kernel_bounded_2p, W=W, P=P, L=L, o1=costs.gap_open,
            e1=costs.gap_extend, e2=costs.gap_extend2, x=costs.mismatch,
            B_BLK=B, dtype=jnp.int32, free_start=free_start,
            max_run=max_run),
        out_shape=jax.ShapeDtypeStruct((B, L), jnp.int32),
        grid_spec=pltpu.PrefetchScalarGridSpec(
            num_scalar_prefetch=6, grid=(1,), in_specs=[vmem()],
            out_specs=vmem(),
            scratch_shapes=[pltpu.VMEM((W, B, L), jnp.int32)] * 3
            + [pltpu.VMEM((B, L), jnp.int32)]),
        interpret=True)
    return np.asarray(call(jdg.symbols, jdg.pred_slots_flat,
                           jdg.pred_valid_flat, jdg.write_slots, end_ok,
                           jdg.meta, case["jq"]))


# ---- B13 and B14 against the Pallas kernels --------------------------------

@pytest.mark.parametrize("max_run", [0, 16])
@pytest.mark.parametrize("name", ["semi-global", "bounded"])
def test_bounded_2p_plain_equals_pallas(case, name, max_run):
    """B13: the best rows and the scores read off them equal the Pallas
    kernel's, with a free graph begin (semi-global) and without (bounded),
    uncapped and under a cap that over-estimates the 40-base insertion;
    the wrapper takes the plain version for a CPU tensor and counts no
    launch."""
    jp, tp = _params(case, name)
    rows = tcf.bounded_best_rows_2p_plain(case["tdg"], case["tq"], T2P,
                                          tp[0], tp[1], max_run)
    raw = _raw_bounded_2p(case, J2P, jp[0], jp[1], max_run)
    np.testing.assert_array_equal(rows.numpy(), raw)
    with interpret_mode():
        want = np.asarray(jpf.pallas_fill_scores_bounded_2p(
            case["jdg"], case["jq"], case["jl"], J2P, jp[0], jp[1], jp[2],
            max_run=max_run))
    got = tcf.bounded_scores_2p_plain(case["tdg"], case["tq"], case["tl"],
                                      T2P, *tp, max_run=max_run).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    before = tcf.bounded_best_rows_2p.launches
    via = tcf.bounded_scores_2p(case["tdg"], case["tq"], case["tl"], T2P,
                                *tp, max_run=max_run)
    np.testing.assert_array_equal(via.numpy(), want)
    assert tcf.bounded_best_rows_2p.launches == before
    if max_run:
        exact = tcf.bounded_scores_2p_plain(case["tdg"], case["tq"],
                                            case["tl"], T2P, *tp).numpy()
        assert (got >= exact).all()
        if name == "semi-global":
            assert got[7] > exact[7]


@pytest.mark.parametrize("max_run", [0, 16])
@pytest.mark.parametrize("name", sorted(SPANS))
def test_bounded_with_ends_2p_plain_equals_pallas(case, name, max_run):
    """B14: (scores, end ranks, end offsets) equal the Pallas kernel's, and
    its best row is B13's."""
    jp, tp = _params(case, name)
    with interpret_mode():
        want = jpf.pallas_bounded_with_ends_2p(
            case["jdg"], case["jq"], case["jl"], J2P, jp[0], jp[1], jp[2],
            max_run=max_run)
    got = tcf.bounded_with_ends_2p_plain(case["tdg"], case["tq"], case["tl"],
                                         T2P, *tp, max_run=max_run)
    _assert_triples_equal(got, want, f"{name} max_run {max_run}")
    before = tcf.bounded_end_rows_2p.launches
    _assert_triples_equal(
        tcf.bounded_with_ends_2p(case["tdg"], case["tq"], case["tl"], T2P,
                                 *tp, max_run=max_run), want)
    assert tcf.bounded_end_rows_2p.launches == before
    best, _ = tcf.bounded_end_rows_2p_plain(case["tdg"], case["tq"], T2P,
                                            tp[0], tp[1], max_run)
    assert torch.equal(best, tcf.bounded_best_rows_2p_plain(
        case["tdg"], case["tq"], T2P, tp[0], tp[1], max_run))


@pytest.mark.parametrize("seed", [71, 73])
def test_bounded_with_ends_2p_randomized_costs(seed):
    """``tests/test_pallas_interpret.py``'s randomized two-piece costs (the
    fold of the coupled scan needs only e1 >= e2): the port's public
    ``dp_fill_ends_free_with_ends`` equals the Pallas kernel and the XLA
    body."""
    rng = random.Random(seed)
    e = rng.randrange(2, 6)
    e2 = rng.randrange(1, e + 1)
    args = (rng.randrange(1, 9), e, rng.randrange(0, 12), e2,
            rng.randrange(12, 30))
    jc, tc = jcosts.GapAffine2Piece(*args), tcosts.GapAffine2Piece(*args)
    g, base = _fused_graph(rng, 200, costs=jc, d=0.04)
    reads = []
    for _ in range(64):
        a = rng.randrange(0, 60)
        b = rng.randrange(a + 40, 200)
        reads.append(_mutate(rng, base[a:b], 0.04).encode())
    c = _pack_both(g, reads)
    jspan, tspan = _span(jcosts, "semi-global"), _span(tcosts, "semi-global")
    jdg = c["jdg"]
    fs, end_ok, jlo = jwf.ends_free_device_params(
        c["flat"], jspan, c["jl"], jdg.n_nodes_padded, two_piece=True)
    xla = jwf._scores_exec_bounded_ends(
        jdg.window, jc.gap_open, jc.gap_extend, jc.mismatch, fs,
        two_piece_params=(jc.gap_open2, jc.gap_extend2))(
        jdg.symbols, jdg.pred_slots, jdg.pred_valid, jdg.write_slots,
        jdg.end_rank, end_ok, c["jq"], c["jl"], jlo)
    with interpret_mode():
        pallas = jpf.pallas_bounded_with_ends_2p(jdg, c["jq"], c["jl"], jc,
                                                 fs, end_ok, jlo)
    got = twf.dp_fill_ends_free_with_ends(c["tdg"], c["flat"], c["tq"],
                                          c["tl"], tc, tspan)
    _assert_triples_equal(got, xla, f"{args} xla")
    _assert_triples_equal(got, pallas, f"{args} pallas")


@pytest.mark.parametrize("name", sorted(SPANS))
def test_public_fills_2p_equal_xla_bodies(case, name):
    """``dp_fill_scores_ends_free`` and ``dp_fill_ends_free_with_ends`` under
    two-piece costs equal the XLA bodies with ``two_piece_params``."""
    jp, _ = _params(case, name)
    jdg = case["jdg"]
    tp_params = (J2P.gap_open2, J2P.gap_extend2)
    args = (jdg.symbols, jdg.pred_slots, jdg.pred_valid, jdg.write_slots,
            jdg.end_rank, jp[1], case["jq"], case["jl"], jp[2])
    want = jwf._scores_exec_bounded_ends(
        jdg.window, J2P.gap_open, J2P.gap_extend, J2P.mismatch, jp[0],
        two_piece_params=tp_params)(*args)
    got = twf.dp_fill_ends_free_with_ends(
        case["tdg"], case["flat"], case["tq"], case["tl"], T2P,
        _span(tcosts, name))
    _assert_triples_equal(got, want, name)
    scores = jwf._scores_exec_bounded(
        jdg.window, J2P.gap_open, J2P.gap_extend, J2P.mismatch, jp[0],
        tp_params)(*args)
    np.testing.assert_array_equal(
        twf.dp_fill_scores_ends_free(case["tdg"], case["flat"], case["tq"],
                                     case["tl"], T2P,
                                     _span(tcosts, name)).numpy(),
        np.asarray(scores))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(scores))


# ---- the end offset rule -----------------------------------------------------

@pytest.mark.parametrize("qry_end", [("unbounded", None), ("included", 20),
                                     ("excluded", 20)],
                         ids=["unbounded", "included", "excluded"])
def test_two_piece_query_end_lo_matches(case, qry_end):
    """jlo under two-piece costs: an unbounded query end ends at the read's
    last base (jlo = n, the two-piece engines' rule), the bounded kinds as
    under one-piece costs; the end mask does not depend on the costs."""
    jspan = jcosts.EndsFree(qry_free_end=qry_end)
    tspan = tcosts.EndsFree(qry_free_end=qry_end)
    lens = np.array([len(r) for r in case["reads"]] + [0, 5])
    jl = jnp.asarray(lens, dtype=jnp.int32)
    tl = torch.as_tensor(lens, dtype=torch.int32)
    for two_piece in (False, True):
        want = jwf.ends_free_device_params(
            case["flat"], jspan, jl, case["jdg"].n_nodes_padded,
            two_piece=two_piece)
        got = twf.ends_free_device_params(
            case["flat"], tspan, tl, case["tdg"].n_nodes_padded, two_piece)
        assert got[0] == bool(want[0])
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
        np.testing.assert_array_equal(
            twf.query_end_lo(tspan, lens, two_piece), np.asarray(want[2]))
    if qry_end[0] == "unbounded":
        np.testing.assert_array_equal(twf.query_end_lo(tspan, lens, True),
                                      lens)


# ---- the scorer and the mapper -----------------------------------------------

@pytest.mark.parametrize("name", sorted(SPANS))
def test_scorer_2p_ends_free_matches_jax(case, name):
    """``BandedScorer.scores``: every call is one bounded full fill under the
    capped ladder (no banded or drift tier), as the reference's
    accelerator route; scores, hints and stats equal call by call."""
    port = BandedScorer(case["flat"], T2P, dg=case["tdg"],
                        aln_type=_span(tcosts, name))
    exact = tcf.bounded_scores_2p_plain(
        case["tdg"], case["tq"], case["tl"], T2P, *_params(case, name)[1])
    with accel_sim():
        ref = jbd.BandedScorer(case["flat"], J2P, dg=case["jdg"],
                               aln_type=_span(jcosts, name))
        for kw in ({}, {}, {"ub": 40, "max_retries": 1}):
            want = np.asarray(ref.scores(case["jq"], case["jl"], **kw))
            got = port.scores(case["tq"], case["tl"], **kw)
            assert got.dtype == np.int32
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(got, exact.numpy())
            assert port._ub_hint == ref._ub_hint, kw
            for k in ("fills", "cells_filled", "tiers",
                      "fullfill_fallbacks"):
                assert port.stats[k] == ref.stats[k], (kw, k)
    assert port.stats["tiers"] == 0 and port.stats["fills"] == 3


@pytest.mark.parametrize("name", sorted(SPANS))
def test_mapper_score_batch_2p_ends_free(case, name):
    """``BatchMapper.score_batch`` and ``prescore`` under two-piece costs
    equal ``poasta_tpu``'s (accelerator route)."""
    reads = case["reads"]
    port = BatchMapper(case["graph"], T2P, device="cpu",
                       aln_type=_span(tcosts, name))
    with accel_sim():
        ref = JaxMapper(case["graph"], J2P, aln_type=_span(jcosts, name))
        want = np.asarray(ref.score_batch(reads))
    got = port.score_batch(reads)
    np.testing.assert_array_equal(got, want)
    assert port.scorer.stats["fills"] == ref._ef_scorer.stats["fills"] == 1
    token = port.prescore(reads)
    np.testing.assert_array_equal(token[1][0], want)


@pytest.fixture(scope="module")
def mapping_case():
    """A 700-base backbone with skip edges and 8 reads of 300 bases at 1%,
    one random (its alignment is all mismatches and gaps)."""
    rng = random.Random(17)
    base = "".join(rng.choice("ACGT") for _ in range(700))
    g = POAGraph()
    g.add_alignment_with_weights("s0", base.encode(), None, [1] * 700)
    for v in range(0, 697, 97):
        g.add_edge(v, v + 3, 0, 1)
    g.post_process()
    reads = []
    for _ in range(8):
        a = rng.randrange(0, 400)
        reads.append(_mutate(rng, base[a:a + 300], 0.01).encode())
    reads[5] = "".join(rng.choice("ACGT") for _ in range(200)).encode()
    return g, reads


def _alignments(out):
    return [(int(s), [(p.rpos, p.qpos) for p in a]) for s, a in out]


@pytest.mark.parametrize("name", sorted(SPANS))
def test_align_batch_2p_equals_the_reference(mapping_case, name,
                                             monkeypatch):
    """``align_batch`` under two-piece costs equals ``poasta_tpu``'s, with
    ``POASTA_SEED=all`` set: no seeded fill runs and nothing is learnt, no
    read is traced on the device, every read takes the anchored corridor;
    every alignment costs its score, and under the semi-global span covers
    the whole read."""
    monkeypatch.setenv("POASTA_SEED", "all")
    monkeypatch.setenv("POASTA_SEED_DEBUG", "1")

    def no_seed(*a, **k):
        raise AssertionError("a seeded fill ran under two-piece costs")

    monkeypatch.setattr(tmapper, "seed_scores", no_seed)
    g, reads = mapping_case
    jm = JaxMapper(g, J2P, aln_type=_span(jcosts, name))
    tm = BatchMapper(g, T2P, device="cpu", aln_type=_span(tcosts, name))
    with interpret_mode():
        for round_ in range(2):
            want = jm.align_batch(reads)
            got = tm.align_batch(reads)
            assert _alignments(got) == _alignments(want), (name, round_)
            stats = tm.last_ends_free_stats
            assert stats["device_traced"] == 0
            assert stats["anchored_ok"] == jm.last_ends_free_stats[
                "anchored_ok"] == len(reads)
            assert tm.last_banded_stats == {"device_traced": 0,
                                            "host_backtraced": len(reads)}
            assert tm.last_seed_stats is None and tm._seed_rate is None
        scores = tm.score_batch(reads)
    assert [s for s, _ in got] == list(map(int, scores))
    token = tm.prescore(reads)
    assert _alignments(tm.align_batch(reads, prescored=token)) == \
        _alignments(got)
    for (score, aln), read in zip(got, reads):
        assert twf.alignment_cost(g, read, aln, T2P) == score
        assert jwf.alignment_cost(g, read, list(aln), J2P) == score
        if name == "semi-global":
            qs = [p.qpos for p in aln if p.qpos is not None]
            assert qs and qs[0] == 0 and qs[-1] == len(read) - 1


@pytest.mark.parametrize("name", sorted(SPANS))
def test_align_batch_2p_equals_the_exact_engine(name):
    """Short reads through the same path against the A* engine under
    Dijkstra."""
    rng = random.Random(87)
    g, base = _fused_graph(rng, 150, costs=J2P)
    reads = [_mutate(rng, base[a:a + n], 0.05).encode()
             for a, n in ((0, 60), (40, 70), (70, 75), (20, 120))]
    tm = BatchMapper(g, T2P, device="cpu", aln_type=_span(tcosts, name))
    engine = PoastaAligner(T2P, _span(tcosts, name), heuristic="dijkstra")
    got = tm.align_batch(reads)
    assert [s for s, _ in got] == [engine.align(g, r).score for r in reads]
    assert [s for s, _ in got] == list(map(int, tm.score_batch(reads)))


def test_align_batch_2p_without_the_native_engine_raises(mapping_case,
                                                         monkeypatch):
    """Without the native engine the reference runs the Dijkstra engine per
    read; the port raises, as it does under one-piece costs."""
    g, reads = mapping_case

    def no_engine(*a, **k):
        raise RuntimeError("g++ not found")

    monkeypatch.setattr(port_native, "NativeAligner", no_engine)
    tm = BatchMapper(g, T2P, device="cpu",
                     aln_type=_span(tcosts, "semi-global"))
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        tm.align_batch(reads[:2])
