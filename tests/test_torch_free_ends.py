"""The port's free graph ends of the global full fill on the CPU against the
JAX package: ``dp_fill_scores(free_start=, free_end=)`` under one- and
two-piece costs (B2f, ``_fill_kernel`` with its free-end flags, and B12f,
``_fill_kernel_2p`` with them: in the port the bounded fills B4 and B13
under an end mask), ``dp_fill_full(free_start=True)`` and
``backtrace_dense_ends_free``.

Same numpy-seeded inputs through both packages.  The JAX side runs its
Pallas kernels in interpret mode and its XLA bodies on the CPU; the port
runs its kernels' plain versions (CPU tensors, ``device="cpu"``).  Every
comparison is exact (tolerance 0).
"""

import functools
import random
from contextlib import contextmanager

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from poasta_tpu.aligner import GapAffine, Global, PoastaAligner
from poasta_tpu.aligner import costs as jcosts
from poasta_tpu.aligner import wavefront as jwf
from poasta_tpu.graphs import POAGraph
from poasta_tpu.ops import pallas_fill as jpf
from poasta_tpu_torch.aligner import costs as tcosts
from poasta_tpu_torch.aligner import wavefront as twf
from poasta_tpu_torch.ops import cuda_fill as tcf

torch.set_num_threads(1)

COSTS = GapAffine(4, 2, 6)
J2P = jcosts.GapAffine2Piece(mismatch=4, gap_extend=2, gap_open=8,
                             gap_extend2=1, gap_open2=24)
T2P = tcosts.GapAffine2Piece(mismatch=4, gap_extend=2, gap_open=8,
                             gap_extend2=1, gap_open2=24)
FLAGS = [(False, False), (True, False), (False, True), (True, True)]
FLAG_IDS = ["global", "free-start", "free-end", "both"]


@contextmanager
def interpret_mode():
    jpf.set_interpret_mode(True)
    try:
        yield
    finally:
        jpf.set_interpret_mode(False)


def _graph_case(seed, glen, qlen, qshift_max):
    """``tests/test_pallas_fill.py``'s free-end cases: a ``glen``-base graph
    fused with two copies at 6% and 64 queries of ``qlen`` bases cut from
    its base at random starts."""
    rng = random.Random(seed)
    base = "".join(rng.choice("ACGT") for _ in range(glen))

    def mutate(s):
        out = []
        for ch in s:
            r = rng.random()
            if r < 0.06:
                continue
            out.append(rng.choice("ACGT") if r < 0.12 else ch)
        return "".join(out) or "A"

    g = POAGraph()
    py = PoastaAligner(COSTS, Global(), heuristic="mingap")
    g.add_alignment_with_weights("s0", base.encode(), None, [1] * glen)
    for i in range(1, 3):
        s = mutate(base).encode()
        r = py.align(g, s)
        g.add_alignment_with_weights(f"s{i}", s, r.alignment, [1] * len(s))
    reads = [base[rng.randrange(0, qshift_max):][:qlen].encode()
             for _ in range(64)]
    # a few mutated reads, so that the free ends are not all free matches
    for i in range(0, 64, 8):
        reads[i] = mutate(reads[i].decode()).encode()
    flat = g.flatten()
    jq, jl = jwf.pack_queries(reads)
    tq, tl = twf.pack_queries(reads, device="cpu")
    return {"graph": g, "flat": flat, "reads": reads,
            "jdg": jwf.DeviceGraph.build(flat),
            "tdg": twf.DeviceGraph.build(flat, device="cpu"),
            "jq": jq, "jl": jl, "tq": tq, "tl": tl}


@pytest.fixture(scope="module")
def case_1p():
    return _graph_case(11, 120, 60, 40)


@pytest.fixture(scope="module")
def case_2p():
    return _graph_case(13, 100, 50, 30)


def _raw_pallas_fill(case, costs, free_start, free_end):
    """The raw (B, L) end row of ``_fill_kernel`` (one-piece) or
    ``_fill_kernel_2p`` in interpret mode, int32, one block over the batch,
    built as ``_pallas_exec(_2p)`` builds the call but without reading it
    at the reads' lengths."""
    jdg = case["jdg"]
    B, L = (int(d) for d in case["jq"].shape)
    W, P = jdg.window, int(jdg.pred_slots.shape[1])
    if costs.is_two_piece:
        kernel = functools.partial(
            jpf._fill_kernel_2p, o1=costs.gap_open, e1=costs.gap_extend,
            e2=costs.gap_extend2, x=costs.mismatch)
        rings = 3
    else:
        kernel = functools.partial(
            jpf._fill_kernel, o=costs.gap_open, e=costs.gap_extend,
            x=costs.mismatch)
        rings = 2
    scratch = [pltpu.VMEM((W, B, L), jnp.int32)] * rings
    if free_end:
        scratch.append(pltpu.VMEM((B, L), jnp.int32))

    def vmem():
        return pl.BlockSpec((B, L), lambda i, *_: (i, 0),
                            memory_space=pltpu.VMEM)

    call = pl.pallas_call(
        functools.partial(kernel, W=W, P=P, L=L, B_BLK=B, dtype=jnp.int32,
                          free_start=free_start, free_end=free_end),
        out_shape=jax.ShapeDtypeStruct((B, L), jnp.int32),
        grid_spec=pltpu.PrefetchScalarGridSpec(
            num_scalar_prefetch=5, grid=(1,), in_specs=[vmem()],
            out_specs=vmem(), scratch_shapes=scratch),
        interpret=True)
    return np.asarray(call(jdg.symbols, jdg.pred_slots_flat,
                           jdg.pred_valid_flat, jdg.write_slots, jdg.meta,
                           case["jq"]))


@pytest.mark.parametrize("fs,fe", FLAGS, ids=FLAG_IDS)
@pytest.mark.parametrize("model", ["1p", "2p"])
def test_dp_fill_scores_free_ends_match(case_1p, case_2p, model, fs, fe):
    """``dp_fill_scores(free_start=, free_end=)`` equals the Pallas kernel's
    scores in interpret mode and the XLA body's; the plain version's rows
    (the bounded fill under the end mask) equal the Pallas kernel's raw end
    rows at every lane; the port's own rank scan agrees; the wrapper on a
    CPU tensor launches nothing."""
    case = case_1p if model == "1p" else case_2p
    jc, tc = (COSTS, COSTS) if model == "1p" else (J2P, T2P)
    with interpret_mode():
        pallas_fn = jpf.pallas_fill_scores_2p if model == "2p" \
            else jpf.pallas_fill_scores
        pallas = np.asarray(pallas_fn(case["jdg"], case["jq"], case["jl"],
                                      jc, free_start=fs, free_end=fe))
    xla = np.asarray(jwf.dp_fill_scores(case["jdg"], case["jq"], case["jl"],
                                        jc, free_start=fs, free_end=fe,
                                        engine="xla"))
    np.testing.assert_array_equal(pallas, xla)
    counters = (tcf.free_fill_rows, tcf.free_fill_rows_2p,
                tcf.fill_end_rows, tcf.fill_end_rows_2p)
    before = [c.launches for c in counters]
    got = twf.dp_fill_scores(case["tdg"], case["tq"], case["tl"], tc,
                             free_start=fs, free_end=fe).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, xla)
    assert [c.launches for c in counters] == before
    np.testing.assert_array_equal(
        twf.scan_scores(case["tdg"], case["tq"], case["tl"], tc,
                        free_start=fs, free_end=fe).numpy(), xla)
    rows = tcf.free_fill_rows_plain(case["tdg"], case["tq"], tc, fs, fe)
    np.testing.assert_array_equal(
        rows.numpy(), _raw_pallas_fill(case, jc, fs, fe))
    np.testing.assert_array_equal(
        tcf.free_fill_scores_plain(case["tdg"], case["tq"], case["tl"], tc,
                                   fs, fe).numpy(), xla)
    if fs or fe:
        assert (got <= twf.dp_fill_scores(case["tdg"], case["tq"],
                                          case["tl"], tc).numpy()).all()


def test_free_end_mask_and_wrappers(case_1p):
    """The end mask: ranks 1 .. n_nodes - 1 with a free end (the virtual
    end rank included, rank 0 and the padding not), the end rank alone
    without; cached per graph.  Each wrapper takes the cost model of its
    kernel."""
    dg = case_1p["tdg"]
    free = tcf.free_end_mask(dg, True).numpy()
    assert free.shape == (dg.n_nodes_padded,) and free.dtype == np.int32
    assert free[0] == 0 and free[1:dg.n_nodes].all()
    assert not free[dg.n_nodes:].any()
    only_end = tcf.free_end_mask(dg, False).numpy()
    assert np.flatnonzero(only_end).tolist() == [dg.end_rank_i]
    assert tcf.free_end_mask(dg, True) is tcf.free_end_mask(dg, True)
    q = case_1p["tq"]
    with pytest.raises(ValueError, match="takes one-piece costs"):
        tcf.free_fill_rows(dg, q, T2P, True, True)
    with pytest.raises(ValueError, match="takes two-piece costs"):
        tcf.free_fill_rows_2p(dg, q, COSTS, True, True)
    with pytest.raises(ValueError, match="no free-end full fill"):
        tcf.free_fill_rows(dg, q.to("meta"), COSTS, True, False)
    assert torch.equal(tcf.free_fill_rows(dg, q, COSTS, False, True),
                       tcf.free_fill_rows_plain(dg, q, COSTS, False, True))


@pytest.mark.parametrize("fs", [False, True], ids=["global", "free-start"])
def test_dp_fill_full_matches(case_1p, fs):
    """``dp_fill_full``'s tables (every padded rank) and scores equal the
    reference's XLA body, with and without a free graph begin."""
    case = case_1p
    want = jwf.dp_fill_full(case["jdg"], case["jq"], case["jl"], COSTS,
                            free_start=fs)
    got = twf.dp_fill_full(case["tdg"], case["tq"], case["tl"], COSTS,
                           free_start=fs)
    for name, g_arr, w_arr in zip(("scores", "M", "I", "D"), got, want):
        np.testing.assert_array_equal(g_arr.numpy(), np.asarray(w_arr),
                                      err_msg=name)
    if fs:
        # a free graph begin puts a 0 at offset 0 of every real rank
        M = got[1].numpy()
        assert (M[1:case["flat"].n_nodes - 1, :, 0] == 0).all()


SPANS = {
    "semi-global": {"qry_free_end": ("included", 0)},
    "ends-free": {},
    "bounded": {"qry_free_end": ("included", 20),
                "graph_free_begin": ("included", 0),
                "graph_free_end": ("included", 20)},
}


@pytest.mark.parametrize("name", sorted(SPANS))
def test_backtrace_dense_ends_free_matches(case_1p, name):
    """``backtrace_dense_ends_free`` on ``dp_fill_full``'s tables (the
    span's free begin) gives the reference's score and pairs for every
    read; the scores are the bounded fill's."""
    case = case_1p
    jspan = jcosts.EndsFree(**SPANS[name])
    tspan = tcosts.EndsFree(**SPANS[name])
    fs, end_ok, jlo = twf.ends_free_device_params(
        case["flat"], tspan, case["tl"], case["tdg"].n_nodes_padded)
    _, M, I, D = twf.dp_fill_full(case["tdg"], case["tq"], case["tl"], COSTS,
                                  free_start=fs)
    M, I, D = M.numpy(), I.numpy(), D.numpy()
    eo, jlo = end_ok.numpy(), jlo.numpy()
    scores = twf.dp_fill_scores_ends_free(case["tdg"], case["flat"],
                                          case["tq"], case["tl"], COSTS,
                                          tspan).numpy()
    for b, q in enumerate(case["reads"]):
        tables = (M[:, b, :], I[:, b, :], D[:, b, :])
        want = jwf.backtrace_dense_ends_free(case["flat"], *tables, q, COSTS,
                                             eo, int(jlo[b]), fs)
        got = twf.backtrace_dense_ends_free(case["flat"], *tables, q, COSTS,
                                            eo, int(jlo[b]), fs)
        assert got[0] == want[0] == scores[b], (name, b)
        assert [(p.rpos, p.qpos) for p in got[1]] == \
            [(p.rpos, p.qpos) for p in want[1]], (name, b)
        assert twf.alignment_cost(case["graph"], q, got[1], COSTS) == got[0]
