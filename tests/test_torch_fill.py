"""The PyTorch port's fills and window planning against the JAX package.

Same seeded inputs through both packages; the JAX side runs its Pallas
kernels in interpret mode and its XLA bodies on the CPU, the port runs its
kernels' plain versions (CPU tensors).  Every comparison is exact
(tolerance 0): scores are integer DP values.
"""

import random
from contextlib import contextmanager

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poasta_tpu.aligner import GapAffine
from poasta_tpu.aligner import banded as jbd
from poasta_tpu.aligner import wavefront as jwf
from poasta_tpu.graphs import POAGraph
from poasta_tpu.native import NativeAligner
from poasta_tpu.ops import dp_rows as jrows
from poasta_tpu.ops import pallas_fill as jpf
from poasta_tpu_torch.aligner import banded as tbd
from poasta_tpu_torch.aligner import wavefront as twf
from poasta_tpu_torch.ops import cuda_fill as tcf
from poasta_tpu_torch.ops import dp_rows as trows

torch.set_num_threads(1)

COSTS = GapAffine(4, 2, 6)


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


@contextmanager
def interpret_mode():
    jpf.set_interpret_mode(True)
    try:
        yield
    finally:
        jpf.set_interpret_mode(False)


@pytest.fixture(scope="module")
def case():
    """A fused ~470-node graph, 64 reads at 3-6% divergence, both
    packages' device graphs and batches, and the exact scores."""
    rng = random.Random(21)
    base = "".join(rng.choice("ACGT") for _ in range(420))
    g = POAGraph()
    g.add_alignment_with_weights("s0", base.encode(), None, [1] * len(base))
    for i in range(1, 4):
        s = _mutate(rng, base, 0.05).encode()
        _, aln, _ = NativeAligner(g).align(s, COSTS)
        g.add_alignment_with_weights(f"s{i}", s, aln, [1] * len(s))
    reads = [_mutate(rng, base, 0.03 + 0.03 * (i % 2)).encode()
             for i in range(64)]
    flat = g.flatten()
    na = NativeAligner(g)
    jq, jl = jwf.pack_queries(reads)
    tq, tl = twf.pack_queries(reads, device="cpu")
    return {
        "flat": flat, "reads": reads,
        "jdg": jwf.DeviceGraph.build(flat), "tdg": twf.DeviceGraph.build(flat, device="cpu"),
        "jq": jq, "jl": jl, "tq": tq, "tl": tl,
        "exact": np.array([na.align(q, COSTS)[0] for q in reads]),
    }


@pytest.mark.parametrize("start,free", [(False, False), (True, False),
                                        (False, True)])
def test_row_update_matches(start, free):
    rng = np.random.default_rng(7)
    B, P, L = 5, 4, 256
    pred_M = rng.integers(0, 400, size=(B, P, L)).astype(np.int32)
    pred_D = rng.integers(0, 400, size=(B, P, L)).astype(np.int32)
    pred_M[rng.random((B, P, L)) < 0.2] = jrows.INF
    pred_D[rng.random((B, P, L)) < 0.2] = jrows.INF
    mask = np.array([True, False, True, True])
    match = rng.choice([0, 6], size=(B, L)).astype(np.int32)
    ref = jrows.row_update(jnp.asarray(pred_M), jnp.asarray(pred_D),
                           jnp.asarray(mask), jnp.asarray(match), 4, 2,
                           is_start_row=jnp.asarray(start),
                           free_start=jnp.asarray(free))
    got = trows.row_update(torch.as_tensor(pred_M), torch.as_tensor(pred_D),
                           torch.as_tensor(mask), torch.as_tensor(match), 4,
                           2, is_start_row=start, free_start=free)
    for r, t in zip(ref, got):
        assert t.dtype == torch.int32
        assert (np.asarray(r) == t.numpy()).all()


def test_insertion_row_matches():
    rng = np.random.default_rng(3)
    A = rng.integers(-50, 500, size=(6, 384)).astype(np.int32)
    A[:, ::7] = jrows.INF
    ref = np.asarray(jrows.insertion_row(jnp.asarray(A), 4, 2))
    got = trows.insertion_row(torch.as_tensor(A), 4, 2).numpy()
    assert (ref == got).all()


def test_fill_scores_plain_matches(case):
    got = tcf.fill_scores_plain(case["tdg"], case["tq"], case["tl"],
                                COSTS).numpy()
    xla = np.asarray(jwf.dp_fill_scores(case["jdg"], case["jq"], case["jl"],
                                        COSTS, engine="xla"))
    with interpret_mode():
        pallas = np.asarray(jpf.pallas_fill_scores(
            case["jdg"], case["jq"], case["jl"], COSTS))
    scan = twf.scan_scores(case["tdg"], case["tq"], case["tl"],
                           COSTS).numpy()
    assert (got == pallas).all()
    assert (got == xla).all()
    assert (scan == xla).all()
    assert (got == case["exact"]).all()
    # CPU tensors take the plain version through the public entry point
    launches = tcf.fill_end_rows.launches
    via = twf.dp_fill_scores(case["tdg"], case["tq"], case["tl"], COSTS)
    assert (via.numpy() == got).all()
    assert tcf.fill_end_rows.launches == launches


def _windows(case, ub):
    lens = [len(r) for r in case["reads"]]
    n_min, n_max = min(lens), max(lens)
    ws, width, _, _ = jbd.band_windows(case["flat"], n_min, n_max, COSTS, ub)
    return (ws // 128) * 128, width + 128


@pytest.mark.parametrize("ub", [150, 200])
def test_banded_scores_plain_matches(case, ub):
    ws, width = _windows(case, ub)
    L = int(case["tq"].shape[1])
    jprep = jpf.prepare_banded(case["jdg"], COSTS, ws, width, L)
    tprep = tcf.prepare_banded(case["tdg"], COSTS, ws, width, L)
    cap = tbd.ins_run_cap(COSTS, ub, tprep["width"])
    assert tprep["width"] < L  # real windows, not the whole row
    assert 0 < cap < tprep["width"]  # a binding cap
    xla_fn = jbd._banded_exec(case["jdg"].window, tprep["width"],
                              int(case["jdg"].pred_slots.shape[1]),
                              COSTS.gap_open, COSTS.gap_extend,
                              COSTS.mismatch)
    xla = np.asarray(xla_fn(
        case["jdg"].symbols, jnp.asarray(case["jdg"].pred_ranks_np),
        case["jdg"].pred_valid, jprep["wstarts"], case["jdg"].write_slots,
        case["jdg"].end_rank, case["jq"], case["jl"]))
    for max_run in (0, cap):
        got = tcf.banded_scores_plain(case["tdg"], case["tq"], case["tl"],
                                      COSTS, tprep, max_run=max_run).numpy()
        ref = np.asarray(jpf.pallas_banded_scores(
            case["jdg"], case["jq"], case["jl"], COSTS, prep=jprep,
            max_run=max_run, chain_skip=False, interpret=True))
        assert (got == ref).all(), max_run
        # verified scores are exact, the rest over-estimate
        ok = got <= ub
        assert ok.any()
        assert (got[ok] == case["exact"][ok]).all()
        assert (got >= case["exact"]).all()
        if max_run == 0:
            assert (got == xla).all()


def test_banded_scores_dispatch_cpu(case):
    ws, width = _windows(case, 150)
    L = int(case["tq"].shape[1])
    prep = tcf.prepare_banded(case["tdg"], COSTS, ws, width, L)
    launches = tcf.banded_end_rows.launches
    got = tcf.banded_scores(case["tdg"], case["tq"], case["tl"], COSTS, prep)
    ref = tcf.banded_scores_plain(case["tdg"], case["tq"], case["tl"],
                                  COSTS, prep)
    assert got.dtype == torch.int32 and torch.equal(got, ref)
    assert tcf.banded_end_rows.launches == launches


@pytest.mark.parametrize("seed", [1, 2, 3, 4])
def test_window_planning_matches(case, seed):
    rng = random.Random(seed)
    flat, jdg, tdg = case["flat"], case["jdg"], case["tdg"]
    for _ in range(6):
        n_min = rng.randrange(300, 460)
        n_max = n_min + rng.randrange(0, 120)
        ub = rng.choice([8, 30, 100, 400, 2000])
        ref = jbd.band_windows(flat, n_min, n_max, COSTS, ub)
        got = tbd.band_windows(flat, n_min, n_max, COSTS, ub)
        for a, b in zip(ref, got):
            assert (np.asarray(a) == np.asarray(b)).all()
        width = ref[1] + 128
        assert tbd.ins_run_cap(COSTS, ub, width) == \
            jbd.ins_run_cap(COSTS, ub, width)
        ws = (ref[0] // 128) * 128
        L = ((n_max + 1 + 127) // 128) * 128
        jp = jpf.prepare_banded(jdg, COSTS, ws, width, L)
        tp = tcf.prepare_banded(tdg, COSTS, ws, width, L)
        assert (jp["margin"], jp["width"], jp["L"]) == \
            (tp["margin"], tp["width"], tp["L"])
        assert (np.asarray(jp["wstarts"]) == tp["wstarts"].numpy()).all()
        assert (np.asarray(jp["pred_wstarts"])
                == tp["pred_wstarts"].numpy()).all()
        assert int(jp["w_end"]) == tp["w_end"]


@pytest.mark.parametrize("cap", [1, 2, 5, 64, 100, 384])
def test_prefix_min_matches(cap):
    """The plain versions' scan against the reference's truncated rounds
    (``_prefix_min_trunc``); a cap as wide as the row is the full
    prefix-min."""
    rng = np.random.default_rng(cap)
    t = rng.integers(-300, 900, size=(4, 384)).astype(np.int32)
    t[:, ::11] = jrows.INF
    got = tcf._prefix_min(torch.as_tensor(t), cap).numpy()
    ref = np.asarray(jbd._prefix_min_trunc(jnp.asarray(t), cap, 4))
    assert (got == ref).all()


def test_pad_to_pow2_blocks_matches():
    for rows in (0, 1, 63, 64, 65, 200, 1000, 1025):
        assert tbd._pad_to_pow2_blocks(rows) == jbd._pad_to_pow2_blocks(rows)
