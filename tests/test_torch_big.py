"""The port's fills against the JAX package's streamed big-graph kernels:
B9 ``_fill_kernel_bounded_big`` and B11 ``_banded_kernel_big``.

Past its 1 MiB scalar-prefetch budget the reference streams the per-rank
tables from HBM in 1,024-rank chunks (B9, B11) and slides a (B_BLK, QSEG)
query segment over the read (B11).  A card reads the rank tables from
global memory at any graph size, so the port has no streamed twin: B9's
work is B4's (``ops/cuda_fill.py:bounded_best_rows``) and B11's is B1's
(``banded_end_rows``).  These tests hold the port's plain versions, and
its public entry points on the CPU, equal to the streamed kernels in
Pallas interpret mode on graphs whose rank loop crosses chunk boundaries
and windows whose query segment slides.  Tolerance 0: the values are
integer DP scores.
"""

import random
from contextlib import contextmanager
from unittest import mock

import jax
import numpy as np
import pytest
import torch

from poasta_tpu.aligner import GapAffine
from poasta_tpu.aligner import banded as jbd
from poasta_tpu.aligner import costs as jcosts
from poasta_tpu.aligner import wavefront as jwf
from poasta_tpu.graphs import POAGraph
from poasta_tpu.ops import pallas_fill as jpf
from poasta_tpu_torch import convert
from poasta_tpu_torch.aligner import banded as tbd
from poasta_tpu_torch.aligner import costs as tcosts
from poasta_tpu_torch.aligner import wavefront as twf
from poasta_tpu_torch.ops import cuda_fill as tcf

torch.set_num_threads(1)

COSTS = GapAffine(4, 2, 6)
SPANS = {
    # the CLI's -m semi-global
    "semi-global": ("UNBOUNDED", ("included", 0), "UNBOUNDED", "UNBOUNDED"),
    # bench.py:273's bounded span
    "bounded": ("UNBOUNDED", ("included", 50), ("included", 0),
                ("included", 50)),
}


def _span(mod, name):
    return mod.EndsFree(*(mod.UNBOUNDED if b == "UNBOUNDED"
                          else getattr(mod, b[0])(b[1])
                          for b in SPANS[name]))


@contextmanager
def accel_sim():
    """Interpret mode plus a non-"cpu" backend name, as the JAX package's
    own interpret tests run its kernels."""
    jpf.set_interpret_mode(True)
    try:
        with mock.patch.object(jax, "default_backend",
                               lambda: "interpret-sim"):
            yield
    finally:
        jpf.set_interpret_mode(False)


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


def _backbone(rng, n, skip_every=97):
    """A linear graph of ``n`` bases with an edge v -> v+3 every
    ``skip_every`` nodes (P = 2, the bench's pangenome shape)."""
    base = "".join(rng.choice("ACGT") for _ in range(n))
    g = POAGraph()
    g.add_alignment_with_weights("s0", base.encode(), None, [1] * n)
    for v in range(0, n - 3, skip_every):
        g.add_edge(v, v + 3, 0, 1)
    g.post_process()
    return g, base


def _both(g, reads):
    flat = g.flatten()
    jq, jl = jwf.pack_queries(reads)
    tq, tl = twf.pack_queries(reads, device="cpu")
    return {"flat": flat, "jdg": jwf.DeviceGraph.build(flat),
            "tdg": twf.DeviceGraph.build(flat, device="cpu"),
            "jq": jq, "jl": jl, "tq": tq, "tl": tl}


@pytest.fixture(scope="module")
def fill_case():
    """2,202 ranks (the streamed rank loop crosses the chunk boundaries at
    1,024 and 2,048) and 64 fragments of 120-200 bases at 3%: L = 256."""
    rng = random.Random(3)
    g, base = _backbone(rng, 2200)
    reads = []
    for _ in range(64):
        a = rng.randrange(0, 2000)
        reads.append(_mutate(rng, base[a:a + rng.randrange(120, 200)],
                             0.03).encode())
    case = _both(g, reads)
    assert case["flat"].n_nodes > 2 * jpf.BIG_CHUNK
    assert int(case["jdg"].pred_slots.shape[1]) == 2
    return case


@pytest.fixture(scope="module")
def banded_case():
    """2,002 ranks (two chunks) and 64 reads of the whole ~2,000-base
    backbone at 1%: L = 2,048."""
    rng = random.Random(31)
    g, base = _backbone(rng, 2000)
    reads = [_mutate(rng, base, 0.01).encode() for _ in range(64)]
    return _both(g, reads)


@pytest.mark.parametrize("max_run", [0, 64], ids=["uncapped", "cap64"])
@pytest.mark.parametrize("name", list(SPANS))
def test_b9_bounded_scores_match_streamed_kernel(fill_case, name, max_run):
    c = fill_case
    fs, end_ok, jlo = jwf.ends_free_device_params(
        c["flat"], _span(jcosts, name), c["jl"], c["jdg"].n_nodes_padded)
    with accel_sim():
        want = np.asarray(jpf.pallas_fill_scores_bounded_big(
            c["jdg"], c["jq"], c["jl"], COSTS, fs, end_ok, jlo,
            max_run=max_run))
    tp = convert.ends_free_params_from_reference(
        fs, np.asarray(end_ok), np.asarray(jlo), device="cpu")
    plain = tcf.bounded_scores_plain(c["tdg"], c["tq"], c["tl"], COSTS,
                                     *tp, max_run=max_run).numpy()
    public = twf.dp_fill_scores_ends_free(
        c["tdg"], c["flat"], c["tq"], c["tl"], COSTS,
        _span(tcosts, name), max_run=max_run).numpy()
    np.testing.assert_array_equal(plain, want)
    np.testing.assert_array_equal(public, want)
    assert (want < tcf.INF).any()


@pytest.mark.parametrize("free_start,free_end",
                         [(False, False), (True, False), (False, True),
                          (True, True)])
def test_b9_global_route_matches_streamed_kernel(fill_case, free_start,
                                                 free_end):
    """``dp_fill_scores`` against the reference's route past the gate
    (``aligner/wavefront.py:1106-1122``): the streamed bounded kernel under
    ``_big_end_mask`` with jlo = n."""
    c = fill_case
    with accel_sim():
        want = np.asarray(jpf.pallas_fill_scores_bounded_big(
            c["jdg"], c["jq"], c["jl"], COSTS, free_start,
            jwf._big_end_mask(c["jdg"], free_end), c["jl"]))
    got = twf.dp_fill_scores(c["tdg"], c["tq"], c["tl"], COSTS, free_start,
                             free_end).numpy()
    np.testing.assert_array_equal(got, want)


# a tier that verifies most of banded_case's reads (they cost 300-490)
UB = 450


def _banded_windows(case, ub):
    ln = np.asarray(case["jl"])
    ws, wd, _, _ = jbd.band_windows(case["flat"], int(ln.min()),
                                    int(ln.max()), COSTS, ub)
    return (ws // 128) * 128, wd + 128


@pytest.mark.parametrize("capped", [False, True])
def test_b11_banded_scores_match_streamed_kernel(banded_case, capped):
    """Windows on which the streamed kernel's query segment really slides:
    QSEG < L, and a later chunk starts past lane 0."""
    c = banded_case
    L = int(c["jq"].shape[1])
    ws, wd = _banded_windows(c, UB)
    prep_b = jpf.prepare_banded_big(c["jdg"], COSTS, ws, wd, L)
    assert prep_b["qseg"] < L
    assert (np.asarray(prep_b["qbase"]) > 0).any()
    prep = tcf.prepare_banded(c["tdg"], COSTS, ws, wd, L)
    max_run = tbd.ins_run_cap(COSTS, UB, prep["width"]) if capped else 0
    assert prep["margin"] == prep_b["margin"]
    assert (max_run > 0) == capped
    with accel_sim():
        want = np.asarray(jpf.pallas_banded_scores_big(
            c["jdg"], c["jq"], c["jl"], COSTS, prep_b, max_run=max_run))
    got = tcf.banded_scores_plain(c["tdg"], c["tq"], c["tl"], COSTS, prep,
                                  max_run).numpy()
    np.testing.assert_array_equal(got, want)
    assert (want <= UB).sum() > 32


def test_b11_width_past_the_row_clamps(banded_case):
    """A requested width past L: both packages clamp the windows to the
    row (``_clamp_windows_to_row``) and every read's score is exact."""
    c = banded_case
    L = int(c["jq"].shape[1])
    ws, wd = _banded_windows(c, 2000)
    assert wd > L
    prep_b = jpf.prepare_banded_big(c["jdg"], COSTS, ws, wd, L)
    prep = tcf.prepare_banded(c["tdg"], COSTS, ws, wd, L)
    assert prep["width"] == prep_b["width"] <= L
    with accel_sim():
        want = np.asarray(jpf.pallas_banded_scores_big(
            c["jdg"], c["jq"], c["jl"], COSTS, prep_b))
    got = tcf.banded_scores_plain(c["tdg"], c["tq"], c["tl"], COSTS,
                                  prep).numpy()
    np.testing.assert_array_equal(got, want)
    exact = twf.dp_fill_scores(c["tdg"], c["tq"], c["tl"], COSTS).numpy()
    np.testing.assert_array_equal(got, exact)
