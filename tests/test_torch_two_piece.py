"""The port's two-piece global scoring (B12 ``_fill_kernel_2p``, B16
``_banded_kernel_2p``, B17 ``_banded_kernel_drift_2p``) on the CPU against
the JAX package.

Same numpy-seeded inputs through both packages.  The JAX side runs its
Pallas kernels in interpret mode and its XLA bodies on the CPU; the port
runs its kernels' plain versions (CPU tensors, ``device="cpu"``).  Every
comparison is exact (tolerance 0: the values are integer DP scores), for
verified and for over-estimated rows alike.

The port's fills fold the TPU kernels' coupled (I1, I2) min-plus scan into
one prefix-min of A tilted by e2 (``ops/cuda_fill.py:fill_constants``);
the tests below hold that fold to the coupled scan, truncated and not,
row by row and through the kernels.
"""

import functools
import random
import types
from contextlib import contextmanager
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from poasta_tpu.aligner import GapAffine
from poasta_tpu.aligner import banded as jbd
from poasta_tpu.aligner import costs as jcosts
from poasta_tpu.aligner import wavefront as jwf
from poasta_tpu.graphs import POAGraph
from poasta_tpu.native import NativeAligner
from poasta_tpu.ops import dp_rows_2p as jrows2
from poasta_tpu.ops import pallas_fill as jpf
from poasta_tpu.parallel import BatchMapper as JaxMapper
from poasta_tpu_torch import BandedScorer, BatchMapper, convert
from poasta_tpu_torch.aligner import banded as tbd
from poasta_tpu_torch.aligner import costs as tcosts
from poasta_tpu_torch.aligner import wavefront as twf
from poasta_tpu_torch.ops import cuda_fill as tcf
from poasta_tpu_torch.ops import dp_rows_2p as trows2

torch.set_num_threads(1)

INF = tcf.INF
# the penalties of poasta align -n 4 -g 8,24 -e 2,1, in each package's class
J2P = jcosts.GapAffine2Piece(4, 2, 8, 1, 24)
T2P = tcosts.GapAffine2Piece(4, 2, 8, 1, 24)
COSTS_1P = GapAffine(4, 2, 6)
LADDER_STATS = ("fills", "tiers", "fullfill_fallbacks")


@contextmanager
def interpret_mode():
    jpf.set_interpret_mode(True)
    try:
        yield
    finally:
        jpf.set_interpret_mode(False)


@contextmanager
def accel_sim():
    """Interpret mode plus a non-"cpu" backend name: the JAX scorer takes
    its accelerator route (the Pallas kernels, capped by ``ins_run_cap``),
    which the port always takes."""
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


def _packed(g, reads):
    flat = g.flatten()
    jq, jl = jwf.pack_queries(reads)
    tq, tl = twf.pack_queries(reads, device="cpu")
    na = NativeAligner(g)
    return {
        "graph": g, "flat": flat, "reads": reads,
        "jdg": jwf.DeviceGraph.build(flat),
        "tdg": twf.DeviceGraph.build(flat, device="cpu"),
        "jq": jq, "jl": jl, "tq": tq, "tl": tl,
        "exact": np.array([na.align_banded(q, T2P)[0] for q in reads]),
    }


@pytest.fixture(scope="module")
def case():
    """A graph of a 900-base sequence fused with three copies at 4%
    (1,103 nodes) and 64 reads at 1-2%, one of them at 20% (an
    over-estimated row at every tier the tests use); L 1024."""
    rng = random.Random(41)
    base = "".join(rng.choice("ACGT") for _ in range(900))
    g = POAGraph()
    g.add_alignment_with_weights("s0", base.encode(), None, [1] * len(base))
    for i in range(1, 4):
        s = _mutate(rng, base, 0.04).encode()
        _, aln, _ = NativeAligner(g).align(s, COSTS_1P)
        g.add_alignment_with_weights(f"s{i}", s, aln, [1] * len(s))
    reads = [_mutate(rng, base, 0.01 + 0.01 * (i % 2)).encode()
             for i in range(64)]
    reads[9] = _mutate(rng, base, 0.2).encode()
    return _packed(g, reads)


@pytest.fixture(scope="module")
def sv_case():
    """A 1000-base graph with an 840-base deletion allele and 64 reads at
    1.5%, half from each allele: lengths spread by ~850 bases, L 1024."""
    rng = random.Random(43)
    base = "".join(rng.choice("ACGT") for _ in range(1000))
    variant = base[:80] + base[920:]
    g = POAGraph()
    g.add_alignment_with_weights("s0", base.encode(), None, [1] * len(base))
    _, aln, _ = NativeAligner(g).align(variant.encode(), COSTS_1P)
    g.add_alignment_with_weights("s1", variant.encode(), aln,
                                 [1] * len(variant))
    reads = [_mutate(rng, base if i % 2 else variant, 0.015).encode()
             for i in range(64)]
    reads[5] = _mutate(rng, base, 0.2).encode()
    out = _packed(g, reads)
    lens = np.array([len(r) for r in reads])
    out.update(n_min=int(lens.min()), n_max=int(lens.max()))
    return out


def _at(raw, idx):
    """What the Pallas wrappers read off their kernels' end rows: lane
    ``idx`` of each read's row, INF where it lies outside the row."""
    inside = (idx >= 0) & (idx < raw.shape[1])
    at = np.take_along_axis(raw, np.clip(idx, 0, raw.shape[1] - 1)[:, None],
                            axis=1)[:, 0]
    return np.where(inside, at, INF)


def _raw_pallas(kernel, static, prefetch, inputs, out_lanes, scratch):
    """A Pallas kernel's raw (B, out_lanes) output in interpret mode, one
    block over the whole batch, built as its ``_*_exec`` builds the call
    but without the score extraction behind it."""
    B = int(inputs[0].shape[0])

    def vmem(lanes):
        return pl.BlockSpec((B, lanes), lambda i, *_: (i, 0),
                            memory_space=pltpu.VMEM)

    call = pl.pallas_call(
        functools.partial(kernel, B_BLK=B, dtype=jnp.int32, **static),
        out_shape=jax.ShapeDtypeStruct((B, out_lanes), jnp.int32),
        grid_spec=pltpu.PrefetchScalarGridSpec(
            num_scalar_prefetch=len(prefetch), grid=(1,),
            in_specs=[vmem(int(t.shape[1])) for t in inputs],
            out_specs=vmem(out_lanes),
            scratch_shapes=[pltpu.VMEM(s, jnp.int32) for s in scratch]),
        interpret=True)
    return np.asarray(call(*prefetch, *inputs))


# ---- (a) the row recurrence and the fold of the coupled scan ----------------

ROW = st.lists(st.one_of(st.integers(0, 3000), st.just(INF)), min_size=64,
               max_size=64)


@st.composite
def two_piece_costs(draw):
    e2 = draw(st.integers(1, 4))
    e1 = draw(st.integers(e2, 8))
    return draw(st.integers(0, 12)), e1, e2


@settings(max_examples=25, deadline=None, derandomize=True)
@given(rows=st.lists(ROW, min_size=3, max_size=3), costs=two_piece_costs())
def test_insertion_rows_2p_match_jax_and_the_fold(rows, costs):
    """The twin's coupled scan equals the JAX associative scan; truncated
    to any power-of-two window, min(A, I1, I2) equals the fills' fold: one
    prefix-min of A - e2*j over the same window, reopened at o1 + e1."""
    o1, e1, e2 = costs
    A = np.array(rows, dtype=np.int32)
    ref = jrows2.insertion_rows_2p(jnp.asarray(A), o1, e1, 0, e2)
    got = trows2.insertion_rows_2p(torch.as_tensor(A), o1, e1, 0, e2)
    for r, t in zip(ref, got):
        assert t.dtype == torch.int32 and (np.asarray(r) == t.numpy()).all()
    At = torch.as_tensor(A)
    j = e2 * torch.arange(A.shape[1], dtype=torch.int32)
    for cap in (1, 2, 8, 32, 64):
        i1, i2 = trows2.insertion_rows_2p(At, o1, e1, 0, e2, max_shift=cap)
        coupled = torch.minimum(At, torch.minimum(i1, i2))
        pref = tcf._prefix_min(At - j, cap)
        fold = torch.minimum(At, torch.clamp(
            tcf._shift_right(pref) + (o1 + e1 - e2) + j, max=INF))
        assert torch.equal(coupled, fold), cap


@pytest.mark.parametrize("start,free", [(False, False), (True, False),
                                        (False, True)])
def test_row_update_2p_matches_jax(start, free):
    rng = np.random.default_rng(11)
    B, P, L = 5, 4, 128
    preds = []
    for _ in range(3):
        t = rng.integers(0, 500, size=(B, P, L)).astype(np.int32)
        t[rng.random((B, P, L)) < 0.2] = INF
        preds.append(t)
    mask = np.array([True, False, True, True])
    match = rng.choice([0, 4], size=(B, L)).astype(np.int32)
    ref = jrows2.row_update_2p(*(jnp.asarray(t) for t in preds),
                               jnp.asarray(mask), jnp.asarray(match), 8, 2,
                               1, is_start_row=jnp.asarray(start),
                               free_start=jnp.asarray(free))
    got = trows2.row_update_2p(*(torch.as_tensor(t) for t in preds),
                               torch.as_tensor(mask), torch.as_tensor(match),
                               8, 2, 1, is_start_row=start, free_start=free)
    for r, t in zip(ref, got):
        assert t.dtype == torch.int32 and (np.asarray(r) == t.numpy()).all()


def test_fill_constants():
    assert tcf.fill_constants(COSTS_1P) == (6, 2, 2, 4)
    assert tcf.fill_constants(T2P) == (8 + 2 - 1, 1, 2, 4)
    bad = types.SimpleNamespace(is_two_piece=True, gap_open=8, gap_extend=1,
                                gap_extend2=2, mismatch=4)
    with pytest.raises(ValueError, match="gap_extend >= gap_extend2"):
        tcf.fill_constants(bad)


# ---- (b) window planning ------------------------------------------------

@pytest.mark.parametrize("seed", [1, 2])
def test_band_windows_and_run_cap_match(case, sv_case, seed):
    """``band_windows``, ``band_windows_drift`` and ``ins_run_cap`` for
    two-piece costs (gaps counted at e2, runs at min(e1, e2))."""
    rng = random.Random(seed)
    flat = case["flat"]
    for _ in range(6):
        n_min = rng.randrange(700, 900)
        n_max = n_min + rng.randrange(0, 120)
        ub = rng.choice([8, 30, 100, 400, 2000])
        ref = jbd.band_windows(flat, n_min, n_max, J2P, ub)
        got = tbd.band_windows(flat, n_min, n_max, T2P, ub)
        for a, b in zip(ref, got):
            assert (np.asarray(a) == np.asarray(b)).all()
        assert got[1] >= tbd.band_windows(flat, n_min, n_max, COSTS_1P,
                                          ub)[1]
        for width in (128, ref[1] + 128, 4096):
            assert tbd.ins_run_cap(T2P, ub, width) == \
                jbd.ins_run_cap(J2P, ub, width)
    flat = sv_case["flat"]
    for _ in range(4):
        n_min = rng.randrange(80, 300)
        n_max = n_min + rng.randrange(512, 900)
        ub = rng.choice([40, 120, 400, 1500])
        S = jbd.drift_steps_for(n_min, n_max)
        ref = jbd.band_windows_drift(flat, n_min, n_max, J2P, ub, S)
        got = tbd.band_windows_drift(flat, n_min, n_max, T2P, ub, S)
        assert got[1] == ref[1]
        for a, b in ((got[0], ref[0]), (got[2], ref[2])):
            assert a.dtype == b.dtype and (a == b).all()


# ---- (c) the plain fills against the Pallas kernels and the XLA bodies ------

@pytest.mark.parametrize("ub", [160, 250])
def test_banded_2p_plain_matches(case, ub):
    """B16: the untilted end rows equal the Pallas kernel's in interpret
    mode, and so do the scores read off them, capped and uncapped (the
    wrapper itself on the capped call); verified rows are exact, the rest
    over-estimate."""
    lens = [len(r) for r in case["reads"]]
    ws, width, _, _ = jbd.band_windows(case["flat"], min(lens), max(lens),
                                       J2P, ub)
    ws, width = (ws // 128) * 128, width + 128
    L = int(case["tq"].shape[1])
    jprep = jpf.prepare_banded(case["jdg"], J2P, ws, width, L)
    tprep = tcf.prepare_banded(case["tdg"], T2P, ws, width, L)
    Wb, margin = tprep["width"], tprep["margin"]
    assert Wb < L
    cap = tbd.ins_run_cap(T2P, ub, Wb)
    assert 0 < cap < Wb
    jdg = case["jdg"]
    W, P = jdg.window, int(jdg.pred_slots.shape[1])
    for max_run in (0, cap):
        rows = tcf.banded_end_rows_2p_plain(case["tdg"], case["tq"], T2P,
                                            tprep, max_run)
        raw = _raw_pallas(
            jpf._banded_kernel_2p,
            dict(W=W, P=P, Wb=Wb, MARGIN=margin, o1=8, e1=2, e2=1, x=4,
                 max_run=max_run),
            [jdg.symbols, jdg.pred_slots_flat, jdg.pred_valid_flat,
             jprep["pred_wstarts"], jprep["wstarts"], jdg.write_slots,
             jdg.meta], [case["jq"]], Wb, [(W, 64, 2 * margin + Wb)] * 3)
        assert (rows.numpy() == raw).all()
        got = tcf.banded_scores_2p_plain(case["tdg"], case["tq"], case["tl"],
                                         T2P, tprep, max_run).numpy()
        ref = _at(raw, np.asarray(case["jl"]) - tprep["w_end"])
        if max_run and ub == 160:
            with interpret_mode():
                ref = np.asarray(jpf.pallas_banded_scores_2p(
                    jdg, case["jq"], case["jl"], J2P, jprep,
                    max_run=max_run))
        assert got.dtype == np.int32 and (got == ref).all(), max_run
        ok = got <= ub
        assert ok.any() and not ok.all()
        assert (got[ok] == case["exact"][ok]).all()
        assert (got >= case["exact"]).all()


def _drift_layout(sv_case, ub):
    flat, n_min, n_max = sv_case["flat"], sv_case["n_min"], sv_case["n_max"]
    S = jbd.drift_steps_for(n_min, n_max)
    ws, width, sr = jbd.band_windows_drift(flat, n_min, n_max, J2P, ub, S)
    L = int(sv_case["tq"].shape[1])
    Lp = max(L, -(-(int(ws.max()) + width) // 128) * 128)
    jprep = jpf.prepare_banded_drift(sv_case["jdg"], J2P, ws, width, sr, S,
                                     Lp)
    tprep = convert.drift_prep_from_reference(
        {k: (np.asarray(v) if hasattr(v, "shape") else v)
         for k, v in jprep.items()}, device="cpu")
    tqp = torch.nn.functional.pad(sv_case["tq"], (tprep["mq"], Lp - L))
    return jprep, tprep, jnp.asarray(tqp.numpy()), tqp, S


def test_drift_2p_plain_matches(sv_case):
    """B17: every ring rolls with the read's frame; the untilted end rows
    equal the Pallas kernel's in interpret mode, the lanes that stale ring
    margins reach included (ROADMAP C7); scores equal the ones read off
    them, its wrapper's (capped) and the XLA body's (uncapped)."""
    ub = 80
    jprep, tprep, jqp, tqp, S = _drift_layout(sv_case, ub)
    Wb, margin, mq = tprep["width"], tprep["margin"], tprep["mq"]
    n_min, jdg = sv_case["n_min"], sv_case["jdg"]
    assert Wb < int(sv_case["tq"].shape[1]) and mq > 0
    ws, width, sr = tbd.band_windows_drift(sv_case["flat"], n_min,
                                           sv_case["n_max"], T2P, ub, S)
    own = tcf.prepare_banded_drift(sv_case["tdg"], T2P, ws, width, sr, S,
                                   jprep["L"])
    assert (own["width"], own["mq"], own["margin"]) == (Wb, mq, margin)
    cap = tbd.ins_run_cap(T2P, ub, Wb)
    assert 0 < cap < Wb
    W, P = jdg.window, int(jdg.pred_slots.shape[1])
    nbs = tcf.drift_units(sv_case["tl"], n_min)
    xla = np.asarray(jbd._banded_exec_drift_2p(
        W, Wb, P, 8, 2, 1, 4, S)(
        jdg.symbols, jnp.asarray(jdg.pred_ranks_np), jdg.pred_valid,
        jprep["wstarts"], jdg.write_slots, jdg.end_rank, jprep["s_ranks"],
        jprep["s_prev"], jqp, sv_case["jl"], jnp.asarray(n_min, jnp.int32),
        jnp.asarray(mq, jnp.int32)))
    tile = jnp.broadcast_to(jnp.asarray(nbs.numpy())[:, None], (64, 128))
    for max_run in (0, cap):
        rows = tcf.drift_end_rows_2p_plain(sv_case["tdg"], tqp, nbs, T2P,
                                           tprep, max_run)
        raw = _raw_pallas(
            jpf._banded_kernel_drift_2p,
            dict(W=W, P=P, Wb=Wb, MARGIN=margin, MQ=mq, S=S, o1=8, e1=2,
                 e2=1, x=4, max_run=max_run),
            [jdg.symbols, jdg.pred_slots_flat, jdg.pred_valid_flat,
             jprep["pred_wstarts"], jprep["wstarts"], jdg.write_slots,
             jprep["s_ranks"], jprep["s_prev"], jdg.meta],
            [jqp, tile], Wb,
            [(W, 64, 2 * margin + Wb)] * 3 + [tuple(jqp.shape)])
        assert (rows.numpy() == raw).all(), max_run
        got = tcf.drift_scores_2p_plain(sv_case["tdg"], tqp, sv_case["tl"],
                                        T2P, tprep, n_min,
                                        max_run=max_run).numpy()
        ref = _at(raw, np.asarray(sv_case["jl"]) - tprep["w_end"]
                  - 128 * nbs.numpy())
        if max_run:
            with interpret_mode():
                ref = np.asarray(jpf.pallas_banded_scores_drift_2p(
                    jdg, jqp, sv_case["jl"], J2P, jprep, n_min,
                    max_run=max_run))
        assert got.dtype == np.int32 and (got == ref).all(), max_run
        ok = got <= ub
        assert ok.any() and not ok.all()
        assert (got[ok] == sv_case["exact"][ok]).all()
        if max_run == 0:
            assert (got == xla).all()


def test_fill_2p_plain_matches(case):
    """B12: the untilted end rows equal the Pallas kernel's in interpret
    mode; scores equal the ones read off them, the native engine's and, on
    16 reads, the XLA body's and the port's own scan over
    ``row_update_2p``."""
    jdg = case["jdg"]
    W, P = jdg.window, int(jdg.pred_slots.shape[1])
    L = int(case["tq"].shape[1])
    rows = tcf.fill_end_rows_2p_plain(case["tdg"], case["tq"], T2P).numpy()
    raw = _raw_pallas(jpf._fill_kernel_2p,
                      dict(W=W, P=P, L=L, o1=8, e1=2, e2=1, x=4),
                      [jdg.symbols, jdg.pred_slots_flat, jdg.pred_valid_flat,
                       jdg.write_slots, jdg.meta], [case["jq"]], L,
                      [(W, 64, L)] * 3)
    assert (rows == raw).all()
    got = tcf.fill_scores_2p_plain(case["tdg"], case["tq"], case["tl"],
                                   T2P).numpy()
    assert (got == _at(raw, np.asarray(case["jl"]))).all()
    assert (got == case["exact"]).all()
    sub = slice(0, 16)
    xla = np.asarray(jwf.dp_fill_scores(jdg, case["jq"][sub],
                                        case["jl"][sub], J2P, engine="xla"))
    scan = twf.scan_scores(case["tdg"], case["tq"][sub], case["tl"][sub],
                           T2P).numpy()
    assert (xla == got[sub]).all() and (scan == got[sub]).all()
    launches = tcf.fill_end_rows_2p.launches
    via = twf.dp_fill_scores(case["tdg"], case["tq"], case["tl"], T2P)
    assert (via.numpy() == got).all()
    assert tcf.fill_end_rows_2p.launches == launches  # CPU: plain version


def test_wrappers_refuse_the_other_cost_model(case):
    """A wrapper takes the cost model of its kernel; CPU tensors take the
    plain versions and count no launch."""
    lens = [len(r) for r in case["reads"]]
    ws, width, _, _ = tbd.band_windows(case["flat"], min(lens), max(lens),
                                       T2P, 150)
    L = int(case["tq"].shape[1])
    prep = tcf.prepare_banded(case["tdg"], T2P, (ws // 128) * 128,
                              width + 128, L)
    with pytest.raises(ValueError, match="takes one-piece costs"):
        tcf.banded_end_rows(case["tdg"], case["tq"], T2P, prep)
    with pytest.raises(ValueError, match="takes two-piece costs"):
        tcf.banded_end_rows_2p(case["tdg"], case["tq"], COSTS_1P, prep)
    with pytest.raises(ValueError, match="takes two-piece costs"):
        tcf.fill_end_rows_2p(case["tdg"], case["tq"], COSTS_1P)
    before = tcf.banded_end_rows_2p.launches
    got = tcf.banded_end_rows_2p(case["tdg"], case["tq"], T2P, prep)
    assert torch.equal(got, tcf.banded_end_rows_2p_plain(
        case["tdg"], case["tq"], T2P, prep))
    assert tcf.banded_end_rows_2p.launches == before
    with pytest.raises(ValueError, match="no two-piece banded fill"):
        tcf.banded_end_rows_2p(case["tdg"], case["tq"].to("meta"), T2P, prep)


# ---- (d) the slice as a whole --------------------------------------------

def _run_both(c, calls):
    """The JAX scorer (accelerator route) and the port's through the same
    ``scores`` calls: ladders must agree call by call."""
    port = BandedScorer(c["flat"], T2P, dg=c["tdg"])
    out = []
    with accel_sim():
        ref = jbd.BandedScorer(c["flat"], J2P, dg=c["jdg"])
        for kw in calls:
            j = np.asarray(ref.scores(c["jq"], c["jl"], **kw))
            p = port.scores(c["tq"], c["tl"], **kw)
            assert port.last_attempts == ref.last_attempts, kw
            assert port._ub_hint == ref._ub_hint, kw
            for k in LADDER_STATS:
                assert port.stats[k] == ref.stats[k], (kw, k)
            out.append((j, p))
        fell = [k for k in ref._prep_cache if str(k[0]).startswith("no")]
        assert not fell, "the reference's Pallas route fell back"
    return out, port


def test_scorer_2p_matches_jax_and_native(case):
    """Shared windows: a tier at ub 120 leaves a tail, the retry resolves
    it; a single attempt sends the tail to the full fill (B12); the hint
    learnt on the way equals the reference's."""
    runs, port = _run_both(case, [{"ub": 120}, {}, {"ub": 60,
                                                    "max_retries": 1}])
    for j, p in runs:
        assert p.dtype == np.int32
        assert (p == j).all() and (p == case["exact"]).all()
    assert port.stats["fullfill_fallbacks"] >= 1


def test_scorer_2p_drift_matches_jax_and_native(sv_case, monkeypatch):
    """Mixed-length traffic: the ladder drifts (B17) and learns the
    reference's hint; drift off gives the same scores."""
    calls = {"n": 0}
    real = tcf.drift_end_rows_2p_plain
    monkeypatch.setattr(tcf, "drift_end_rows_2p_plain",
                        lambda *a, **k: calls.__setitem__("n", calls["n"] + 1)
                        or real(*a, **k))
    runs, port = _run_both(sv_case, [{"ub": 100}, {}])
    for j, p in runs:
        assert (p == j).all() and (p == sv_case["exact"]).all()
    assert calls["n"] >= 1
    assert any(k[0] == "drift" and v[0] is not None
               for k, v in port._prep_cache.items())
    monkeypatch.setattr(BandedScorer, "DRIFT_MIN_SPREAD", 1 << 30)
    shared = BandedScorer(sv_case["flat"], T2P, dg=sv_case["tdg"])
    assert (shared.scores(sv_case["tq"], sv_case["tl"])
            == sv_case["exact"]).all()


def test_mapper_2p_matches_jax(case):
    """``BatchMapper`` under two-piece costs: scores and alignments equal
    poasta_tpu's; every read takes the native backtrace seeded with its
    device score, and its pairs cost that score (plus the leading insertion
    run a backtrace does not emit)."""
    reads = case["reads"][:16]
    port = BatchMapper(case["graph"], T2P, device="cpu")
    ref = JaxMapper(case["graph"], J2P)
    got = port.score_batch(reads)
    assert (got == np.asarray(ref.score_batch(reads))).all()
    assert (got == case["exact"][:16]).all()
    assert port.takes_banded_path(reads)
    out = port.align_batch(reads)
    want = ref.align_batch(reads)
    assert [(s, list(a)) for s, a in out] == [(s, list(a)) for s, a in want]
    assert port.last_banded_stats == {"device_traced": 0,
                                      "host_backtraced": 16}
    token = port.prescore(reads)
    assert token is not None and (token[1] == got).all()
    assert [(s, list(a)) for s, a in port.align_batch(reads, prescored=token)
            ] == [(s, list(a)) for s, a in out]
    for r, (s, aln) in zip(reads, out):
        lead = next(p.qpos for p in aln if p.qpos is not None)
        extra = 0 if lead == 0 else 8 + 2 + (lead - 1) * 1
        cost = twf.alignment_cost(case["graph"], r, aln, T2P)
        assert cost == jwf.alignment_cost(case["graph"], r, list(aln), J2P)
        assert cost + extra == s


def test_two_piece_ends_free_is_not_ported_yet(case):
    """Every entry point that takes an ends-free span scores and aligns
    under two-piece costs and equals poasta_tpu (8 reads, the JAX side on
    its CPU route); the dense tables still refuse two-piece costs, as the
    reference's do."""
    reads = case["reads"][:8]
    span = tcosts.EndsFree(tcosts.UNBOUNDED, tcosts.included(0),
                           tcosts.UNBOUNDED, tcosts.UNBOUNDED)
    jspan = jcosts.EndsFree(jcosts.UNBOUNDED, jcosts.included(0),
                            jcosts.UNBOUNDED, jcosts.UNBOUNDED)
    jq, jl = jwf.pack_queries(reads)
    tq, tl = twf.pack_queries(reads, device="cpu")
    want = np.asarray(jwf.dp_fill_scores_ends_free(
        case["jdg"], case["flat"], jq, jl, J2P, jspan))
    args = (case["tdg"], case["flat"], tq, tl, T2P, span)
    np.testing.assert_array_equal(twf.dp_fill_scores_ends_free(*args).numpy(),
                                  want)
    np.testing.assert_array_equal(
        twf.dp_fill_ends_free_with_ends(*args)[0].numpy(), want)
    np.testing.assert_array_equal(
        BandedScorer(case["flat"], T2P, dg=case["tdg"],
                     aln_type=span).scores(tq, tl), want)
    port = BatchMapper(case["graph"], T2P, device="cpu", aln_type=span)
    np.testing.assert_array_equal(port.score_batch(reads), want)
    got = port.align_batch(reads)
    ref = JaxMapper(case["graph"], J2P, aln_type=jspan).align_batch(reads)
    assert [(s, list(a)) for s, a in got] == [(s, list(a)) for s, a in ref]
    assert [s for s, _ in got] == list(map(int, want))
    with pytest.raises(NotImplementedError, match="two-piece"):
        twf.dp_fill_full(case["tdg"], case["tq"], case["tl"], T2P)


def test_stale_drift_margins_fall_below_the_optimum_left_of_the_end(sv_case):
    """ROADMAP C7: a drift ring's margin keeps lanes of its previous
    occupant, a cost of another rank at the same offset, so the one-piece
    drift rows (tilted, bit-equal to the Pallas kernel's) fall below the
    exact full fill's at some lanes; on these inputs all of them lie left
    of the reads' end lanes, and every score is exact."""
    flat, n_min, n_max = sv_case["flat"], sv_case["n_min"], sv_case["n_max"]
    S = tbd.drift_steps_for(n_min, n_max)
    ws, width, sr = tbd.band_windows_drift(flat, n_min, n_max, COSTS_1P, 80,
                                           S)
    L = int(sv_case["tq"].shape[1])
    Lp = max(L, -(-(int(ws.max()) + width) // 128) * 128)
    prep = tcf.prepare_banded_drift(sv_case["tdg"], COSTS_1P, ws, width, sr,
                                    S, Lp)
    qpad = torch.nn.functional.pad(sv_case["tq"], (prep["mq"], Lp - L))
    nbs = tcf.drift_units(sv_case["tl"], n_min)
    rows = tcf.drift_end_rows_plain(sv_case["tdg"], qpad, nbs, COSTS_1P,
                                    prep).numpy().astype(np.int64)
    j = (prep["w_end"] + 128 * nbs.numpy())[:, None] + np.arange(width)
    got = np.where(rows >= INF // 2, INF, rows + 2 * j)
    full = tcf.fill_end_rows_plain(sv_case["tdg"], sv_case["tq"],
                                   COSTS_1P).numpy()
    inside = (j >= 0) & (j < L)
    exact = np.take_along_axis(full, np.clip(j, 0, L - 1), axis=1)
    below = inside & (got < exact)
    assert below.any()
    n = np.asarray(sv_case["jl"])[:, None]
    assert (j[below] < np.broadcast_to(n, j.shape)[below]).all()
    scores = tcf.drift_scores_plain(sv_case["tdg"], qpad, sv_case["tl"],
                                    COSTS_1P, prep, n_min).numpy()
    na = NativeAligner(sv_case["graph"])
    ok = scores <= 80
    assert ok.any()
    assert [int(s) for s in scores[ok]] == \
        [na.align(r, COSTS_1P)[0] for r, v in zip(sv_case["reads"], ok) if v]
