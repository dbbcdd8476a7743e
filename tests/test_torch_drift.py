"""The port's drifting-window scoring (B3 ``_banded_kernel_drift``, B6
``_banded_kernel_drift_ef``) on the CPU against the JAX package.

Same numpy-seeded inputs through both packages.  The JAX side runs its
Pallas kernels in interpret mode and its XLA bodies on the CPU; the port
runs its kernels' plain versions (CPU tensors, ``device="cpu"``).  Every
comparison is exact (tolerance 0: the values are integer DP scores), for
verified and for over-estimated rows alike.
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
from poasta_tpu_torch import BandedScorer, BatchMapper, convert
from poasta_tpu_torch.aligner import banded as tbd
from poasta_tpu_torch.aligner import costs as tcosts
from poasta_tpu_torch.aligner import wavefront as twf
from poasta_tpu_torch.ops import cuda_fill as tcf

torch.set_num_threads(1)

COSTS = GapAffine(4, 2, 6)
INF = tcf.INF
LADDER_STATS = ("fills", "tiers", "fullfill_fallbacks")
# the bench's bounded span, scaled to the test graph
BOUNDED = ("unbounded", None), ("included", 40), ("included", 0), \
    ("included", 40)


def _span(mod, spec=BOUNDED):
    def bound(kind, val):
        return mod.UNBOUNDED if kind == "unbounded" else (
            mod.included(val) if kind == "included" else mod.excluded(val))
    return mod.EndsFree(*(bound(*b) for b in spec))


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
    its accelerator route, whose window layout the port always uses."""
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


@pytest.fixture(scope="module")
def case():
    """A 1000-base graph with an 840-base deletion allele and 64 reads at
    1.5%, half from each allele: lengths spread by ~850 bases, L = 1024."""
    rng = random.Random(13)
    base = "".join(rng.choice("ACGT") for _ in range(1000))
    variant = base[:80] + base[920:]
    g = POAGraph()
    g.add_alignment_with_weights("s0", base.encode(), None, [1] * len(base))
    _, aln, _ = NativeAligner(g).align(variant.encode(), COSTS)
    g.add_alignment_with_weights("s1", variant.encode(), aln,
                                 [1] * len(variant))
    reads = [_mutate(rng, base if i % 2 else variant, 0.015).encode()
             for i in range(64)]
    # one read no ub of the tests verifies: an over-estimated row
    reads[5] = _mutate(rng, base, 0.2).encode()
    flat = g.flatten()
    jq, jl = jwf.pack_queries(reads)
    tq, tl = twf.pack_queries(reads, device="cpu")
    lens = np.array([len(r) for r in reads])
    na = NativeAligner(g)
    return {
        "graph": g, "flat": flat, "reads": reads,
        "jdg": jwf.DeviceGraph.build(flat),
        "tdg": twf.DeviceGraph.build(flat, device="cpu"),
        "jq": jq, "jl": jl, "tq": tq, "tl": tl,
        "n_min": int(lens.min()), "n_max": int(lens.max()),
        "exact": np.array([na.align(q, COSTS)[0] for q in reads]),
    }


def _layout(case, ub, aln_j=None):
    """The drift layout at ``ub`` as ``BandedScorer._fill_once_drift``
    builds it: (jprep, tprep via convert, padded query of each package)."""
    flat, n_min, n_max = case["flat"], case["n_min"], case["n_max"]
    S = jbd.drift_steps_for(n_min, n_max)
    ws, width, sr = jbd.band_windows_drift(flat, n_min, n_max, COSTS, ub, S,
                                           aln_type=aln_j)
    L = int(case["tq"].shape[1])
    Lp = max(L, -(-(int(ws.max()) + width) // 128) * 128)
    jprep = jpf.prepare_banded_drift(case["jdg"], COSTS, ws, width, sr, S, Lp)
    tprep = convert.drift_prep_from_reference(
        {k: (np.asarray(v) if hasattr(v, "shape") else v)
         for k, v in jprep.items()}, device="cpu")
    tqp = torch.nn.functional.pad(case["tq"], (tprep["mq"], Lp - L))
    return jprep, tprep, jnp.asarray(tqp.numpy()), tqp, S, (ws, width, sr)


def _raw_drift_rows(case, jprep, jqp, nbs, max_run, ends=None):
    """The Pallas drift kernels' raw output in interpret mode: B3's (B, Wb)
    tilted end rows, or with ``ends = (end_ok, jlo, lengths)`` B6's best
    tiles.  Built as ``_banded_exec_drift[_ef]`` builds its call, without
    the score extraction behind it."""
    jdg = case["jdg"]
    B, LQ = jqp.shape
    W, P = jdg.window, int(jdg.pred_slots.shape[1])
    Wb, margin, mq = jprep["width"], jprep["margin"], jprep["mq"]
    static = dict(W=W, P=P, Wb=Wb, MARGIN=margin, MQ=mq, S=jprep["S"],
                  o=COSTS.gap_open, e=COSTS.gap_extend, x=COSTS.mismatch,
                  B_BLK=B, dtype=jnp.int32, max_run=max_run)

    def vmem(lanes):
        return pl.BlockSpec((B, lanes), lambda i, *_: (i, 0),
                            memory_space=pltpu.VMEM)

    def tile(v):
        return jnp.broadcast_to(jnp.asarray(v, jnp.int32)[:, None], (B, 128))

    prefetch = [jdg.symbols, jdg.pred_slots_flat, jdg.pred_valid_flat,
                jprep["pred_wstarts"], jprep["wstarts"], jdg.write_slots,
                jprep["s_ranks"], jprep["s_prev"]]
    inputs = [jqp, tile(nbs)]
    kernel = jpf._banded_kernel_drift
    if ends is not None:
        kernel = jpf._banded_kernel_drift_ef
        prefetch.append(jnp.asarray(ends[0]))
        inputs += [tile(ends[1]), tile(ends[2])]
    prefetch.append(jdg.meta)
    call = pl.pallas_call(
        functools.partial(kernel, **static),
        out_shape=jax.ShapeDtypeStruct((B, Wb), jnp.int32),
        grid_spec=pltpu.PrefetchScalarGridSpec(
            num_scalar_prefetch=len(prefetch), grid=(1,),
            in_specs=[vmem(LQ)] + [vmem(128)] * (len(inputs) - 1),
            out_specs=vmem(Wb),
            scratch_shapes=[pltpu.VMEM((W, B, 2 * margin + Wb), jnp.int32),
                            pltpu.VMEM((W, B, 2 * margin + Wb), jnp.int32),
                            pltpu.VMEM((B, LQ), jnp.int32)]),
        interpret=True)
    return np.asarray(call(*prefetch, *inputs))


# ---- (a) the numpy twins ---------------------------------------------------

@pytest.mark.parametrize("n_min,n_max", [(100, 100), (100, 101), (100, 228),
                                         (100, 229), (193, 611), (50, 4100)])
def test_drift_steps_for_matches(n_min, n_max):
    assert tbd.drift_steps_for(n_min, n_max) == \
        jbd.drift_steps_for(n_min, n_max)


@pytest.mark.parametrize("spec", [
    None, BOUNDED,
    (("unbounded", None), ("excluded", 30), ("included", 0),
     ("excluded", 30)),
    (("included", 5), ("unbounded", None), ("included", 0),
     ("unbounded", None)),
], ids=["global", "bench", "excluded", "unbounded-ends"])
def test_band_windows_drift_matches(case, spec):
    flat = case["flat"]
    aj = _span(jcosts, spec) if spec else None
    at = _span(tcosts, spec) if spec else None
    rng = random.Random(3)
    for _ in range(6):
        n_min = rng.randrange(80, 300)
        n_max = n_min + rng.randrange(512, 900)
        ub = rng.choice([8, 40, 120, 400, 1500])
        S = jbd.drift_steps_for(n_min, n_max)
        ref = jbd.band_windows_drift(flat, n_min, n_max, COSTS, ub, S,
                                     aln_type=aj)
        got = tbd.band_windows_drift(flat, n_min, n_max, COSTS, ub, S,
                                     aln_type=at)
        assert got[1] == ref[1]
        for a, b in ((got[0], ref[0]), (got[2], ref[2])):
            assert a.dtype == b.dtype and (a == b).all()


def test_band_windows_drift_refuses_free_graph_begin(case):
    semi = tcosts.EndsFree(tcosts.UNBOUNDED, tcosts.included(0),
                           tcosts.UNBOUNDED, tcosts.UNBOUNDED)
    with pytest.raises(ValueError, match="free graph begin"):
        tbd.band_windows_drift(case["flat"], 100, 700, COSTS, 100, 8,
                               aln_type=semi)


@pytest.mark.parametrize("ub", [40, 90, 300])
def test_prepare_banded_drift_matches(case, ub):
    jprep, conv, _, _, S, (ws, width, sr) = _layout(case, ub)
    own = tcf.prepare_banded_drift(case["tdg"], COSTS, ws, width, sr, S,
                                   jprep["L"])
    for prep in (own, conv):
        for k in ("margin", "width", "mq", "S", "L"):
            assert prep[k] == jprep[k], k
        assert prep["w_end"] == int(jprep["w_end"])
        for k in convert.DRIFT_PREP_TENSORS:
            assert prep[k].dtype == torch.int32
            assert (prep[k].numpy() == np.asarray(jprep[k])).all(), k
        assert prep["wstarts_min"] == int(ws.min()) < 0
    with pytest.raises(ValueError, match="power of two"):
        tcf.prepare_banded_drift(case["tdg"], COSTS, ws, width, sr, 3,
                                 jprep["L"])


def test_drift_units_match(case):
    nbs = tcf.drift_units(case["tl"], case["n_min"]).numpy()
    ref = np.maximum(np.asarray(case["jl"]) - case["n_min"] + 64, 0) // 128
    assert nbs.dtype == np.int32 and (nbs == ref).all()
    assert nbs.max() == (case["n_max"] - case["n_min"] + 64) // 128


# ---- (b) the plain fills against the Pallas kernels and the XLA bodies ------

@pytest.mark.parametrize("ub", [60, 150])
def test_drift_plain_matches(case, ub):
    """B3: end rows equal the Pallas kernel's in interpret mode, scores
    equal its wrapper's and the XLA body's, capped and uncapped."""
    jprep, tprep, jqp, tqp, S, _ = _layout(case, ub)
    width, n_min = tprep["width"], case["n_min"]
    assert width < int(case["tq"].shape[1])  # a real band
    assert tprep["mq"] > 0  # negative frame starts are exercised
    cap = tbd.ins_run_cap(COSTS, ub, width)
    assert 0 < cap < width
    jdg = case["jdg"]
    xla = np.asarray(jbd._banded_exec_drift(
        jdg.window, width, int(jdg.pred_slots.shape[1]), COSTS.gap_open,
        COSTS.gap_extend, COSTS.mismatch, S)(
        jdg.symbols, jnp.asarray(jdg.pred_ranks_np), jdg.pred_valid,
        jprep["wstarts"], jdg.write_slots, jdg.end_rank, jprep["s_ranks"],
        jprep["s_prev"], jqp, case["jl"], jnp.asarray(n_min, jnp.int32),
        jnp.asarray(tprep["mq"], jnp.int32)))
    nbs = tcf.drift_units(case["tl"], n_min)
    for max_run in (0, cap):
        rows = tcf.drift_end_rows_plain(case["tdg"], tqp, nbs, COSTS, tprep,
                                        max_run).numpy()
        ref_rows = _raw_drift_rows(case, jprep, jqp, nbs.numpy(), max_run)
        assert rows.shape == ref_rows.shape == (64, width)
        assert (rows == ref_rows).all(), max_run
        got = tcf.drift_scores_plain(case["tdg"], tqp, case["tl"], COSTS,
                                     tprep, n_min, max_run=max_run).numpy()
        with interpret_mode():
            ref = np.asarray(jpf.pallas_banded_scores_drift(
                jdg, jqp, case["jl"], COSTS, jprep, n_min, max_run=max_run))
        assert got.dtype == np.int32 and (got == ref).all(), max_run
        ok = got <= ub
        assert ok.any() and not ok.all()  # verified and over-estimated rows
        assert (got[ok] == case["exact"][ok]).all()
        assert (got >= case["exact"]).all()
        if max_run == 0:
            assert (got == xla).all()


@pytest.mark.parametrize("ub", [60, 150])
def test_drift_ef_plain_matches(case, ub):
    """B6: best tiles equal the Pallas kernel's in interpret mode, scores
    equal its wrapper's and the XLA body's, capped and uncapped."""
    aj, at = _span(jcosts), _span(tcosts)
    jprep, tprep, jqp, tqp, S, _ = _layout(case, ub, aj)
    width, n_min = tprep["width"], case["n_min"]
    jdg, flat = case["jdg"], case["flat"]
    fs, jok, jjlo = jwf.ends_free_device_params(flat, aj, case["jl"],
                                                jdg.n_nodes_padded)
    tfs, end_ok, jlo = convert.ends_free_params_from_reference(
        fs, np.asarray(jok), np.asarray(jjlo), device="cpu")
    own = twf.ends_free_device_params(flat, at, case["tl"],
                                      case["tdg"].n_nodes_padded)
    assert own[0] == tfs is False
    assert torch.equal(own[1], end_ok) and torch.equal(own[2], jlo)
    assert 0 < int(end_ok.sum()) < flat.n_nodes  # a binding graph-end bound
    exact = np.asarray(jwf.dp_fill_scores_ends_free(
        jdg, flat, case["jq"], case["jl"], COSTS, aj, engine="xla"))
    xla = np.asarray(jbd._banded_exec_drift_ef(
        jdg.window, width, int(jdg.pred_slots.shape[1]), COSTS.gap_open,
        COSTS.gap_extend, COSTS.mismatch, S)(
        jdg.symbols, jnp.asarray(jdg.pred_ranks_np), jdg.pred_valid,
        jprep["wstarts"], jdg.write_slots, jdg.end_rank, jok,
        jprep["s_ranks"], jprep["s_prev"], jqp, case["jl"], jjlo,
        jnp.asarray(n_min, jnp.int32), jnp.asarray(tprep["mq"], jnp.int32)))
    nbs = tcf.drift_units(case["tl"], n_min)
    cap = tbd.ins_run_cap(COSTS, ub, width)
    for max_run in (0, cap):
        tiles = tcf.drift_ef_best_rows_plain(
            case["tdg"], tqp, nbs, case["tl"], jlo, COSTS, tprep, end_ok,
            max_run).numpy()
        ref_tiles = _raw_drift_rows(
            case, jprep, jqp, nbs.numpy(), max_run,
            ends=(np.asarray(jok), np.asarray(jjlo), np.asarray(case["jl"])))
        assert (tiles == ref_tiles).all(), max_run
        got = tcf.drift_ef_scores_plain(case["tdg"], tqp, case["tl"], COSTS,
                                        tprep, n_min, end_ok, jlo,
                                        max_run=max_run).numpy()
        with interpret_mode():
            ref = np.asarray(jpf.pallas_banded_scores_drift_ef(
                jdg, jqp, case["jl"], COSTS, jprep, n_min, jok, jjlo,
                max_run=max_run))
        assert got.dtype == np.int32 and (got == ref).all(), max_run
        ok = got <= ub
        assert ok.any() and not ok.all()
        assert (got[ok] == exact[ok]).all()
        assert (got >= exact).all()
        if max_run == 0:
            assert (got == xla).all()


def test_drift_dispatch_cpu(case):
    """CPU tensors take the plain versions through the wrappers and count
    no launch; another device raises."""
    _, tprep, _, tqp, _, _ = _layout(case, 90)
    nbs = tcf.drift_units(case["tl"], case["n_min"])
    before = tcf.drift_end_rows.launches, tcf.drift_ef_best_rows.launches
    got = tcf.drift_end_rows(case["tdg"], tqp, nbs, COSTS, tprep)
    assert torch.equal(got, tcf.drift_end_rows_plain(case["tdg"], tqp, nbs,
                                                     COSTS, tprep))
    assert (tcf.drift_end_rows.launches,
            tcf.drift_ef_best_rows.launches) == before
    with pytest.raises(ValueError, match="no drift fill"):
        tcf.drift_end_rows(case["tdg"], tqp.to("meta"), nbs, COSTS, tprep)
    with pytest.raises(ValueError, match="no drift ends-free fill"):
        tcf.drift_ef_best_rows(case["tdg"], tqp.to("meta"), nbs, case["tl"],
                               case["tl"], COSTS, tprep, nbs)


# ---- (c) the slice as a whole ------------------------------------------------

def _run_both(case, calls, spec=None):
    """The JAX scorer (accelerator route) and the port's through the same
    ``scores`` calls: ladders must agree call by call."""
    aj = _span(jcosts, spec) if spec else None
    at = _span(tcosts, spec) if spec else None
    port = BandedScorer(case["flat"], COSTS, dg=case["tdg"], aln_type=at)
    out = []
    with accel_sim():
        ref = jbd.BandedScorer(case["flat"], COSTS, dg=case["jdg"],
                               aln_type=aj)
        for kw in calls:
            j = np.asarray(ref.scores(case["jq"], case["jl"], **kw))
            p = port.scores(case["tq"], case["tl"], **kw)
            assert port.last_attempts == ref.last_attempts, kw
            assert port._ub_hint == ref._ub_hint, kw
            for k in LADDER_STATS:
                assert port.stats[k] == ref.stats[k], (kw, k)
            out.append((j, p))
        nodrift = [k for k in ref._prep_cache if str(k[0]).startswith("no")]
        assert not nodrift, "the reference's Pallas route fell back"
    return out, port


def test_scorer_drift_global_matches_jax_and_native(case, monkeypatch):
    """Mixed-length global traffic: the ladder drifts, retries its tail and
    learns the same hint; scores equal the exact engine's."""
    calls = {"drift": 0}
    real = tcf.drift_end_rows_plain
    monkeypatch.setattr(tcf, "drift_end_rows_plain",
                        lambda *a, **k: calls.__setitem__(
                            "drift", calls["drift"] + 1) or real(*a, **k))
    runs, port = _run_both(case, [{"ub": 60}, {}])
    for j, p in runs:
        assert p.dtype == np.int32
        assert (p == j).all()
        assert (p == case["exact"]).all()
    assert calls["drift"] >= 1  # the drifting fill served the ladder
    assert any(k[0] == "drift" and v[0] is not None
               for k, v in port._prep_cache.items())
    assert port.stats["tiers"] > 2  # the 20% read forced a retry


def test_scorer_drift_off_gives_the_same_scores(case, monkeypatch):
    """With drift disabled the shared windows give the same exact scores
    from wider bands."""
    monkeypatch.setattr(BandedScorer, "DRIFT_MIN_SPREAD", 1 << 30)
    port = BandedScorer(case["flat"], COSTS, dg=case["tdg"])
    got = port.scores(case["tq"], case["tl"])
    assert (got == case["exact"]).all()
    assert not any(k[0] == "drift" for k in port._prep_cache)


def test_scorer_drift_bounded_span_matches_jax_and_exact(case):
    """The bench's bounded span on mixed-length traffic reaches the drift
    x ends-free fill; scores equal poasta_tpu's on both its routes and the
    exact engine's on sampled reads."""
    before = tcf.drift_ef_best_rows.launches
    runs, port = _run_both(case, [{"ub": 60}, {}], spec=BOUNDED)
    aj = _span(jcosts)
    exact = np.asarray(jwf.dp_fill_scores_ends_free(
        case["jdg"], case["flat"], case["jq"], case["jl"], COSTS, aj,
        engine="xla"))
    for j, p in runs:
        assert (p == j).all()
        assert (p == exact).all()
    assert any(k[0] == "drift" and v[0] is not None
               for k, v in port._prep_cache.items())
    assert tcf.drift_ef_best_rows.launches == before  # CPU: plain version
    from poasta_tpu_torch import PoastaAligner

    engine = PoastaAligner(COSTS, _span(tcosts), heuristic="dijkstra")
    # Dijkstra: the mingap heuristic is not admissible under free ends
    for i in (0, 33):
        assert engine.align(case["graph"], case["reads"][i]).score == \
            int(runs[-1][1][i]), i


def test_mapper_score_batch_mixed_lengths(case):
    """The library entry point on both spans against poasta_tpu's."""
    for spec in (None, BOUNDED):
        at = _span(tcosts, spec) if spec else None
        aj = _span(jcosts, spec) if spec else None
        got = BatchMapper(case["graph"], COSTS, device="cpu",
                          aln_type=at).score_batch(case["reads"])
        ref = JaxMapper(case["graph"], COSTS, aln_type=aj).score_batch(
            case["reads"])
        assert got.dtype == np.int32 and (got == np.asarray(ref)).all()
    assert (got < INF).all()
