"""The port's ends-free scoring on shared windows (B5 ``_banded_kernel_ef``)
and its bounded full fill under the capped ladder (B4
``_fill_kernel_bounded``) on the CPU against the JAX package.

Same numpy-seeded inputs through both packages.  The JAX side runs its
Pallas kernels in interpret mode and its XLA bodies on the CPU; the port
runs its kernels' plain versions (CPU tensors, ``device="cpu"``).  Every
comparison is exact (tolerance 0: the values are integer DP scores), for
verified and for over-estimated rows alike.
"""

import random
from contextlib import contextmanager
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poasta_tpu.aligner import GapAffine
from poasta_tpu.aligner import banded as jbd
from poasta_tpu.aligner import costs as jcosts
from poasta_tpu.aligner import wavefront as jwf
from poasta_tpu.graphs import POAGraph
from poasta_tpu.native import NativeAligner
from poasta_tpu.ops import pallas_fill as jpf
from poasta_tpu.parallel import BatchMapper as JaxMapper
from poasta_tpu_torch import BandedScorer, BatchMapper, PoastaAligner, convert
from poasta_tpu_torch.aligner import banded as tbd
from poasta_tpu_torch.aligner import costs as tcosts
from poasta_tpu_torch.aligner import wavefront as twf
from poasta_tpu_torch.ops import cuda_fill as tcf

torch.set_num_threads(1)

COSTS = GapAffine(4, 2, 6)
INF = tcf.INF
LADDER_STATS = ("fills", "tiers", "fullfill_fallbacks")
# spans by field; a field left out is unbounded
SPANS = {
    # the CLI's -m semi-global: the whole read, anywhere in the graph
    "semi-global": {"qry_free_end": ("included", 0)},
    "ends-free": {},
    # the bench's bounded span, scaled to the test graph
    "bounded": {"qry_free_end": ("included", 30),
                "graph_free_begin": ("included", 0),
                "graph_free_end": ("included", 30)},
    "excluded": {"qry_free_begin": ("included", 4),
                 "qry_free_end": ("excluded", 12),
                 "graph_free_begin": ("excluded", 9),
                 "graph_free_end": ("excluded", 25)},
    "free-begin-bounded-end": {"qry_free_end": ("excluded", 1),
                               "graph_free_end": ("included", 40)},
    "query-end-only": {"graph_free_begin": ("included", 0),
                       "graph_free_end": ("included", 0)},
    # excluded(0): no rank may end an alignment
    "never": {"graph_free_end": ("excluded", 0)},
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
    """A fused ~600-node graph and 64 fragments of 440-520 bases cut from
    its base sequence at 3% (every 16th at 15%), L = 640; read 7 carries a
    40-base insertion, which a capped scan over-estimates."""
    rng = random.Random(37)
    base = "".join(rng.choice("ACGT") for _ in range(560))
    g = POAGraph()
    g.add_alignment_with_weights("s0", base.encode(), None, [1] * len(base))
    for i in range(1, 3):
        s = _mutate(rng, base, 0.05).encode()
        _, aln, _ = NativeAligner(g).align(s, COSTS)
        g.add_alignment_with_weights(f"s{i}", s, aln, [1] * len(s))
    reads = []
    for i in range(64):
        a = rng.randrange(0, 40)
        b = a + rng.randrange(440, 520)
        reads.append(_mutate(rng, base[a:b], 0.15 if i % 16 == 3 else 0.03)
                     .encode())
    ins = "".join(rng.choice("ACGT") for _ in range(40))
    reads[7] = (base[20:250] + ins + base[250:480]).encode()
    flat = g.flatten()
    jq, jl = jwf.pack_queries(reads)
    tq, tl = twf.pack_queries(reads, device="cpu")
    lens = np.array([len(r) for r in reads])
    return {
        "graph": g, "flat": flat, "reads": reads,
        "jdg": jwf.DeviceGraph.build(flat),
        "tdg": twf.DeviceGraph.build(flat, device="cpu"),
        "jq": jq, "jl": jl, "tq": tq, "tl": tl,
        "n_min": int(lens.min()), "n_max": int(lens.max()),
    }


def _params(case, name):
    """(jax triple, port triple via convert) of a span for the batch."""
    jp = jwf.ends_free_device_params(case["flat"], _span(jcosts, name),
                                     case["jl"], case["jdg"].n_nodes_padded)
    tp = convert.ends_free_params_from_reference(
        jp[0], np.asarray(jp[1]), np.asarray(jp[2]), device="cpu")
    return jp, tp


def _exact(case, name):
    return np.asarray(jwf.dp_fill_scores_ends_free(
        case["jdg"], case["flat"], case["jq"], case["jl"], COSTS,
        _span(jcosts, name), engine="xla"))


# ---- (a) the numpy twins ---------------------------------------------------

@pytest.mark.parametrize("name", [None, *SPANS])
def test_free_allowances_and_band_windows_match(case, name):
    aj = _span(jcosts, name) if name else None
    at = _span(tcosts, name) if name else None
    assert tbd._free_allowances(at) == jbd._free_allowances(aj)
    rng = random.Random(5)
    for _ in range(8):
        n_min = rng.randrange(200, 450)
        n_max = n_min + rng.randrange(0, 150)
        ub = rng.choice([8, 30, 100, 400, 2000])
        ref = jbd.band_windows(case["flat"], n_min, n_max, COSTS, ub,
                               aln_type=aj)
        got = tbd.band_windows(case["flat"], n_min, n_max, COSTS, ub,
                               aln_type=at)
        for a, b in zip(ref, got):
            assert (np.asarray(a) == np.asarray(b)).all()
            assert np.asarray(a).dtype == np.asarray(b).dtype


@pytest.mark.parametrize("name", list(SPANS))
def test_ends_free_device_params_match(case, name):
    lens = np.array([0, 1, 2, 11, 12, 13, 29, 30, 31, 450], dtype=np.int32)
    ref = jwf.ends_free_device_params(case["flat"], _span(jcosts, name),
                                      jnp.asarray(lens),
                                      case["jdg"].n_nodes_padded)
    got = twf.ends_free_device_params(case["flat"], _span(tcosts, name),
                                      torch.as_tensor(lens),
                                      case["tdg"].n_nodes_padded)
    assert got[0] == ref[0]
    for g, r in zip(got[1:], ref[1:]):
        assert g.dtype == torch.int32
        assert (g.numpy() == np.asarray(r)).all()
    assert (twf.query_end_lo(_span(tcosts, name), lens)
            == np.asarray(ref[2])).all()
    with pytest.raises(TypeError):
        twf.ends_free_device_params(case["flat"], tcosts.Global(),
                                    torch.as_tensor(lens), 64)


# ---- (b) the plain fills against the Pallas kernels and the XLA bodies ------

@pytest.mark.parametrize("name", ["semi-global", "bounded", "excluded"])
def test_bounded_plain_matches(case, name):
    """B4: scores equal the Pallas kernel's in interpret mode capped and
    uncapped, the XLA body's uncapped; sampled columns of the best row
    equal the kernel's."""
    (fs, jok, jjlo), (tfs, end_ok, jlo) = _params(case, name)
    exact = _exact(case, name)
    jdg, tdg = case["jdg"], case["tdg"]
    over = 0
    for max_run in (0, 16):
        got = tcf.bounded_scores_plain(tdg, case["tq"], case["tl"], COSTS,
                                       tfs, end_ok, jlo,
                                       max_run=max_run).numpy()
        best = tcf.bounded_best_rows_plain(tdg, case["tq"], COSTS, tfs,
                                           end_ok, max_run).numpy()
        with interpret_mode():
            ref = np.asarray(jpf.pallas_fill_scores_bounded(
                jdg, case["jq"], case["jl"], COSTS, fs, jok, jjlo,
                max_run=max_run))
            for j in (0, 1, 300, 511):
                at_j = jnp.full((64,), j, jnp.int32)
                col = np.asarray(jpf.pallas_fill_scores_bounded(
                    jdg, case["jq"], at_j, COSTS, fs, jok, at_j,
                    max_run=max_run))
                assert (best[:, j] == col).all(), (max_run, j)
        assert got.dtype == np.int32 and (got == ref).all(), max_run
        assert (got >= exact).all()
        over += int((got > exact).sum())
        if max_run == 0:
            assert (got == exact).all()
    assert over > 0  # a cap over-estimated some row


@pytest.mark.parametrize("name,ub", [("semi-global", 120),
                                     ("semi-global", 220), ("bounded", 150),
                                     ("excluded", 150),
                                     ("free-begin-bounded-end", 150)])
def test_ef_plain_matches(case, name, ub):
    """B5: scores equal the Pallas kernel's in interpret mode capped and
    uncapped and the XLA body's uncapped; sampled columns of the un-tilted
    best row equal the kernel's.  Fragments verify under the semi-global
    span; under the spans bounded at the graph's ends every row is an
    over-estimate at this ub, and must agree all the same."""
    (fs, jok, jjlo), (tfs, end_ok, jlo) = _params(case, name)
    exact = _exact(case, name)
    jdg, tdg, flat = case["jdg"], case["tdg"], case["flat"]
    n_min, n_max = case["n_min"], case["n_max"]
    ws, width, _, _ = jbd.band_windows(flat, n_min, n_max, COSTS, ub,
                                       aln_type=_span(jcosts, name))
    ws, width = (ws // 128) * 128, width + 128
    L = int(case["tq"].shape[1])
    Lp = max(L, -(-(int(ws.max()) + width) // 128) * 128)
    jprep = jpf.prepare_banded(jdg, COSTS, ws, width, Lp)
    tprep = tcf.prepare_banded(tdg, COSTS, ws, width, Lp)
    assert tprep["width"] < L  # a real band
    tqp = torch.nn.functional.pad(case["tq"], (0, Lp - L))
    jqp = jnp.asarray(tqp.numpy())
    xla = np.asarray(jbd._banded_exec_ef(
        jdg.window, tprep["width"], int(jdg.pred_slots.shape[1]),
        COSTS.gap_open, COSTS.gap_extend, COSTS.mismatch, fs)(
        jdg.symbols, jnp.asarray(jdg.pred_ranks_np), jdg.pred_valid,
        jprep["wstarts"], jdg.write_slots, jdg.end_rank, jok, jqp,
        case["jl"], jjlo))
    cap = tbd.ins_run_cap(COSTS, ub, tprep["width"])
    assert 0 < cap < tprep["width"]
    for max_run in (0, cap):
        got = tcf.ef_scores_plain(tdg, tqp, case["tl"], COSTS, tprep, tfs,
                                  end_ok, jlo, max_run=max_run).numpy()
        best = tcf.ef_best_rows_plain(tdg, tqp, COSTS, tprep, tfs, end_ok,
                                      max_run)
        assert best.shape == (64, Lp)
        col_e = COSTS.gap_extend * torch.arange(Lp, dtype=torch.int32)
        best = torch.where(best >= INF // 2, INF, best + col_e).numpy()
        with interpret_mode():
            ref = np.asarray(jpf.pallas_banded_scores_ef(
                jdg, jqp, case["jl"], COSTS, jprep, fs, jok, jjlo,
                max_run=max_run))
            for j in (0, 1, 300, 511):
                at_j = jnp.full((64,), j, jnp.int32)
                col = np.asarray(jpf.pallas_banded_scores_ef(
                    jdg, jqp, at_j, COSTS, jprep, fs, jok, at_j,
                    max_run=max_run))
                assert (best[:, j] == col).all(), (max_run, j)
        assert got.dtype == np.int32 and (got == ref).all(), max_run
        ok = got <= ub
        assert not ok.all()  # over-estimated rows
        assert ok.any() == (name == "semi-global")  # and verified ones
        assert (got[ok] == exact[ok]).all()
        assert (got >= exact).all()
        if max_run == 0:
            assert (got == xla).all()


def test_ends_free_dispatch_cpu(case):
    """CPU tensors take the plain versions through the wrappers and the
    public entry point, and count no launch; another device raises."""
    _, (tfs, end_ok, jlo) = _params(case, "semi-global")
    before = tcf.bounded_best_rows.launches, tcf.ef_best_rows.launches
    via = twf.dp_fill_scores_ends_free(
        case["tdg"], case["flat"], case["tq"], case["tl"], COSTS,
        _span(tcosts, "semi-global"))
    assert (via.numpy() == _exact(case, "semi-global")).all()
    assert (tcf.bounded_best_rows.launches,
            tcf.ef_best_rows.launches) == before
    meta = case["tq"].to("meta")
    with pytest.raises(ValueError, match="no bounded fill"):
        tcf.bounded_best_rows(case["tdg"], meta, COSTS, tfs, end_ok)
    with pytest.raises(ValueError, match="no ends-free banded fill"):
        tcf.ef_best_rows(case["tdg"], meta, COSTS, {}, tfs, end_ok)


# ---- (c) the slice as a whole ------------------------------------------------

def _run_both(case, name, calls):
    """The JAX scorer (accelerator route) and the port's through the same
    ``scores`` calls: scores, ladders and learned hints agree call by
    call."""
    port = BandedScorer(case["flat"], COSTS, dg=case["tdg"],
                        aln_type=_span(tcosts, name))
    out = []
    with accel_sim():
        ref = jbd.BandedScorer(case["flat"], COSTS, dg=case["jdg"],
                               aln_type=_span(jcosts, name))
        for kw in calls:
            j = np.asarray(ref.scores(case["jq"], case["jl"], **kw))
            p = port.scores(case["tq"], case["tl"], **kw)
            assert p.dtype == np.int32 and (p == j).all(), kw
            assert port.last_attempts == ref.last_attempts, kw
            assert port._ub_hint == ref._ub_hint, kw
            for k in LADDER_STATS:
                assert port.stats[k] == ref.stats[k], (kw, k)
            out.append(p)
        assert not [k for k in ref._prep_cache if str(k[0]).startswith("no")]
    return out, port


def test_scorer_semi_global_matches_jax_and_exact(case, monkeypatch):
    """Fragments under the CLI's semi-global span: the ladder's tiers run
    the ends-free banded fill, and with one attempt the tail reaches the
    capped ladder over the bounded full fill; scores equal poasta_tpu's,
    the exact full fill's and the exact engine's."""
    seen = []
    real = twf.bounded_scores
    monkeypatch.setattr(
        twf, "bounded_scores",
        lambda *a, max_run=0, **k: seen.append(max_run)
        or real(*a, max_run=max_run, **k))
    runs, port = _run_both(case, "semi-global",
                           [{"ub": 40, "max_retries": 1}, {}, {}])
    exact = _exact(case, "semi-global")
    for p in runs:
        assert (p == exact).all()
    assert port.stats["fullfill_fallbacks"] >= 1
    assert [c for c in seen if c > 0], "the capped ladder never capped"
    assert any(k[0] == "ef_full_ub" for k in port._ub_hint
               if isinstance(k[0], str))
    engine = PoastaAligner(COSTS, _span(tcosts, "semi-global"),
                           heuristic="dijkstra")
    # the A* engine under Dijkstra: its mingap heuristic is not admissible
    # when ends are free (it returns 806 for read 3, whose optimum is 706)
    for i in (0, 7, 40):  # 3% reads and the 40-base insertion
        assert engine.align(case["graph"], case["reads"][i]).score == \
            int(runs[-1][i]), i


@pytest.mark.parametrize("name", ["bounded", "excluded", "ends-free",
                                  "free-begin-bounded-end",
                                  "query-end-only"])
def test_scorer_spans_match_jax(case, name):
    runs, _ = _run_both(case, name, [{"ub": 60}, {}])
    exact = _exact(case, name)
    for p in runs:
        assert (p == exact).all()


def test_scorer_whole_batch_full_fill(case):
    """No read verifies at ub 4: with one attempt the whole batch takes
    the bounded full fill, and the next call goes straight to it or back
    to the band exactly as poasta_tpu does."""
    runs, port = _run_both(case, "semi-global",
                           [{"ub": 4, "max_retries": 1}, {}])
    assert (runs[0] == _exact(case, "semi-global")).all()
    assert port.stats["fullfill_fallbacks"] == 1


def test_mapper_score_batch_ends_free(case):
    """The library entry point against poasta_tpu's; an unsatisfiable
    query-end bound scores INF in both."""
    for name in ("semi-global", "bounded"):
        got = BatchMapper(case["graph"], COSTS, device="cpu",
                          aln_type=_span(tcosts, name)).score_batch(
            case["reads"])
        ref = JaxMapper(case["graph"], COSTS,
                        aln_type=_span(jcosts, name)).score_batch(
            case["reads"])
        assert got.dtype == np.int32 and (got == np.asarray(ref)).all()
    got = BatchMapper(case["graph"], COSTS, device="cpu",
                      aln_type=_span(tcosts, "never")).score_batch(
        case["reads"][:8])
    assert (got == INF).all()


# ---- (d) the capped ladder ---------------------------------------------------

def _stub_fills(true, runs, log):
    """Fills of a batch whose exact scores are ``true`` and whose longest
    insertion runs are ``runs``: a cap below a read's run over-estimates it
    (or loses it to INF where ``true`` is INF anyway)."""
    def capped(cap):
        log.append(cap)
        return (np.where(runs > cap, np.minimum(true + 3 * runs, INF),
                         true),)

    def plain():
        log.append("plain")
        return (true.copy(),)
    return capped, plain


@pytest.mark.parametrize("true,runs,ub0", [
    ([10, 20, 30], [1, 2, 3], 64),          # verifies at the first cap
    ([10, 200, 30], [1, 70, 3], 40),        # climbs: 40 -> 160 -> 640
    ([10, 5000, 30], [1, 900, 3], 40),      # falls through, finite
    ([10, INF, 30], [1, 0, 3], 40),         # falls through, INF row
    ([0, 0, 0], [0, 0, 0], 64),             # max floored at 1
    ([10, 20, 30], [1, 2, 3], 1 << 20),     # cap no narrower than the row
], ids=["first", "climb", "finite-fallthrough", "inf-row", "zeros", "wide"])
def test_run_capped_ladder_matches(true, runs, ub0):
    true, runs = np.array(true, dtype=np.int32), np.array(runs)
    jlog, tlog = [], []
    ref = jbd.run_capped_ladder(COSTS, 512, ub0, *_stub_fills(true, runs,
                                                              jlog))
    got = tbd.run_capped_ladder(COSTS, 512, ub0, *_stub_fills(true, runs,
                                                              tlog))
    assert tlog == jlog
    assert got[1] == ref[1]
    assert (got[0][0] == ref[0][0]).all() and (got[0][0] == true).all()
    assert tbd.LADDER_INF_SKIP == jbd.LADDER_INF_SKIP


def test_capped_fill_error_propagates(case, monkeypatch):
    """A capped fill that raises is the kernel's own error: the port's
    ladder lets it through where poasta_tpu's falls back to the plain
    fill, and so does the scorer above it."""
    def broken(cap):
        raise RuntimeError("bounded fill kernel launch failed")

    def plain():
        return (np.zeros(3, dtype=np.int32),)

    out, hint = jbd.run_capped_ladder(COSTS, 512, 40, broken, plain)
    assert hint is None and (out[0] == 0).all()
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        tbd.run_capped_ladder(COSTS, 512, 40, broken, plain)

    real = twf.bounded_scores

    def fails_when_capped(*a, max_run=0, **k):
        if max_run:
            raise RuntimeError("bounded fill kernel launch failed")
        return real(*a, max_run=max_run, **k)

    monkeypatch.setattr(twf, "bounded_scores", fails_when_capped)
    port = BandedScorer(case["flat"], COSTS, dg=case["tdg"],
                        aln_type=_span(tcosts, "semi-global"))
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        port.scores(case["tq"], case["tl"], ub=4, max_retries=1)


def test_ladder_backs_off_after_inf_rows(case):
    """Rows no ub can verify send the next ``LADDER_INF_SKIP`` calls of
    that shape straight to the plain fill, as in poasta_tpu."""
    port = BandedScorer(case["flat"], COSTS, dg=case["tdg"],
                        aln_type=_span(tcosts, "never"))
    with accel_sim():
        ref = jbd.BandedScorer(case["flat"], COSTS, dg=case["jdg"],
                               aln_type=_span(jcosts, "never"))
        for _ in range(3):
            j = np.asarray(ref._full_scores(case["jq"], case["jl"]))
            p = port._full_scores(case["tq"], case["tl"])
            assert (p == j).all() and (p == INF).all()
            assert port._ub_hint == ref._ub_hint
    L = int(case["tq"].shape[1])
    assert port._ub_hint == {("ef_full_ub", L): -tbd.LADDER_INF_SKIP + 2}
