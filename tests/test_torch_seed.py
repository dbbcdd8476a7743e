"""The port's seeded corridor fill (B8 ``_seed_kernel``) and the seeded
ends-free scoring path on the CPU against the JAX package.

Same numpy-seeded inputs through both packages.  The JAX side runs its
Pallas kernels in interpret mode with ``POASTA_SEED=all`` and
``POASTA_SEED_DEBUG=1`` (as ``tests/test_seeds.py`` does); the port runs
its kernels' plain versions (CPU tensors, ``device="cpu"``).  Every
comparison is exact (tolerance 0: integer DP scores, ranks and offsets).
"""

import random
from unittest import mock

import numpy as np
import pytest
import torch

from poasta_tpu.aligner import GapAffine
from poasta_tpu.aligner import costs as jcosts
from poasta_tpu.aligner import wavefront as jwf
from poasta_tpu.graphs import POAGraph
from poasta_tpu.ops import pallas_fill as jpf
from poasta_tpu.ops import pallas_seed as jps
from poasta_tpu.parallel import BatchMapper as JaxMapper
from poasta_tpu_torch import BatchMapper, convert
from poasta_tpu_torch.aligner import costs as tcosts
from poasta_tpu_torch.aligner import wavefront as twf
from poasta_tpu_torch.ops import seed as tseed
from poasta_tpu_torch.parallel import mapper as tmapper

torch.set_num_threads(1)

COSTS = GapAffine(4, 2, 6)
INF = tseed.INF


def _semi(mod):
    return mod.EndsFree(mod.UNBOUNDED, mod.included(0), mod.UNBOUNDED,
                        mod.UNBOUNDED)


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setenv("POASTA_SEED", "all")
    monkeypatch.setenv("POASTA_SEED_DEBUG", "1")
    jpf.set_interpret_mode(True)
    try:
        yield
    finally:
        jpf.set_interpret_mode(False)


def _mutate(rng, s, d):
    out = []
    for ch in s:
        r = rng.random()
        if r < d / 3:
            continue
        if r < 2 * d / 3:
            out.append(rng.choice("ACGT"))
            out.append(ch)
        elif r < d:
            out.append(rng.choice("ACGT"))
        else:
            out.append(ch)
    return "".join(out) or "A"


def _backbone_graph(rng, n, skip_every=97):
    base = "".join(rng.choice("ACGT") for _ in range(n))
    g = POAGraph()
    g.add_alignment_with_weights("s0", base.encode(), None, [1] * n)
    for v in range(0, n - 3, skip_every):
        g.add_edge(v, v + 3, 0, 1)
    g.post_process()
    return g, base


def _reads(rng, base, n_reads, read_len, div, lo=0, hi=None):
    hi = len(base) - read_len if hi is None else hi
    out = []
    for _ in range(n_reads):
        a = rng.randrange(lo, hi)
        out.append(_mutate(rng, base[a:a + read_len], div).encode())
    return out


def _port_graph(jdg):
    return convert.device_graph_from_reference(
        {k: (getattr(jdg, k) if k in ("window", "end_rank_i")
             else np.asarray(getattr(jdg, k)))
         for k in convert.REFERENCE_KEYS}, device="cpu")


CASES = {
    # (seed, nodes, reads, read length, divergence, locus range)
    "one-chunk": (11, 1400, 16, 700, 0.01, 0, None),
    # loci past the first 4096-rank tile: the reference's blocks enter at a
    # nonzero rank with a nonzero window start
    "deep-locus": (61, 6000, 16, 600, 0.01, 4200, 5200),
    "divergent": (23, 2000, 8, 500, 0.03, 0, None),
}


def _reference_seed_calls(g, reads):
    """Drive the JAX mapper's seeded scoring on ``reads`` (one batch to
    learn the rates, one seeded) and record every ``pallas_seed_scores``
    call: its arguments as numpy, and what it returned."""
    m = JaxMapper(g, COSTS, aln_type=_semi(jcosts))
    qshift, lengths = jwf.pack_queries(reads)
    m._ends_free_scores(reads, qshift, lengths, False)
    calls = []
    real = jps.pallas_seed_scores

    def rec(dg, flat, q, ln, costs, free_start, end_ok, jlo, a, b, ub):
        out = real(dg, flat, q, ln, costs, free_start, end_ok, jlo, a, b, ub)
        calls.append((dict(
            q=np.asarray(q), lengths=np.asarray(ln), free_start=free_start,
            end_ok=np.asarray(end_ok), jlo=np.asarray(jlo), alpha=np.asarray(a),
            beta=np.asarray(b), ub=np.asarray(ub)), out))
        return out

    with mock.patch.object(jps, "pallas_seed_scores", rec):
        scores = m._ends_free_scores(reads, qshift, lengths, False)
    return m, calls, scores


def _reference_block_ranges(tdg, flat, costs, args):
    """The rank range the reference's kernel walks for each read, in the
    caller's order: its 16-read locus-sorted blocks, each from the block's
    first corridor rank rounded down to 4096 to its last rounded up to
    1024 (``poasta_tpu/ops/pallas_seed.py:339-351``)."""
    B = args["q"].shape[0]
    e = costs.gap_extend
    Wb = tseed.corridor_width(costs, args["alpha"], args["beta"], args["ub"])
    LQ = -(-max(args["q"].shape[1], Wb + 128) // 128) * 128
    blk = min(jpf.pick_b_blk(tdg.window, Wb, LQ, 4, n_rings=4),
              jps.SEED_B_BLK)
    while B % blk:
        blk //= 2
    perm = np.argsort(args["alpha"] + args["beta"], kind="stable")
    _, _, _, r_lo, r_hi, has = tseed.seed_schedule(
        flat, args["lengths"], args["ub"] // e + 1, args["alpha"],
        args["beta"], Wb, tdg.n_nodes_padded, "cpu")
    r_lo, r_hi, has = (t.numpy()[perm].reshape(-1, blk)
                       for t in (r_lo, r_hi, has))
    C = jpf.BIG_CHUNK
    n = flat.n_nodes
    lo_b = np.where(has, r_lo, tdg.n_nodes_padded).min(axis=1)
    hi_b = np.where(has, r_hi, -1).max(axis=1)
    has_b = has.any(axis=1)
    begin_b = np.where(has_b, (lo_b // 4096) * 4096, 0)
    cend = np.minimum(-(-n // C), -(-(hi_b + 1) // C))
    end_b = np.where(has_b, np.minimum(cend * C, n), 0)
    end_b = np.maximum(end_b, begin_b)
    r_begin = np.empty(B, np.int64)
    r_end = np.empty(B, np.int64)
    r_begin[perm] = np.repeat(begin_b, blk)
    r_end[perm] = np.repeat(end_b, blk)
    return r_begin, r_end


@pytest.fixture(scope="module", params=sorted(CASES))
def seeded(request):
    seed, n, n_reads, read_len, div, lo, hi = CASES[request.param]
    rng = random.Random(seed)
    g, base = _backbone_graph(rng, n)
    reads = _reads(rng, base, n_reads, read_len, div, lo, hi)
    # a garbage read: no cluster, or a corridor that does not verify
    reads[3] = "".join(rng.choice("ACGT") for _ in range(read_len)).encode()
    jpf.set_interpret_mode(True)
    mp = pytest.MonkeyPatch()
    mp.setenv("POASTA_SEED", "all")
    mp.setenv("POASTA_SEED_DEBUG", "1")
    try:
        m, calls, scores = _reference_seed_calls(g, reads)
    finally:
        mp.undo()
        jpf.set_interpret_mode(False)
    assert calls, "the reference never reached its seed kernel"
    return {"name": request.param, "graph": g, "reads": reads, "jax": m,
            "calls": calls, "scores": scores, "tdg": _port_graph(m.dg)}


def test_seed_scores_plain_equals_pallas_seed_scores(seeded):
    """All four outputs of every seeded call (tight tier, then the wide
    tier's retry subset), given the reference's block rank ranges."""
    m, tdg = seeded["jax"], seeded["tdg"]
    for args, want in seeded["calls"]:
        ranges = _reference_block_ranges(tdg, m.flat, COSTS, args)
        got = tseed.seed_scores_plain(
            tdg, m.flat, torch.tensor(args["q"]), args["lengths"], COSTS,
            args["free_start"], torch.tensor(args["end_ok"]), args["jlo"],
            args["alpha"], args["beta"], args["ub"], ranges=ranges)
        for name, g_arr, w_arr in zip(("scores", "end ranks", "end offsets",
                                       "ok"), got, want):
            np.testing.assert_array_equal(g_arr, np.asarray(w_arr),
                                          err_msg=f"{seeded['name']} {name}")


def test_own_rank_ranges_resolve_what_the_reference_resolves(seeded):
    """On the main path each read walks only its own corridor span.  Every
    read the reference's call verifies (ok and score <= ub) comes out with
    the same score and end state; tight ranges can only raise a score."""
    m, tdg = seeded["jax"], seeded["tdg"]
    for args, want in seeded["calls"]:
        got = tseed.seed_scores(
            tdg, m.flat, torch.tensor(args["q"]), args["lengths"], COSTS,
            args["free_start"], torch.tensor(args["end_ok"]), args["jlo"],
            args["alpha"], args["beta"], args["ub"])
        w_sc, w_er, w_ej, w_ok = (np.asarray(a) for a in want)
        np.testing.assert_array_equal(got[3], w_ok)
        assert (got[0] >= w_sc).all()
        hit = w_ok & (got[0] <= args["ub"])
        assert hit.sum() >= (w_ok & (w_sc <= args["ub"])).sum() - 1
        np.testing.assert_array_equal(got[0][hit], w_sc[hit])
        np.testing.assert_array_equal(got[1][hit], w_er[hit])
        np.testing.assert_array_equal(got[2][hit], w_ej[hit])


def test_seeded_scoring_path_equals_the_reference(seeded):
    """``_ends_free_scores`` through the port's seeded path: scores and
    end states equal the reference's, and the same reads seed."""
    g, reads, m = seeded["graph"], seeded["reads"], seeded["jax"]
    tm = BatchMapper(g, COSTS, device="cpu", aln_type=_semi(tcosts))
    q, ln = twf.pack_queries(reads, device="cpu")
    first = tm._ends_free_scores(reads, q, ln)
    assert tm._seed_rate == pytest.approx(m._seed_rate, rel=0, abs=0) \
        or tm.last_seed_stats is None
    got = tm._ends_free_scores(reads, q, ln)
    for g_arr, w_arr, f_arr in zip(got, seeded["scores"], first):
        np.testing.assert_array_equal(g_arr, np.asarray(w_arr))
        np.testing.assert_array_equal(g_arr, f_arr)
    for key in ("seeded", "seed_tail", "seed_k", "seed_attempts",
                "no_cluster", "cert_failed", "unverified", "seed_ub"):
        assert tm.last_seed_stats[key] == m.last_seed_stats[key], key
    assert tm.last_seed_stats["seeded"] >= len(reads) // 2
    assert tm.last_seed_stats["seed_tail"] >= 1  # the garbage read


def test_width_budget_routes_to_the_full_fill():
    """Corridors past WB_MAX lanes return None (the reference's rule), and
    the mapper then full-fills."""
    rng = random.Random(5)
    g, base = _backbone_graph(rng, 1400)
    reads = _reads(rng, base, 8, 600, 0.01)
    tm = BatchMapper(g, COSTS, device="cpu", aln_type=_semi(tcosts))
    q, ln = twf.pack_queries(reads, device="cpu")
    free_start, end_ok, jlo = tm.scorer._ef_params(ln)
    lens = np.array([len(r) for r in reads])
    wide = tseed.seed_scores(
        tm.dg, tm.flat, q, lens, COSTS, free_start, end_ok, jlo.numpy(),
        np.zeros(8, np.int64), np.zeros(8, np.int64),
        np.full(8, 2 * tseed.WB_MAX, np.int64))
    assert wide is None
    assert tseed.corridor_width(COSTS, np.zeros(1), np.zeros(1),
                                np.array([100])) == 512
    ref = tm._fill_ends_free_capped(q, ln, lens)
    tm._seed_rate = (50.0, 60.0)  # rates whose corridors pass the budget
    got = tm._ends_free_scores(reads, q, ln)
    for g_arr, w_arr in zip(got, ref):
        np.testing.assert_array_equal(g_arr, w_arr)


def test_reads_the_schedule_cannot_cover_come_back_inf():
    """ok = False (the schedule's bounds do not fit the width) gives INF,
    whatever the kernel computed."""
    rng = random.Random(9)
    g, base = _backbone_graph(rng, 1400)
    reads = _reads(rng, base, 4, 600, 0.01)
    tm = BatchMapper(g, COSTS, device="cpu", aln_type=_semi(tcosts))
    q, ln = twf.pack_queries(reads, device="cpu")
    free_start, end_ok, jlo = tm.scorer._ef_params(ln)
    lens = np.array([len(r) for r in reads])
    ok_false = torch.zeros(4, dtype=torch.bool)
    real = tseed.seed_schedule

    def no_cover(*a, **k):
        out = list(real(*a, **k))
        out[1] = ok_false
        return tuple(out)

    with mock.patch.object(tseed, "seed_schedule", no_cover):
        sc, _, _, ok = tseed.seed_scores(
            tm.dg, tm.flat, q, lens, COSTS, free_start, end_ok, jlo.numpy(),
            np.full(4, -700, np.int64), np.full(4, 0, np.int64),
            np.full(4, 200, np.int64))
    assert not ok.any() and (sc == INF).all()


def test_rate_hint_transfers_across_length_profiles():
    """Batches come sorted by length, so each has its own (n_min, n_max):
    the per-character rates a batch of short reads teaches must seed a
    batch of longer ones, with the reference's result."""
    rng = random.Random(67)
    g, base = _backbone_graph(rng, 1400)
    short = _reads(rng, base, 8, 500, 0.01)
    long = _reads(rng, base, 8, 800, 0.01)
    jm = JaxMapper(g, COSTS, aln_type=_semi(jcosts))
    tm = BatchMapper(g, COSTS, device="cpu", aln_type=_semi(tcosts))
    jq, jl = jwf.pack_queries(short)
    tq, tl = twf.pack_queries(short, device="cpu")
    jm._ends_free_scores(short, jq, jl, False)
    tm._ends_free_scores(short, tq, tl)
    assert tm._seed_rate == jm._seed_rate and tm.last_seed_stats is None
    jq, jl = jwf.pack_queries(long)
    tq, tl = twf.pack_queries(long, device="cpu")
    want = jm._ends_free_scores(long, jq, jl, False)
    got = tm._ends_free_scores(long, tq, tl)
    assert tm.last_seed_stats["seeded"] >= 6
    assert tm.last_seed_stats["seeded"] == jm.last_seed_stats["seeded"]
    for g_arr, w_arr in zip(got, want):
        np.testing.assert_array_equal(g_arr, np.asarray(w_arr))


@pytest.mark.parametrize("why", ["unbounded-query-end", "bounded-begin",
                                 "small-graph-auto", "seed-off"])
def test_routes_that_never_seed(why, monkeypatch):
    """The algorithm's own routes around the seeded fill: a span whose
    reads may end at offset ~1 can never certify; a bounded graph begin
    anchors at the start node; auto mode leaves small graphs alone;
    POASTA_SEED=0 switches it off.  The full fill answers each time."""
    rng = random.Random(17)
    g, base = _backbone_graph(rng, 1200)
    reads = _reads(rng, base, 8, 600, 0.01)
    span = _semi(tcosts)
    if why == "unbounded-query-end":
        span = tcosts.EndsFree()
    elif why == "bounded-begin":
        span = tcosts.EndsFree(graph_free_begin=("included", 0),
                               qry_free_end=("included", 0))
    elif why == "small-graph-auto":
        monkeypatch.setenv("POASTA_SEED", "")
    else:
        monkeypatch.setenv("POASTA_SEED", "0")
    tm = BatchMapper(g, COSTS, device="cpu", aln_type=span)
    q, ln = twf.pack_queries(reads, device="cpu")
    lens = np.array([len(r) for r in reads])
    with mock.patch.object(tmapper, "seed_scores",
                           side_effect=AssertionError("seeded")):
        tm._ends_free_scores(reads, q, ln)
        got = tm._ends_free_scores(reads, q, ln)
    assert tm.last_seed_stats is None
    assert (tm._seed_rate is None) == (why == "seed-off")
    for g_arr, w_arr in zip(got, tm._fill_ends_free_capped(q, ln, lens)):
        np.testing.assert_array_equal(g_arr, w_arr)


def test_seed_fill_error_propagates():
    """An exception of the seeded fill is not swallowed (the reference
    swallows every one unless POASTA_SEED_DEBUG is set)."""
    rng = random.Random(29)
    g, base = _backbone_graph(rng, 1200)
    reads = _reads(rng, base, 8, 600, 0.01)
    tm = BatchMapper(g, COSTS, device="cpu", aln_type=_semi(tcosts))
    q, ln = twf.pack_queries(reads, device="cpu")
    tm._ends_free_scores(reads, q, ln)
    with mock.patch.object(tmapper, "seed_scores",
                           side_effect=ValueError("boom")):
        with pytest.raises(ValueError, match="boom"):
            tm._ends_free_scores(reads, q, ln)


def test_reference_swallows_the_seed_fill_error(monkeypatch):
    """What the port does not copy: without POASTA_SEED_DEBUG the
    reference's seeded path hides the same error behind the full fill."""
    monkeypatch.delenv("POASTA_SEED_DEBUG")
    rng = random.Random(29)
    g, base = _backbone_graph(rng, 1200)
    reads = _reads(rng, base, 8, 600, 0.01)
    jm = JaxMapper(g, COSTS, aln_type=_semi(jcosts))
    jq, jl = jwf.pack_queries(reads)
    want = jm._ends_free_scores(reads, jq, jl, False)
    with mock.patch.object(jps, "pallas_seed_scores",
                           side_effect=ValueError("boom")):
        got = jm._ends_free_scores(reads, jq, jl, False)
    np.testing.assert_array_equal(np.asarray(got[0]), np.asarray(want[0]))
