"""The port's CUDA kernels against their plain PyTorch versions on the card.

Marked ``cuda``: without a card every test skips (decided inside the
``card`` fixture, never at import).  The machine with the card has no JAX,
so this file imports none; run it there from the repo root with

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py
"""

import random

import numpy as np
import pytest
import torch

from poasta_tpu_torch import (
    UNBOUNDED,
    BandedScorer,
    BatchMapper,
    EndsFree,
    GapAffine,
    NativeAligner,
    POAGraph,
    PoastaAligner,
    included,
    pack_queries,
)
from poasta_tpu_torch.aligner import banded as tbd
from poasta_tpu_torch.aligner.wavefront import (
    DeviceGraph,
    dp_fill_scores_ends_free,
    ends_free_device_params,
)
from poasta_tpu_torch.ops import cuda_fill as cf
from poasta_tpu_torch.ops import trace as tr

pytestmark = pytest.mark.cuda
torch.set_num_threads(1)

COSTS = GapAffine(4, 2, 6)


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda", 0)


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


def _case(seed, glen, n_reads, div=0.04, read_len=None):
    rng = random.Random(seed)
    base = "".join(rng.choice("ACGT") for _ in range(glen))
    g = POAGraph()
    g.add_alignment_with_weights("s0", base.encode(), None, [1] * glen)
    for i in range(1, 3):
        s = _mutate(rng, base, div).encode()
        _, aln, _ = NativeAligner(g).align(s, COSTS)
        g.add_alignment_with_weights(f"s{i}", s, aln, [1] * len(s))
    src = base if read_len is None else (base * (read_len // glen + 1))
    reads = [_mutate(rng, src[:read_len or glen], div).encode()
             for _ in range(n_reads)]
    return g, reads


def _banded_prep(flat, dg, lengths, ub, L):
    lens = lengths.cpu().numpy()
    ws, width, _, _ = tbd.band_windows(flat, int(lens.min()), int(lens.max()),
                                       COSTS, ub)
    return cf.prepare_banded(dg, COSTS, (ws // 128) * 128, width + 128, L)


@pytest.mark.parametrize("ub", [120, 400])
@pytest.mark.parametrize("capped", [False, True])
def test_banded_kernel_matches_plain(card, ub, capped):
    g, reads = _case(1, 300, 64)
    flat = g.flatten()
    dg = DeviceGraph.build(flat, device=card)
    q, lengths = pack_queries(reads, device=card)
    prep = _banded_prep(flat, dg, lengths, ub, int(q.shape[1]))
    max_run = tbd.ins_run_cap(COSTS, ub, prep["width"]) if capped else 0
    before = cf.banded_end_rows.launches
    got = cf.banded_end_rows(dg, q, COSTS, prep, max_run)
    torch.cuda.synchronize()
    assert cf.banded_end_rows.launches == before + 1
    assert torch.equal(got, cf.banded_end_rows_plain(dg, q, COSTS, prep,
                                                     max_run))


def test_banded_kernel_rings_in_global_memory(card):
    """A 6 kb full-width band passes the 227 KB of shared memory with its
    scratch rows and rings together: the rings move to global memory."""
    g, reads = _case(2, 6000, 8, div=0.02)
    flat = g.flatten()
    dg = DeviceGraph.build(flat, device=card)
    q, lengths = pack_queries(reads, device=card)
    L = int(q.shape[1])
    prep = cf.prepare_banded(dg, COSTS, np.zeros(flat.n_nodes, np.int32),
                             L, L)
    plan = cf.banded_plan(dg.window, prep["width"], prep["margin"])
    if plan["placement"] == "smem":
        pytest.fail(f"expected a global-memory placement, got {plan}")
    got = cf.banded_end_rows(dg, q, COSTS, prep, 0)
    assert torch.equal(got, cf.banded_end_rows_plain(dg, q, COSTS, prep, 0))
    exact = [NativeAligner(g).align(r, COSTS)[0] for r in reads[:2]]
    scores = cf.banded_scores(dg, q, lengths, COSTS, prep).cpu().numpy()
    assert list(scores[:2]) == exact


@pytest.mark.parametrize("read_len", [None, 12000])
def test_fill_kernel_matches_plain(card, read_len):
    """Short rows keep the working set in shared memory; a 12 kb row
    puts even the scratch rows in global memory."""
    g, reads = _case(3, 250, 64 if read_len is None else 2,
                     read_len=read_len)
    dg = DeviceGraph.build(g.flatten(), device=card)
    q, lengths = pack_queries(reads, device=card)
    plan = cf.fill_plan(dg.window, int(q.shape[1]))
    assert plan["placement"] == ("smem" if read_len is None else "global")
    before = cf.fill_end_rows.launches
    got = cf.fill_end_rows(dg, q, COSTS)
    torch.cuda.synchronize()
    assert cf.fill_end_rows.launches == before + 1
    assert torch.equal(got, cf.fill_end_rows_plain(dg, q, COSTS))
    if read_len is None:
        na = NativeAligner(g)
        scores = cf.fill_scores(dg, q, lengths, COSTS).cpu().numpy()
        assert [int(s) for s in scores[:4]] == \
            [na.align(r, COSTS)[0] for r in reads[:4]]


def test_score_batch_on_card_matches_native(card):
    g, reads = _case(4, 500, 64, div=0.03)
    mapper = BatchMapper(g, COSTS, device=card)
    before = cf.banded_end_rows.launches
    scores = mapper.score_batch(reads)
    assert cf.banded_end_rows.launches > before
    na = NativeAligner(g)
    assert list(scores) == [na.align(r, COSTS)[0] for r in reads]


@pytest.mark.parametrize("seed", range(6))
def test_random_batches_on_card_match_native(card, seed):
    """Randomised sweep: graph size, divergence and read count drawn from
    the seed; every score on the card equals the native exact engine's."""
    rng = random.Random(100 + seed)
    g, reads = _case(seed, rng.randrange(40, 900), rng.randrange(1, 80),
                     div=rng.choice([0.01, 0.04, 0.1, 0.15]))
    mapper = BatchMapper(g, COSTS, device=card)
    na = NativeAligner(g)
    assert list(mapper.score_batch(reads)) == \
        [na.align(r, COSTS)[0] for r in reads]


def _trace_tier(card, g, reads, Wb):
    """B18 and the decode against their plain versions at one tier of the
    device traceback; returns (placement, verified count)."""
    flat = g.flatten()
    mapper = BatchMapper(g, COSTS, device=card)
    scores = mapper.score_batch(reads)
    dg = mapper.dg
    q, lengths = pack_queries(reads, device=card)
    k_tier, k_full = tr.gap_budgets(flat, scores, COSTS, Wb)
    inp, ok = tr.tier_inputs(dg, flat, q, lengths.cpu().numpy(), k_tier, Wb)
    before = tr.trace_fill.launches
    aval, ptr = tr.trace_fill(dg, **inp, costs=COSTS, Wb=Wb)
    torch.cuda.synchronize()
    assert tr.trace_fill.launches == before + 1
    aval_p, ptr_p = tr.trace_fill_plain(dg, **inp, costs=COSTS, Wb=Wb)
    assert torch.equal(aval, aval_p)
    assert torch.equal(ptr, ptr_p)
    verified = (aval.cpu().numpy() == scores) & ok
    t_max = int(-(-(int(lengths.max()) + int(k_full.max()) + 8) // 512) * 512)
    walk = (tr.pred_rank_table(dg, card), inp["wstarts"], inp["anchor_r"],
            inp["anchor_j"], dg.end_rank_i,
            torch.as_tensor(verified, device=card), t_max)
    before = tr.trace_decode.launches
    ops, done = tr.trace_decode(ptr, *walk)
    torch.cuda.synchronize()
    assert tr.trace_decode.launches == before + 1
    ops_p, done_p = tr.decode_plain(ptr, *walk)
    assert torch.equal(ops, ops_p)
    assert torch.equal(done, done_p)
    return tr.trace_plan(dg.window, Wb)["placement"], int(verified.sum())


@pytest.mark.parametrize("Wb", [256, 4096])
def test_trace_kernels_match_plain(card, Wb):
    """Rings in shared memory at Wb 256 and in global memory at Wb 4096
    (W = 4 rings of 4096 lanes pass 227 KB with the scratch rows); the
    last read carries a 120-base deletion that the first tier cannot
    verify."""
    g, reads = _case(5, 300, 63)
    reads.append(reads[0][:80] + reads[0][200:])
    placement, n_verified = _trace_tier(card, g, reads, Wb)
    assert placement == ("smem" if Wb == 256 else "rings-global")
    assert n_verified >= 60


def test_align_batch_traces_on_card(card):
    """The banded route on the card: every read traced on the device, and
    the alignments equal the native banded backtrace's."""
    g, reads = _case(6, 600, 64, div=0.03)
    mapper = BatchMapper(g, COSTS, device=card)
    mapper.DENSE_TABLE_BUDGET = 0
    before = tr.trace_fill.launches
    out = mapper.align_batch(reads)
    assert tr.trace_fill.launches > before
    assert mapper.last_banded_stats["device_traced"] == len(reads)
    na = NativeAligner(g)
    for (score, aln), r in zip(out, reads):
        ns, naln = na.align_banded(r, COSTS, ub=score)
        assert ns == score
        assert list(aln) == list(naln)


def test_trace_serves_graph_past_reference_gate(card, monkeypatch):
    """B19 folds into B18: a 45k-rank graph is past the reference's 1 MiB
    prefetch gate (where it needed the streamed big kernel, or the host);
    on the default route the one trace kernel aligns it."""
    monkeypatch.delenv("POASTA_DEVICE_TRACE", raising=False)
    rng = random.Random(9)
    base = "".join(rng.choice("ACGT") for _ in range(45000))
    g = POAGraph()
    g.add_alignment_with_weights("s0", base.encode(), None, [1] * len(base))
    reads = [_mutate(rng, base, 0.01).encode() for _ in range(2)]
    mapper = BatchMapper(g, COSTS, device=card)
    before = tr.trace_fill.launches
    out = mapper.align_batch(reads)
    assert tr.trace_fill.launches > before
    assert mapper.last_banded_stats["device_traced"] == 2
    na = NativeAligner(g)
    for (score, aln), r in zip(out, reads):
        ns, naln = na.align_banded(r, COSTS, ub=score)
        assert ns == score
        assert list(aln) == list(naln)


# ---- ends-free and drifting-window fills (B3, B4, B5, B6) --------------------

SEMI_GLOBAL = EndsFree(UNBOUNDED, included(0), UNBOUNDED, UNBOUNDED)
BOUNDED = EndsFree(UNBOUNDED, included(40), included(0), included(40))


def _sv_case(seed, glen=1000, n_reads=64):
    """A graph with a deletion allele spanning most of it and reads from
    both alleles: lengths spread past the drift threshold."""
    rng = random.Random(seed)
    base = "".join(rng.choice("ACGT") for _ in range(glen))
    variant = base[:80] + base[glen - 80:]
    g = POAGraph()
    g.add_alignment_with_weights("s0", base.encode(), None, [1] * glen)
    _, aln, _ = NativeAligner(g).align(variant.encode(), COSTS)
    g.add_alignment_with_weights("s1", variant.encode(), aln,
                                 [1] * len(variant))
    reads = [_mutate(rng, base if i % 2 else variant, 0.015).encode()
             for i in range(n_reads)]
    return g, reads


def _drift_layout(flat, dg, q, lengths, ub, aln_type=None):
    lens = lengths.cpu().numpy()
    n_min, n_max = int(lens.min()), int(lens.max())
    S = tbd.drift_steps_for(n_min, n_max)
    ws, width, sr = tbd.band_windows_drift(flat, n_min, n_max, COSTS, ub, S,
                                           aln_type=aln_type)
    L = int(q.shape[1])
    Lp = max(L, -(-(int(ws.max()) + width) // 128) * 128)
    prep = cf.prepare_banded_drift(dg, COSTS, ws, width, sr, S, Lp)
    qpad = torch.nn.functional.pad(q, (prep["mq"], Lp - L))
    return prep, qpad, n_min


@pytest.mark.parametrize("ub", [60, 150])
@pytest.mark.parametrize("capped", [False, True])
def test_drift_kernel_matches_plain(card, ub, capped):
    """B3: the circular ring rows give what the literal rolls give."""
    g, reads = _sv_case(11)
    flat = g.flatten()
    dg = DeviceGraph.build(flat, device=card)
    q, lengths = pack_queries(reads, device=card)
    prep, qpad, n_min = _drift_layout(flat, dg, q, lengths, ub)
    assert prep["mq"] > 0 and prep["S"] >= 4
    max_run = tbd.ins_run_cap(COSTS, ub, prep["width"]) if capped else 0
    nbs = cf.drift_units(lengths, n_min)
    before = cf.drift_end_rows.launches
    got = cf.drift_end_rows(dg, qpad, nbs, COSTS, prep, max_run)
    torch.cuda.synchronize()
    assert cf.drift_end_rows.launches == before + 1
    assert torch.equal(got, cf.drift_end_rows_plain(dg, qpad, nbs, COSTS,
                                                    prep, max_run))
    scores = cf.drift_scores(dg, qpad, lengths, COSTS, prep, n_min,
                             max_run=max_run).cpu().numpy()
    na = NativeAligner(g)
    ok = scores <= ub
    assert ok.any()
    assert [int(s) for s in scores[ok]] == \
        [na.align(r, COSTS)[0] for r, v in zip(reads, ok) if v]


@pytest.mark.parametrize("capped", [False, True])
def test_drift_ef_kernel_matches_plain(card, capped):
    """B6: best tiles equal the plain version's under the bounded span."""
    g, reads = _sv_case(12)
    flat = g.flatten()
    dg = DeviceGraph.build(flat, device=card)
    q, lengths = pack_queries(reads, device=card)
    ub = 120
    prep, qpad, n_min = _drift_layout(flat, dg, q, lengths, ub, BOUNDED)
    _, end_ok, jlo = ends_free_device_params(flat, BOUNDED, lengths,
                                             dg.n_nodes_padded)
    max_run = tbd.ins_run_cap(COSTS, ub, prep["width"]) if capped else 0
    nbs = cf.drift_units(lengths, n_min)
    before = cf.drift_ef_best_rows.launches
    got = cf.drift_ef_best_rows(dg, qpad, nbs, lengths, jlo, COSTS, prep,
                                end_ok, max_run)
    torch.cuda.synchronize()
    assert cf.drift_ef_best_rows.launches == before + 1
    assert torch.equal(got, cf.drift_ef_best_rows_plain(
        dg, qpad, nbs, lengths, jlo, COSTS, prep, end_ok, max_run))


@pytest.mark.parametrize("span", [SEMI_GLOBAL, BOUNDED],
                         ids=["semi-global", "bounded"])
@pytest.mark.parametrize("capped", [False, True])
def test_ef_kernel_matches_plain(card, span, capped):
    """B5: the positional best row, free graph begin or not."""
    g, reads = _case(13, 600, 64, div=0.03)
    reads = [r[10:len(r) - 20] for r in reads]
    flat = g.flatten()
    dg = DeviceGraph.build(flat, device=card)
    q, lengths = pack_queries(reads, device=card)
    lens = lengths.cpu().numpy()
    ub = 150
    ws, width, _, _ = tbd.band_windows(flat, int(lens.min()),
                                       int(lens.max()), COSTS, ub,
                                       aln_type=span)
    prep = cf.prepare_banded(dg, COSTS, (ws // 128) * 128, width + 128,
                             int(q.shape[1]))
    assert prep["width"] < int(q.shape[1])
    fs, end_ok, jlo = ends_free_device_params(flat, span, lengths,
                                              dg.n_nodes_padded)
    max_run = tbd.ins_run_cap(COSTS, ub, prep["width"]) if capped else 0
    before = cf.ef_best_rows.launches
    got = cf.ef_best_rows(dg, q, COSTS, prep, fs, end_ok, max_run)
    torch.cuda.synchronize()
    assert cf.ef_best_rows.launches == before + 1
    assert torch.equal(got, cf.ef_best_rows_plain(dg, q, COSTS, prep, fs,
                                                  end_ok, max_run))


@pytest.mark.parametrize("read_len,max_run", [(None, 0), (None, 16),
                                              (12000, 64)])
def test_bounded_kernel_matches_plain(card, read_len, max_run):
    """B4: in shared memory at short rows, in global memory at a 12 kb
    row; capped and uncapped."""
    g, reads = _case(14, 250, 64 if read_len is None else 2,
                     read_len=read_len)
    flat = g.flatten()
    dg = DeviceGraph.build(flat, device=card)
    q, lengths = pack_queries(reads, device=card)
    plan = cf.bounded_plan(dg.window, int(q.shape[1]))
    assert plan["placement"] == ("smem" if read_len is None else "global")
    fs, end_ok, jlo = ends_free_device_params(flat, SEMI_GLOBAL, lengths,
                                              dg.n_nodes_padded)
    before = cf.bounded_best_rows.launches
    got = cf.bounded_best_rows(dg, q, COSTS, fs, end_ok, max_run)
    torch.cuda.synchronize()
    assert cf.bounded_best_rows.launches == before + 1
    assert torch.equal(got, cf.bounded_best_rows_plain(dg, q, COSTS, fs,
                                                       end_ok, max_run))


def test_ends_free_scores_on_card_match_exact_engine(card):
    """The slice on the card: fragments under the semi-global span through
    the ladder (B5) and its capped full fill (B4), mixed lengths under the
    bounded span (B6) and the global span (B3); scores equal the exact
    full fill's, and sampled reads the exact engine's."""
    g, reads = _case(15, 700, 64, div=0.03)
    frags = [r[(7 * i) % 60:len(r) - (11 * i) % 90]
             for i, r in enumerate(reads)]
    scorer = BandedScorer(g.flatten(), COSTS, device=card,
                          aln_type=SEMI_GLOBAL)
    q, lengths = pack_queries(frags, device=card)
    before = cf.ef_best_rows.launches, cf.bounded_best_rows.launches
    got = scorer.scores(q, lengths, ub=60, max_retries=1)
    assert cf.ef_best_rows.launches > before[0]
    assert cf.bounded_best_rows.launches > before[1]
    exact = dp_fill_scores_ends_free(scorer.dg, scorer.flat, q, lengths,
                                     COSTS, SEMI_GLOBAL).cpu().numpy()
    assert (got == exact).all()
    engine = PoastaAligner(COSTS, SEMI_GLOBAL, heuristic="dijkstra")
    for i in (0, 9, 31):
        assert engine.align(g, frags[i]).score == int(got[i])

    g, reads = _sv_case(16)
    na = NativeAligner(g)
    for span, counter in ((None, cf.drift_end_rows),
                          (BOUNDED, cf.drift_ef_best_rows)):
        mapper = BatchMapper(g, COSTS, device=card, aln_type=span)
        q, lengths = pack_queries(reads, device=card)
        before = counter.launches
        got = mapper.scorer.scores(q, lengths, ub=60)  # a drifting tier
        assert counter.launches > before, span
        assert (mapper.score_batch(reads) == got).all()
        if span is None:
            assert list(got) == [na.align(r, COSTS)[0] for r in reads]
        else:
            exact = dp_fill_scores_ends_free(
                mapper.dg, mapper.flat, q, lengths, COSTS, span)
            assert (got == exact.cpu().numpy()).all()
