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
from poasta_tpu_torch.aligner import GapAffine2Piece
from poasta_tpu_torch.aligner import banded as tbd
from poasta_tpu_torch.aligner.wavefront import (
    DeviceGraph,
    alignment_cost,
    dp_fill_scores_ends_free,
    ends_free_device_params,
)
from poasta_tpu_torch.ops import cuda_fill as cf
from poasta_tpu_torch.ops import trace as tr

pytestmark = pytest.mark.cuda
torch.set_num_threads(1)

COSTS = GapAffine(4, 2, 6)
# the penalties of poasta align -n 4 -g 8,24 -e 2,1
COSTS_2P = GapAffine2Piece(4, 2, 8, 1, 24)


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
    """A 7 kb full-width band's rings pass the 227 KB of shared memory
    (W 4 x 2 rings x 7,424 lanes): they move to global memory."""
    g, reads = _case(2, 7000, 8, div=0.02)
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
    """Short rows take the register body, rings in shared memory; a 12 kb
    row takes the rows body, its scratch rows in global memory too."""
    g, reads = _case(3, 250, 64 if read_len is None else 2,
                     read_len=read_len)
    dg = DeviceGraph.build(g.flatten(), device=card)
    q, lengths = pack_queries(reads, device=card)
    plan = cf.fill_plan(dg.window, int(q.shape[1]))
    assert plan["placement"] == ("smem" if read_len is None else "global")
    assert plan["body"] == ("registers" if read_len is None else "rows")
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
    _decode_held(ptr, walk)
    return tr.trace_plan(dg.window, Wb), dg.window, int(verified.sum())


def _decode_held(ptr, walk):
    """The decode kernel against its plain version on the same planes (a
    read a warp: at B not a multiple of the block's warps, the grid's last
    block has empty warps); the wrapper's count moves once.  Returns the
    kernel's ops and done."""
    want = tr.decode_plain(ptr, *walk)
    before = tr.trace_decode.launches
    got = tr.trace_decode(ptr, *walk)
    torch.cuda.synchronize()
    assert tr.trace_decode.launches == before + 1
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    return got


def _decode_planes(card, seed, B, Wb, P, n=120, t_max=448):
    """Random pointer planes on the card, as the trace fill lays them out:
    every rank's predecessors lie below it (padding columns 0), window
    starts step 0 or 128 a rank, pred columns below each rank's in-degree,
    2% origin words;
    anchors at the end rank or off it, inside their window or past either
    edge; some reads inactive.  Returns the decode's arguments."""
    gen = torch.Generator(device=card)
    gen.manual_seed(seed)

    def ints(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen, device=card,
                             dtype=torch.int32)

    def unit(shape):
        return torch.rand(shape, generator=gen, device=card)

    Np = -(-n // 64) * 64
    ranks = torch.arange(1, n, device=card).view(-1, 1)
    lo = (ranks - 6).clamp(min=0)
    pr = torch.zeros((Np, P), dtype=torch.int32, device=card)
    pr[1:n] = (lo + (unit((n - 1, P)) * (ranks - lo)).long()).int()
    deg = torch.ones((Np, 1, 1), dtype=torch.int32, device=card)
    deg[1:n, 0, 0] = ints(1, P + 1, (n - 1,))
    pr *= (torch.arange(P, device=card).view(1, -1) < deg.view(-1, 1)).int()
    steps = unit((B, Np)) < 0.08
    steps[:, 0] = False
    ws = (steps.cumsum(1) * 128).int()
    shape = (Np, B, Wb)
    u = unit(shape)
    msrc = (u > 0.6).int() + (u > 0.75).int() + (u > 0.98).int()
    # the fill's columns point at real predecessors only
    ptr = (msrc | ints(0, 1 << 20, shape) % deg << 2
           | ints(0, 2, shape) << 7 | ints(0, 2, shape) << 8
           | ints(0, 1 << 20, shape) % deg << 9)
    ptr[n:] = 0
    ar = torch.where(unit(B) < 0.7, n - 1, ints(0, n, (B,))).int()
    aj = (ws[torch.arange(B, device=card), ar.long()]
          + ints(-20, Wb + 60, (B,))).clamp(min=0).int()
    return (ptr.contiguous(), pr.view(-1), ws.contiguous(), ar, aj, n - 1,
            unit(B) < 0.85, t_max)


@pytest.mark.parametrize("Wb", tr.TIER_WIDTHS)
@pytest.mark.parametrize("B", [1, 31, 32, 33, 64, 65, 1024])
def test_decode_kernel_matches_plain_on_drawn_planes(card, B, Wb):
    """At the warp and block edges and every tier width, P in {1, 2, 4, 8,
    16, 32} across the grid: step words and done flags equal."""
    P = (1, 2, 4, 8, 16, 32)[(B + Wb // 256) % 6]
    ptr, *walk = _decode_planes(card, 1000 * B + Wb, B, Wb, P)
    _decode_held(ptr, walk)


@pytest.mark.parametrize("Wb", [256, 4096])
def test_trace_kernels_match_plain(card, Wb):
    """The trace at the narrowest and widest tiers, its rings where the
    register body's plan puts them (beside the warp carries, the warp
    words and the slot starts: in shared memory on this graph's ring at
    both widths); the last read carries a 120-base deletion that the first
    tier cannot verify."""
    g, reads = _case(5, 300, 63)
    reads.append(reads[0][:80] + reads[0][200:])
    plan, W, n_verified = _trace_tier(card, g, reads, Wb)
    assert plan["body"] == "registers" and plan["barriers_per_rank"] == 2
    assert plan["placement"] == _reg_expected_placement(W, Wb,
                                                        _trace_side(W))
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
    """B4: the register body in shared memory at short rows, the rows
    body in global memory at a 12 kb row; capped and uncapped."""
    g, reads = _case(14, 250, 64 if read_len is None else 2,
                     read_len=read_len)
    flat = g.flatten()
    dg = DeviceGraph.build(flat, device=card)
    q, lengths = pack_queries(reads, device=card)
    plan = cf.bounded_plan(dg.window, int(q.shape[1]), max_run=max_run)
    assert plan["placement"] == ("smem" if read_len is None else "global")
    assert plan["body"] == ("registers" if read_len is None else "rows")
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


# ---- ends-free alignment: B7, B8, the anchored trace ---------------------------

def _backbone(rng, n, skip_every):
    """A linear graph of ``n`` bases with an edge v -> v+3 every
    ``skip_every`` nodes (the bench's pangenome shape); (graph, bases)."""
    base = "".join(rng.choice("ACGT") for _ in range(n))
    g = POAGraph()
    g.add_alignment_with_weights("s0", base.encode(), None, [1] * n)
    for v in range(0, n - 3, skip_every):
        g.add_edge(v, v + 3, 0, 1)
    g.post_process()
    return g, base


def _backbone_case(seed, n, n_reads, read_len, div=0.015, skip_every=500):
    """:func:`_backbone` and reads cut from it."""
    rng = random.Random(seed)
    g, base = _backbone(rng, n, skip_every)
    reads = []
    for _ in range(n_reads):
        a = rng.randrange(0, n - read_len)
        reads.append(_mutate(rng, base[a:a + read_len], div).encode())
    return g, reads


@pytest.mark.parametrize("shape,max_run", [
    ((1500, 64, 600), 0), ((1500, 64, 600), 32),
    # past 21k ranks, where the reference switches to its streamed twin
    ((22000, 16, 900), 0), ((22000, 16, 900), 64)])
@pytest.mark.parametrize("span", [SEMI_GLOBAL, BOUNDED],
                         ids=["semi-global", "bounded"])
def test_bounded_ends_kernel_matches_plain(card, shape, max_run, span):
    g, reads = _backbone_case(21, *shape)
    flat = g.flatten()
    dg = DeviceGraph.build(flat, device=card)
    q, lengths = pack_queries(reads, device=card)
    free_start, end_ok, jlo = ends_free_device_params(
        flat, span, lengths, dg.n_nodes_padded)
    before = cf.bounded_end_rows.launches
    got = cf.bounded_end_rows(dg, q, COSTS, free_start, end_ok, max_run)
    torch.cuda.synchronize()
    assert cf.bounded_end_rows.launches == before + 1
    want = cf.bounded_end_rows_plain(dg, q, COSTS, free_start, end_ok,
                                     max_run)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    # the best row is the scoring fill's (B4)
    assert torch.equal(got[0], cf.bounded_best_rows(dg, q, COSTS, free_start,
                                                    end_ok, max_run))
    triple = cf.bounded_with_ends(dg, q, lengths, COSTS, free_start, end_ok,
                                  jlo, max_run)
    plain = cf.bounded_with_ends_plain(dg, q, lengths, COSTS, free_start,
                                       end_ok, jlo, max_run)
    assert all(torch.equal(a, b) for a, b in zip(triple, plain))


def _seed_call(card, shape, ub_rate):
    """Inputs of one seeded corridor call on a backbone case: hits,
    clusters and per-read bounds as the mapper makes them."""
    from poasta_tpu_torch.aligner.seeds import KmerIndex, propose_clusters
    from poasta_tpu_torch.aligner.wavefront import query_end_lo

    g, reads = _backbone_case(23, *shape)
    mapper = BatchMapper(g, COSTS, device=card, aln_type=SEMI_GLOBAL)
    q, lengths = pack_queries(reads, device=card)
    lens = np.array([len(r) for r in reads], np.int64)
    free_start, end_ok, _ = mapper.scorer._ef_params(lengths)
    idx = KmerIndex(mapper.flat)
    hits = idx.seed_hits(q.cpu().numpy(), lens)
    ub = (ub_rate * lens + 2 * COSTS.mismatch).astype(np.int64)
    a_star, b_star, n_cluster = propose_clusters(hits, ub // COSTS.gap_extend)
    assert (n_cluster > 0).all()
    jlo = query_end_lo(SEMI_GLOBAL, lens).astype(np.int64)
    return mapper, q, lens, free_start, end_ok, jlo, a_star, b_star, ub


@pytest.mark.parametrize("shape,ub_rate", [
    ((1500, 64, 600), 0.4), ((1500, 64, 600), 1.2),
    ((22000, 16, 900), 0.4)])
def test_seed_kernel_matches_plain(card, shape, ub_rate):
    """B8 on each read's own rank range, and on one range shared by the
    whole batch (as the reference's blocks share theirs)."""
    from poasta_tpu_torch.ops import seed as sd

    mapper, q, lens, fs, end_ok, jlo, a, b, ub = _seed_call(card, shape,
                                                            ub_rate)
    n = mapper.flat.n_nodes
    shared = (np.zeros(len(lens), np.int64), np.full(len(lens), n, np.int64))
    for ranges in (None, shared):
        before = sd.seed_end_states.launches
        got = sd.seed_scores(mapper.dg, mapper.flat, q, lens, COSTS, fs,
                             end_ok, jlo, a, b, ub, ranges=ranges)
        torch.cuda.synchronize()
        assert sd.seed_end_states.launches == before + 1
        want = sd.seed_scores_plain(mapper.dg, mapper.flat, q, lens, COSTS,
                                    fs, end_ok, jlo, a, b, ub, ranges=ranges)
        for g_arr, w_arr in zip(got, want):
            assert np.array_equal(g_arr, w_arr)
    exact = cf.bounded_with_ends(mapper.dg, q, torch.as_tensor(
        lens, device=card), COSTS, fs, end_ok,
        torch.as_tensor(jlo, device=card))
    hit = got[3] & (got[0] <= ub)
    assert hit.sum() >= len(lens) // 2
    for g_arr, e_arr in zip(got[:3], exact):
        assert np.array_equal(g_arr[hit], e_arr.cpu().numpy()[hit])


def _in_range(ptr, r_begin, r_end):
    """``ptr`` (Np, B, Wb) with each read's rows outside its rank range
    zeroed, as the plain trace fill leaves them: what a kernel's planes are
    compared on."""
    r = torch.arange(ptr.shape[0], device=ptr.device).view(-1, 1)
    walked = (r >= r_begin.view(1, -1)) & (r <= r_end.view(1, -1))
    return torch.where(walked.unsqueeze(-1), ptr, 0)


@pytest.mark.parametrize("shape,Wb", [((1500, 64, 600), 256),
                                      ((1500, 64, 600), 4096),
                                      ((22000, 8, 900), 512)])
def test_anchored_trace_kernel_matches_plain(card, shape, Wb):
    """B18 with ``free_start`` and per-read anchors, over every rank and
    over each read's rank range as ``trace_align`` gives it (``aval`` and
    the rows each read walks), and the decode over its planes."""
    g, reads = _backbone_case(25, *shape)
    flat = g.flatten()
    dg = DeviceGraph.build(flat, device=card)
    q, lengths = pack_queries(reads, device=card)
    free_start, end_ok, jlo = ends_free_device_params(
        flat, SEMI_GLOBAL, lengths, dg.n_nodes_padded)
    sc, er, ej = (t.cpu().numpy() for t in cf.bounded_with_ends(
        dg, q, lengths, COSTS, free_start, end_ok, jlo))
    k_tier, k_full = tr.gap_budgets(flat, sc, COSTS, Wb)
    lens = lengths.cpu().numpy()
    inp, ok = tr.tier_inputs(dg, flat, q, lens, k_tier, Wb, er, ej)
    before = tr.trace_fill.launches
    aval, ptr = tr.trace_fill(dg, **inp, costs=COSTS, Wb=Wb, free_start=True)
    torch.cuda.synchronize()
    assert tr.trace_fill.launches == before + 1
    aval_p, ptr_p = tr.trace_fill_plain(dg, **inp, costs=COSTS, Wb=Wb,
                                        free_start=True)
    assert torch.equal(aval, aval_p) and torch.equal(ptr, ptr_p)
    verified = (aval.cpu().numpy() == sc) & ok
    assert verified.sum() >= len(reads) // 2
    t_max = int(-(-(int(lens.max()) + int(k_full.max()) + 8) // 512) * 512)
    walk = (tr.pred_rank_table(dg, card), inp["wstarts"], inp["anchor_r"],
            inp["anchor_j"], dg.end_rank_i,
            torch.as_tensor(verified, device=card), t_max)
    ops, done = _decode_held(ptr, walk)
    assert bool(done[torch.as_tensor(verified, device=card)].all())
    rb, re = tr.trace_ranges(flat, lens, k_full, dg.n_nodes_padded, card, er,
                             ej, True)
    aval_r, ptr_r = tr.trace_fill(dg, **inp, costs=COSTS, Wb=Wb,
                                  free_start=True, r_begin=rb, r_end=re)
    aval_rp, ptr_rp = tr.trace_fill_plain(dg, **inp, costs=COSTS, Wb=Wb,
                                          free_start=True, r_begin=rb,
                                          r_end=re)
    assert torch.equal(aval_r, aval_rp)
    assert torch.equal(_in_range(ptr_r, rb, re), ptr_rp)
    assert np.array_equal((aval_r.cpu().numpy() == sc) & ok, verified)
    ops_r, done_r = _decode_held(ptr_r, walk)
    assert torch.equal(ops_r, ops) and torch.equal(done_r, done)


def test_anchored_trace_range_past_rank_0(card):
    """B18 over rank ranges that start past rank 0 (reads from the second
    half of a 3,000-node backbone): the kernel leaves the rows outside a
    read's range unwritten, whatever the planes held before (the
    allocator's block is filled with a pattern first), and ``aval``, the
    walked rows and the decoded chains equal the plain version's and the
    full walk's."""
    rng = random.Random(137)
    n, Wb = 3000, 256
    g, base = _backbone(rng, n, 500)
    reads = []
    for i in range(24):
        a = rng.randrange(1600, n - 700)
        read = base[a:a + 600]
        if i % 4 == 0:  # 40 matches, then a 30-base deletion
            read = base[a:a + 40] + base[a + 70:a + 630]
        reads.append(_mutate(rng, read, 0.015).encode())
    flat = g.flatten()
    dg = DeviceGraph.build(flat, device=card)
    q, lengths = pack_queries(reads, device=card)
    free_start, end_ok, jlo = ends_free_device_params(
        flat, SEMI_GLOBAL, lengths, dg.n_nodes_padded)
    sc, er, ej = (t.cpu().numpy() for t in cf.bounded_with_ends(
        dg, q, lengths, COSTS, free_start, end_ok, jlo))
    lens = lengths.cpu().numpy()
    k_tier, k_full = tr.gap_budgets(flat, sc, COSTS, Wb)
    inp, ok = tr.tier_inputs(dg, flat, q, lens, k_tier, Wb, er, ej)
    rb, re = tr.trace_ranges(flat, lens, k_full, dg.n_nodes_padded, card, er,
                             ej, True)
    assert int(rb.min()) > 1000
    aval, ptr = tr.trace_fill(dg, **inp, costs=COSTS, Wb=Wb, free_start=True)
    torch.cuda.synchronize()
    del ptr
    # the next planes reuse the freed block: fill it with a pattern the
    # ranged fill must leave where it walks nothing
    junk = torch.full((dg.n_nodes_padded, len(reads), Wb), 0x5A5A5A5A,
                      dtype=torch.int32, device=card)
    del junk
    aval_r, ptr_r = tr.trace_fill(dg, **inp, costs=COSTS, Wb=Wb,
                                  free_start=True, r_begin=rb, r_end=re)
    torch.cuda.synchronize()
    aval_p, ptr_p = tr.trace_fill_plain(dg, **inp, costs=COSTS, Wb=Wb,
                                        free_start=True, r_begin=rb,
                                        r_end=re)
    assert torch.equal(aval_r, aval_p)
    assert torch.equal(_in_range(ptr_r, rb, re), ptr_p)
    # below every read's range: the pattern, never written
    assert bool((ptr_r[:int(rb.min())] == 0x5A5A5A5A).all())
    verified = (aval.cpu().numpy() == sc) & ok
    assert verified.sum() >= len(reads) - 2
    assert np.array_equal((aval_r.cpu().numpy() == sc) & ok, verified)
    t_max = int(-(-(int(lens.max()) + int(k_full.max()) + 8) // 512) * 512)
    walk = (tr.pred_rank_table(dg, card), inp["wstarts"], inp["anchor_r"],
            inp["anchor_j"], dg.end_rank_i,
            torch.as_tensor(verified, device=card), t_max)
    ops_r, done_r = _decode_held(ptr_r, walk)
    ops, done = tr.trace_decode(tr.trace_fill(
        dg, **inp, costs=COSTS, Wb=Wb, free_start=True)[1], *walk)
    assert torch.equal(ops_r, ops) and torch.equal(done_r, done)
    assert bool(done_r[torch.as_tensor(verified, device=card)].all())


def test_anchored_trace_and_decode_past_2_31_plane_elements(card):
    """The 64-bit plane offsets at the smallest size that needs them: 64
    reads of 2,000 bases on a 140,000-node backbone, every read's corridor
    at ranks past 131,072, so that each pointer row B18 writes and the
    decode reads lies past element 2^31 of the (Np, 64, 256) planes.  The
    decode kernel equals its plain version, every read verifies, and each
    decoded alignment costs its score (B18's plain version would walk
    140,000 ranks: minutes)."""
    from poasta_tpu_torch.aligner.alignment import ArrayAlignment

    rng = random.Random(131)
    n, B, read_len, Wb = 140_000, 64, 2_000, 256
    g, base = _backbone(rng, n, 500)
    reads = []
    for _ in range(B):
        a = rng.randrange(132_500, n - read_len)
        reads.append(_mutate(rng, base[a:a + read_len], 0.015).encode())
    flat = g.flatten()
    dg = DeviceGraph.build(flat, device=card)
    Np = dg.n_nodes_padded
    past = 2 ** 31 // (B * Wb)
    assert Np * B * Wb > 2 ** 31 and past == 131_072
    q, lengths = pack_queries(reads, device=card)
    free_start, end_ok, jlo = ends_free_device_params(
        flat, SEMI_GLOBAL, lengths, Np)
    sc, er, ej = (t.cpu().numpy() for t in cf.bounded_with_ends(
        dg, q, lengths, COSTS, free_start, end_ok, jlo))
    lens = lengths.cpu().numpy()
    k_tier, k_full = tr.gap_budgets(flat, sc, COSTS, Wb)
    inp, ok = tr.tier_inputs(dg, flat, q, lens, k_tier, Wb, er, ej)
    # each read's corridor, as the schedule bounds it
    dmin, dmax = tr._sched_potentials(flat, Np, card)

    def put(v):
        return torch.as_tensor(np.asarray(v, dtype=np.int64), device=card)

    er64 = er.astype(np.int64)
    _, _, _, r_lo, _, has = tr._schedule_body(
        dmin, dmax, put(lens), put(k_tier), put(ej),
        put(flat.min_dist_from_start[er64]),
        put(flat.max_dist_from_start[er64]), flat.n_nodes, Wb)
    assert bool(has.all()) and int(r_lo.min()) >= past
    aval, ptr = tr.trace_fill(dg, **inp, costs=COSTS, Wb=Wb, free_start=True)
    assert tuple(ptr.shape) == (Np, B, Wb)
    verified = (aval.cpu().numpy() == sc) & ok
    assert verified.all()
    t_max = int(-(-(int(lens.max()) + int(k_full.max()) + 8) // 512) * 512)
    walk = (tr.pred_rank_table(dg, card), inp["wstarts"], inp["anchor_r"],
            inp["anchor_j"], dg.end_rank_i,
            torch.as_tensor(verified, device=card), t_max)
    ops, done = _decode_held(ptr, walk)
    assert bool(done.all())
    ops = ops.cpu().numpy()
    for b, read in enumerate(reads):
        rpos, qpos = tr.replay_steps(ops[b], int(ej[b]), flat.node_of_rank)
        aln = ArrayAlignment(rpos, qpos)
        steps = ops[b][ops[b] != 0]
        assert int((steps >> 4).min()) >= past  # every rank it walked
        assert alignment_cost(g, read, aln, COSTS) == int(sc[b])


def test_seeded_align_batch_matches_full_fill_route(card, monkeypatch):
    """``align_batch`` under the semi-global span on a graph large enough
    to seed by itself: the seeded batches equal the POASTA_SEED=0 route
    (full fill every batch) and the POASTA_DEVICE_TRACE=0 route."""
    from poasta_tpu_torch.ops import seed as sd

    g, reads = _backbone_case(27, 9000, 32, 1200)
    mapper = BatchMapper(g, COSTS, device=card, aln_type=SEMI_GLOBAL)
    first = mapper.align_batch(reads)
    before = (sd.seed_end_states.launches, tr.trace_fill.launches,
              cf.bounded_end_rows.launches)
    assert before[2] > 0 and mapper.last_seed_stats is None
    got = mapper.align_batch(reads)
    assert sd.seed_end_states.launches > before[0]
    assert tr.trace_fill.launches > before[1]
    assert mapper.last_seed_stats["seeded"] >= 24
    assert mapper.last_ends_free_stats["exact_fallback"] == 0
    pairs = [(s, list(a)) for s, a in got]
    assert pairs == [(s, list(a)) for s, a in first]
    monkeypatch.setenv("POASTA_DEVICE_TRACE", "0")
    assert [(s, list(a)) for s, a in mapper.align_batch(reads)] == pairs
    monkeypatch.delenv("POASTA_DEVICE_TRACE")
    monkeypatch.setenv("POASTA_SEED", "0")
    full = BatchMapper(g, COSTS, device=card, aln_type=SEMI_GLOBAL)
    full.align_batch(reads)
    assert [(s, list(a)) for s, a in full.align_batch(reads)] == pairs
    assert full.last_seed_stats is None


# ---- two-piece costs: B16, B17, B12 ------------------------------------


def _prep_2p(flat, dg, lengths, ub, L):
    lens = lengths.cpu().numpy()
    ws, width, _, _ = tbd.band_windows(flat, int(lens.min()), int(lens.max()),
                                       COSTS_2P, ub)
    return cf.prepare_banded(dg, COSTS_2P, (ws // 128) * 128, width + 128, L)


@pytest.mark.parametrize("ub", [250, 600])
@pytest.mark.parametrize("capped", [False, True])
def test_banded_2p_kernel_matches_plain(card, ub, capped):
    """B16: end rows equal the plain version's, over-estimated rows
    included; verified scores equal the native engine's."""
    g, reads = _case(31, 400, 64, div=0.05)
    flat = g.flatten()
    dg = DeviceGraph.build(flat, device=card)
    q, lengths = pack_queries(reads, device=card)
    L = int(q.shape[1])
    prep = _prep_2p(flat, dg, lengths, ub, L)
    q = torch.nn.functional.pad(q, (0, max(0, prep["L"] - L)))
    max_run = tbd.ins_run_cap(COSTS_2P, ub, prep["width"]) if capped else 0
    before = cf.banded_end_rows_2p.launches
    got = cf.banded_end_rows_2p(dg, q, COSTS_2P, prep, max_run)
    torch.cuda.synchronize()
    assert cf.banded_end_rows_2p.launches == before + 1
    assert torch.equal(got, cf.banded_end_rows_2p_plain(dg, q, COSTS_2P,
                                                        prep, max_run))
    scores = cf.banded_scores_2p(dg, q, lengths, COSTS_2P, prep,
                                 max_run).cpu().numpy()
    ok = scores <= ub
    assert ok.any()
    na = NativeAligner(g)
    assert [int(s) for s in scores[ok]] == \
        [na.align_banded(r, COSTS_2P)[0] for r, v in zip(reads, ok) if v]


def test_banded_2p_kernel_past_the_reference_smem_budget(card):
    """B16 on a 22k-rank graph (the reference's scalar-prefetch budget
    sends such graphs to its streamed kernels): rank tables come from
    global memory at any size."""
    g, reads = _case(32, 22000, 4, div=0.002)
    flat = g.flatten()
    assert flat.n_nodes > 22000
    dg = DeviceGraph.build(flat, device=card)
    q, lengths = pack_queries(reads, device=card)
    ub = 1500
    prep = _prep_2p(flat, dg, lengths, ub, int(q.shape[1]))
    max_run = tbd.ins_run_cap(COSTS_2P, ub, prep["width"])
    got = cf.banded_end_rows_2p(dg, q, COSTS_2P, prep, max_run)
    assert torch.equal(got, cf.banded_end_rows_2p_plain(dg, q, COSTS_2P,
                                                        prep, max_run))
    scores = cf.banded_scores_2p(dg, q, lengths, COSTS_2P, prep,
                                 max_run).cpu().numpy()
    assert (scores <= ub).all()
    na = NativeAligner(g)
    assert [int(s) for s in scores[:2]] == \
        [na.align_banded(r, COSTS_2P)[0] for r in reads[:2]]


@pytest.mark.parametrize("capped", [False, True])
def test_drift_2p_kernel_matches_plain(card, capped):
    """B17: all three rings roll with the read's frame as the literal rolls
    of the plain version do."""
    g, reads = _sv_case(33)
    flat = g.flatten()
    dg = DeviceGraph.build(flat, device=card)
    q, lengths = pack_queries(reads, device=card)
    lens = lengths.cpu().numpy()
    n_min, n_max = int(lens.min()), int(lens.max())
    S = tbd.drift_steps_for(n_min, n_max)
    ub = 80
    ws, width, sr = tbd.band_windows_drift(flat, n_min, n_max, COSTS_2P, ub,
                                           S)
    L = int(q.shape[1])
    assert width < L  # the scorer takes drift only narrower than the row
    Lp = max(L, -(-(int(ws.max()) + width) // 128) * 128)
    prep = cf.prepare_banded_drift(dg, COSTS_2P, ws, width, sr, S, Lp)
    qpad = torch.nn.functional.pad(q, (prep["mq"], Lp - L))
    assert prep["mq"] > 0 and S >= 4
    max_run = tbd.ins_run_cap(COSTS_2P, ub, width) if capped else 0
    nbs = cf.drift_units(lengths, n_min)
    before = cf.drift_end_rows_2p.launches
    got = cf.drift_end_rows_2p(dg, qpad, nbs, COSTS_2P, prep, max_run)
    torch.cuda.synchronize()
    assert cf.drift_end_rows_2p.launches == before + 1
    assert torch.equal(got, cf.drift_end_rows_2p_plain(dg, qpad, nbs,
                                                       COSTS_2P, prep,
                                                       max_run))
    scores = cf.drift_scores_2p(dg, qpad, lengths, COSTS_2P, prep, n_min,
                                max_run=max_run).cpu().numpy()
    ok = scores <= ub
    assert ok.sum() >= len(reads) // 4
    na = NativeAligner(g)
    assert [int(s) for s in scores[ok][:8]] == \
        [na.align_banded(r, COSTS_2P)[0] for r, v in zip(reads, ok) if v][:8]


@pytest.mark.parametrize("read_len", [None, 12000])
def test_fill_2p_kernel_matches_plain(card, read_len):
    """B12: short rows take the register body, rings in shared memory; a
    12 kb row takes the rows body, its scratch rows in global memory
    too."""
    g, reads = _case(34, 250, 64 if read_len is None else 2,
                     read_len=read_len)
    dg = DeviceGraph.build(g.flatten(), device=card)
    q, lengths = pack_queries(reads, device=card)
    plan = cf.fill_plan(dg.window, int(q.shape[1]), two_piece=True)
    assert plan["placement"] == ("smem" if read_len is None else "global")
    assert plan["body"] == ("registers" if read_len is None else "rows")
    before = cf.fill_end_rows_2p.launches
    got = cf.fill_end_rows_2p(dg, q, COSTS_2P)
    torch.cuda.synchronize()
    assert cf.fill_end_rows_2p.launches == before + 1
    assert torch.equal(got, cf.fill_end_rows_2p_plain(dg, q, COSTS_2P))
    na = NativeAligner(g)
    scores = cf.fill_scores_2p(dg, q, lengths, COSTS_2P).cpu().numpy()
    assert [int(s) for s in scores[:4]] == \
        [na.align_banded(r, COSTS_2P)[0] for r in reads[:4]]


def test_two_piece_batch_mapper_on_card(card):
    """score_batch under two-piece costs equals the native engine; every
    align_batch alignment reproduces its score (the leading insertion run
    a backtrace does not emit as pairs counted back in)."""
    g, reads = _case(35, 600, 64, div=0.04)
    mapper = BatchMapper(g, COSTS_2P, device=card)
    before = cf.banded_end_rows_2p.launches
    scores = mapper.score_batch(reads)
    assert cf.banded_end_rows_2p.launches > before
    na = NativeAligner(g)
    assert list(scores) == [na.align_banded(r, COSTS_2P)[0] for r in reads]
    out = mapper.align_batch(reads)
    assert [s for s, _ in out] == list(scores)
    assert mapper.last_banded_stats == {"device_traced": 0,
                                        "host_backtraced": len(reads)}
    for r, (s, aln) in zip(reads, out):
        lead = next(p.qpos for p in aln if p.qpos is not None)
        extra = 0 if lead == 0 else (COSTS_2P.gap_open + COSTS_2P.gap_extend
                                     + (lead - 1) * COSTS_2P.gap_extend2)
        assert alignment_cost(g, r, aln, COSTS_2P) + extra == s


# ---- two-piece ends-free: B13, B14 (B15), and the free-end fills B2f, B12f -----

@pytest.mark.parametrize("max_run", [0, 32])
@pytest.mark.parametrize("span", [SEMI_GLOBAL, BOUNDED],
                         ids=["semi-global", "bounded"])
def test_bounded_2p_kernel_matches_plain(card, max_run, span):
    """B13: best rows and scores equal the plain version's, with a free
    graph begin and without, uncapped and capped."""
    g, reads = _backbone_case(22, 1500, 64, 600)
    flat = g.flatten()
    dg = DeviceGraph.build(flat, device=card)
    q, lengths = pack_queries(reads, device=card)
    fs, end_ok, jlo = ends_free_device_params(flat, span, lengths,
                                              dg.n_nodes_padded, True)
    before = cf.bounded_best_rows_2p.launches
    got = cf.bounded_best_rows_2p(dg, q, COSTS_2P, fs, end_ok, max_run)
    torch.cuda.synchronize()
    assert cf.bounded_best_rows_2p.launches == before + 1
    assert torch.equal(got, cf.bounded_best_rows_2p_plain(
        dg, q, COSTS_2P, fs, end_ok, max_run))
    scores = cf.bounded_scores_2p(dg, q, lengths, COSTS_2P, fs, end_ok, jlo,
                                  max_run)
    assert torch.equal(scores, cf.bounded_scores_2p_plain(
        dg, q, lengths, COSTS_2P, fs, end_ok, jlo, max_run))


@pytest.mark.parametrize("shape,max_run", [
    ((1500, 64, 600), 0), ((1500, 64, 600), 32),
    # past 21k ranks, where the reference switches to its streamed twin
    # B15: the port reads rank tables from global memory at any size
    ((22000, 16, 900), 0), ((22000, 16, 900), 64)])
def test_bounded_ends_2p_kernel_matches_plain(card, shape, max_run):
    """B14: best rows and end ranks equal the plain version's; the best row
    is B13's, and the (score, end rank, end offset) triples equal."""
    g, reads = _backbone_case(23, *shape)
    flat = g.flatten()
    dg = DeviceGraph.build(flat, device=card)
    q, lengths = pack_queries(reads, device=card)
    fs, end_ok, jlo = ends_free_device_params(flat, SEMI_GLOBAL, lengths,
                                              dg.n_nodes_padded, True)
    before = cf.bounded_end_rows_2p.launches
    got = cf.bounded_end_rows_2p(dg, q, COSTS_2P, fs, end_ok, max_run)
    torch.cuda.synchronize()
    assert cf.bounded_end_rows_2p.launches == before + 1
    want = cf.bounded_end_rows_2p_plain(dg, q, COSTS_2P, fs, end_ok, max_run)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(got[0], cf.bounded_best_rows_2p(
        dg, q, COSTS_2P, fs, end_ok, max_run))
    triple = cf.bounded_with_ends_2p(dg, q, lengths, COSTS_2P, fs, end_ok,
                                     jlo, max_run)
    plain = cf._with_ends_from(want[0], want[1], lengths, jlo)
    assert all(torch.equal(a, b) for a, b in zip(triple, plain))


@pytest.mark.parametrize("fs,fe", [(False, False), (True, False),
                                   (False, True), (True, True)])
@pytest.mark.parametrize("two_piece", [False, True], ids=["1p", "2p"])
def test_free_fill_kernels_match_plain(card, two_piece, fs, fe):
    """B2f and B12f: B4's and B13's kernels under the end mask equal their
    plain version at every lane; ``dp_fill_scores`` with a flag set
    launches them, and without flags equals the global fill (B2, B12)."""
    from poasta_tpu_torch.aligner.wavefront import dp_fill_scores

    costs = COSTS_2P if two_piece else COSTS
    wrapper = cf.free_fill_rows_2p if two_piece else cf.free_fill_rows
    g, reads = _case(36, 400, 64, div=0.04)
    reads = [r[(i % 7) * 20:] for i, r in enumerate(reads)]
    dg = DeviceGraph.build(g.flatten(), device=card)
    q, lengths = pack_queries(reads, device=card)
    before = wrapper.launches
    got = wrapper(dg, q, costs, fs, fe)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    assert torch.equal(got, cf.free_fill_rows_plain(dg, q, costs, fs, fe))
    before = wrapper.launches
    scores = dp_fill_scores(dg, q, lengths, costs, free_start=fs,
                            free_end=fe)
    assert wrapper.launches == before + (1 if fs or fe else 0)
    assert torch.equal(scores, cf.free_fill_scores_plain(
        dg, q, lengths, costs, fs, fe))
    if not (fs or fe):
        assert torch.equal(got, (cf.fill_end_rows_2p if two_piece
                                 else cf.fill_end_rows)(dg, q, costs))


@pytest.mark.parametrize("span", [SEMI_GLOBAL, BOUNDED],
                         ids=["semi-global", "bounded"])
def test_two_piece_ends_free_mapper_on_card(card, span):
    """``BatchMapper`` under two-piece costs and an ends-free span: scores
    through B13 equal the plain version's uncapped fill; ``align_batch``
    runs B14, traces nothing on the device, and every alignment costs its
    score."""
    g, reads = _case(37, 600, 64, div=0.04)
    mapper = BatchMapper(g, COSTS_2P, device=card, aln_type=span)
    before = cf.bounded_best_rows_2p.launches
    scores = mapper.score_batch(reads)
    assert cf.bounded_best_rows_2p.launches > before
    q, lengths = pack_queries(reads, device=card)
    fs, end_ok, jlo = ends_free_device_params(mapper.flat, span, lengths,
                                              mapper.dg.n_nodes_padded, True)
    exact = cf.bounded_scores_2p_plain(mapper.dg, q, lengths, COSTS_2P, fs,
                                       end_ok, jlo).cpu().numpy()
    assert (scores == exact).all()
    before = cf.bounded_end_rows_2p.launches
    out = mapper.align_batch(reads)
    assert cf.bounded_end_rows_2p.launches > before
    assert [s for s, _ in out] == list(map(int, scores))
    assert mapper.last_ends_free_stats["device_traced"] == 0
    assert mapper.last_ends_free_stats["anchored_ok"] == len(reads)
    for r, (s, aln) in zip(reads, out):
        assert alignment_cost(g, r, aln, COSTS_2P) == s


# ---- past the reference's size gates: B9's and B11's sizes ---------------------

def _bubble_case(seed, n, n_alleles, block, n_reads, div=0.01):
    """A ``n``-base backbone whose every other ``block``-base stretch has
    ``n_alleles`` random alleles beside it (P = n_alleles + 1 at each
    join), and reads of ``n`` bases along random paths at ``div``."""
    from poasta_tpu_torch.aligner.alignment import AlignedPair

    rng = random.Random(seed)
    base = "".join(rng.choice("ACGT") for _ in range(n))
    g = POAGraph()
    g.add_alignment_with_weights("s0", base.encode(), None, [1] * n)
    paths = [base]
    for k in range(1, n_alleles + 1):
        seq, aln = [], []
        for start in range(0, n, block):
            own = (start // block) % 2 == 1
            for v in range(start, min(start + block, n)):
                aln.append(AlignedPair(None if own else v, len(seq)))
                seq.append(rng.choice("ACGT") if own else base[v])
        paths.append("".join(seq))
        g.add_alignment_with_weights(f"s{k}", paths[-1].encode(), aln,
                                     [1] * n)
    reads = []
    for _ in range(n_reads):
        mosaic = "".join(rng.choice(paths)[s:s + block]
                         for s in range(0, n, block))
        reads.append(_mutate(rng, mosaic, div).encode())
    return g, reads


@pytest.fixture(scope="module")
def backbone_40k(card):
    """The bench's pangenome shape at 40,000 bases (an edge v -> v+3 every
    977 nodes, P = 2), past the reference's 1 MiB rank-table gate: 2
    reads of 5 kb cut from it and one of the whole backbone, at 1%."""
    rng = random.Random(43)
    g, base = _backbone(rng, 40000, 977)
    reads = []
    for _ in range(2):
        a = rng.randrange(0, 35000)
        reads.append(_mutate(rng, base[a:a + 5000], 0.01).encode())
    flat = g.flatten()
    return (g, flat, DeviceGraph.build(flat, device=card), reads,
            _mutate(rng, base, 0.01).encode())


def test_bounded_kernel_past_the_reference_gate(card, backbone_40k):
    """B4 on 40,002 ranks (the size of the reference's streamed B9) against
    its plain version on 2 reads of 5 kb under the semi-global span."""
    g, flat, dg, reads, _ = backbone_40k
    assert flat.n_nodes >= 40000 and int(dg.pred_slots.shape[1]) == 2
    q, lengths = pack_queries(reads, device=card)
    fs, end_ok, _ = ends_free_device_params(flat, SEMI_GLOBAL, lengths,
                                            dg.n_nodes_padded)
    before = cf.bounded_best_rows.launches
    got = cf.bounded_best_rows(dg, q, COSTS, fs, end_ok)
    torch.cuda.synchronize()
    assert cf.bounded_best_rows.launches == before + 1
    assert torch.equal(got, cf.bounded_best_rows_plain(dg, q, COSTS, fs,
                                                       end_ok))


def test_banded_kernel_past_the_reference_gate(card):
    """B1 on a 34k-rank bubble graph (P = 4) with 2 reads of 12 kb (the
    size of the reference's streamed B11) against its plain version; the
    verified scores equal the native engine's."""
    g, reads = _bubble_case(47, 12000, 3, 1000, 2)
    flat = g.flatten()
    assert flat.n_nodes >= 30000
    dg = DeviceGraph.build(flat, device=card)
    assert int(dg.pred_slots.shape[1]) == 4
    q, lengths = pack_queries(reads, device=card)
    na = NativeAligner(g)
    exact = [na.align_banded(r, COSTS)[0] for r in reads]
    ub = max(exact) + 64
    prep = _banded_prep(flat, dg, lengths, ub, int(q.shape[1]))
    max_run = tbd.ins_run_cap(COSTS, ub, prep["width"])
    before = cf.banded_end_rows.launches
    got = cf.banded_end_rows(dg, q, COSTS, prep, max_run)
    torch.cuda.synchronize()
    assert cf.banded_end_rows.launches == before + 1
    assert torch.equal(got, cf.banded_end_rows_plain(dg, q, COSTS, prep,
                                                     max_run))
    scores = cf.banded_scores(dg, q, lengths, COSTS, prep, max_run)
    assert [int(s) for s in scores.cpu()] == exact


def test_banded_kernel_full_width_40k_lanes_in_global_memory(card,
                                                              backbone_40k):
    """One 40 kb read on the 40,002-rank graph at the clamped full-width
    tier, L = 40,960: rows and rings take the global-memory placement (a
    block slab of 64-bit size); kernel and plain version agree and the
    score is the native engine's."""
    g, flat, dg, _, read = backbone_40k
    q, lengths = pack_queries([read], device=card)
    q = torch.nn.functional.pad(q, (0, 40960 - int(q.shape[1])))
    prep = cf.prepare_banded(dg, COSTS, np.zeros(flat.n_nodes, np.int32),
                             40960, 40960)
    plan = cf.banded_plan(dg.window, prep["width"], prep["margin"])
    assert prep["width"] == 40960 and plan["placement"] == "global"
    got = cf.banded_end_rows(dg, q, COSTS, prep, 0)
    torch.cuda.synchronize()
    assert torch.equal(got, cf.banded_end_rows_plain(dg, q, COSTS, prep, 0))
    score = cf.banded_scores(dg, q, lengths, COSTS, prep)
    assert int(score[0]) == NativeAligner(g).align_banded(read, COSTS)[0]


# ---- the banded template's bodies: widths, caps, placements ------------------
# Every case is held torch.equal to the plain version.  The register body
# gives each thread K lanes; widths of an odd number of 8 K-lane groups
# (4,224 at K 8, 6,272 at K 16) leave the last warp part past the row.


def _full_width(card, seed, width, two_piece=False, n_reads=4, q_lanes=None):
    """A bubble graph (P = 3 at each join, invalid predecessor slots
    elsewhere) and reads under one full-width window of ``width`` lanes,
    the query padded to ``q_lanes`` (default ``width``)."""
    g, reads = _bubble_case(seed, 600, 2, 50, n_reads, div=0.03)
    flat = g.flatten()
    dg = DeviceGraph.build(flat, device=card)
    assert int(dg.pred_slots.shape[1]) >= 3
    assert not bool(dg.pred_valid_flat.view(-1, dg.pred_slots.shape[1])
                    [: flat.n_nodes].bool().all())
    q, lengths = pack_queries(reads, device=card)
    Lq = q_lanes or width
    q = torch.nn.functional.pad(q, (0, Lq - int(q.shape[1]))).contiguous()
    costs = COSTS_2P if two_piece else COSTS
    prep = cf.prepare_banded(dg, costs, np.zeros(flat.n_nodes, np.int32),
                             width, Lq)
    return flat, dg, q, lengths, costs, prep


def _caps(plan, width):
    K = plan["lanes_per_thread"]
    return [1, 2, 32 * K, width, width + 1]


@pytest.mark.parametrize("width", [384, 1152, 4224, 6272])
@pytest.mark.parametrize("two_piece", [False, True], ids=["B1", "B16"])
def test_register_body_matches_plain(card, width, two_piece):
    """B1 and B16 at caps 1, 2, one warp's span (32 K lanes), the width and
    past it."""
    flat, dg, q, _, costs, prep = _full_width(card, 50 + width, width,
                                              two_piece)
    variant = cf.VARIANT_GLOBAL_2P if two_piece else cf.VARIANT_GLOBAL
    plan = cf.variant_plan(variant, dg.window, width, prep["margin"], width)
    assert plan["body"] == "registers" and plan["barriers_per_rank"] == 2
    kernel, plain = ((cf.banded_end_rows_2p, cf.banded_end_rows_2p_plain)
                     if two_piece else
                     (cf.banded_end_rows, cf.banded_end_rows_plain))
    before = kernel.rows_launches
    for cap in _caps(plan, width):
        got = kernel(dg, q, costs, prep, cap)
        torch.cuda.synchronize()
        assert torch.equal(got, plain(dg, q, costs, prep, cap)), (plan, cap)
    assert kernel.rows_launches == before


@pytest.mark.parametrize("span", [SEMI_GLOBAL, BOUNDED],
                         ids=["semi-global", "bounded"])
@pytest.mark.parametrize("width", [384, 4224])
def test_register_body_ends_free_matches_plain(card, span, width):
    """B5 (ENDS 1, the positional best row), free graph begin or not."""
    flat, dg, q, lengths, costs, prep = _full_width(card, 70 + width, width)
    fs, end_ok, _ = ends_free_device_params(flat, span, lengths,
                                            dg.n_nodes_padded)
    plan = cf.variant_plan(cf.VARIANT_EF, dg.window, width, prep["margin"],
                           width)
    for cap in _caps(plan, width):
        got = cf.ef_best_rows(dg, q, costs, prep, fs, end_ok, cap)
        torch.cuda.synchronize()
        assert torch.equal(got, cf.ef_best_rows_plain(dg, q, costs, prep, fs,
                                                      end_ok, cap)), cap


def test_register_body_global_placement(card):
    """B5 with a 57,344-lane query: the best row and the suffix row pass
    the 227 KB of shared memory, so the register body keeps only its warp
    carries there and the rest in the block's global slab."""
    width, Lq = 1152, 57344
    flat, dg, q, lengths, costs, prep = _full_width(card, 90, width,
                                                    q_lanes=Lq)
    plan = cf.variant_plan(cf.VARIANT_EF, dg.window, width, prep["margin"],
                           Lq)
    assert plan["body"] == "registers" and plan["placement"] == "global"
    fs, end_ok, _ = ends_free_device_params(flat, SEMI_GLOBAL, lengths,
                                            dg.n_nodes_padded)
    for cap in (0, 64):
        got = cf.ef_best_rows(dg, q, costs, prep, fs, end_ok, cap)
        assert torch.equal(got, cf.ef_best_rows_plain(dg, q, costs, prep, fs,
                                                      end_ok, cap)), cap


@pytest.mark.parametrize("two_piece", [False, True], ids=["B1", "B16"])
def test_rows_body_matches_plain(card, two_piece):
    """Past 16 x 672 lanes (B1) and 16 x 512 (B16) the plan takes the rows
    body (12,416 lanes: chunks of 16 lanes, 800 threads, everything in
    global memory)."""
    width = 12416
    flat, dg, q, _, costs, prep = _full_width(card, 110, width, two_piece,
                                              n_reads=2)
    variant = cf.VARIANT_GLOBAL_2P if two_piece else cf.VARIANT_GLOBAL
    plan = cf.variant_plan(variant, dg.window, width, prep["margin"], width)
    assert plan["body"] == "rows" and plan["barriers_per_rank"] == 5
    kernel, plain = ((cf.banded_end_rows_2p, cf.banded_end_rows_2p_plain)
                     if two_piece else
                     (cf.banded_end_rows, cf.banded_end_rows_plain))
    before = kernel.rows_launches
    for cap in (1, 2, 512, 0):
        got = kernel(dg, q, costs, prep, cap)
        assert torch.equal(got, plain(dg, q, costs, prep, cap)), cap
    assert kernel.rows_launches == before + 4


@pytest.mark.parametrize("which", ["B3", "B6", "B17"])
@pytest.mark.parametrize("capped", [False, True])
def test_drift_bodies_wrap_the_ring(card, which, capped):
    """Reads 2,840 lanes apart drift past the whole ring row (128 x nbs >=
    TOT), so the rotation wraps and re-frames clear lanes across the wrap;
    ENDS 2 keeps its best tile in registers."""
    g, reads = _sv_case(120, glen=3000, n_reads=16)
    flat = g.flatten()
    dg = DeviceGraph.build(flat, device=card)
    q, lengths = pack_queries(reads, device=card)
    costs = COSTS_2P if which == "B17" else COSTS
    lens = lengths.cpu().numpy()
    n_min, n_max = int(lens.min()), int(lens.max())
    S = tbd.drift_steps_for(n_min, n_max)
    ub = 60
    span = BOUNDED if which == "B6" else None
    ws, width, sr = tbd.band_windows_drift(flat, n_min, n_max, costs, ub, S,
                                           aln_type=span)
    L = int(q.shape[1])
    Lp = max(L, -(-(int(ws.max()) + width) // 128) * 128)
    prep = cf.prepare_banded_drift(dg, costs, ws, width, sr, S, Lp)
    qpad = torch.nn.functional.pad(q, (prep["mq"], Lp - L)).contiguous()
    nbs = cf.drift_units(lengths, n_min)
    assert 128 * int(nbs.max()) >= width + 2 * prep["margin"]
    max_run = tbd.ins_run_cap(costs, ub, width) if capped else 0
    if which == "B6":
        _, end_ok, jlo = ends_free_device_params(flat, span, lengths,
                                                 dg.n_nodes_padded)
        li = lengths.to(torch.int32).contiguous()
        jl = jlo.to(torch.int32).contiguous()
        got = cf.drift_ef_best_rows(dg, qpad, nbs, li, jl, costs, prep,
                                    end_ok, max_run)
        ref = cf.drift_ef_best_rows_plain(dg, qpad, nbs, li, jl, costs, prep,
                                          end_ok, max_run)
    elif which == "B17":
        got = cf.drift_end_rows_2p(dg, qpad, nbs, costs, prep, max_run)
        ref = cf.drift_end_rows_2p_plain(dg, qpad, nbs, costs, prep, max_run)
    else:
        got = cf.drift_end_rows(dg, qpad, nbs, costs, prep, max_run)
        ref = cf.drift_end_rows_plain(dg, qpad, nbs, costs, prep, max_run)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)


@pytest.mark.parametrize("which", ["B16", "B17"])
def test_split_placement_matches_plain(card, which):
    """Two-piece rings that do not fit whole keep M and D1 in shared memory
    and D2 in the block's global slab: B16 at a 5,120-lane full-width tier,
    B17 on drifting windows of 4,480 lanes whose re-frames clear D2 rows in
    the slab."""
    if which == "B16":
        flat, dg, q, _, costs, prep = _full_width(card, 130, 5120, True)
        plan = cf.variant_plan(cf.VARIANT_GLOBAL_2P, dg.window, 5120,
                               prep["margin"], 5120)
        assert plan["placement"] == "rings-split", plan
        for cap in (1, 2048, 0):
            got = cf.banded_end_rows_2p(dg, q, costs, prep, cap)
            assert torch.equal(got, cf.banded_end_rows_2p_plain(
                dg, q, costs, prep, cap)), cap
        return
    g, reads = _sv_case(120, glen=8000, n_reads=4)
    flat = g.flatten()
    dg = DeviceGraph.build(flat, device=card)
    q, lengths = pack_queries(reads, device=card)
    lens = lengths.cpu().numpy()
    n_min, n_max = int(lens.min()), int(lens.max())
    S = tbd.drift_steps_for(n_min, n_max)
    ws, width, sr = tbd.band_windows_drift(flat, n_min, n_max, COSTS_2P,
                                           2000, S)
    L = int(q.shape[1])
    Lp = max(L, -(-(int(ws.max()) + width) // 128) * 128)
    prep = cf.prepare_banded_drift(dg, COSTS_2P, ws, width, sr, S, Lp)
    qpad = torch.nn.functional.pad(q, (prep["mq"], Lp - L)).contiguous()
    plan = cf.variant_plan(cf.VARIANT_DRIFT_2P, dg.window, width,
                           prep["margin"], Lp)
    assert plan["placement"] == "rings-split", plan
    nbs = cf.drift_units(lengths, n_min)
    assert int(nbs.max()) > 0
    for cap in (0, 256):
        got = cf.drift_end_rows_2p(dg, qpad, nbs, COSTS_2P, prep, cap)
        assert torch.equal(got, cf.drift_end_rows_2p_plain(
            dg, qpad, nbs, COSTS_2P, prep, cap)), cap


# ---- the full-fill template's bodies: widths, caps, placements, variants -----
# Every case is held torch.equal to the plain version.  The register body
# gives each thread K lanes; 4,224 and 4,992 lanes at K 8 and 6,272 at K 16
# leave the last warp part past the row; 8,192 is its widest row (6,144
# for B14), 8,320 the rows body's.

FILL_NAMES = ("B2", "B4", "B7", "B12", "B13", "B14")  # variants 0, 1, 2, 3-5
FILL_2P = ("B12", "B13", "B14")
# csrc/fill_kernel.cu:fill_reg_max_threads, at K 4, 8 and 16
FILL_MAX_THREADS = {"B2": (1024, 1024, 512), "B4": (1024, 1024, 512),
                    "B7": (1024, 896, 512), "B12": (1024, 896, 512),
                    "B13": (1024, 768, 512), "B14": (1024, 640, 384)}


def _fill_expected_lanes(name, width):
    """The smallest K whose threads, rounded up to a warp, fit the
    variant's limit; 0 past the register body's widest row."""
    for K, limit in zip((4, 8, 16), FILL_MAX_THREADS[name]):
        if -(-(width // K) // 32) * 32 <= limit:
            return K
    return 0


def _fill_case(card, seed, width, n_reads=3):
    """A bubble graph (P = 3 at each join, invalid predecessor slots
    elsewhere) and reads cut to fit, padded to ``width`` lanes."""
    g, reads = _bubble_case(seed, 600, 2, 50, n_reads, div=0.03)
    flat = g.flatten()
    dg = DeviceGraph.build(flat, device=card)
    assert not bool(dg.pred_valid_flat.view(-1, dg.pred_slots.shape[1])
                    [: flat.n_nodes].bool().all())
    q, lengths = pack_queries([r[:width - 1] for r in reads], device=card)
    q = torch.nn.functional.pad(q, (0, width - int(q.shape[1]))).contiguous()
    return flat, dg, q, lengths


def _fill_plan(name, W, L, max_run=0):
    two = name in FILL_2P
    if name in ("B2", "B12"):
        return cf.fill_plan(W, L, two_piece=two)
    return cf.bounded_plan(W, L, ends=name in ("B7", "B14"), two_piece=two,
                           max_run=max_run)


def _fill_fns(name, dg, q, fs, end_ok, max_run):
    """(wrapper, kernel call, plain call) of a full-fill variant."""
    costs = COSTS_2P if name in FILL_2P else COSTS
    if name in ("B2", "B12"):
        w, p = ((cf.fill_end_rows_2p, cf.fill_end_rows_2p_plain)
                if name == "B12" else (cf.fill_end_rows,
                                       cf.fill_end_rows_plain))
        return w, (lambda: w(dg, q, costs)), (lambda: p(dg, q, costs))
    w, p = {"B4": (cf.bounded_best_rows, cf.bounded_best_rows_plain),
            "B7": (cf.bounded_end_rows, cf.bounded_end_rows_plain),
            "B13": (cf.bounded_best_rows_2p, cf.bounded_best_rows_2p_plain),
            "B14": (cf.bounded_end_rows_2p, cf.bounded_end_rows_2p_plain)
            }[name]
    return (w, lambda: w(dg, q, costs, fs, end_ok, max_run),
            lambda: p(dg, q, costs, fs, end_ok, max_run))


def _fill_expected_placement(name, W, L):
    """The register body's placement by the rings alone, beside the warp
    carries and (bounded) the scan's suffix row."""
    optin = torch.cuda.get_device_properties(0).shared_memory_per_block_optin
    side = 128 + (0 if name in ("B2", "B12") else 4 * L)
    ring = 4 * W * L
    n_rings = 3 if name in FILL_2P else 2
    if side + n_rings * ring <= optin:
        return "smem"
    if n_rings == 3 and side + 2 * ring <= optin:
        return "rings-split"
    return "rings-global"


def _fill_check(card, name, flat, dg, q, lengths, caps, body):
    """Each cap, alternating a free graph begin with a dense end mask (the
    semi-global span) and the end rank alone: kernel equal to plain, one
    launch, on ``body``."""
    fs, end_ok, _ = ends_free_device_params(flat, SEMI_GLOBAL, lengths,
                                            dg.n_nodes_padded,
                                            name in FILL_2P)
    masks = [(fs, end_ok), (False, cf.free_end_mask(dg, False))]
    for i, cap in enumerate(caps):
        f, m = masks[i % 2]
        wrapper, kernel, plain = _fill_fns(name, dg, q, f, m, cap)
        before = wrapper.launches, wrapper.rows_launches
        got = kernel()
        torch.cuda.synchronize()
        assert wrapper.launches == before[0] + 1
        assert wrapper.rows_launches == before[1] + (body == "rows")
        want = plain()
        gots = got if isinstance(got, tuple) else (got,)
        wants = want if isinstance(want, tuple) else (want,)
        assert all(torch.equal(a, b) for a, b in zip(gots, wants)), (name,
                                                                     cap)


@pytest.mark.parametrize("width", [384, 1152, 4224, 4992, 6144, 6272,
                                   8192])
@pytest.mark.parametrize("name", FILL_NAMES)
def test_fill_register_body_matches_plain(card, width, name):
    """B2, B4, B7, B12, B13 and B14 at caps 1, 2, one warp's span (32 K)
    and the row (the global fills scan the whole row), with the body,
    lanes, threads, barriers and placement the plan gives: the register
    body, or for B14 past 6,144 lanes the rows body."""
    flat, dg, q, lengths = _fill_case(card, 200 + width, width)
    plan = _fill_plan(name, dg.window, width)
    K = _fill_expected_lanes(name, width)
    if K == 0:
        assert plan["body"] == "rows", plan
        K = 4  # the caps below
    else:
        assert plan["body"] == "registers" and plan["barriers_per_rank"] == 2
        assert plan["lanes_per_thread"] == K, plan
        assert plan["threads"] == -(-(width // K) // 32) * 32 <= 1024
        assert plan["placement"] == _fill_expected_placement(
            name, dg.window, width), plan
    caps = [0] if name in ("B2", "B12") else [1, 2, 32 * K, 0]
    _fill_check(card, name, flat, dg, q, lengths, caps, plan["body"])


@pytest.mark.parametrize("name", FILL_NAMES)
def test_fill_rows_body_past_the_register_body(card, name):
    """Past 8,192 lanes the plan takes the rows body (scratch rows and
    block_prefix_min: 3 + log2(cap) barriers a rank), by shape alone."""
    width = 8320
    flat, dg, q, lengths = _fill_case(card, 300, width, n_reads=2)
    plan = _fill_plan(name, dg.window, width, 64)
    assert plan["body"] == "rows", plan
    assert plan["barriers_per_rank"] == (3 + 14 if name in ("B2", "B12")
                                         else 3 + 6)
    caps = [0] if name in ("B2", "B12") else [64, 0]
    _fill_check(card, name, flat, dg, q, lengths, caps, "rows")


@pytest.mark.parametrize("name", FILL_NAMES)
def test_fill_register_body_placements(card, name):
    """Each placement the register body can take on this graph's ring
    (W rows): the narrowest row (a multiple of 128 within the register
    body's reach) that gives it, at caps 2,048 and the row.  Two-piece
    rings must split somewhere, one-piece rings leave shared memory."""
    flat, dg, q, lengths = _fill_case(card, 400, 8192, n_reads=2)
    seen = []
    for target in ("smem", "rings-split", "rings-global"):
        widths = [L for L in range(128, 8193, 128)
                  if _fill_expected_lanes(name, L)
                  and _fill_expected_placement(name, dg.window, L) == target]
        if not widths:  # past the register body's reach at this W
            continue
        width = widths[0]
        plan = _fill_plan(name, dg.window, width)
        assert plan["body"] == "registers" and plan["placement"] == target, (
            target, plan)
        qw = q[:, :width].contiguous()
        caps = [0] if name in ("B2", "B12") else [2048, 0]
        _fill_check(card, name, flat, dg, qw, torch.clamp(
            lengths, max=width - 1), caps, "registers")
        seen.append(target)
    assert seen[0] == "smem" and ("rings-split" if name in FILL_2P
                                  else "rings-global") in seen, seen


# ---- the trace and seeded fills' register bodies: widths, caps, placements ---
# Each case is held torch.equal to the plain version on random monotone
# window steps (0 or 128 lanes a rank, as a schedule gives them).

# csrc/trace_kernel.cu:TRACE_LANES and seed_kernel.cu:SEED_LANES
REG_LANES = 4
TRACE_WIDTHS = (128, 256, 384, 1024, 1152, 4096)
SEED_WIDTHS = (128, 256, 1024, 2560, 4096)


def _trace_side(W):
    """The trace's side words: one a warp, then the W slot starts."""
    return 32 + -(-W // 4) * 4


def _seed_side(W, Wb):
    """The seed's side rows: the scan's suffix row, then the slot starts."""
    return Wb + -(-W // 4) * 4


def _reg_expected_placement(W, Wb, side_ints):
    """The rings (M and D, W rows of Wb lanes) in shared memory where they
    fit beside the warp carries and the side words, else in the slab."""
    optin = torch.cuda.get_device_properties(0).shared_memory_per_block_optin
    side = 128 + 4 * side_ints
    if side + 8 * W * Wb <= optin:
        return "smem"
    return "rings-global" if side <= optin else "global"


def _check_reg_plan(plan, W, Wb, side_ints):
    assert plan["body"] == "registers" and plan["barriers_per_rank"] == 2
    assert plan["lanes_per_thread"] == REG_LANES, plan
    assert plan["threads"] == -(-(Wb // REG_LANES) // 32) * 32, plan
    assert plan["placement"] == _reg_expected_placement(W, Wb,
                                                        side_ints), plan


def _random_steps(card, dg, B, seed, rate=0.2):
    rng = np.random.default_rng(seed)
    steps = rng.random((B, dg.n_nodes_padded)) < rate
    steps[:, dg.n_nodes:] = False
    return rng, torch.as_tensor(steps, device=card)


def _trace_inputs(card, dg, q, lengths, Wb, rng, steps, anchor):
    """qpad of max(L, Wb + 128) lanes, the window starts of ``steps`` and
    anchors: "end" the global one, "inside" a random rank at an offset of
    its window, "outside" past it."""
    B, L = q.shape
    qpad = torch.nn.functional.pad(q, (0, max(L, Wb + 128) - L)).contiguous()
    wst = tr.window_starts(steps).contiguous()
    if anchor == "end":
        ar = np.full(B, dg.end_rank_i)
        aj = lengths.cpu().numpy()
    else:
        ar = rng.integers(0, dg.n_nodes, B)
        w = wst.cpu().numpy()[np.arange(B), ar]
        aj = w + (rng.integers(0, Wb, B) if anchor == "inside"
                  else Wb + rng.integers(0, 256, B))
    return {"qpad": qpad, "wstarts": wst,
            "anchor_r": torch.as_tensor(ar.astype(np.int32), device=card),
            "anchor_j": torch.as_tensor(aj.astype(np.int32), device=card)}


def _trace_check(dg, inp, Wb, free_start):
    """B18 against its plain version: ``aval`` and the pointer rows each
    read walks (every row where ``inp`` gives no rank range)."""
    before = tr.trace_fill.launches
    aval, ptr = tr.trace_fill(dg, **inp, costs=COSTS, Wb=Wb,
                              free_start=free_start)
    torch.cuda.synchronize()
    assert tr.trace_fill.launches == before + 1
    aval_p, ptr_p = tr.trace_fill_plain(dg, **inp, costs=COSTS, Wb=Wb,
                                        free_start=free_start)
    if "r_begin" in inp:
        ptr = _in_range(ptr, inp["r_begin"], inp["r_end"])
    assert torch.equal(aval, aval_p) and torch.equal(ptr, ptr_p), (
        Wb, free_start)


def _trace_ranges(card, dg, B, rng):
    """Random rank ranges inside the graph, one of them a single rank and
    one empty."""
    lo = rng.integers(0, dg.n_nodes, B)
    hi = lo + rng.integers(0, dg.n_nodes - lo)
    hi[0], hi[-1] = lo[0], lo[-1] - 1
    return {"r_begin": torch.as_tensor(lo.astype(np.int32), device=card),
            "r_end": torch.as_tensor(hi.astype(np.int32), device=card)}


@pytest.mark.parametrize("Wb", TRACE_WIDTHS)
def test_trace_register_body_matches_plain(card, Wb):
    """B18 at every tier width (and 128, 384, 1,152), global and with
    ``free_start``, anchors at the end,
    inside and outside their windows, on a P = 3 bubble graph with invalid
    predecessor slots; the plan's body, lanes, threads, barriers and
    placement."""
    flat, dg, q, lengths = _fill_case(card, 500 + Wb, Wb)
    _check_reg_plan(tr.trace_plan(dg.window, Wb), dg.window, Wb,
                    _trace_side(dg.window))
    rng, steps = _random_steps(card, dg, int(q.shape[0]), Wb)
    for fs, anchor in ((False, "end"), (True, "inside"), (True, "outside"),
                       (False, "inside")):
        _trace_check(dg, _trace_inputs(card, dg, q, lengths, Wb, rng, steps,
                                       anchor), Wb, fs)
    # rank ranges: each block starts and ends its walk where its read's
    # range says
    inp = _trace_inputs(card, dg, q, lengths, Wb, rng, steps, "inside")
    inp.update(_trace_ranges(card, dg, int(q.shape[0]), rng))
    _trace_check(dg, inp, Wb, True)


def _seed_inputs(card, dg, lengths, Wb, rng, steps, ranges):
    """Window starts entering each read's rank range
    (``range_window_starts``) and the ranges: "all", "wide" (a random
    stretch), "one" rank, "empty"."""
    from poasta_tpu_torch.ops import seed as sd

    B, n = int(lengths.shape[0]), dg.n_nodes
    if ranges == "all":
        rb, re = np.zeros(B, np.int64), np.full(B, n, np.int64)
    else:
        rb = rng.integers(0, n, B)
        re = {"empty": rb, "one": rb + 1,
              "wide": np.minimum(rb + rng.integers(1, n + 1, B), n)}[ranges]
    start = torch.cumsum(steps.to(torch.int64), dim=1) * 128
    r_begin = torch.as_tensor(rb, device=card)
    wst = sd.range_window_starts(steps, start, r_begin).contiguous()
    jlo = rng.integers(0, 3, B)

    def i32(v):
        return torch.as_tensor(np.asarray(v).astype(np.int32), device=card)
    return wst, i32(jlo), i32(rb), i32(re)


def _seed_check(dg, q, lengths, wst, jlo, rb, re, fs, end_ok, Wb, max_run):
    from poasta_tpu_torch.ops import seed as sd

    ln = lengths.to(torch.int32).contiguous()
    args = (dg, q, wst, ln, jlo, rb, re, COSTS, fs, end_ok, Wb, max_run)
    before = sd.seed_end_states.launches
    got = sd.seed_end_states(*args)
    torch.cuda.synchronize()
    assert sd.seed_end_states.launches == before + 1
    want = sd.seed_end_states_plain(*args)
    assert torch.equal(got, want), (Wb, max_run)
    return got


@pytest.mark.parametrize("Wb", SEED_WIDTHS)
def test_seed_register_body_matches_plain(card, Wb):
    """B8 at corridor widths 128 ... 4,096 (2,560 the main path's) at caps
    1, 64, 1,024 and past the window, over every read's whole range, random
    stretches, one rank and empty ranges ((INF, -1, 2^30)), under the
    semi-global span's end mask and free graph begin and under the end
    rank alone; the plan's body, lanes, threads, barriers and placement."""
    from poasta_tpu_torch.ops import seed as sd

    flat, dg, q, lengths = _fill_case(card, 600 + Wb, Wb)
    _check_reg_plan(sd.seed_plan(dg.window, Wb), dg.window, Wb,
                    _seed_side(dg.window, Wb))
    fs, end_ok, _ = ends_free_device_params(flat, SEMI_GLOBAL, lengths,
                                            dg.n_nodes_padded)
    masks = [(fs, end_ok), (False, cf.free_end_mask(dg, False))]
    rng, steps = _random_steps(card, dg, int(q.shape[0]), Wb)
    for i, (cap, ranges) in enumerate(zip((1, 64, 1024, Wb + 1),
                                          ("all", "wide", "one", "empty"))):
        f, m = masks[i % 2]
        inp = _seed_inputs(card, dg, lengths, Wb, rng, steps, ranges)
        got = _seed_check(dg, q, lengths, *inp, f, m, Wb,
                          cap if cap <= Wb else 0)
        if ranges == "empty":
            assert (got.cpu().numpy() == [INF_SCORE, -1, 1 << 30]).all()


INF_SCORE = 1 << 28  # csrc/common.cuh POASTA_INF


def _wide_ring_case(card, seed, n=400, span=24, every=2, n_reads=3):
    """A backbone with an edge v -> v + span every ``every`` nodes, so
    about span / every rows stay live at once (a wide ring, W >= 10), and
    reads cut from it."""
    rng = random.Random(seed)
    base = "".join(rng.choice("ACGT") for _ in range(n))
    g = POAGraph()
    g.add_alignment_with_weights("s0", base.encode(), None, [1] * n)
    for v in range(0, n - span, every):
        g.add_edge(v, v + span, 0, 1)
    g.post_process()
    reads = [_mutate(rng, base[a:a + 120], 0.02).encode()
             for a in (rng.randrange(0, n - 120) for _ in range(n_reads))]
    flat = g.flatten()
    dg = DeviceGraph.build(flat, device=card)
    assert dg.window >= 10, dg.window
    q, lengths = pack_queries(reads, device=card)
    return flat, dg, q, lengths


def _widths_for(W, side_fn, target):
    return [Wb for Wb in range(128, 4097, 128)
            if _reg_expected_placement(W, Wb, side_fn(Wb)) == target]


def test_trace_register_body_placements(card):
    """B18's rings in shared memory and in the block's global slab: the
    narrowest tier width that gives each on a wide ring."""
    flat, dg, q, lengths = _wide_ring_case(card, 71)
    seen = []
    for target in ("smem", "rings-global"):
        Wb = _widths_for(dg.window, lambda _: _trace_side(dg.window),
                         target)[0]
        plan = tr.trace_plan(dg.window, Wb)
        _check_reg_plan(plan, dg.window, Wb, _trace_side(dg.window))
        rng, steps = _random_steps(card, dg, int(q.shape[0]), Wb)
        for fs, anchor in ((False, "end"), (True, "inside")):
            _trace_check(dg, _trace_inputs(card, dg, q, lengths, Wb, rng,
                                           steps, anchor), Wb, fs)
        seen.append(plan["placement"])
    assert seen == ["smem", "rings-global"]


def test_seed_register_body_placements(card):
    """B8's rings in shared memory and in the block's global slab: the
    narrowest corridor width that gives each on a wide ring, windowed and
    not."""
    from poasta_tpu_torch.ops import seed as sd

    flat, dg, q, lengths = _wide_ring_case(card, 73)
    fs, end_ok, _ = ends_free_device_params(flat, SEMI_GLOBAL, lengths,
                                            dg.n_nodes_padded)
    seen = []
    for target in ("smem", "rings-global"):
        Wb = _widths_for(dg.window, lambda w: _seed_side(dg.window, w),
                         target)[0]
        plan = sd.seed_plan(dg.window, Wb)
        _check_reg_plan(plan, dg.window, Wb, _seed_side(dg.window, Wb))
        rng, steps = _random_steps(card, dg, int(q.shape[0]), Wb)
        for cap, ranges in ((64, "all"), (0, "wide")):
            inp = _seed_inputs(card, dg, lengths, Wb, rng, steps, ranges)
            _seed_check(dg, q, lengths, *inp, fs, end_ok, Wb, cap)
        seen.append(plan["placement"])
    assert seen == ["smem", "rings-global"]


# ---- devices other than the current one, and a mesh of one card --------------

def test_kernels_launch_on_their_inputs_card(card):
    """B1 and B4 on tensors of the last visible card while cuda:0 is
    current: each launch plans and runs under its inputs' device (the guard
    of ``_launch_variant`` and ``_launch_full_fill``) and equals its plain
    version there.  With one card the last is cuda:0 itself."""
    last = torch.device("cuda", torch.cuda.device_count() - 1)
    g, reads = _case(5, 300, 64)
    flat = g.flatten()
    dg = DeviceGraph.build(flat, device=last)
    q, lengths = pack_queries(reads, device=last)
    prep = _banded_prep(flat, dg, lengths, 200, int(q.shape[1]))
    fs, end_ok, _ = ends_free_device_params(flat, SEMI_GLOBAL, lengths,
                                            dg.n_nodes_padded)
    with torch.cuda.device(0):
        assert torch.cuda.current_device() == 0
        b1 = cf.banded_end_rows(dg, q, COSTS, prep, 0)
        b4 = cf.bounded_best_rows(dg, q, COSTS, fs, end_ok, 0)
    assert b1.device == b4.device == last
    torch.cuda.synchronize(last)
    assert torch.equal(b1, cf.banded_end_rows_plain(dg, q, COSTS, prep, 0))
    assert torch.equal(b4, cf.bounded_best_rows_plain(dg, q, COSTS, fs,
                                                      end_ok, 0))


def test_repeated_card_mesh_equals_one_card(card):
    """A dp = 2 mesh of cuda:0 twice: the sharded full fill (B2 a shard),
    the meshed banded scorer (B1 a shard), ``BatchMapper(mesh=)``'s
    ``score_batch`` and ``align_batch``, and the sharded bounded fill with
    end states (B7 a shard) equal the unmeshed outputs."""
    from poasta_tpu_torch.aligner.wavefront import (
        dp_fill_ends_free_with_ends,
        dp_fill_scores,
    )
    from poasta_tpu_torch.parallel import make_mesh, make_sharded_score_fn

    mesh = make_mesh(devices=[card, card], dp=2)
    g, reads = _case(6, 800, 128, div=0.03)
    flat = g.flatten()
    dg = DeviceGraph.build(flat, device=card)
    q, lengths = pack_queries(reads, device=card)
    one = dp_fill_scores(dg, q, lengths, COSTS).cpu().numpy()
    before = cf.fill_end_rows.launches
    got = make_sharded_score_fn(dg, COSTS, mesh)(q, lengths)
    assert cf.fill_end_rows.launches == before + 2
    assert got.cpu().numpy().tolist() == one.tolist()

    before = cf.banded_end_rows.launches
    banded = BandedScorer(flat, COSTS, mesh=mesh).scores(q, lengths)
    assert (cf.banded_end_rows.launches - before) % 2 == 0
    assert cf.banded_end_rows.launches > before
    assert banded.tolist() == one.tolist()

    meshed = BatchMapper(g, COSTS, mesh)
    plain = BatchMapper(g, COSTS, device=card)
    assert meshed.score_batch(reads).tolist() == one.tolist()
    want = plain.align_batch(reads[:64])
    got = meshed.align_batch(reads[:64])
    assert [(s, [(p.rpos, p.qpos) for p in a]) for s, a in got] == \
        [(s, [(p.rpos, p.qpos) for p in a]) for s, a in want]

    before = cf.bounded_end_rows.launches
    ends = dp_fill_ends_free_with_ends(dg, flat, q, lengths, COSTS,
                                       SEMI_GLOBAL, mesh=mesh)
    assert cf.bounded_end_rows.launches == before + 2
    want = dp_fill_ends_free_with_ends(dg, flat, q, lengths, COSTS,
                                       SEMI_GLOBAL)
    assert [t.tolist() for t in ends] == [t.tolist() for t in want]
