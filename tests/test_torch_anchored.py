"""The port's ends-free alignment on the CPU against the JAX package: the
bounded full fill with end states (B7 ``_fill_kernel_bounded_ends``), the
anchored ``free_start`` trace (B18 ``_trace_kernel``) and
``BatchMapper.align_batch`` under ends-free spans.

Same numpy-seeded inputs through both packages.  The JAX side runs its
Pallas kernels in interpret mode (with ``POASTA_SEED=all`` and
``POASTA_SEED_DEBUG=1``) and its XLA bodies on the CPU; the port runs its
kernels' plain versions (CPU tensors, ``device="cpu"``).  Every comparison
is exact (tolerance 0).
"""

import random
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poasta_tpu.aligner import GapAffine
from poasta_tpu.aligner import costs as jcosts
from poasta_tpu.aligner import wavefront as jwf
from poasta_tpu.graphs import POAGraph
from poasta_tpu.native import NativeAligner
from poasta_tpu.ops import pallas_fill as jpf
from poasta_tpu.ops import pallas_trace as jpt
from poasta_tpu.parallel import BatchMapper as JaxMapper
from poasta_tpu_torch import BatchMapper, PoastaAligner, convert
from poasta_tpu_torch.aligner import banded as tbd
from poasta_tpu_torch.aligner import costs as tcosts
from poasta_tpu_torch.aligner import wavefront as twf
from poasta_tpu_torch.ops import cuda_fill as tcf
from poasta_tpu_torch.ops import trace as tr
from poasta_tpu_torch.parallel import mapper as tmapper

torch.set_num_threads(1)

COSTS = GapAffine(4, 2, 6)
INF = tcf.INF
# spans by field; a field left out is unbounded
SPANS = {
    # the CLI's -m semi-global and -m ends-free
    "semi-global": {"qry_free_end": ("included", 0)},
    "ends-free": {},
    # the bench's bounded span (mixed-length config)
    "bounded": {"qry_free_end": ("included", 50),
                "graph_free_begin": ("included", 0),
                "graph_free_end": ("included", 50)},
}


def _span(mod, name):
    return mod.EndsFree(**SPANS[name])


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
        if r < d:
            continue
        out.append(rng.choice("ACGT") if r < 2 * d else ch)
        if rng.random() < d:
            out.append(rng.choice("ACGT"))
    return "".join(out) or "A"


def _fused_graph(rng, length, nseq=3, d=0.05):
    base = "".join(rng.choice("ACGT") for _ in range(length))
    g = POAGraph()
    g.add_alignment_with_weights("s0", base.encode(), None, [1] * length)
    for i in range(1, nseq):
        s = _mutate(rng, base, d).encode()
        _, aln, _ = NativeAligner(g).align(s, COSTS)
        g.add_alignment_with_weights(f"s{i}", s, aln, [1] * len(s))
    return g, base


@pytest.fixture(scope="module")
def fill_case():
    """A fused ~330-node graph and 64 fragments of 180-260 bases at 3%
    (every 16th at 15%), L = 384; read 7 carries a 40-base insertion, which
    a capped scan over-estimates."""
    rng = random.Random(71)
    g, base = _fused_graph(rng, 300)
    reads = []
    for i in range(64):
        a = rng.randrange(0, 40)
        b = a + rng.randrange(180, 260)
        reads.append(_mutate(rng, base[a:b], 0.15 if i % 16 == 3 else 0.03)
                     .encode())
    ins = "".join(rng.choice("ACGT") for _ in range(40))
    reads[7] = (base[20:120] + ins + base[120:220]).encode()
    return _pack_both(g, reads)


@pytest.fixture(scope="module")
def repeat_case():
    """A linear graph that holds one 120-base segment twice, and reads cut
    from the segment: two ranks tie for every end offset, and under the
    all-unbounded span so do offsets."""
    rng = random.Random(73)

    def rnd(n):
        return "".join(rng.choice("ACGT") for _ in range(n))

    seg = rnd(120)
    base = rnd(60) + seg + rnd(90) + seg + rnd(60)
    g = POAGraph()
    g.add_alignment_with_weights("s0", base.encode(), None, [1] * len(base))
    g.post_process()
    reads = [seg.encode(), seg[10:90].encode(), seg[:100].encode()]
    reads += [_mutate(rng, seg, 0.03).encode() for _ in range(61)]
    return _pack_both(g, reads)


def _pack_both(g, reads):
    flat = g.flatten()
    jq, jl = jwf.pack_queries(reads)
    tq, tl = twf.pack_queries(reads, device="cpu")
    return {"graph": g, "flat": flat, "reads": reads,
            "jdg": jwf.DeviceGraph.build(flat),
            "tdg": twf.DeviceGraph.build(flat, device="cpu"),
            "jq": jq, "jl": jl, "tq": tq, "tl": tl}


def _params(case, name):
    jp = jwf.ends_free_device_params(case["flat"], _span(jcosts, name),
                                     case["jl"], case["jdg"].n_nodes_padded)
    tp = convert.ends_free_params_from_reference(
        jp[0], np.asarray(jp[1]), np.asarray(jp[2]), device="cpu")
    return jp, tp


def _assert_triples_equal(got, want, msg=""):
    for name, g_arr, w_arr in zip(("scores", "end ranks", "end offsets"),
                                  got, want):
        np.testing.assert_array_equal(
            g_arr.numpy() if isinstance(g_arr, torch.Tensor) else g_arr,
            np.asarray(w_arr), err_msg=f"{msg} {name}")


# ---- B7 --------------------------------------------------------------------

@pytest.mark.parametrize("max_run", [0, 16])
@pytest.mark.parametrize("name", sorted(SPANS))
def test_bounded_with_ends_plain_equals_pallas(fill_case, name, max_run):
    """(scores, end ranks, end offsets) of the plain version equal the
    Pallas kernel's, uncapped and under a cap that over-estimates rows (the
    40-base insertion), for a free and for a bounded graph begin."""
    case = fill_case
    jp, tp = _params(case, name)
    want = jpf.pallas_bounded_with_ends(
        case["jdg"], case["jq"], case["jl"], COSTS, jp[0], jp[1], jp[2],
        max_run=max_run)
    got = tcf.bounded_with_ends_plain(case["tdg"], case["tq"], case["tl"],
                                      COSTS, *tp, max_run=max_run)
    _assert_triples_equal(got, want, f"{name} max_run {max_run}")
    # the wrapper takes the plain version for a CPU tensor
    _assert_triples_equal(
        tcf.bounded_with_ends(case["tdg"], case["tq"], case["tl"], COSTS,
                              *tp, max_run=max_run), want)
    if max_run:
        exact = tcf.bounded_with_ends_plain(case["tdg"], case["tq"],
                                            case["tl"], COSTS, *tp)
        assert (got[0] >= exact[0]).all()
        if name == "semi-global":
            assert int(got[0][7]) > int(exact[0][7])


@pytest.mark.parametrize("name", sorted(SPANS))
def test_bounded_with_ends_plain_equals_xla_body(fill_case, name):
    case = fill_case
    jp, tp = _params(case, name)
    fn = jwf._scores_exec_bounded_ends(
        case["jdg"].window, COSTS.gap_open, COSTS.gap_extend, COSTS.mismatch,
        jp[0])
    jdg = case["jdg"]
    want = fn(jdg.symbols, jdg.pred_slots, jdg.pred_valid, jdg.write_slots,
              jdg.end_rank, jp[1], case["jq"], case["jl"], jp[2])
    got = twf.dp_fill_ends_free_with_ends(
        case["tdg"], case["flat"], case["tq"], case["tl"], COSTS,
        _span(tcosts, name))
    _assert_triples_equal(got, want, name)
    # the scores are the scoring fill's (B4)
    np.testing.assert_array_equal(
        got[0].numpy(), twf.dp_fill_scores_ends_free(
            case["tdg"], case["flat"], case["tq"], case["tl"], COSTS,
            _span(tcosts, name)).numpy())


@pytest.mark.parametrize("name", ["semi-global", "ends-free"])
def test_end_state_ties(repeat_case, name):
    """Two ranks reach the same best at the same offset (the repeat): the
    lowest rank wins; offsets that tie go to the largest."""
    case = repeat_case
    jp, tp = _params(case, name)
    want = jpf.pallas_bounded_with_ends(
        case["jdg"], case["jq"], case["jl"], COSTS, jp[0], jp[1], jp[2])
    got = tcf.bounded_with_ends_plain(case["tdg"], case["tq"], case["tl"],
                                      COSTS, *tp)
    _assert_triples_equal(got, want, name)
    best, ranks = tcf.bounded_end_rows_plain(case["tdg"], case["tq"], COSTS,
                                             tp[0], tp[1])
    n0 = len(case["reads"][0])
    assert int(best[0, n0]) == 0  # the segment itself: two exact copies
    first = int(ranks[0, n0])
    assert int(got[1][0]) == first
    # the same cell 210 ranks on (the second copy) scores 0 too
    sym = case["flat"].symbols
    assert sym[first] == sym[first + 210]


def test_bounded_end_rows_needs_a_span(fill_case):
    case = fill_case
    with pytest.raises(ValueError):
        tcf._launch_full_fill(tcf.bounded_end_rows, case["tdg"], case["tq"],
                              COSTS, ends=True)


# ---- the anchored schedule and trace -------------------------------------------

@pytest.fixture(scope="module")
def trace_case():
    """A fused ~340-node graph and 12 fragments of 90-200 bases at 4% under
    the semi-global span, with their exact end states."""
    rng = random.Random(79)
    g, base = _fused_graph(rng, 320, d=0.06)
    reads = []
    for _ in range(11):
        a = rng.randrange(0, 110)
        reads.append(_mutate(rng, base[a:a + rng.randrange(90, 200)], 0.04)
                     .encode())
    reads.append((base[40:100] + base[160:230]).encode())  # a 60-base gap
    return _anchored_case(g, reads)


def _anchored_case(g, reads):
    """Both packages' rows of ``reads`` and their exact end states under
    the semi-global span."""
    case = _pack_both(g, reads)
    sc, er, ej = twf.dp_fill_ends_free_with_ends(
        case["tdg"], case["flat"], case["tq"], case["tl"], COSTS,
        _span(tcosts, "semi-global"))
    case.update(scores=sc.numpy().astype(np.int64), er=er.numpy(),
                ej=ej.numpy(), lens=case["tl"].numpy())
    return case


@pytest.fixture(scope="module")
def deletion_case():
    """Reads whose optimal path starts with a stretch of matches and then
    deletes 24-64 graph bases, cheaper than inserting the stretch: each
    starts that many ranks before its diagonal from the anchor, one or two
    ranks inside its range."""
    rng = random.Random(83)
    # a line, so that the corridor's first rank lies at the path's start
    g, base = _backbone_graph(rng, 480, skip_every=480)
    reads = []
    for p, d in ((40, 24), (60, 40), (90, 64), (70, 30)):
        a = rng.randrange(0, 120)
        reads.append((base[a:a + p] + base[a + p + d:a + p + d + 140])
                     .encode())
    return _anchored_case(g, reads)


@pytest.fixture(scope="module")
def start_case():
    """Reads anchored within their proven gap budget of rank 0: a short
    prefix of the graph after 40 inserted bases, and short mutated
    prefixes."""
    rng = random.Random(89)
    g, base = _fused_graph(rng, 300, d=0.05)
    ins = "".join(rng.choice("ACGT") for _ in range(40))
    reads = [(ins + base[:20]).encode(), (ins[:24] + base[:36]).encode()]
    reads += [_mutate(rng, base[:rng.randrange(30, 80)], 0.06).encode()
              for _ in range(4)]
    return _anchored_case(g, reads)


@pytest.fixture(scope="module")
def end_case():
    """Reads cut from the graph's last bases: anchored at its last ranks."""
    rng = random.Random(97)
    g, base = _fused_graph(rng, 300, d=0.05)
    reads = [base[-150:].encode(), base[-60:].encode()]
    reads += [_mutate(rng, base[-rng.randrange(80, 200):], 0.04).encode()
              for _ in range(4)]
    return _anchored_case(g, reads)


def _unpack_bits(packed, Np):
    words = np.asarray(packed).astype(np.uint32)
    bits = (words[:, :, None] >> np.arange(32, dtype=np.uint32)) & 1
    return bits.reshape(words.shape[0], -1)[:, :Np].astype(bool)


@pytest.mark.parametrize("Wb", [256, 512])
def test_anchored_schedule_matches_jax(trace_case, Wb):
    case = trace_case
    flat, Np = case["flat"], case["tdg"].n_nodes_padded
    k, _ = tr.gap_budgets(flat, case["scores"], COSTS, Wb)
    j_packed, j_any, j_starts, j_ok = jpt.build_trace_schedule(
        flat, case["lens"], k, Wb, Np, case["er"], case["ej"])
    steps, ok = tr.build_trace_schedule(
        flat, case["lens"], k, Wb, Np, device="cpu", anchor_r_np=case["er"],
        anchor_j_np=case["ej"])
    assert np.array_equal(ok, np.asarray(j_ok))
    assert np.array_equal(steps.numpy(), _unpack_bits(j_packed, Np))
    n = flat.n_nodes
    assert np.array_equal(tr.window_starts(steps).numpy()[:, :n],
                          np.asarray(j_starts)[:, :n])
    # the rank range the schedule reports holds every rank the anchor's
    # corridor touches, and the anchor itself
    body = tr._schedule_body(
        *tr._sched_potentials(flat, Np, "cpu"),
        torch.as_tensor(case["lens"].astype(np.int64)),
        torch.as_tensor(k.astype(np.int64)),
        torch.as_tensor(case["ej"].astype(np.int64)),
        torch.as_tensor(flat.min_dist_from_start[case["er"]]
                        .astype(np.int64)),
        torch.as_tensor(flat.max_dist_from_start[case["er"]]
                        .astype(np.int64)), n, Wb)
    r_lo, r_hi, has = (t.numpy() for t in body[3:])
    assert has.all()
    assert (r_lo <= case["er"]).all() and (case["er"] <= r_hi).all()


def _jax_anchored_tier(case, Wb, free_start):
    """One tier of the reference's ``pallas_trace_align`` with anchors, in
    interpret mode, for every read."""
    flat, jdg = case["flat"], case["jdg"]
    q = case["tq"].numpy()
    B, L = q.shape
    Np = jdg.n_nodes_padded
    P = int(jdg.pred_slots.shape[1])
    k, k_full = tr.gap_budgets(flat, case["scores"], COSTS, Wb)
    packed, any_step, starts, ok = jpt.build_trace_schedule(
        flat, case["lens"], k, Wb, Np, case["er"], case["ej"])
    blk = 32
    Bp = -(-B // blk) * blk
    LQ = max(L, Wb + 128)
    qpad = np.zeros((Bp, LQ), np.int32)
    qpad[:B, :L] = q
    sb = jnp.pad(packed, ((0, Bp - B), (0, 0)))
    arp = np.zeros((Bp,), np.int32)
    arp[:B] = case["er"]
    ajp = np.zeros((Bp,), np.int32)
    ajp[:B] = case["ej"]
    fn = jpt._trace_exec(Bp // blk, Np, jdg.window, P, Wb, int(sb.shape[1]),
                         LQ, COSTS.gap_open, COSTS.gap_extend, COSTS.mismatch,
                         blk, free_start)
    aval, ptr = fn(jdg.symbols, jdg.pred_slots_flat, jdg.pred_valid_flat,
                   jdg.write_slots, any_step, jdg.meta, jnp.asarray(qpad), sb,
                   jnp.asarray(arp), jnp.asarray(ajp))
    aval = np.asarray(aval)[:B]
    verified = (aval == case["scores"]) & np.asarray(ok)
    t_max = int(-(-(int(case["lens"].max()) + int(k_full.max()) + 8)
                  // 512) * 512)
    pr = np.zeros((Np, P), np.int32)
    pr[:jdg.pred_ranks_np.shape[0]] = jdg.pred_ranks_np
    vp = np.zeros((Bp,), bool)
    vp[:B] = verified
    stp = jnp.pad(starts, ((0, Bp - B), (0, 0)))
    ops, done = jpt._decode_exec(t_max, Np, Bp, Wb, P)(
        ptr, jnp.asarray(pr.reshape(-1)), stp.reshape(-1), jnp.asarray(arp),
        jnp.asarray(ajp), jnp.asarray(np.int32(jdg.end_rank_i)),
        jnp.asarray(vp))
    return {"ptr": np.array(ptr)[:Np, :B], "aval": aval, "k": k,
            "verified": verified, "ops": np.array(ops)[:B],
            "done": np.array(done)[:B], "t_max": t_max}


@pytest.mark.parametrize("Wb", [256, 512])
def test_anchored_trace_fill_and_decode_match_jax(trace_case, Wb):
    """With ``free_start``: the plain trace fill's planes and anchor values
    and the plain decode's step words equal the Pallas kernel's and the XLA
    decode's; every verified read's chain stops at an origin word away
    from rank 0 and replays to an alignment that costs its score."""
    case = trace_case
    flat, dg = case["flat"], case["tdg"]
    n = flat.n_nodes
    ref = _jax_anchored_tier(case, Wb, True)
    inp, ok = tr.tier_inputs(dg, flat, case["tq"], case["lens"], ref["k"],
                             Wb, case["er"], case["ej"])
    aval, ptr = tr.trace_fill_plain(dg, **inp, costs=COSTS, Wb=Wb,
                                    free_start=True)
    assert np.array_equal(ptr.numpy()[:n], ref["ptr"][:n])
    assert np.array_equal(aval.numpy(), ref["aval"])
    assert ref["verified"].sum() >= 10
    # the global origin rule gives other planes on these inputs
    assert not torch.equal(
        ptr, tr.trace_fill_plain(dg, **inp, costs=COSTS, Wb=Wb)[1])
    walk = (tr.pred_rank_table(dg, "cpu"), inp["wstarts"], inp["anchor_r"],
            inp["anchor_j"], dg.end_rank_i, torch.as_tensor(ref["verified"]),
            ref["t_max"])
    ops, done = tr.decode_plain(ptr, *walk)
    assert np.array_equal(ops.numpy(), ref["ops"])
    assert np.array_equal(done.numpy(), ref["done"])
    stops_off_rank_0 = 0
    for b in np.nonzero(ref["verified"] & ref["done"])[0]:
        words = ref["ops"][b]
        last = int(np.nonzero(words)[0][-1])
        if words[last] & 15 == tr.OP_STOP and words[last] >> 4 > 0:
            stops_off_rank_0 += 1
        got = tr.replay_steps(words, int(case["ej"][b]), flat.node_of_rank)
        want = jpt.replay_steps(words, int(case["ej"][b]), flat.node_of_rank)
        assert np.array_equal(got[0], want[0])
        assert np.array_equal(got[1], want[1])
    assert stops_off_rank_0 > 0


def test_anchored_trace_align_matches_native(trace_case):
    """``trace_align`` with anchors: every read's alignment equals the
    native engine's anchored corridor backtrace."""
    case = trace_case
    outs = tr.trace_align(case["tdg"], case["flat"], case["tq"], case["tl"],
                          COSTS, case["scores"], anchor_r=case["er"],
                          anchor_j=case["ej"], free_start=True)
    na = NativeAligner(case["graph"])
    for b, read in enumerate(case["reads"]):
        score, naln = na.align_anchored(
            read, COSTS, int(case["flat"].node_of_rank[case["er"][b]]),
            int(case["ej"][b]), int(case["scores"][b]), free_start=True)
        assert score == int(case["scores"][b])
        assert outs[b] is not None, f"read {b} not verified by any tier"
        assert list(outs[b]) == list(naln), b


def _in_range(ptr, r_begin, r_end):
    """``ptr`` (Np, B, Wb) with each read's rows outside its rank range
    zeroed, as the plain trace fill leaves them: what a kernel's planes are
    compared on."""
    r = torch.arange(ptr.shape[0], device=ptr.device).view(-1, 1)
    walked = (r >= r_begin.view(1, -1)) & (r <= r_end.view(1, -1))
    return torch.where(walked.unsqueeze(-1), ptr, 0)


# ---- the anchored trace over each read's rank range -------------------------------

RANGE_CASES = ["trace_case", "deletion_case", "start_case", "end_case"]


def _case_holds_its_shape(name, case, k_full):
    """Each new fixture reaches the corner it was built for."""
    flat = case["flat"]
    if name == "start_case":
        assert (case["er"] < k_full).any()
    elif name == "end_case":
        assert case["er"].max() >= flat.n_nodes - 3


@pytest.mark.parametrize("Wb", [256, 512])
@pytest.mark.parametrize("name", RANGE_CASES)
def test_ranged_trace_equals_the_full_walk(request, name, Wb):
    """``trace_align``'s ``free_start`` route at one tier: the plain trace
    fill over each read's rank range (``trace_ranges``) verifies the same
    reads as the walk over every rank, has the same anchor value wherever
    that equals the score (and none below the full walk's anywhere), and
    its planes decode to the same step words and alignments."""
    case = request.getfixturevalue(name)
    flat, dg = case["flat"], case["tdg"]
    sc = case["scores"]
    k, k_full = tr.gap_budgets(flat, sc, COSTS, Wb)
    _case_holds_its_shape(name, case, k_full)
    inp, ok = tr.tier_inputs(dg, flat, case["tq"], case["lens"], k, Wb,
                             case["er"], case["ej"], k_full, True)
    rb, re = inp.pop("r_begin"), inp.pop("r_end")
    # the driver's ranges, from the schedule's operands, are trace_ranges'
    want = tr.trace_ranges(flat, case["lens"], k_full, dg.n_nodes_padded,
                           "cpu", case["er"], case["ej"], True)
    assert torch.equal(rb, want[0]) and torch.equal(re, want[1])
    assert np.array_equal(re.numpy(), case["er"])
    assert (rb.numpy() <= case["er"]).all() and (rb.numpy() >= 0).all()
    aval_f, ptr_f = tr.trace_fill_plain(dg, **inp, costs=COSTS, Wb=Wb,
                                        free_start=True)
    aval_r, ptr_r = tr.trace_fill_plain(dg, **inp, costs=COSTS, Wb=Wb,
                                        free_start=True, r_begin=rb, r_end=re)
    aval_f, aval_r = aval_f.numpy(), aval_r.numpy()
    verified = (aval_f == sc) & ok
    assert np.array_equal((aval_r == sc) & ok, verified)
    assert verified.sum() >= len(sc) // 2
    assert np.array_equal(aval_r[aval_f == sc], aval_f[aval_f == sc])
    assert (aval_r >= aval_f).all()
    # the rows outside a read's range stay 0
    assert torch.equal(_in_range(ptr_r, rb, re), ptr_r)
    t_max = int(-(-(int(case["lens"].max()) + int(k_full.max()) + 8)
                  // 512) * 512)
    walk = (tr.pred_rank_table(dg, "cpu"), inp["wstarts"], inp["anchor_r"],
            inp["anchor_j"], dg.end_rank_i, torch.as_tensor(verified), t_max)
    ops_f, done_f = tr.decode_plain(ptr_f, *walk)
    ops_r, done_r = tr.decode_plain(ptr_r, *walk)
    assert torch.equal(ops_r, ops_f) and torch.equal(done_r, done_f)
    for b in np.nonzero(verified & done_f.numpy())[0]:
        got = tr.replay_steps(ops_r[b].numpy(), int(case["ej"][b]),
                              flat.node_of_rank)
        want = tr.replay_steps(ops_f[b].numpy(), int(case["ej"][b]),
                               flat.node_of_rank)
        assert np.array_equal(got[0], want[0])
        assert np.array_equal(got[1], want[1])
        steps = ops_r[b].numpy()
        ranks = steps[steps != 0] >> 4
        assert ranks.min() >= rb[b] and ranks.max() <= re[b]
        if name == "deletion_case":
            # the path starts well before its diagonal from the anchor
            first = int(ranks[-1])
            assert first < case["er"][b] - case["ej"][b] - 16, b
            assert first <= rb[b] + 2, b  # and the range is tight there


@pytest.mark.parametrize("name", RANGE_CASES[1:])
def test_ranged_trace_align_matches_native(request, name):
    """``trace_align`` with anchors, over each read's rank range, on the
    reads that start before their diagonal and those anchored near either
    end of the graph: every alignment equals the native engine's."""
    case = request.getfixturevalue(name)
    outs = tr.trace_align(case["tdg"], case["flat"], case["tq"], case["tl"],
                          COSTS, case["scores"], anchor_r=case["er"],
                          anchor_j=case["ej"], free_start=True)
    na = NativeAligner(case["graph"])
    for b, read in enumerate(case["reads"]):
        score, naln = na.align_anchored(
            read, COSTS, int(case["flat"].node_of_rank[case["er"][b]]),
            int(case["ej"][b]), int(case["scores"][b]), free_start=True)
        assert score == int(case["scores"][b])
        assert outs[b] is not None, f"read {b} not verified by any tier"
        assert list(outs[b]) == list(naln), b


def test_trace_ranges_without_a_free_start(trace_case):
    """Without ``free_start`` the one origin is rank 0: each read walks
    from rank 0 to its anchor rank."""
    case = trace_case
    flat = case["flat"]
    _, k_full = tr.gap_budgets(flat, case["scores"], COSTS, 256)
    rb, re = tr.trace_ranges(flat, case["lens"], k_full,
                             case["tdg"].n_nodes_padded, "cpu", case["er"],
                             case["ej"], False)
    assert not rb.any() and np.array_equal(re.numpy(), case["er"])
    assert rb.dtype == re.dtype == torch.int32
    inp, _ = tr.tier_inputs(case["tdg"], flat, case["tq"], case["lens"],
                            k_full, 256, case["er"], case["ej"], k_full,
                            False)
    assert torch.equal(inp["r_begin"], rb) and torch.equal(inp["r_end"], re)


# ---- the slice as a whole --------------------------------------------------------

def _backbone_graph(rng, n, skip_every=97):
    base = "".join(rng.choice("ACGT") for _ in range(n))
    g = POAGraph()
    g.add_alignment_with_weights("s0", base.encode(), None, [1] * n)
    for v in range(0, n - 3, skip_every):
        g.add_edge(v, v + 3, 0, 1)
    g.post_process()
    return g, base


@pytest.fixture(scope="module")
def mapping_case():
    """A 1200-base backbone with skip edges and 8 reads of 600 bases at
    1%, one of them random (it never seeds)."""
    rng = random.Random(13)
    g, base = _backbone_graph(rng, 1200)
    reads = []
    for _ in range(8):
        a = rng.randrange(0, 600)
        reads.append(_mutate(rng, base[a:a + 600], 0.01).encode())
    reads[5] = "".join(rng.choice("ACGT") for _ in range(400)).encode()
    return g, base, reads


def _alignments(out):
    return [(int(s), [(p.rpos, p.qpos) for p in a]) for s, a in out]


@pytest.mark.parametrize("name", sorted(SPANS))
def test_align_batch_equals_the_reference(mapping_case, name):
    """Two batches (the first teaches the seed rates, the second seeds
    where the span allows it): scores, alignments and the seeded path's
    counters equal ``poasta_tpu``'s; every alignment costs its score."""
    g, _, reads = mapping_case
    jm = JaxMapper(g, COSTS, aln_type=_span(jcosts, name))
    tm = BatchMapper(g, COSTS, device="cpu", aln_type=_span(tcosts, name))
    for round_ in range(2):
        want = jm.align_batch(reads)
        got = tm.align_batch(reads)
        assert _alignments(got) == _alignments(want), (name, round_)
        js, ts = jm.last_ends_free_stats, tm.last_ends_free_stats
        assert ts["anchored_ok"] == js["anchored_ok"] == len(reads)
        assert ts["exact_fallback"] == js["exact_fallback"] == 0
        assert "trace_error" not in js
    jsd, tsd = getattr(jm, "last_seed_stats", None), tm.last_seed_stats
    if name == "semi-global":
        assert tsd["seeded"] >= 6 and tsd["seed_tail"] >= 1
        for key in ("seeded", "seed_tail", "seed_k"):
            assert tsd[key] == jsd[key], key
    else:
        assert tsd is None and jsd is None
    for (score, aln), read in zip(got, reads):
        assert twf.alignment_cost(g, read, aln, COSTS) == score
        assert jwf.alignment_cost(g, read, aln, COSTS) == score


@pytest.mark.parametrize("name", sorted(SPANS))
def test_align_batch_equals_the_exact_engine(name):
    """Short reads through the same path against the A* engine under
    Dijkstra (its minimum-gap-cost heuristic is not admissible when ends
    are free)."""
    rng = random.Random(83)
    g, base = _fused_graph(rng, 150)
    reads = [_mutate(rng, base[a:a + n], 0.05).encode()
             for a, n in ((0, 60), (40, 70), (70, 75), (20, 120))]
    tm = BatchMapper(g, COSTS, device="cpu", aln_type=_span(tcosts, name))
    engine = PoastaAligner(COSTS, _span(tcosts, name), heuristic="dijkstra")
    got = tm.align_batch(reads)
    assert [s for s, _ in got] == [engine.align(g, r).score for r in reads]
    assert [s for s, _ in got] == list(map(int, tm.score_batch(reads)))


def test_trace_route_and_host_route_agree(mapping_case, monkeypatch):
    """POASTA_DEVICE_TRACE=0 sends every read to ``align_anchored``;
    POASTA_SEED=0 fills every batch at full width: one answer."""
    g, _, reads = mapping_case
    span = _span(tcosts, "semi-global")
    tm = BatchMapper(g, COSTS, device="cpu", aln_type=span)
    tm.align_batch(reads)
    want = _alignments(tm.align_batch(reads))
    assert tm.last_ends_free_stats["device_traced"] >= 7
    assert tm.last_banded_stats["device_traced"] \
        == tm.last_ends_free_stats["device_traced"]
    monkeypatch.setenv("POASTA_DEVICE_TRACE", "0")
    assert _alignments(tm.align_batch(reads)) == want
    assert tm.last_ends_free_stats["device_traced"] == 0
    assert tm.last_banded_stats == {"device_traced": 0,
                                    "host_backtraced": len(reads)}
    monkeypatch.delenv("POASTA_DEVICE_TRACE")
    monkeypatch.setenv("POASTA_SEED", "0")
    plain = BatchMapper(g, COSTS, device="cpu", aln_type=span)
    plain.align_batch(reads)
    assert _alignments(plain.align_batch(reads)) == want
    assert plain.last_seed_stats is None and plain._seed_rate is None


def test_prescore_token_carries_end_states(mapping_case):
    g, _, reads = mapping_case
    tm = BatchMapper(g, COSTS, device="cpu",
                     aln_type=_span(tcosts, "semi-global"))
    want = _alignments(tm.align_batch(reads))
    token = tm.prescore(reads)
    assert token[0] is reads and len(token[1]) == 3
    assert _alignments(tm.align_batch(reads, prescored=token)) == want
    assert not tm.takes_banded_path(reads)
    assert tm.prescore([]) is None and tm.align_batch([]) == []


def test_capped_ladder_keeps_end_states(fill_case, monkeypatch):
    """With the ladder driven on the CPU (the card's route): capped fills
    run, and scores and end states equal the uncapped fill's."""
    case = fill_case
    tm = BatchMapper(case["graph"], COSTS, device="cpu",
                     aln_type=_span(tcosts, "semi-global"))
    lens = case["tl"].numpy().astype(np.int64)
    want = tm._fill_ends_free_capped(case["tq"], case["tl"], lens)
    caps = []
    real = tmapper.dp_fill_ends_free_with_ends
    monkeypatch.setattr(
        tmapper, "dp_fill_ends_free_with_ends",
        lambda *a, max_run=0: caps.append(max_run) or real(*a,
                                                           max_run=max_run))
    monkeypatch.setattr(BatchMapper, "_ef_cap_enabled", lambda self: True)
    for _ in range(2):
        got = tm._fill_ends_free_capped(case["tq"], case["tl"], lens)
        _assert_triples_equal(got, want)
    assert caps[0] > 0 and caps[-1] > 0
    key = (int(lens.min()), int(lens.max()))
    assert tm._ef_ub_hint[key] == int(want[0].max())
    assert tbd.ins_run_cap(COSTS, tm._ef_ub_hint[key], 384) == caps[-1]


# ---- reference faults the port does not copy ---------------------------------------

def test_anchored_trace_error_propagates(mapping_case, monkeypatch):
    """The reference files an exception of the anchored device trace under
    ``stats["trace_error"]`` and carries on (``mapper.py:872-876``)."""
    g, _, reads = mapping_case

    def broken(*args, **kwargs):
        raise RuntimeError("trace kernel failed")

    tm = BatchMapper(g, COSTS, device="cpu",
                     aln_type=_span(tcosts, "semi-global"))
    monkeypatch.setattr(tr, "trace_fill_plain", broken)
    with pytest.raises(RuntimeError, match="trace kernel failed"):
        tm.align_batch(reads)
    jm = JaxMapper(g, COSTS, aln_type=_span(jcosts, "semi-global"))
    with mock.patch.object(jpt, "pallas_trace_align", broken):
        out = jm.align_batch(reads)
    assert len(out) == len(reads)
    assert "trace kernel failed" in jm.last_ends_free_stats["trace_error"]


def test_unverified_anchor_raises(mapping_case, monkeypatch):
    """A wrong end state shows up as a corridor ``align_anchored`` cannot
    verify.  The reference then quietly aligns the read with the exact
    engine (``mapper.py:893-905``); the port raises, naming the read and
    its (score, rank, offset)."""
    g, _, reads = mapping_case
    monkeypatch.setenv("POASTA_DEVICE_TRACE", "0")
    tm = BatchMapper(g, COSTS, device="cpu",
                     aln_type=_span(tcosts, "semi-global"))
    real = BatchMapper._ends_free_scores

    def wrong_end(self, queries, qshift, lengths):
        sc, er, ej = real(self, queries, qshift, lengths)
        er = er.copy()
        er[2] = (er[2] + 300) % 900 + 1
        return sc, er, ej

    monkeypatch.setattr(BatchMapper, "_ends_free_scores", wrong_end)
    with pytest.raises(RuntimeError, match=r"read 2: .*never verified score "
                                           r"\d+ at end state \(rank \d+, "
                                           r"offset \d+\)"):
        tm.align_batch(reads)


def test_unsatisfiable_span_raises(mapping_case):
    g, _, reads = mapping_case
    tm = BatchMapper(g, COSTS, device="cpu", aln_type=tcosts.EndsFree(
        graph_free_end=("excluded", 0)))
    with pytest.raises(RuntimeError, match="unsatisfiable bounds"):
        tm.align_batch(reads[:2])
