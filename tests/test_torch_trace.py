"""The port's device traceback (``poasta_tpu_torch/ops/trace.py``) on the
CPU, against ``poasta_tpu/ops/pallas_trace.py`` in Pallas interpret mode
and against the native engine's banded backtrace.  Tolerance 0: schedules,
pointer planes, anchor values, decode step words and alignments must be
equal.

Cases are ``tests/test_trace.py``'s: seeds 5/17/29 with GapAffine(4,2,6)
and (3,1,9) plus a big-indel read that needs a wider tier, and the four
edge cases (perfect, b"A", query >> graph, query << graph).
"""

import random

import numpy as np
import pytest
import torch

from poasta_tpu.aligner import GapAffine, Global, PoastaAligner
from poasta_tpu.aligner import wavefront as jwf
from poasta_tpu.graphs import POAGraph
from poasta_tpu.native import NativeAligner
from poasta_tpu.ops import pallas_trace as jpt
from poasta_tpu.ops.pallas_fill import set_interpret_mode
from poasta_tpu_torch import BatchMapper
from poasta_tpu_torch.aligner.wavefront import (
    DeviceGraph,
    pack_queries,
    scan_scores,
)
from poasta_tpu_torch.ops import trace as tr

torch.set_num_threads(1)

CASES = ["seed5", "seed17", "seed29", "edges"]


@pytest.fixture(autouse=True)
def _interpret():
    set_interpret_mode(True)
    try:
        yield
    finally:
        set_interpret_mode(False)


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


def _fused_graph(rng, costs, length=160, nseq=3, d=0.08):
    base = "".join(rng.choice("ACGT") for _ in range(length))
    g = POAGraph()
    al = PoastaAligner(costs, Global(), heuristic="mingap")
    g.add_alignment_with_weights("s0", base.encode(), None, [1] * length)
    for i in range(1, nseq):
        s = _mutate(rng, base, d).encode()
        r = al.align(g, s)
        g.add_alignment_with_weights(f"s{i}", s, r.alignment, [1] * len(s))
    return g, base


def _case(name):
    """(graph, reads, costs) of one ``tests/test_trace.py`` case."""
    if name == "edges":
        costs = GapAffine(4, 2, 6)
        rng = random.Random(41)
        g, base = _fused_graph(rng, costs, length=80, nseq=2)
        return g, [base.encode(), b"A", (base * 2).encode(),
                   base[:20].encode()], costs
    seed = int(name[4:])
    costs = GapAffine(3, 1, 9) if seed == 29 else GapAffine(4, 2, 6)
    rng = random.Random(seed)
    g, base = _fused_graph(rng, costs)
    reads = [_mutate(rng, base, 0.08).encode() for _ in range(5)]
    reads.append((base[:40] + base[120:]).encode())  # tier-retry read
    return g, reads, costs


def _setup(name):
    g, reads, costs = _case(name)
    flat = g.flatten()
    dg = DeviceGraph.build(flat, device="cpu")
    q, lengths = pack_queries(reads, device="cpu")
    scores = scan_scores(dg, q, lengths, costs).numpy()
    return g, flat, dg, reads, q, lengths, scores, costs


def _k_tier(flat, scores, costs, Wb):
    k_tier, k_full = tr.gap_budgets(flat, scores, costs, Wb)
    # the formula of poasta_tpu/ops/pallas_trace.py:979, :1012-1013
    n = flat.n_nodes
    spread = int((flat.max_dist_from_start[:n].astype(np.int64)
                  - flat.min_dist_from_start[:n]).max())
    ref_full = np.maximum(scores.astype(np.int64) - costs.gap_open, 0) \
        // costs.gap_extend + 1
    assert np.array_equal(k_full, ref_full)
    assert np.array_equal(k_tier, np.minimum(
        ref_full, np.maximum((Wb - spread - 160) // 2, 16)))
    return k_tier, k_full


def _unpack_bits(packed, Np):
    words = np.asarray(packed).astype(np.uint32)
    bits = (words[:, :, None] >> np.arange(32, dtype=np.uint32)) & 1
    return bits.reshape(words.shape[0], -1)[:, :Np].astype(bool)


@pytest.mark.parametrize("name", CASES)
def test_schedule_matches_jax(name):
    _, flat, dg, _, _, lengths, scores, costs = _setup(name)
    Np = dg.n_nodes_padded
    for Wb in (256, 1024):
        k, _ = _k_tier(flat, scores, costs, Wb)
        lens = lengths.numpy()
        j_packed, j_any, j_starts, j_ok = jpt.build_trace_schedule(
            flat, lens, k, Wb, Np)
        steps, ok = tr.build_trace_schedule(flat, lens, k, Wb, Np,
                                            device="cpu")
        assert np.array_equal(ok, np.asarray(j_ok))
        assert np.array_equal(steps.numpy(), _unpack_bits(j_packed, Np))
        assert np.array_equal(steps.numpy().any(axis=0).astype(np.int32),
                              np.asarray(j_any))
        # the fill's window starts are the schedule's, less its start at
        # rank 0 (the schedule's starts are 0 past the last real rank)
        n = flat.n_nodes
        j_starts = np.asarray(j_starts)
        wst = tr.window_starts(steps).numpy()
        assert np.array_equal(wst[:, :n] + j_starts[:, :1], j_starts[:, :n])
        assert not j_starts[:, n:].any()


def _jax_tier(flat, jdg, qshift, lengths, scores, costs, Wb):
    """One tier of ``pallas_trace_align`` for every read, in interpret
    mode: (schedule, planes, aval, ops, done, t_max, inputs)."""
    import jax.numpy as jnp

    B, L = qshift.shape
    Np = jdg.n_nodes_padded
    P = int(jdg.pred_slots.shape[1])
    k, k_full = _k_tier(flat, scores, costs, Wb)
    packed, any_step, starts, ok = jpt.build_trace_schedule(
        flat, lengths, k, Wb, Np)
    blk = 32
    Bp = -(-B // blk) * blk
    LQ = max(L, Wb + 128)
    qpad = np.zeros((Bp, LQ), np.int32)
    qpad[:B, :L] = qshift
    sb = jnp.pad(packed, ((0, Bp - B), (0, 0)))
    arp = np.zeros((Bp,), np.int32)
    arp[:B] = jdg.end_rank_i
    ajp = np.zeros((Bp,), np.int32)
    ajp[:B] = lengths
    fn = jpt._trace_exec(Bp // blk, Np, jdg.window, P, Wb, int(sb.shape[1]),
                         LQ, costs.gap_open, costs.gap_extend, costs.mismatch,
                         blk, False)
    aval, ptr = fn(jdg.symbols, jdg.pred_slots_flat, jdg.pred_valid_flat,
                   jdg.write_slots, any_step, jdg.meta, jnp.asarray(qpad), sb,
                   jnp.asarray(arp), jnp.asarray(ajp))
    aval = np.asarray(aval)[:B]
    verified = (aval == scores) & np.asarray(ok)
    t_max = int(-(-(int(lengths.max()) + int(k_full.max()) + 8) // 512) * 512)
    pr = np.zeros((Np, P), np.int32)
    pr[:jdg.pred_ranks_np.shape[0]] = jdg.pred_ranks_np
    vp = np.zeros((Bp,), bool)
    vp[:B] = verified
    stp = jnp.pad(starts, ((0, Bp - B), (0, 0)))
    ops, done = jpt._decode_exec(t_max, Np, Bp, Wb, P)(
        ptr, jnp.asarray(pr.reshape(-1)), stp.reshape(-1), jnp.asarray(arp),
        jnp.asarray(ajp), jnp.asarray(np.int32(jdg.end_rank_i)),
        jnp.asarray(vp))
    # writable copies: torch wraps them without copying
    return {"ptr": np.array(ptr)[:Np, :B], "aval": aval,
            "verified": verified, "ops": np.array(ops)[:B],
            "done": np.array(done)[:B], "t_max": t_max, "pr": pr,
            "starts": np.array(starts)}


@pytest.mark.parametrize("name", CASES)
def test_trace_fill_and_decode_match_jax(name):
    """At the first two tiers, for every read of the case: the plain trace
    fill's planes and anchor values, and the plain decode's step words
    and done flags (over the same planes), equal the Pallas kernel's and
    the XLA decode's; replay_steps equals its original."""
    _, flat, dg, _, q, lengths, scores, costs = _setup(name)
    jdg = jwf.DeviceGraph.build(flat)
    lens = lengths.numpy()
    n = flat.n_nodes
    any_verified = 0
    for Wb in (256, 512):
        ref = _jax_tier(flat, jdg, q.numpy(), lens, scores, costs, Wb)
        k, _ = _k_tier(flat, scores, costs, Wb)
        inp, ok = tr.tier_inputs(dg, flat, q, lens, k, Wb)
        aval, ptr = tr.trace_fill_plain(dg, **inp, costs=costs, Wb=Wb)
        assert np.array_equal(ptr.numpy()[:n], ref["ptr"][:n]), Wb
        assert np.array_equal(aval.numpy(), ref["aval"]), Wb
        assert not ptr[n:].any()

        pr = tr.pred_rank_table(dg, "cpu")
        assert np.array_equal(pr.numpy(), ref["pr"].reshape(-1))
        verified = torch.as_tensor(ref["verified"])
        walk = (inp["anchor_r"], inp["anchor_j"], dg.end_rank_i, verified,
                ref["t_max"])
        ops, done = tr.decode_plain(torch.as_tensor(ref["ptr"]), pr,
                                    torch.as_tensor(ref["starts"]), *walk)
        assert np.array_equal(ops.numpy(), ref["ops"]), Wb
        assert np.array_equal(done.numpy(), ref["done"]), Wb
        # the port's own planes decode to the same words
        ops2, done2 = tr.decode_plain(ptr, pr, inp["wstarts"], *walk)
        assert np.array_equal(ops2.numpy(), ref["ops"]), Wb
        assert np.array_equal(done2.numpy(), ref["done"]), Wb
        for b in np.nonzero(ref["verified"] & ref["done"])[0]:
            got = tr.replay_steps(ref["ops"][b], int(lens[b]),
                                  flat.node_of_rank)
            want = jpt.replay_steps(ref["ops"][b], int(lens[b]),
                                    flat.node_of_rank)
            assert np.array_equal(got[0], want[0])
            assert np.array_equal(got[1], want[1])
            any_verified += 1
    assert any_verified > 0


def _pairs(aln):
    return list(zip(aln.rpos_arr.tolist(), aln.qpos_arr.tolist()))


@pytest.mark.parametrize("name", CASES)
def test_trace_align_matches_native(name):
    g, flat, dg, reads, q, lengths, scores, costs = _setup(name)
    outs = tr.trace_align(dg, flat, q, lengths, costs, scores)
    na = NativeAligner(g)
    for b, read in enumerate(reads):
        ns, naln = na.align_banded(read, costs, ub=int(scores[b]))
        assert ns == int(scores[b])
        assert outs[b] is not None, f"read {b} not verified by any tier"
        want = list(zip(np.where(naln.rpos_arr < 0, -1, naln.rpos_arr)
                        .tolist(),
                        np.where(naln.qpos_arr < 0, -1, naln.qpos_arr)
                        .tolist()))
        assert _pairs(outs[b]) == want, b


@pytest.mark.parametrize("mode,on", [("", True), ("1", True),
                                     ("all", True), ("0", False)])
def test_trace_enabled_opt_out(monkeypatch, mode, on):
    """The device trace runs at every graph size; only
    ``POASTA_DEVICE_TRACE=0`` sends every read to the host backtrace."""
    monkeypatch.setenv("POASTA_DEVICE_TRACE", mode)
    assert tr.trace_enabled() is on


def _traced_pairs(name):
    _, flat, dg, _, q, lengths, scores, costs = _setup(name)
    outs = tr.trace_align(dg, flat, q, lengths, costs, scores)
    return [None if a is None else list(a) for a in outs]


@pytest.mark.parametrize("cap", [1, 2])
def test_trace_align_splits_by_free_memory(monkeypatch, cap):
    """Where the device's free memory holds only ``cap`` reads' buffers of
    a tier, the pending reads run in sub-batches, with the same result."""
    want = _traced_pairs("seed17")
    launches = []
    real_fill = tr.trace_fill

    def counting_fill(g, qpad, *args, **kwargs):
        launches.append(int(qpad.shape[0]))
        return real_fill(g, qpad, *args, **kwargs)

    monkeypatch.setattr(tr, "trace_fill", counting_fill)
    monkeypatch.setattr(tr, "tier_bytes_per_read", lambda dg, Wb: 1)
    monkeypatch.setattr(tr, "free_bytes", lambda dev: 2 * cap)
    assert _traced_pairs("seed17") == want
    assert max(launches) <= cap and sum(launches) >= len(want)


def test_read_past_free_memory_takes_host_backtrace(monkeypatch):
    """A read whose trace buffers alone pass the device's free memory stays
    untraced; align_batch aligns it with the native banded backtrace."""
    g, reads, costs, mapper = _mapper_case(0, monkeypatch)
    want = mapper.align_batch(reads)
    assert mapper.last_banded_stats["device_traced"] == len(reads)
    monkeypatch.setattr(tr, "free_bytes", lambda dev: 0)
    got = mapper.align_batch(reads)
    assert mapper.last_banded_stats == {"device_traced": 0,
                                        "host_backtraced": len(reads)}
    assert [(s, list(a)) for s, a in got] == \
        [(s, list(a)) for s, a in want]


def _mapper_case(budget, monkeypatch):
    g, reads, costs = _case("seed17")
    monkeypatch.setattr(BatchMapper, "DENSE_TABLE_BUDGET", budget)
    return g, reads, costs, BatchMapper(g, costs, device="cpu")


def test_trace_error_propagates(monkeypatch):
    """ROADMAP C4: the reference hands the whole batch to the host when the
    trace raises (``mapper.py:1087-1092``).  The port lets it propagate."""
    g, reads, costs, mapper = _mapper_case(0, monkeypatch)

    def broken(*args, **kwargs):
        raise RuntimeError("trace kernel failed")

    monkeypatch.setattr(tr, "trace_fill_plain", broken)
    with pytest.raises(RuntimeError, match="trace kernel failed"):
        mapper.align_batch(reads)


def test_missing_native_engine_raises(monkeypatch):
    """ROADMAP C4: the reference's ``_init_banded`` quietly takes the dense
    route when the native engine cannot be built (``mapper.py:976-977``).
    The port raises."""
    import poasta_tpu_torch.native as native

    g, reads, costs, mapper = _mapper_case(0, monkeypatch)

    def unavailable(*args, **kwargs):
        raise OSError("native library unavailable")

    monkeypatch.setattr(native, "NativeAligner", unavailable)
    with pytest.raises(OSError):
        mapper.align_batch(reads)


def test_trace_wrappers_refuse_other_devices():
    g, reads, costs = _case("edges")
    dg = DeviceGraph.build(g.flatten(), device="cpu")
    meta = torch.zeros((1, 512), dtype=torch.int32, device="meta")
    ws = torch.zeros((1, dg.n_nodes_padded), dtype=torch.int32,
                     device="meta")
    one = torch.zeros((1,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        tr.trace_fill(dg, meta, ws, one, one, costs, 256)
    planes = torch.zeros((dg.n_nodes_padded, 1, 256), dtype=torch.int32,
                         device="meta")
    with pytest.raises(ValueError):
        tr.trace_decode(planes, one, ws, one, one, dg.end_rank_i,
                        one.bool(), 512)
