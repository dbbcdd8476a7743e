"""A numpy model of the register bodies of the trace fill
(``csrc/trace_kernel.cu``: ``trace_fill_kernel``, B18, global and with
``free_start``) and the seeded corridor fill (``csrc/seed_kernel.cu``:
``seed_fill_kernel``, B8), rank by rank as the kernels take them: thread t
owns the K lanes [tK, tK + K); each ring slot remembers the window start it
was written at, and a gather reads its row that many lanes right (a
multiple of 128: a thread's lanes are all inside the stored window or all
past it); rank 0 loads nothing.

The trace: the K + 1 lane gather folds min and argmin (``<=`` in ascending
p, invalid columns reading INF) over the thread's lanes and its left lane,
which for thread 0 wraps to lane Wb - 1; the word's M source is set from A
before the scan (M = A where A <= I, else M = I); the scan is
``tests/test_torch_banded_scan.py``'s ``kernel_window`` over the whole
window; isrc takes M one lane left through the warp shuffle and the warp
words (thread 0: lane Wb - 1); at the end rank M = min_pm goes to the ring
before the scan, the word hops with msrc 0 and column pmidx(lane).

The seed: p = 0 loaded (or INF), valid rows folded only where they lie
inside their stored window; the window scan at the cap; each thread's
running best end state over its lanes and ranks under (value ascending,
offset descending, rank ascending), then the block's best.

The kernels are built at K 4 (``TRACE_LANES``, ``SEED_LANES``); the model
takes K in {4, 8, 16}, so the lanes a thread owns are a parameter of the
design it checks, not of one build.

Held with tolerance 0 to the port's plain versions (``ops/trace.py:
trace_fill_plain``, ``ops/seed.py:seed_end_states_plain``) by hypothesis
over Wb (multiples of 128 up to 4096), K in {4, 8, 16}, caps 1 to Wb + 1,
P = 4 with invalid slots and all-INF ties, random window steps, anchors
inside and outside their windows, ``free_start`` on and off, every rank
(the trace without a range) or empty, one-rank and wide rank ranges (each
block walking only its read's), and sparse and dense end masks; and to the
reference's Pallas ``_trace_kernel`` and ``_seed_kernel`` in interpret
mode.
"""

import functools
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from poasta_tpu.aligner import costs as jcosts
from poasta_tpu.aligner import wavefront as jwf
from poasta_tpu.graphs import POAGraph
from poasta_tpu.ops import pallas_fill as jpf
from poasta_tpu.ops import pallas_seed as jps
from poasta_tpu.ops import pallas_trace as jpt
from poasta_tpu_torch.aligner import costs as tcosts
from poasta_tpu_torch.aligner import wavefront as twf
from poasta_tpu_torch.ops import cuda_fill as tcf
from poasta_tpu_torch.ops import seed as tseed
from poasta_tpu_torch.ops import trace as tr
from test_torch_banded_scan import kernel_window
from test_torch_fill_reg_model import _bubble_graph, _mutate

torch.set_num_threads(1)

INF = tcf.INF
WARP = 32
NO_RANK = tseed.NO_RANK


# ---- the models --------------------------------------------------------------

def _rows(ring, slot, lanes, inside):
    """Ring row ``slot`` at ``lanes`` (T, K) where ``inside`` (T,), else
    INF."""
    row = ring[slot][np.minimum(lanes, ring.shape[1] - 1)]
    return np.where(inside[:, None], row, INF)


def _at_anchor(aval, vals, j, aj):
    """min(aval, the untilted M at offset ``aj``), where a lane holds it."""
    hit = vals[j == aj]
    return min(aval, int(hit.min())) if hit.size else aval


def model_trace(dg, qpad, wstarts, anchor_r, anchor_j, consts, Wb, K,
                free_start=False, wrap=True, r_begin=None, r_end=None):
    """The trace kernel's register body: (aval (B,), ptr (Np, B, Wb)).
    ``wrap=False`` gives thread 0 no left lane (the rule the kernel must
    not follow: lane 0's column then ignores lane Wb - 1).  ``r_begin`` /
    ``r_end``: (B,) the first and last rank each read's block walks (None:
    every rank); the rows it does not walk stay 0 here."""
    o, e, x = consts
    B, LQ = qpad.shape
    assert Wb % 128 == 0 and LQ % 4 == 0
    T = Wb // K  # the active threads
    P = int(dg.pred_slots.shape[1])
    slots, valid = dg.pred_slots.numpy(), dg.pred_valid_np
    wslots, symbols = dg.write_slots.numpy(), dg.symbols.numpy()
    n, W = dg.n_nodes, dg.window
    base = np.arange(T) * K
    lanes = base[:, None] + np.arange(K)
    left = np.where(base > 0, base - 1, Wb - 1)  # thread 0 wraps
    wl = np.arange(T) % WARP
    ptr = np.zeros((dg.n_nodes_padded, B, Wb), dtype=np.int64)
    aval = np.full(B, INF, dtype=np.int64)
    for b in range(B):
        mring = np.full((W, Wb), INF, dtype=np.int64)
        dring = np.full((W, Wb), INF, dtype=np.int64)
        sstart = np.zeros(W, dtype=np.int64)
        r0 = 0 if r_begin is None else max(int(r_begin[b]), 0)
        r1 = n - 1 if r_end is None else min(int(r_end[b]), n - 1)
        for r in range(r0, r1 + 1):
            w_r = int(wstarts[b, r])
            is_end = r == dg.end_rank_i
            origin = (not is_end) if free_start else r == 0
            w_slot = wslots[r]
            for p in range(P):
                load = r > 0 if p == 0 else bool(valid[r][p])
                slot = slots[r][p]
                sh = w_r - sstart[slot]
                inside = np.full(T, load) & (base + sh < Wb)
                am = _rows(mring, slot, lanes + sh, inside)
                ad = _rows(dring, slot, lanes + sh, inside)
                aml = np.where(load & (left + sh < Wb) & (wrap | (base > 0)),
                               mring[slot][np.minimum(left + sh, Wb - 1)],
                               INF)
                if p == 0:
                    pm, pd, pml = am, ad, aml
                    pmi = np.zeros((T, K), dtype=np.int64)
                    pdi = np.zeros((T, K), dtype=np.int64)
                    pmil = np.zeros(T, dtype=np.int64)
                    continue
                pmi = np.where(am <= pm, p, pmi)
                pdi = np.where(ad <= pd, p, pdi)
                pmil = np.where(aml <= pml, p, pmil)
                pm, pd = np.minimum(pm, am), np.minimum(pd, ad)
                pml = np.minimum(pml, aml)
            # the lanes: lane 0's diagonal is INF, its column wraps
            j = w_r + lanes
            qv = np.where(j < LQ, qpad[b][np.minimum(j, LQ - 1)], 0)
            src = np.concatenate([np.where(base > 0, pml, INF)[:, None],
                                  pm[:, :-1]], axis=1)
            diag = src + np.where(qv == symbols[r], -e, x - e)
            d_open = pm + (o + e)
            D = np.minimum(d_open, pd + e)
            is_open = D == d_open
            A = np.minimum(diag, D)
            if origin:
                A = np.where(j == 0, np.minimum(A, 0), A)
            if is_end:
                msrc, didx = np.zeros_like(A), pmi
            else:
                msrc = np.where(A == diag, 0, np.where(A == D, 1, 2))
                didx = np.concatenate([pmil[:, None], pmi[:, :-1]], axis=1)
            word = (msrc | (didx << 2) | (np.where(is_open, 0, 1) << 8)
                    | (np.where(is_open, pmi, pdi) << 9))
            # D (and at the end rank M = min_pm) before the scan: a rank
            # never gathers from the slot it writes but at rank 0
            assert all(slots[r][p] != w_slot for p in range(P)
                       if valid[r][p])
            dring[w_slot] = (np.full_like(D, INF) if is_end else D).ravel()
            if is_end:
                mring[w_slot] = pm.ravel()
                if r == anchor_r[b]:
                    aval[b] = _at_anchor(aval[b], pm + e * j, j, anchor_j[b])
            ins = np.minimum(kernel_window(A.ravel(), Wb, K) + o,
                             INF).reshape(T, K)
            M = np.minimum(A, ins)
            if not is_end:
                msrc = np.where(A <= ins, word & 3, 2)
                if origin:
                    msrc = np.where((j == 0) & (M == 0), 3, msrc)
                word = (word & ~3) | msrc
            # M one lane left: the thread's own lane k - 1; at k = 0 the
            # warp shuffle, or a warp word (thread 0: lane Wb - 1's warp)
            mlast = M[:, K - 1]
            warp_end = (wl == WARP - 1) | (base + K == Wb)
            wlast = {t // WARP: mlast[t] for t in np.nonzero(warp_end)[0]}
            mleft = np.concatenate([[INF], mlast[:-1]])
            for t in np.nonzero(wl == 0)[0]:
                mleft[t] = wlast[t // WARP - 1 if t else (T - 1) // WARP]
            mprev = np.concatenate([mleft[:, None], M[:, :-1]], axis=1)
            word = word | (np.where(ins == mprev + o, 0, 1) << 7)
            ptr[r, b] = word.ravel()
            if not is_end:
                mring[w_slot] = M.ravel()
                if r == anchor_r[b]:
                    aval[b] = _at_anchor(aval[b], M + e * j, j, anchor_j[b])
            sstart[w_slot] = w_r
    return aval.astype(np.int32), ptr.astype(np.int32)


def _seed_better(v1, j1, r1, v0, j0, r0):
    return (v1 < v0) | ((v1 == v0) & ((j1 > j0) | ((j1 == j0) & (r1 < r0))))


def model_seed(dg, qshift, wstarts, lengths, jlo, r_begin, r_end, costs,
               free_start, end_ok, Wb, max_run=0, K=4):
    """The seed kernel's register body: (B, 3) int32 end states; the
    signature of ``seed_end_states_plain`` (``K`` aside)."""
    o, e, x = costs.gap_open, costs.gap_extend, costs.mismatch
    q = qshift.numpy()
    ws = wstarts.numpy()
    B, L = q.shape
    cap = tcf._scan_cap(Wb, max_run)
    T = Wb // K
    P = int(dg.pred_slots.shape[1])
    slots, valid = dg.pred_slots.numpy(), dg.pred_valid_np
    wslots, symbols = dg.write_slots.numpy(), dg.symbols.numpy()
    permitted = end_ok.numpy()
    W = dg.window
    base = np.arange(T) * K
    lanes = base[:, None] + np.arange(K)
    out = np.zeros((B, 3), dtype=np.int64)
    for b in range(B):
        mring = np.full((W, Wb), INF, dtype=np.int64)
        dring = np.full((W, Wb), INF, dtype=np.int64)
        sstart = np.zeros(W, dtype=np.int64)
        bv = np.full(T, INF, dtype=np.int64)
        bj = np.full(T, -1, dtype=np.int64)
        br = np.full(T, NO_RANK, dtype=np.int64)
        n_b, jlo_b = int(lengths[b]), int(jlo[b])
        for r in range(int(r_begin[b]), int(r_end[b])):
            w_r = int(ws[b, r])
            is_end = r == dg.end_rank_i
            origin = (not is_end) if free_start else r == 0
            w_slot = wslots[r]
            pm = np.full((T, K), INF, dtype=np.int64)
            pd = np.full((T, K), INF, dtype=np.int64)
            pml = np.full(T, INF, dtype=np.int64)
            for p in range(P):
                if p > 0 and not valid[r][p]:
                    continue
                slot = slots[r][p]
                sh = w_r - sstart[slot]
                loads = p > 0 or r > 0
                inside = np.full(T, loads) & (base + sh < Wb)
                am = _rows(mring, slot, lanes + sh, inside)
                ad = _rows(dring, slot, lanes + sh, inside)
                if p == 0:  # loaded, or INF
                    pm, pd = am, ad
                else:  # folded only inside its stored window
                    pm = np.where(inside[:, None], np.minimum(pm, am), pm)
                    pd = np.where(inside[:, None], np.minimum(pd, ad), pd)
                lin = loads & (base > 0) & (base - 1 + sh < Wb)
                pml = np.where(lin, np.minimum(
                    pml, mring[slot][np.minimum(base - 1 + sh, Wb - 1)]),
                    pml)
            j = w_r + lanes
            assert all(slots[r][p] != w_slot for p in range(P)
                       if valid[r][p])
            if is_end:
                M = pm
                dring[w_slot] = INF
            else:
                qv = np.where(j < L, q[b][np.minimum(j, L - 1)], 0)
                src = np.concatenate([pml[:, None], pm[:, :-1]], axis=1)
                D = np.minimum(pm + (o + e), pd + e)
                A = np.minimum(src + np.where(qv == symbols[r], -e, x - e),
                               D)
                if origin:
                    A = np.where(j == 0, np.minimum(A, 0), A)
                dring[w_slot] = D.ravel()
                win = kernel_window(A.ravel(), cap, K).reshape(T, K)
                M = np.minimum(A, np.minimum(win + o, INF))
            mring[w_slot] = M.ravel()
            may_end = is_end or permitted[r] == 1
            elig = may_end & (j >= jlo_b) & (j <= n_b)
            cand = np.where(elig, np.minimum(M + e * j, INF), INF)
            for k in range(K):
                take = _seed_better(cand[:, k], j[:, k], r, bv, bj, br)
                bv = np.where(take, cand[:, k], bv)
                bj = np.where(take, j[:, k], bj)
                br = np.where(take, r, br)
            sstart[w_slot] = w_r
        # the block's best: the order is total, so the shuffle tree's
        # order of reduction cannot change it
        best = min(zip(bv, -bj, br))
        out[b] = (best[0], -best[1], best[2])
    return torch.as_tensor(out.astype(np.int32))


# ---- cases -----------------------------------------------------------------

def make_case(seed, n=20, n_alleles=2, block=4, tie=False, n_reads=2,
              read_len=None):
    """A bubble graph (P = 4: one invalid slot at every join) and reads
    walked along its paths, mutated; both packages' graphs and rows."""
    rng = random.Random(seed)
    g, paths = _bubble_graph(rng, n, n_alleles, block, tie)
    reads = []
    for _ in range(n_reads):
        want = read_len or rng.randrange(1, 2 * n)
        walk = ""
        while len(walk) < want:
            walk += _mutate(rng, "".join(rng.choice(paths)[s:s + block]
                                         for s in range(0, n, block)), 0.05)
        reads.append(walk[:want].encode())
    flat = g.flatten()
    tq, tl = twf.pack_queries(reads, device="cpu")
    return {"flat": flat, "tdg": twf.DeviceGraph.build(flat, device="cpu"),
            "jdg": jwf.DeviceGraph.build(flat), "tq": tq, "tl": tl,
            "reads": reads}


def _costs(args=(4, 2, 6)):
    return tcosts.GapAffine(*args), jcosts.GapAffine(*args)


def random_steps(rng, B, Np, n, rate):
    """(B, Np) bool window steps at ``rate`` per real rank."""
    steps = rng.random((B, Np)) < rate
    steps[:, n:] = False
    return steps


def trace_inputs(case, Wb, steps, rng, anchor):
    """The trace fill's inputs: qpad of max(L, Wb + 128) lanes, the window
    starts of ``steps``, and anchors: "end" the global one, "inside" a
    random rank at an offset of its window, "outside" past it."""
    tdg, q, lens = case["tdg"], case["tq"], case["tl"].numpy()
    B, L = q.shape
    LQ = max(L, Wb + 128)
    qpad = torch.nn.functional.pad(q, (0, LQ - L)).contiguous()
    wst = tr.window_starts(torch.as_tensor(steps))
    n = tdg.n_nodes
    if anchor == "end":
        ar = np.full(B, tdg.end_rank_i)
        aj = lens.astype(np.int64)
    else:
        ar = rng.integers(0, n, B)
        w = wst.numpy()[np.arange(B), ar]
        aj = w + (rng.integers(0, Wb, B) if anchor == "inside"
                  else Wb + rng.integers(0, 256, B))
    return {"qpad": qpad, "wstarts": wst,
            "anchor_r": torch.as_tensor(ar.astype(np.int32)),
            "anchor_j": torch.as_tensor(aj.astype(np.int32))}


def _check_trace(case, tc, inp, Wb, K, free_start):
    """The model against the plain version on the same inputs, a rank
    range in ``inp`` or not: the planes (the rows a read does not walk
    are 0 in both) and ``aval``."""
    consts = (tc.gap_open, tc.gap_extend, tc.mismatch)
    ranges = {k: inp[k].numpy() for k in ("r_begin", "r_end") if k in inp}
    got = model_trace(case["tdg"], inp["qpad"].numpy(),
                      inp["wstarts"].numpy(), inp["anchor_r"].numpy(),
                      inp["anchor_j"].numpy(), consts, Wb, K, free_start,
                      **ranges)
    aval, ptr = tr.trace_fill_plain(case["tdg"], **inp, costs=tc, Wb=Wb,
                                    free_start=free_start)
    np.testing.assert_array_equal(got[1], ptr.numpy())
    np.testing.assert_array_equal(got[0], aval.numpy())
    return got


def rank_ranges(rng, B, n, kind):
    """(r_begin, r_end) (B,) int32: "none" (every rank: no range), "wide"
    (a random range inside the graph), "one" (a single rank), "empty"
    (r_end before r_begin)."""
    if kind == "none":
        return {}
    lo = rng.integers(0, n, B)
    if kind == "wide":
        hi = lo + rng.integers(0, n - lo)
    elif kind == "one":
        hi = lo
    else:
        hi = lo - 1
    return {"r_begin": torch.as_tensor(lo.astype(np.int32)),
            "r_end": torch.as_tensor(hi.astype(np.int32))}


# ---- the trace model against the port's plain version --------------------------

@st.composite
def trace_case(draw):
    K = draw(st.sampled_from([4, 8, 16]))
    return {"K": K, "Wb": 128 * draw(st.integers(1, 32)),
            "costs": (draw(st.integers(1, 6)), draw(st.integers(1, 4)),
                      draw(st.integers(0, 10))),
            "free_start": draw(st.booleans()),
            "rate": draw(st.sampled_from([0.0, 0.15, 0.6])),
            "anchor": draw(st.sampled_from(["end", "inside", "outside"])),
            "range": draw(st.sampled_from(["none", "wide", "one", "empty"])),
            "tie": draw(st.booleans()), "n": draw(st.integers(6, 24)),
            "seed": draw(st.integers(0, 2**31 - 1))}


@settings(max_examples=100, deadline=None, derandomize=True,
          suppress_health_check=[HealthCheck.too_slow])
@given(trace_case())
def test_trace_model_matches_plain(c):
    case = make_case(c["seed"], n=c["n"], tie=c["tie"])
    tc, _ = _costs(c["costs"])
    rng = np.random.default_rng(c["seed"])
    steps = random_steps(rng, 2, case["tdg"].n_nodes_padded, c["n"],
                         c["rate"])
    inp = trace_inputs(case, c["Wb"], steps, rng, c["anchor"])
    inp.update(rank_ranges(rng, 2, case["tdg"].n_nodes, c["range"]))
    _check_trace(case, tc, inp, c["Wb"], c["K"], c["free_start"])


@pytest.mark.parametrize("Wb", [128, 256, 384, 1024, 1152, 4096])
@pytest.mark.parametrize("K", [4, 8, 16])
def test_trace_model_at_tier_widths(Wb, K):
    """The tier widths (and 128, 384, 1,152: threads not a multiple of 32
    at some K), global and anchored, with reads whose windows step: the
    lane-0 wrap of the diagonal column and of isrc reaches across warps."""
    case = make_case(Wb + K, n=16, n_reads=2, read_len=40)
    tc, _ = _costs()
    rng = np.random.default_rng(Wb * K)
    steps = random_steps(rng, 2, case["tdg"].n_nodes_padded, 16, 0.2)
    for fs, anchor in ((False, "end"), (True, "inside")):
        inp = trace_inputs(case, Wb, steps, rng, anchor)
        _check_trace(case, tc, inp, Wb, K, fs)


@pytest.mark.parametrize("K", [4, 16])
def test_trace_lane_zero_column_wraps(K):
    """Lane 0's diagonal column is lane Wb - 1's argmin (the lane roll
    wraps): a thread 0 that gathered no left lane would give other planes.
    """
    case = make_case(3, n=24, n_reads=2, read_len=60)
    tc, _ = _costs()
    rng = np.random.default_rng(3)
    Wb = 128
    steps = random_steps(rng, 2, case["tdg"].n_nodes_padded, 24, 0.0)
    inp = trace_inputs(case, Wb, steps, rng, "end")
    _, ptr = _check_trace(case, tc, inp, Wb, K, False)
    _, unwrapped = model_trace(
        case["tdg"], inp["qpad"].numpy(), inp["wstarts"].numpy(),
        inp["anchor_r"].numpy(), inp["anchor_j"].numpy(),
        (tc.gap_open, tc.gap_extend, tc.mismatch), Wb, K, wrap=False)
    assert (unwrapped[:, :, 0] != ptr[:, :, 0]).any()
    assert (unwrapped[:, :, 1:] == ptr[:, :, 1:]).all()


# ---- the trace model against the reference's Pallas kernel ---------------------

def _pack_steps(steps):
    """(B, Np) bool -> the reference's (B, SW) int32 step bits and (Np,)
    any-step row."""
    B, Np = steps.shape
    SW = ((Np + 31) // 32 + 127) // 128 * 128
    words = np.zeros((B, SW), np.uint32)
    for r in np.nonzero(steps.any(axis=0))[0]:
        words[:, r // 32] |= steps[:, r].astype(np.uint32) << np.uint32(
            r % 32)
    return words.view(np.int32), steps.any(axis=0).astype(np.int32)


def _pallas_trace(case, jc, inp, steps, Wb, free_start):
    """``_trace_kernel`` in interpret mode on the same rows, step bits and
    anchors: (aval (B,), ptr (Np, B, Wb))."""
    jdg = case["jdg"]
    qpad = inp["qpad"].numpy()
    B, LQ = qpad.shape
    blk = 32
    Bp = -(-B // blk) * blk
    Np = jdg.n_nodes_padded
    P = int(jdg.pred_slots.shape[1])
    packed, any_step = _pack_steps(steps)
    pad = ((0, Bp - B), (0, 0))
    arp = np.zeros(Bp, np.int32)
    arp[:B] = inp["anchor_r"].numpy()
    ajp = np.zeros(Bp, np.int32)
    ajp[:B] = inp["anchor_j"].numpy()
    jpf.set_interpret_mode(True)
    try:
        fn = jpt._trace_exec(Bp // blk, Np, jdg.window, P, Wb,
                             packed.shape[1], LQ, jc.gap_open, jc.gap_extend,
                             jc.mismatch, blk, free_start)
        aval, ptr = fn(jdg.symbols, jdg.pred_slots_flat, jdg.pred_valid_flat,
                       jdg.write_slots, jnp.asarray(any_step), jdg.meta,
                       jnp.asarray(np.pad(qpad, pad)),
                       jnp.asarray(np.pad(packed, pad)), jnp.asarray(arp),
                       jnp.asarray(ajp))
    finally:
        jpf.set_interpret_mode(False)
    return np.asarray(aval)[:B], np.asarray(ptr)[:Np, :B]


@pytest.mark.parametrize("K,free_start,rate,anchor", [
    (4, False, 0.15, "end"), (8, True, 0.3, "inside"),
    (16, True, 0.0, "outside")])
def test_trace_model_matches_pallas(K, free_start, rate, anchor):
    case = make_case(11 + K, n=14, n_reads=3, tie=K == 8)
    tc, jc = _costs()
    rng = np.random.default_rng(K)
    Wb = 256
    steps = random_steps(rng, 3, case["tdg"].n_nodes_padded, 14, rate)
    inp = trace_inputs(case, Wb, steps, rng, anchor)
    aval, ptr = _check_trace(case, tc, inp, Wb, K, free_start)
    want_aval, want_ptr = _pallas_trace(case, jc, inp, steps, Wb, free_start)
    n = case["tdg"].n_nodes
    np.testing.assert_array_equal(ptr[:n], want_ptr[:n])
    np.testing.assert_array_equal(aval, want_aval)


# ---- the seed model against the port's plain version ----------------------------

def seed_inputs(case, Wb, rng, rate, ranges, mask):
    """The seed fill's inputs: window starts entering each read's range
    (``tseed.range_window_starts`` of random steps and the schedule's own
    starts), rank ranges ("empty", "one", "wide": a random stretch, "all"),
    a jlo and an end mask ("dense": every rank, "sparse": about one in
    eight, the end rank always)."""
    tdg, q, lens = case["tdg"], case["tq"], case["tl"]
    B = q.shape[0]
    Np, n = tdg.n_nodes_padded, tdg.n_nodes
    steps = torch.as_tensor(random_steps(rng, B, Np, n, rate))
    start = torch.cumsum(steps.to(torch.int64), dim=1) * 128
    if ranges == "all":
        rb, re = np.zeros(B), np.full(B, n)
    else:
        rb = rng.integers(0, n, B)
        re = {"empty": rb, "one": rb + 1,
              "wide": np.minimum(rb + rng.integers(1, n + 1, B), n)}[ranges]
    r_begin = torch.as_tensor(rb.astype(np.int64))
    wst = tseed.range_window_starts(steps, start, r_begin).contiguous()
    m = np.zeros(Np, np.int32)
    m[1:n] = 1 if mask == "dense" else rng.random(n - 1) < 0.125
    m[tdg.end_rank_i] = 1

    def i32(v):
        return torch.as_tensor(np.asarray(v).astype(np.int32))
    return {"wstarts": wst, "lengths": i32(lens.numpy()),
            "jlo": i32(rng.integers(0, 3, B)), "r_begin": i32(rb),
            "r_end": i32(re), "end_ok": torch.as_tensor(m)}


def _check_seed(case, tc, inp, Wb, K, free_start, max_run):
    args = (case["tdg"], case["tq"], inp["wstarts"], inp["lengths"],
            inp["jlo"], inp["r_begin"], inp["r_end"], tc, free_start,
            inp["end_ok"], Wb, max_run)
    got = model_seed(*args, K=K)
    want = tseed.seed_end_states_plain(*args)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    return got


@st.composite
def seed_case(draw):
    K = draw(st.sampled_from([4, 8, 16]))
    Wb = 128 * draw(st.integers(1, 32))
    return {"K": K, "Wb": Wb,
            "cap": draw(st.one_of(st.integers(1, Wb + 1),
                                  st.sampled_from([1, K, 32 * K, Wb]))),
            "costs": (draw(st.integers(1, 6)), draw(st.integers(1, 4)),
                      draw(st.integers(0, 10))),
            "free_start": draw(st.booleans()),
            "rate": draw(st.sampled_from([0.0, 0.15, 0.6])),
            "ranges": draw(st.sampled_from(["empty", "one", "wide", "all"])),
            "mask": draw(st.sampled_from(["dense", "sparse"])),
            "tie": draw(st.booleans()), "n": draw(st.integers(6, 24)),
            "seed": draw(st.integers(0, 2**31 - 1))}


@settings(max_examples=100, deadline=None, derandomize=True,
          suppress_health_check=[HealthCheck.too_slow])
@given(seed_case())
def test_seed_model_matches_plain(c):
    case = make_case(c["seed"], n=c["n"], tie=c["tie"], n_reads=3)
    tc, _ = _costs(c["costs"])
    rng = np.random.default_rng(c["seed"])
    inp = seed_inputs(case, c["Wb"], rng, c["rate"], c["ranges"], c["mask"])
    max_run = c["cap"] if c["cap"] <= c["Wb"] else 0
    _check_seed(case, tc, inp, c["Wb"], c["K"], c["free_start"], max_run)


@pytest.mark.parametrize("Wb", [128, 256, 1024, 2560, 4096])
@pytest.mark.parametrize("K", [4, 8, 16])
def test_seed_model_at_corridor_widths(Wb, K):
    """The corridor widths (2,560 the main path's) at caps 1, K (segments
    inside threads), one warp's span, the main path's 1,024 and the
    window; the empty range returns (INF, -1, NO_RANK)."""
    case = make_case(Wb + K, n=12, n_reads=2, read_len=30)
    tc, _ = _costs()
    rng = np.random.default_rng(Wb + K)
    for cap in (1, K, 32 * K, 1024, Wb):
        for fs, ranges, mask in ((True, "all", "dense"),
                                 (False, "wide", "sparse")):
            inp = seed_inputs(case, Wb, rng, 0.2, ranges, mask)
            _check_seed(case, tc, inp, Wb, K, fs, min(cap, Wb))
    inp = seed_inputs(case, Wb, rng, 0.2, "empty", "dense")
    got = _check_seed(case, tc, inp, Wb, K, True, 0)
    assert (got.numpy() == [INF, -1, NO_RANK]).all()


# ---- the seed model against the reference's Pallas kernel ----------------------

def _backbone(rng, n, skip_every=37):
    base = "".join(rng.choice("ACGT") for _ in range(n))
    g = POAGraph()
    g.add_alignment_with_weights("s0", base.encode(), None, [1] * n)
    for v in range(0, n - 3, skip_every):
        g.add_edge(v, v + 3, 0, 1)
    g.post_process()
    return g, base


def _block_ranges(tdg, flat, costs, q, lens, alpha, beta, ub):
    """The rank range the reference's kernel walks for each read: its
    locus-sorted blocks, each from the block's first corridor rank rounded
    down to 4096 to its last rounded up to a table chunk
    (``poasta_tpu/ops/pallas_seed.py:339-351``)."""
    B = q.shape[0]
    Wb = tseed.corridor_width(costs, alpha, beta, ub)
    LQ = -(-max(q.shape[1], Wb + 128) // 128) * 128
    blk = min(jpf.pick_b_blk(tdg.window, Wb, LQ, 4, n_rings=4),
              jps.SEED_B_BLK)
    while B % blk:
        blk //= 2
    perm = np.argsort(alpha + beta, kind="stable")
    _, _, _, r_lo, r_hi, has = tseed.seed_schedule(
        flat, lens, ub // costs.gap_extend + 1, alpha, beta, Wb,
        tdg.n_nodes_padded, "cpu")
    r_lo, r_hi, has = (t.numpy()[perm].reshape(-1, blk)
                       for t in (r_lo, r_hi, has))
    C = jpf.BIG_CHUNK
    n = flat.n_nodes
    lo_b = np.where(has, r_lo, tdg.n_nodes_padded).min(axis=1)
    hi_b = np.where(has, r_hi, -1).max(axis=1)
    has_b = has.any(axis=1)
    begin_b = np.where(has_b, (lo_b // 4096) * 4096, 0)
    end_b = np.where(has_b, np.minimum(
        np.minimum(-(-n // C), -(-(hi_b + 1) // C)) * C, n), 0)
    end_b = np.maximum(end_b, begin_b)
    r_begin = np.empty(B, np.int64)
    r_end = np.empty(B, np.int64)
    r_begin[perm] = np.repeat(begin_b, blk)
    r_end[perm] = np.repeat(end_b, blk)
    return r_begin, r_end


@pytest.mark.parametrize("K,ub_rate", [(4, 0.3), (8, 1.0), (16, 0.3)])
def test_seed_model_matches_pallas(K, ub_rate):
    """``pallas_seed_scores`` (``_seed_kernel`` in interpret mode) on 16
    reads of a backbone graph, against the seeded scores the model's end
    states give over the reference's block rank ranges: scores, end ranks,
    end offsets and the width flags."""
    from poasta_tpu_torch.aligner.seeds import KmerIndex, propose_clusters

    rng = random.Random(31 + K)
    g, base = _backbone(rng, 400)
    reads = []
    for _ in range(16):
        a = rng.randrange(0, 300)
        reads.append(_mutate(rng, base[a:a + 90], 0.02).encode())
    flat = g.flatten()
    tdg = twf.DeviceGraph.build(flat, device="cpu")
    jdg = jwf.DeviceGraph.build(flat)
    tq, tl = twf.pack_queries(reads, device="cpu")
    jq, jl = jwf.pack_queries(reads)
    lens = tl.numpy().astype(np.int64)
    tc, jc = _costs()
    span = tcosts.EndsFree(tcosts.UNBOUNDED, tcosts.included(0),
                           tcosts.UNBOUNDED, tcosts.UNBOUNDED)
    fs, end_ok, jlo = twf.ends_free_device_params(flat, span, tl,
                                                  tdg.n_nodes_padded)
    jlo = np.asarray(jlo).astype(np.int64)
    ub = (ub_rate * lens + 2 * tc.mismatch).astype(np.int64)
    hits = KmerIndex(flat).seed_hits(tq.numpy(), lens)
    alpha, beta, n_cluster = propose_clusters(hits, ub // tc.gap_extend)
    assert (n_cluster > 0).all()
    alpha, beta = np.asarray(alpha, np.int64), np.asarray(beta, np.int64)
    ranges = _block_ranges(tdg, flat, tc, tq.numpy(), lens, alpha, beta, ub)
    jpf.set_interpret_mode(True)
    try:
        want = jps.pallas_seed_scores(
            jdg, flat, jq, jl, jc, fs, jnp.asarray(end_ok.numpy()),
            jnp.asarray(jlo), alpha, beta, ub)
    finally:
        jpf.set_interpret_mode(False)
    got = tseed._seed_scores(functools.partial(model_seed, K=K), tdg, flat,
                             tq, tl, tc, fs, end_ok, jlo, alpha, beta, ub,
                             ranges)
    plain = tseed.seed_scores_plain(tdg, flat, tq, tl, tc, fs, end_ok, jlo,
                                    alpha, beta, ub, ranges)
    assert np.asarray(want[3]).sum() >= 12
    for g_arr, w_arr, p_arr in zip(got, want, plain):
        np.testing.assert_array_equal(g_arr, np.asarray(w_arr))
        np.testing.assert_array_equal(g_arr, p_arr)
