"""A numpy model of the decode kernel (``csrc/decode_kernel.cu``:
``decode_warp_kernel``), step by step as the card's warps walk their reads:
read b is warp b % W of block b // W (W warps a block, empty warps at the
grid's end idle); lane k < P holds predecessor column k of the current rank
and its window start, loaded while the step's one dependent load, the
word, is in flight; the next rank and window
start come from lane mp or dp by shuffle (an insertion keeps both); lane t
% 32 keeps step t's word until the warp stores the line of 32, and the
tail at the stop.

Held with tolerance 0 to the port's plain version (``ops/trace.py:
decode_plain``) and to the reference's XLA decode
(``poasta_tpu/ops/pallas_trace.py:_decode_exec``) by hypothesis
(derandomized) over drawn planes: P in {1, 2, 4, 8, 16, 32}, monotone
window starts stepping 0 or 128 a rank, inactive reads, walks cut at
t_max, chains that stop at rank 0 and at an origin word, anchors at the end
rank and off it, lanes clamped at both window edges, 1 to 8 warps a block;
and on the real planes of ``tests/test_torch_trace.py``'s cases (global
anchors) and ``tests/test_torch_anchored.py``'s ``trace_case``
(``free_start``, per-read end states), which the plain trace fill writes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from poasta_tpu.ops import pallas_trace as jpt
from poasta_tpu_torch.ops import trace as tr
from test_torch_anchored import COSTS as ANCHORED_COSTS
from test_torch_anchored import trace_case  # noqa: F401 (a fixture)
from test_torch_trace import _k_tier, _setup

torch.set_num_threads(1)

WARP = 32
WARPS = 8  # the kernel's DECODE_WARPS


# ---- the model ---------------------------------------------------------------

def warp_walk(ptr, pred_ranks, wstarts, anchor_r, anchor_j, end_rank,
              active, t_max, warps=WARPS):
    """(ops (B, t_max) int32, done (B,) bool) as ``decode_warp_kernel``
    computes them at ``warps`` warps a block."""
    Np, B, Wb = ptr.shape
    P = pred_ranks.size // Np
    lane = np.arange(WARP)
    ops = np.zeros((B, t_max), np.int32)
    done_out = np.zeros((B,), bool)
    blocks = -(-B // warps)
    for block in range(blocks):
        for warp in range(warps):
            b = block * warps + warp
            if b >= B:
                continue  # an empty warp at the grid's end
            ops[b], done_out[b] = _walk_one(
                ptr[:, b], pred_ranks, wstarts[b], int(anchor_r[b]),
                int(anchor_j[b]), end_rank, bool(active[b]), t_max, P, lane)
    return ops, done_out


def _walk_one(plane, pred_ranks, ws, r, j, end_rank, active, t_max, P, lane):
    """One warp's walk of one read: its (t_max,) step words and done."""
    Np, Wb = plane.shape
    out = np.zeros((t_max,), np.int32)
    done = not active

    def pred_row(rank):
        # the lanes below P: the rank's pred column and its window start
        pk = np.where(lane < P, pred_ranks[rank * P + np.minimum(
            lane, P - 1)], 0)
        return pk, np.where(lane < P, ws[pk], 0)

    t = st = 0
    held = np.zeros((WARP,), np.int64)  # lane t % 32: step t's word
    if not done and t_max > 0:
        w = int(ws[r])
        while t < t_max and not done:
            assert 0 <= r < Np  # every load stays in bounds
            word = int(plane[r, min(max(j - w, 0), Wb - 1)])
            pk, wk = pred_row(r)
            msrc, mp = word & 3, (word >> 2) & 31
            isrc, dsrc, dp = (word >> 7) & 1, (word >> 8) & 1, \
                (word >> 9) & 31
            is_hop = r == end_rank and t == 0
            act = msrc if st == 0 else (1 if st == 1 else 2)
            op = 4 if is_hop else {0: 1, 1: 2, 2: 3, 3: 0}[act]
            diag_move = is_hop or act == 0
            moves = diag_move or act == 1
            col = mp if diag_move else dp  # the shuffles' source lane
            nr, nw = int(pk[col]), int(wk[col])
            held[t & 31] = (r << 4) | op
            if t & 31 == 31:  # the warp stores a line of 32 words
                out[t - 31:t + 1] = held
            done = act == 3 or (nr if moves else r) == 0
            st = 0 if diag_move else (dsrc if act == 1 else 2 * isrc)
            j = j - 1 if not is_hop and act in (0, 2) else j
            if moves:
                r, w = nr, nw
            t += 1
        rem = t & 31  # the tail: the unfinished line
        out[t - rem:t] = held[:rem]
    return out, done


# ---- drawn planes --------------------------------------------------------------

def draw_planes(seed, B, n, P, Wb, t_max, origin=0.03):
    """Pointer planes as the trace fill lays them out, with random words:
    every rank's predecessors lie below it (padding columns 0), window
    starts step 0 or 128 a rank, pred columns below each rank's in-degree,
    a share ``origin``
    of origin words; anchors at the end rank or off it, at offsets inside
    their window and past either edge; some reads inactive."""
    rng = np.random.default_rng(seed)
    Np = -(-n // 64) * 64
    pr = np.zeros((Np, P), np.int32)
    ranks = np.arange(1, n)
    lo = np.maximum(ranks - 6, 0)
    pr[1:n] = rng.integers(lo[:, None], ranks[:, None], size=(n - 1, P))
    deg = np.ones((Np, 1, 1), np.int64)
    deg[1:n, 0, 0] = rng.integers(1, P + 1, size=n - 1)
    pr[np.arange(P)[None, :] >= deg[:, :, 0]] = 0
    steps = rng.random((B, Np)) < 0.08
    steps[:, 0] = False
    ws = (np.cumsum(steps, axis=1) * 128).astype(np.int32)
    shape = (Np, B, Wb)
    msrc = rng.choice(4, size=shape, p=[0.62 - origin, 0.15, 0.23, origin])
    # the fill's columns point at real predecessors only
    word = (msrc | rng.integers(0, 1 << 20, size=shape) % deg << 2
            | rng.integers(0, 2, size=shape) << 7
            | rng.integers(0, 2, size=shape) << 8
            | rng.integers(0, 1 << 20, size=shape) % deg << 9
            ).astype(np.int32)
    word[n:] = 0
    ar = np.where(rng.random(B) < 0.7, n - 1,
                  rng.integers(0, n, size=B)).astype(np.int32)
    aj = (ws[np.arange(B), ar] + rng.integers(-20, Wb + 60, size=B))
    aj = np.maximum(aj, 0).astype(np.int32)
    active = rng.random(B) < 0.85
    return word, pr.reshape(-1), ws, ar, aj, n - 1, active, t_max


def _plain(case):
    ptr, pr, ws, ar, aj, end_rank, active, t_max = case
    ops, done = tr.decode_plain(
        torch.as_tensor(ptr), torch.as_tensor(pr), torch.as_tensor(ws),
        torch.as_tensor(ar), torch.as_tensor(aj), end_rank,
        torch.as_tensor(active), t_max)
    return ops.numpy(), done.numpy()


def _reference(case):
    """The XLA decode of ``poasta_tpu`` on the same planes."""
    ptr, pr, ws, ar, aj, end_rank, active, t_max = case
    Np, B, Wb = ptr.shape
    P = pr.size // Np
    ops, done = jpt._decode_exec(t_max, Np, B, Wb, P)(
        jnp.asarray(ptr), jnp.asarray(pr), jnp.asarray(ws.reshape(-1)),
        jnp.asarray(ar), jnp.asarray(aj), jnp.asarray(np.int32(end_rank)),
        jnp.asarray(active))
    return np.asarray(ops), np.asarray(done)


def _check_model(case, want_ops, want_done, warps=WARPS):
    ops, done = warp_walk(*case, warps=warps)
    assert np.array_equal(ops, want_ops)
    assert np.array_equal(done, want_done)


# ---- drawn planes: the model, the plain version and the reference --------------

@settings(max_examples=40, deadline=None, derandomize=True,
          suppress_health_check=[HealthCheck.too_slow])
@given(seed=st.integers(0, 2 ** 31 - 1),
       P=st.sampled_from([1, 2, 4, 8, 16, 32]),
       n=st.sampled_from([2, 40, 150]),
       B=st.sampled_from([1, 3, 9]),
       Wb=st.sampled_from([128, 256]),
       t_max=st.sampled_from([1, 31, 32, 33, 96, 400]),
       origin=st.sampled_from([0.0, 0.03, 0.3]),
       warps=st.sampled_from([1, 2, WARPS]))
def test_warp_walk_matches_plain_and_reference(seed, P, n, B, Wb, t_max,
                                               origin, warps):
    case = draw_planes(seed, B, n, P, Wb, t_max, origin)
    ops, done = _plain(case)
    ref_ops, ref_done = _reference(case)
    assert np.array_equal(ops, ref_ops)
    assert np.array_equal(done, ref_done)
    _check_model(case, ops, done, warps)


def test_drawn_planes_reach_every_stop():
    """The draws above reach each way a walk ends: an origin word, rank 0,
    t_max, and an inactive read; and both line edges of the step store."""
    seen = set()
    for seed in range(40):
        case = draw_planes(seed, 6, 150, 4, 128, 96)
        ops, done = warp_walk(*case)
        active = case[6]
        for b in range(6):
            nz = np.nonzero(ops[b])[0]
            steps = int(nz[-1]) + 1 if nz.size else 0
            if not active[b]:
                seen.add("inactive")
            elif not done[b]:
                seen.add("t_max")
            elif ops[b, steps - 1] & 15 == tr.OP_STOP:
                seen.add("origin")
            else:
                seen.add("rank 0")
            if steps in (32, 64) or steps > 32 and steps % 32:
                seen.add("line" if steps % 32 == 0 else "tail")
    assert seen == {"inactive", "t_max", "origin", "rank 0", "line", "tail"}


# ---- the real planes of the trace tests ----------------------------------------

def _traced_case(dg, flat, inp, ptr, verified, t_max):
    return (ptr.numpy(), tr.pred_rank_table(dg, "cpu").numpy(),
            inp["wstarts"].numpy(), inp["anchor_r"].numpy(),
            inp["anchor_j"].numpy(), dg.end_rank_i, verified, t_max)


@pytest.mark.parametrize("Wb", [256, 512])
@pytest.mark.parametrize("name", ["seed5", "seed17", "seed29", "edges"])
def test_warp_walk_on_global_traces(name, Wb):
    """``tests/test_torch_trace.py``'s cases: the plain trace fill's planes
    at a tier, decoded by the model, equal the plain decode's and the
    reference's step words."""
    _, flat, dg, _, q, lengths, scores, costs = _setup(name)
    lens = lengths.numpy()
    k, k_full = _k_tier(flat, scores, costs, Wb)
    inp, ok = tr.tier_inputs(dg, flat, q, lens, k, Wb)
    aval, ptr = tr.trace_fill_plain(dg, **inp, costs=costs, Wb=Wb)
    verified = (aval.numpy() == scores) & ok
    t_max = int(-(-(int(lens.max()) + int(k_full.max()) + 8) // 512) * 512)
    case = _traced_case(dg, flat, inp, ptr, verified, t_max)
    ops, done = _plain(case)
    ref_ops, ref_done = _reference(case)
    assert np.array_equal(ops, ref_ops) and np.array_equal(done, ref_done)
    assert done[verified].all()
    _check_model(case, ops, done)


@pytest.mark.parametrize("Wb", [256, 512])
def test_warp_walk_on_anchored_traces(trace_case, Wb):
    """``tests/test_torch_anchored.py``'s ``trace_case`` (semi-global end
    states, ``free_start``): the model's step words equal the plain and
    the reference decode's, and the chains stop at origin words off rank
    0."""
    case = trace_case
    flat, dg = case["flat"], case["tdg"]
    k, k_full = tr.gap_budgets(flat, case["scores"], ANCHORED_COSTS, Wb)
    inp, ok = tr.tier_inputs(dg, flat, case["tq"], case["lens"], k, Wb,
                             case["er"], case["ej"])
    aval, ptr = tr.trace_fill_plain(dg, **inp, costs=ANCHORED_COSTS, Wb=Wb,
                                    free_start=True)
    verified = (aval.numpy() == case["scores"]) & ok
    assert verified.sum() >= 10
    t_max = int(-(-(int(case["lens"].max()) + int(k_full.max()) + 8)
                  // 512) * 512)
    walk = _traced_case(dg, flat, inp, ptr, verified, t_max)
    ops, done = _plain(walk)
    ref_ops, ref_done = _reference(walk)
    assert np.array_equal(ops, ref_ops) and np.array_equal(done, ref_done)
    assert done[verified].all()
    _check_model(walk, ops, done)
    last = [ops[b][np.nonzero(ops[b])[0][-1]] for b in np.nonzero(verified)[0]]
    assert any(w & 15 == tr.OP_STOP and w >> 4 > 0 for w in last)
