"""A numpy model of the full-fill kernel's register body
(``csrc/fill_kernel.cu``: ``full_fill_reg_kernel``, B2, B4, B7, B12, B13,
B14), rank by rank as the kernel takes it: thread t owns the K lanes
[tK, tK + K); the K + 1 lane gather (its own lanes of every valid
predecessor row and lane tK - 1, so min_pm(j - 1) is its own); D and D2
stored before the scan; the insertion through the window scan that
``tests/test_torch_banded_scan.py`` models (``kernel_window``: warp
shuffles, warp carries, the suffix row); M into the ring; and the bounded
fills' best row and rank row held per thread, the rank taken only where M
is strictly below the best so far.

The model's outputs are held, with tolerance 0, to the port's plain version
(``ops/cuda_fill.py:_fill_plain``) over L a multiple of 128 up to 5,120, K
in {4, 8, 16}, caps 1 to L + 1, P >= 3 with invalid predecessor slots, a
free graph begin on and off, sparse and dense end masks, ties in the best
row, one- and two-piece costs; and to the reference's Pallas kernels
``_fill_kernel_bounded`` (B4) and ``_fill_kernel_bounded_2p_ends`` (B14) in
interpret mode.
"""

import functools
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from poasta_tpu.aligner import costs as jcosts
from poasta_tpu.aligner import wavefront as jwf
from poasta_tpu.aligner.alignment import AlignedPair
from poasta_tpu.graphs import POAGraph
from poasta_tpu.ops import pallas_fill as jpf
from poasta_tpu_torch.aligner import costs as tcosts
from poasta_tpu_torch.aligner import wavefront as twf
from poasta_tpu_torch.ops import cuda_fill as tcf
from test_torch_banded_scan import kernel_window

torch.set_num_threads(1)

INF = tcf.INF


# ---- the model -------------------------------------------------------------

def _gather(rings, slots, valid, K, L):
    """The K + 1 lane gather of one rank: p = 0 unconditionally (rank 0
    reads an all-INF row), then every valid p.  Per thread (L / K of them
    hold lanes; L is a multiple of 128) its K lanes of each ring and min_pm
    at lane tK - 1: INF for thread 0, whose index -1 is never read."""
    T = L // K
    own = [rg[slots[0]].reshape(T, K).copy() for rg in rings]
    left = np.full(T, INF, dtype=np.int64)
    left[1:] = rings[0][slots[0]][K - 1:L - 1:K]
    for p in range(1, len(slots)):
        if valid[p]:
            own = [np.minimum(a, rg[slots[p]].reshape(T, K))
                   for a, rg in zip(own, rings)]
            left[1:] = np.minimum(left[1:], rings[0][slots[p]][K - 1:L - 1:K])
    return own, left


def model_fill(dg, q, consts, K, cap, two_piece, free_start=False,
               end_ok=None, ends=False, strict=True):
    """The register body on (B, L) query rows ``q`` (numpy): the end rows
    (global), the best rows (``end_ok``), or with ``ends`` (best, ranks).
    ``strict=False`` takes the rank where M ties the best too (the rule the
    kernel must not follow)."""
    o, e, ed, x = consts
    B, L = q.shape
    assert L % 128 == 0 and L % K == 0
    T = L // K
    bounded = end_ok is not None
    c = cap if bounded else L  # the global fills scan the whole prefix
    P = int(dg.pred_slots.shape[1])
    slots = dg.pred_slots.numpy()
    valid = dg.pred_valid_np
    wslots = dg.write_slots.numpy()
    symbols = dg.symbols.numpy()
    j = np.arange(L, dtype=np.int64)
    outs, ranks = [], []
    for b in range(B):
        rings = [np.full((dg.window, L), INF, dtype=np.int64)
                 for _ in range(3 if two_piece else 2)]
        best = np.full((T, K), INF, dtype=np.int64)
        bestr = np.zeros((T, K), dtype=np.int64)
        end_row = None
        for r in range(dg.n_nodes):
            ps = slots[r][:P]
            (pm, pd, *pd2), left = _gather(rings, ps, valid[r], K, L)
            is_end = r == dg.end_rank_i
            w_slot = wslots[r]
            if is_end:
                M = pm.reshape(L)
                for rg in rings[1:]:
                    rg[w_slot] = INF  # the stored D (and D2)
                if not bounded:
                    end_row = M.copy()
            else:
                # the diagonal's source: the thread's own lane k - 1, or
                # the gathered lane tK - 1 at k = 0
                src = np.concatenate([left[:, None], pm[:, :-1]], axis=1)
                mc = np.where(q[b].reshape(T, K) == symbols[r], 0, x)
                D = np.minimum(pm + (o + e), pd + ed)
                A = np.minimum(src + mc, D)
                Ds = [D]
                if two_piece:
                    D2 = np.minimum(pd, pd2[0]) + e
                    A = np.minimum(A, D2)
                    Ds.append(D2)
                A = A.reshape(L)
                seeds = (not is_end) if (bounded and free_start) else r == 0
                if seeds:
                    A[0] = min(A[0], 0)
                # D and D2 go out before the scan's barrier: a rank never
                # gathers from the slot it writes
                assert all(ps[p] != w_slot for p in range(P)
                           if valid[r][p])
                for rg, Dv in zip(rings[1:], Ds):
                    rg[w_slot] = np.minimum(Dv.reshape(L), INF)
                s = A - e * j  # rows are untilted: scan A - e*j
                win = kernel_window(s, c, K)
                M = np.minimum(A, np.minimum(win + o + e * j, INF))
            rings[0][w_slot] = M
            if bounded and end_ok[r] == 1:
                Mt = M.reshape(T, K)
                if ends:
                    take = Mt < best if strict else Mt <= best
                    bestr = np.where(take, r, bestr)
                best = np.minimum(best, Mt)
        outs.append(end_row if not bounded else best.reshape(L))
        ranks.append(bestr.reshape(L))
    out = np.stack(outs).astype(np.int32)
    if ends:
        return out, np.stack(ranks).astype(np.int32)
    return out


# ---- cases -----------------------------------------------------------------

def _mutate(rng, s, d):
    out = []
    for ch in s:
        u = rng.random()
        if u < d:
            continue
        out.append(rng.choice("ACGT") if u < 2 * d else ch)
        if rng.random() < d:
            out.append(rng.choice("ACGT"))
    return "".join(out) or "A"


def _bubble_graph(rng, n, n_alleles, block, tie):
    """An ``n``-base backbone whose every other ``block``-base stretch has
    ``n_alleles`` alleles beside it: P = n_alleles + 1 at each join, padded
    to a power of two, so rows with invalid predecessor slots.  With
    ``tie`` the alleles repeat the backbone's bases, so paths of equal cost
    reach one offset at several ranks."""
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
                seq.append(base[v] if tie or not own else rng.choice("ACGT"))
        paths.append("".join(seq))
        g.add_alignment_with_weights(f"s{k}", paths[-1].encode(), aln,
                                     [1] * n)
    return g, paths


def make_case(seed, L, n=24, n_alleles=2, block=4, tie=False, n_reads=2):
    """A bubble graph and ``n_reads`` reads packed to exactly L lanes (the
    longest read has L - 1 bases): walks along random paths, mutated,
    repeated to length."""
    rng = random.Random(seed)
    g, paths = _bubble_graph(rng, n, n_alleles, block, tie)
    reads = []
    for i in range(n_reads):
        want = L - 1 if i == 0 else rng.randrange(1, L)
        walk = ""
        while len(walk) < want:
            walk += _mutate(rng, "".join(rng.choice(paths)[s:s + block]
                                         for s in range(0, n, block)), 0.05)
        reads.append(walk[:want].encode())
    flat = g.flatten()
    tq, _ = twf.pack_queries(reads, device="cpu")
    jq, _ = jwf.pack_queries(reads)
    assert tq.shape[1] == L
    return {"flat": flat, "tdg": twf.DeviceGraph.build(flat, device="cpu"),
            "jdg": jwf.DeviceGraph.build(flat), "tq": tq, "jq": jq}


def _end_mask(rng, dg, kind):
    """(Np,) int32 end mask: "dense" every real rank and the end rank,
    "sparse" about one rank in eight, "end" the end rank alone."""
    m = np.zeros(dg.n_nodes_padded, dtype=np.int32)
    if kind == "dense":
        m[1:dg.n_nodes] = 1
    elif kind == "sparse":
        m[1:dg.n_nodes] = rng.random(dg.n_nodes - 1) < 0.125
    m[dg.end_rank_i] = 1
    return m


def _costs(two_piece, args=None):
    """(port costs, reference costs); by default the bench's: GapAffine(4,
    2, 6), and two-piece those of ``poasta align -n 4 -g 8,24 -e 2,1``."""
    if two_piece:
        args = args or (4, 2, 8, 1, 24)
        return tcosts.GapAffine2Piece(*args), jcosts.GapAffine2Piece(*args)
    args = args or (4, 2, 6)
    return tcosts.GapAffine(*args), jcosts.GapAffine(*args)


def _plain(case, tc, free_start, end_ok, cap, ends):
    """The port's plain version: the global end rows without ``end_ok``,
    else the bounded rows at the scan cap (``max_run``; L + 1 scans the
    whole row as L does)."""
    if end_ok is None:
        return tcf._fill_plain(case["tdg"], case["tq"], tc).numpy()
    out = tcf._fill_plain(case["tdg"], case["tq"], tc, free_start,
                          torch.as_tensor(end_ok), cap, ends)
    return tuple(t.numpy() for t in out) if ends else out.numpy()


def _check_plain(case, tc, K, cap, free_start, end_ok, ends):
    q = case["tq"].numpy()
    got = model_fill(case["tdg"], q, tcf.fill_constants(tc), K, cap,
                     tc.is_two_piece, free_start, end_ok, ends)
    want = _plain(case, tc, free_start, end_ok, cap, ends)
    for g_arr, w_arr in zip(got if ends else (got,),
                            want if ends else (want,)):
        np.testing.assert_array_equal(g_arr, w_arr)
    return got


# ---- the model against the port's plain version ------------------------------

@st.composite
def fill_case(draw):
    K = draw(st.sampled_from([4, 8, 16]))
    L = 128 * draw(st.integers(1, min(5120, 1024 * K) // 128))
    cap = draw(st.one_of(st.integers(1, L + 1),
                         st.sampled_from([32 * K, L, L + 1])))
    two_piece = draw(st.booleans())
    if two_piece:
        e2 = draw(st.integers(1, 3))
        costs = (draw(st.integers(1, 6)), draw(st.integers(e2, 4)),
                 draw(st.integers(0, 10)), e2, draw(st.integers(10, 30)))
    else:
        costs = (draw(st.integers(1, 6)), draw(st.integers(1, 4)),
                 draw(st.integers(0, 10)))
    variant = draw(st.sampled_from(["global", "bounded", "ends"]))
    return {"K": K, "L": L, "cap": min(cap, L + 1),
            "two_piece": two_piece, "costs": costs, "variant": variant,
            "free_start": draw(st.booleans()),
            "mask": draw(st.sampled_from(["dense", "sparse", "end"])),
            "tie": draw(st.booleans()),
            "n": draw(st.integers(6, 30)),
            "seed": draw(st.integers(0, 2**31 - 1))}


@settings(max_examples=100, deadline=None, derandomize=True,
          suppress_health_check=[HealthCheck.too_slow])
@given(fill_case())
def test_model_matches_plain(c):
    case = make_case(c["seed"], c["L"], n=c["n"], tie=c["tie"])
    tc, _ = _costs(c["two_piece"], c["costs"])
    end_ok = None if c["variant"] == "global" else _end_mask(
        np.random.default_rng(c["seed"]), case["tdg"], c["mask"])
    _check_plain(case, tc, c["K"], c["cap"], c["free_start"], end_ok,
                 c["variant"] == "ends")


@pytest.mark.parametrize("L,K", [(5120, 8), (4096, 4), (4992, 8), (1024, 4),
                                 (384, 4), (1152, 4), (8192, 16)])
@pytest.mark.parametrize("two_piece", [False, True], ids=["1p", "2p"])
def test_model_at_main_path_widths(L, K, two_piece):
    """The main paths' widths at the lanes the plan gives them (threads not
    a multiple of 32 at 384 and 1,152 lanes at K 4; 8,192 the register
    body's widest row), every variant at caps 1, 2, one warp's span
    (32 K), the main paths' 2,048 and the row."""
    case = make_case(L + K, L, n=8)
    tc, _ = _costs(two_piece)
    rng = np.random.default_rng(L)
    _check_plain(case, tc, K, L, False, None, False)
    for cap in (1, 2, 32 * K, 2048, L):
        for fs, mask in ((False, "sparse"), (True, "dense")):
            end_ok = _end_mask(rng, case["tdg"], mask)
            _check_plain(case, tc, K, min(cap, L), fs, end_ok, True)


@pytest.mark.parametrize("two_piece", [False, True], ids=["1p", "2p"])
def test_rank_row_keeps_the_first_rank_on_ties(two_piece):
    """Alleles that repeat the backbone reach equal best values at several
    ranks: the rank row keeps the first (M strictly below the best), as
    the plain version does, and a rule that also takes ties differs."""
    case = make_case(5, 256, n=40, block=5, tie=True)
    tc, _ = _costs(two_piece)
    end_ok = _end_mask(np.random.default_rng(0), case["tdg"], "dense")
    best, ranks = _check_plain(case, tc, 4, 256, True, end_ok, True)
    _, later = model_fill(case["tdg"], case["tq"].numpy(),
                          tcf.fill_constants(tc), 4, 256, two_piece, True,
                          end_ok, True, strict=False)
    assert (later != ranks).any()
    assert (later >= ranks).all()


# ---- the model against the reference's Pallas kernels (interpret mode) -------

def _spec(B, L):
    return pl.BlockSpec((B, L), lambda i, *_: (i, 0),
                        memory_space=pltpu.VMEM)


def _pallas_bounded(case, jc, free_start, end_ok, max_run):
    """B4 ``_fill_kernel_bounded``'s raw (B, L) best row, one block over
    the batch."""
    jdg, jq = case["jdg"], case["jq"]
    B, L = (int(d) for d in jq.shape)
    W, P = jdg.window, int(jdg.pred_slots.shape[1])
    call = pl.pallas_call(
        functools.partial(
            jpf._fill_kernel_bounded, W=W, P=P, L=L, o=jc.gap_open,
            e=jc.gap_extend, x=jc.mismatch, B_BLK=B, dtype=jnp.int32,
            free_start=free_start, max_run=max_run),
        out_shape=jax.ShapeDtypeStruct((B, L), jnp.int32),
        grid_spec=pltpu.PrefetchScalarGridSpec(
            num_scalar_prefetch=6, grid=(1,), in_specs=[_spec(B, L)],
            out_specs=_spec(B, L),
            scratch_shapes=[pltpu.VMEM((W, B, L), jnp.int32)] * 2
            + [pltpu.VMEM((B, L), jnp.int32)]),
        interpret=True)
    return np.asarray(call(jdg.symbols, jdg.pred_slots_flat,
                           jdg.pred_valid_flat, jdg.write_slots,
                           jnp.asarray(end_ok), jdg.meta, jq))


def _pallas_bounded_2p_ends(case, jc, free_start, end_ok, max_run):
    """B14 ``_fill_kernel_bounded_2p_ends``'s raw (B, L) best row and rank
    row, one block over the batch."""
    jdg, jq = case["jdg"], case["jq"]
    B, L = (int(d) for d in jq.shape)
    W, P = jdg.window, int(jdg.pred_slots.shape[1])
    call = pl.pallas_call(
        functools.partial(
            jpf._fill_kernel_bounded_2p_ends, W=W, P=P, L=L,
            o1=jc.gap_open, e1=jc.gap_extend, e2=jc.gap_extend2,
            x=jc.mismatch, B_BLK=B, dtype=jnp.int32, free_start=free_start,
            max_run=max_run),
        out_shape=(jax.ShapeDtypeStruct((B, L), jnp.int32),
                   jax.ShapeDtypeStruct((B, L), jnp.int32)),
        grid_spec=pltpu.PrefetchScalarGridSpec(
            num_scalar_prefetch=6, grid=(1,), in_specs=[_spec(B, L)],
            out_specs=[_spec(B, L), _spec(B, L)],
            scratch_shapes=[pltpu.VMEM((W, B, L), jnp.int32)] * 3
            + [pltpu.VMEM((B, L), jnp.int32)]),
        interpret=True)
    best, ranks = call(jdg.symbols, jdg.pred_slots_flat, jdg.pred_valid_flat,
                       jdg.write_slots, jnp.asarray(end_ok), jdg.meta, jq)
    return np.asarray(best), np.asarray(ranks)


@st.composite
def pallas_case(draw):
    K = draw(st.sampled_from([4, 8, 16]))
    L = draw(st.sampled_from([128, 256]))
    return {"K": K, "L": L, "cap": draw(st.integers(1, L + 1)),
            "two_piece": draw(st.booleans()),
            "free_start": draw(st.booleans()),
            "mask": draw(st.sampled_from(["dense", "sparse"])),
            "tie": draw(st.booleans()), "n": draw(st.integers(6, 16)),
            "seed": draw(st.integers(0, 2**31 - 1))}


@settings(max_examples=16, deadline=None, derandomize=True,
          suppress_health_check=[HealthCheck.too_slow])
@given(pallas_case())
def test_model_matches_pallas(c):
    """One-piece: the model's best row against B4's; two-piece: its best
    and rank rows against B14's."""
    case = make_case(c["seed"], c["L"], n=c["n"], tie=c["tie"])
    tc, jc = _costs(c["two_piece"])
    end_ok = _end_mask(np.random.default_rng(c["seed"]), case["tdg"],
                       c["mask"])
    max_run = c["cap"] if c["cap"] <= c["L"] else 0
    got = model_fill(case["tdg"], case["tq"].numpy(),
                     tcf.fill_constants(tc), c["K"], c["cap"],
                     c["two_piece"], c["free_start"], end_ok,
                     ends=c["two_piece"])
    if c["two_piece"]:
        want = _pallas_bounded_2p_ends(case, jc, c["free_start"], end_ok,
                                       max_run)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    else:
        want = _pallas_bounded(case, jc, c["free_start"], end_ok, max_run)
        np.testing.assert_array_equal(got, want)
