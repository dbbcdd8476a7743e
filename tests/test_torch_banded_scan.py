"""A numpy model of the banded kernel's truncated prefix-min, step for step
as ``csrc/prefix_min.cuh`` (``window_scan_warp``, ``window_scan_block``) and
``csrc/banded_kernel.cu`` take it: thread t owns the K lanes [tK, tK + K),
32-thread warps, w-lane segments (w the first power of two >= cap), a
segmented shuffle scan within each warp, per-warp carries across warps, and
the suffix read w lanes left through one shared row.

The model's window minimum at lane i (the min over lanes [i - w, i - 1]) is
held, with tolerance 0, to the port's plain ``_prefix_min`` and to the
reference's ``_prefix_min_trunc`` (``poasta_tpu/aligner/banded.py``) one lane
to the left, and the insertion row built from it to the plain version's.
Also the K + 1 lane gather: min_pm(lane - 1) from the thread's own loads,
INF at lane 0, never reading index -1.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from poasta_tpu.aligner import banded as jbd
from poasta_tpu_torch.ops import cuda_fill as tcf
from poasta_tpu_torch.ops.dp_rows import INF, _shift_right

WARP = 32


def _pow2_at_least(cap: int) -> int:
    return 1 << (cap - 1).bit_length()


def _shfl_up(v, d):
    """__shfl_up_sync over each warp: lane l takes lane l - d's value, its
    own where l < d."""
    lane = np.arange(v.size) % WARP
    src = np.where(lane >= d, np.arange(v.size) - d, np.arange(v.size))
    return v[src]


def _shfl_down(v, d):
    lane = np.arange(v.size) % WARP
    src = np.where(lane + d < WARP, np.arange(v.size) + d, np.arange(v.size))
    return v[src]


def _seg_scans(v, seg):
    """Inclusive prefix and suffix minima of ``v`` over segments of ``seg``
    lanes inside each warp, as the shuffle rounds d = 1, 2, ... < seg take
    them."""
    li = (np.arange(v.size) % WARP) & (seg - 1)
    inc_p, inc_s = v.copy(), v.copy()
    d = 1
    while d < seg:
        up, dn = _shfl_up(inc_p, d), _shfl_down(inc_s, d)
        inc_p = np.where(li >= d, np.minimum(inc_p, up), inc_p)
        inc_s = np.where(li + d < seg, np.minimum(inc_s, dn), inc_s)
        d <<= 1
    return inc_p, inc_s, li


def kernel_window(s, cap: int, K: int) -> np.ndarray:
    """(Wb,) min over [i - w, i - 1] at each lane i (INF left of lane 0),
    computed as the kernel computes it."""
    s = np.asarray(s, dtype=np.int64)
    Wb = s.size
    w = _pow2_at_least(cap)
    T = -(-(-(-Wb // K)) // WARP) * WARP  # threads, rounded up to a warp
    assert T <= 1024
    lanes = np.full(T * K, INF, dtype=np.int64)
    lanes[:Wb] = s
    lanes = lanes.reshape(T, K)
    tid = np.arange(T)
    base = tid * K
    active = base < Wb
    # level 1: each thread's minimum
    agg = np.where(active, lanes.min(axis=1), INF)
    # level 2: window_scan_warp
    ex_pre = np.full(T, INF, dtype=np.int64)
    ex_suf = np.full(T, INF, dtype=np.int64)
    carry = np.full(WARP, INF, dtype=np.int64)
    g = w // K
    if w > K:
        gm = min(g, WARP)
        inc_p, inc_s, li = _seg_scans(agg, gm)
        ex_pre = np.where(li > 0, _shfl_up(inc_p, 1), INF)
        ex_suf = np.where(li < gm - 1, _shfl_down(inc_s, 1), INF)
        if g > WARP:
            carry[:T // WARP] = inc_p.reshape(-1, WARP)[:, WARP - 1]
    # the suffix row, as far as each warp knows it (right to left)
    windowed = w < Wb
    suf = np.full(T * K, INF, dtype=np.int64)
    run = ex_suf.copy()
    for k in range(K - 1, -1, -1):
        i = base + k
        run = np.minimum(run, lanes[:, k])
        suf[i] = run
        run = np.where(i & (w - 1) == 0, INF, run)
    # level 3 (after the barrier): window_scan_block
    sc = np.full(T, INF, dtype=np.int64)
    if w > K and g > WARP:
        h = g // WARP
        hm = min(h, WARP)
        inc_p, inc_s, li = _seg_scans(carry, hm)
        warp = tid // WARP
        prev = inc_p[(warp + 31) & 31]
        ex_pre = np.where(warp & (hm - 1) != 0, np.minimum(ex_pre, prev),
                          ex_pre)
        u = warp - h
        nxt = inc_s[(u + 1) & 31]
        sc = np.where((u >= 0) & ((u + 1) & (hm - 1) != 0), nxt, INF)
    # level 4: each lane's window from Ex and Suf(i - w)
    win = np.full(T * K, INF, dtype=np.int64)
    run = ex_pre.copy()
    for k in range(K):
        i = base + k
        run = np.where(i & (w - 1) == 0, INF, run)
        sv = np.full(T, INF, dtype=np.int64)
        if windowed:
            if w >= K:
                sv = np.where(base >= w,
                              np.minimum(suf[np.maximum(i - w, 0)], sc), INF)
            else:
                sv = np.where(i >= w, suf[np.maximum(i - w, 0)], INF)
        win[i] = np.minimum(run, sv)
        run = np.minimum(run, lanes[:, k])
    return win[:Wb]


def _prefix_refs(s, cap):
    """The port's plain scan and the reference's truncated rounds, each
    shifted one lane right (INF at lane 0): the window the insertion at
    lane i reads."""
    t = torch.as_tensor(np.asarray(s, dtype=np.int32)).view(1, -1)
    port = _shift_right(tcf._prefix_min(t, cap))[0].numpy().astype(np.int64)
    ref = np.asarray(jbd._prefix_min_trunc(jnp.asarray(t.numpy()), cap, 1))
    ref = np.concatenate([[INF], ref[0, :-1]]).astype(np.int64)
    return port, ref


def _row(rng, Wb, two_piece=False, e=1):
    """A scan input: scores, INF lanes, INF eroded by e a rank, A above
    INF (INF + the diagonal's mismatch), negative tilted values; with
    two-piece costs A - e*lane."""
    a = rng.integers(-3000, 3000, size=Wb)
    kind = rng.integers(0, 6, size=Wb)
    a = np.where(kind == 0, INF, a)
    a = np.where(kind == 1, INF - e * rng.integers(1, 400, size=Wb), a)
    a = np.where(kind == 2, INF + rng.integers(1, 9, size=Wb), a)
    a = np.where(kind == 3, -e * np.arange(Wb) - rng.integers(0, 50, size=Wb),
                 a)
    if two_piece:
        a = a - e * np.arange(Wb)
    return a.astype(np.int32)


def _check(s, cap, K):
    """The kernel's window equals both scans' at INF and below.  Its runs
    start at INF, so a window of lanes above INF (A may pass INF by the
    diagonal's mismatch) reads INF: the insertion min(window + o, INF),
    o >= 0, is INF either way, and no window below INF differs."""
    got = kernel_window(s, cap, K)
    port, ref = _prefix_refs(s, cap)
    assert (got <= INF).all()
    assert (got == np.minimum(ref, INF)).all()
    assert (got == np.minimum(port, INF)).all()


@st.composite
def scan_case(draw):
    K = draw(st.sampled_from([4, 8, 16]))
    max_blocks = min(12288, 1024 * K) // 128  # at most 1024 threads
    Wb = 128 * draw(st.integers(1, max_blocks))
    kind = draw(st.sampled_from(["any", "warp", "wide", "full"]))
    if kind == "warp":  # w equal to one warp's span
        cap = 32 * K
    elif kind == "wide":  # w spanning several warps
        cap = draw(st.sampled_from([64 * K, 128 * K, 256 * K]))
    elif kind == "full":
        cap = draw(st.sampled_from([Wb, Wb + 1]))
    else:
        cap = draw(st.integers(1, Wb + 1))
    return K, Wb, min(cap, Wb + 1), draw(st.booleans()), draw(
        st.integers(0, 2**31 - 1))


@settings(max_examples=60, deadline=None, derandomize=True,
          suppress_health_check=[HealthCheck.too_slow])
@given(scan_case())
def test_kernel_window_matches_both_scans(case):
    K, Wb, cap, two_piece, seed = case
    s = _row(np.random.default_rng(seed), Wb, two_piece, e=1 if two_piece
             else 2)
    _check(s, cap, K)


@pytest.mark.parametrize("K", [4, 8, 16])
@pytest.mark.parametrize("cap", [1, 2, 3, 4, 5, 16, 31, 32, 33, 128, 1024,
                                 2048])
def test_kernel_window_at_small_and_warp_caps(K, cap):
    """Caps below, at and past a thread's lanes, a warp's span (32 K), and
    the main paths' 1024 (B1) and 2048 (B16), on a 3,328-lane row."""
    Wb = 3328
    s = _row(np.random.default_rng(K * 10000 + cap), Wb)
    _check(s, min(cap, Wb + 1), K)


@pytest.mark.parametrize("Wb,K", [(384, 4), (1152, 4), (4224, 8),
                                  (5120, 8), (10752, 16)])
def test_kernel_window_at_main_path_widths(Wb, K):
    """The main paths' widths and the lanes the plan gives them (threads
    not a multiple of 32 at 384 and 1,152 lanes: the last warp is padded
    with lanes past the row)."""
    rng = np.random.default_rng(Wb)
    for cap in (1, 64, 1024, 2048, 8192, Wb, Wb + 1):
        _check(_row(rng, Wb, two_piece=cap % 2 == 0, e=1), min(cap, Wb + 1),
               K)


@pytest.mark.parametrize("cap", [1, 32, 1024, 8192, 40961])
def test_rows_body_chunk(cap):
    """The rows body runs the same scan over chunks of a power of two >=
    Wb / 1024 lanes a thread (64 at L 40,960: 640 threads)."""
    Wb = 40960
    _check(_row(np.random.default_rng(cap), Wb), min(cap, Wb + 1), 64)


def test_insertion_row_matches_the_plain_version():
    """I = min(window + o (+ e*lane, two-piece), INF) from the model's
    window equals the plain version's insertion row, one- and two-piece."""
    rng = np.random.default_rng(7)
    Wb, o = 1152, 6
    for e, two_piece in ((2, False), (1, True)):
        A = _row(rng, Wb)
        lane = np.arange(Wb)
        s = A - e * lane if two_piece else A
        for cap in (1, 40, 512, Wb):
            win = kernel_window(s, cap, 4)
            back = e * lane if two_piece else 0
            got = np.minimum(win + o + back, INF)
            t = torch.as_tensor(s.astype(np.int32)).view(1, -1)
            pref = tcf._prefix_min(t, cap)
            if two_piece:
                pref = pref + torch.as_tensor(e * lane, dtype=torch.int32)
                ref = torch.clamp(_shift_right(pref) + (o + e), max=INF)
            else:
                ref = torch.clamp(_shift_right(pref) + o, max=INF)
            assert (got == ref[0].numpy()).all()


# ---- the K + 1 lane gather -----------------------------------------------

def _gather(ring_row, lane, Wb, K, TOT, drift):
    """Each thread's K + 1 loads from a ring row (``ring_at``): its own
    lanes, then lane base - 1 for base > 0; returns (min_pm per lane, the
    diagonal's source per lane, every index read)."""
    read = []

    def at(i):
        t = lane + i
        if drift and t >= TOT:
            t -= TOT
        read.append(t)
        return int(ring_row[t])

    pm = np.empty(Wb, dtype=np.int64)
    src = np.empty(Wb, dtype=np.int64)
    for base in range(0, Wb, K):
        for k in range(K):
            pm[base + k] = at(base + k)
        left = at(base - 1) if base > 0 else INF
        for k in range(K):
            src[base + k] = pm[base + k - 1] if k else left
    return pm, src, read


@pytest.mark.parametrize("K", [4, 8, 16])
@pytest.mark.parametrize("drift", [False, True])
def test_gather_lane_zero(K, drift):
    """At d = -margin and rotation 0 the window starts at index 0 of the
    row: lane 0's diagonal source is INF, and no load reads index -1 or
    past the row; every other lane's source is min_pm one lane left, as the
    plain version's shift gives it."""
    Wb, margin = 512, 128
    TOT = Wb + 2 * margin
    rng = np.random.default_rng(K)
    row = rng.integers(-500, 500, size=TOT)
    for rot in ((0, 128, TOT - 128) if drift else (0,)):
        for d in (-margin, 0, margin):
            lane = margin + rot + d
            pm, src, read = _gather(row, lane, Wb, K, TOT, drift)
            assert min(read) >= 0 and max(read) < TOT
            want = np.array([row[(lane + i) % TOT if drift else lane + i]
                             for i in range(Wb)])
            assert (pm == want).all()
            shifted = _shift_right(torch.as_tensor(pm).view(1, -1))[0]
            assert (src == shifted.numpy()).all()
            assert src[0] == INF
            # a K-lane group never straddles the wrap: its loads are one
            # 16-byte-aligned run
            for base in range(0, Wb, K):
                run = read[base // K * (K + 1) - (1 if base else 0):][:K]
                assert run[0] % 4 == 0 and run == list(range(run[0],
                                                             run[0] + K))
