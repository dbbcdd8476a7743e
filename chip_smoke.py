"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``poasta_tpu_torch/csrc``, holds each
kernel against its plain PyTorch version on the card (end rows must be
equal, tolerance 0), then drives the library on the bench's uniform
configuration (a ~6k-node POA graph fused from four 5 kb sequences,
GapAffine(4, 2, 6)):

* ``BatchMapper(graph, costs, device="cuda").score_batch(reads)`` on 1024
  reads at 3% divergence (one warm-up, then five timed batches);
* the same mapper's ``BandedScorer.scores(..., max_retries=1)`` on 1024
  reads of the bench's mixed-divergence traffic (95% at 2%, 5% at 15%):
  one banded tier, then the full-width fill for the reads it did not
  verify.

Both runs are the main path: the launch counters are zeroed before them and
read after them.  Every score is checked against the same calls run with
the plain versions, and samples against the native exact engine.  Each
kernel is then compared with its plain version at the shapes the main path
gave it, and a forced ``ub=8`` call drives the ladder's whole-batch
fallback.

Phase 6 drives alignment, the second main path:

* 6a holds the trace kernel (B18) and the decode kernel against their plain
  versions on a ~330-node graph x 64 reads at Wb 256 (rings in shared
  memory) and 4096 (rings in global memory);
* 6b runs the port's CLI, ``python -m poasta_tpu_torch.cli.lasagna align
  G.gfa R.fa -o out.gaf``, on the uniform config (1024 reads, ``-j 64``)
  with every launch counter zeroed just before and read just after; it
  checks that B18 ran, that >= 90% of reads were traced on the device,
  that every ``AS:i`` equals ``score_batch``'s score, and that the GAF is
  byte-equal to the same command with ``POASTA_DEVICE_TRACE=0`` (every
  read through the native host backtrace);
* 6c times the bench's hybrid config, ``align_batch`` on 32 uniform reads;
* 6d holds B18 and the decode against their plain versions at the inputs
  one 6b batch gave them;
* 6e aligns reads of a 45k-rank graph (past the JAX package's 1 MiB trace
  gate) on the default route, and again with ``POASTA_DEVICE_TRACE=0``:
  alignments must be equal, and every read traced on the device.

Phase 7 drives ends-free and drifting-window scoring, the third main path,
each run with every launch counter zeroed just before and read just after:

* 7a the bench's mixed-length SV traffic (a 5,000-base graph with a 4 kb
  deletion allele, 1024 reads at 1.5%, half from each allele) through
  ``BatchMapper.score_batch``: drifting windows (B3), against the same with
  drift switched off, the plain path and the native engine;
* 7b the same reads under the bench's bounded ends-free span
  (``EndsFree(UNBOUNDED, included(50), included(0), included(50))``): drift
  x ends-free (B6), against drift switched off and the exact full fill,
  and two short reads against the exact A* engine;
* 7c 1024 fragments of 2,000-4,000 bases cut from the uniform graph's four
  sequences (95% at 3%, 5% at 15%) under the CLI's semi-global span:
  ``score_batch`` on all of them (one exact full-width tier of the
  ends-free banded fill B5), then, sorted by length into quarters as the
  CLI batches reads, ``BandedScorer.scores(max_retries=1)``: a quarter of
  short fragments is again one exact full-width B5 tier; a quarter of long
  ones has a band narrower than the row, and what its one B5 tier does not
  verify takes the capped ladder over the bounded full fill B4; against
  the plain path, the exact full fill, and the exact A* engine on short
  fragments through the same mapper;
* 7d holds B3, B4, B5 and B6 against their plain versions at the inputs
  7a-7c gave them.

The ``kernels`` line gives, for every kernel, its launches on the main
paths, its time and its plain version's at the main path's shapes, and
``bound_ms``: the least time the card could take for the same work, the
larger of the bytes the function must move (each input read once, each
output written once) over 3.35 TB/s and the integer operations its
recurrence needs (``RECURRENCE_OPS`` and the constants beside it: what the
function needs, not what the kernel spends) over the card's int32 rate
(``INT32_OPS_PER_S``).  No single PyTorch call computes any of these
recurrences, so ``library_ms`` is null throughout.

Any failure raises.  The last line is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.

Needs one card; imports no JAX.
"""

import json
import os
import random
import statistics
import subprocess
import sys
import time
from contextlib import ExitStack
from unittest import mock

REPO = os.path.dirname(os.path.abspath(__file__))
GRAPH_LEN, N_SEQS, N_READS, SEED, DIV = 5000, 4, 1024, 7, 0.03
MIXED_SEED = 11
B1_REPLACES = "poasta_tpu/ops/pallas_fill.py:2007"
B2_REPLACES = "poasta_tpu/ops/pallas_fill.py:304"
B18_REPLACES = "poasta_tpu/ops/pallas_trace.py:121"
DECODE_REPLACES = "poasta_tpu/ops/pallas_trace.py:720"
B3_REPLACES = "poasta_tpu/ops/pallas_fill.py:2822"
B4_REPLACES = "poasta_tpu/ops/pallas_fill.py:461"
B5_REPLACES = "poasta_tpu/ops/pallas_fill.py:2625"
B6_REPLACES = "poasta_tpu/ops/pallas_fill.py:3087"
HYBRID_READS = 32
SV_SEED, SV_DIV, FRAG_SEED = 13, 0.015, 19
# One H100 SXM, from NVIDIA's data sheet: 3.35 TB/s of HBM3, and 67 TFLOP/s
# of fp32 outside the tensor cores.  An SM starts 64 int32 add/min/compare a
# cycle beside 128 fp32 FMAs (which count as two), so the int32 rate is a
# quarter of the fp32 figure.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12 / 4
BIG_GRAPH_LEN, BIG_READS, BIG_SEED, BIG_DIV = 45000, 16, 9, 0.01


def _mutate(rng, s, d, target_len=None):
    out = []
    for ch in s:
        r = rng.random()
        if r < d:
            continue
        out.append(rng.choice("ACGT") if r < 2.5 * d else ch)
        if rng.random() < d:
            out.append(rng.choice("ACGT"))
    s2 = "".join(out)
    if target_len is not None:
        s2 = s2[:target_len]
    return s2 or "A"


def _fused_graph(rng, costs, glen, n_seqs, div):
    from poasta_tpu_torch import NativeAligner, POAGraph

    base = "".join(rng.choice("ACGT") for _ in range(glen))
    graph = POAGraph()
    graph.add_alignment_with_weights("s0", base.encode(), None, [1] * glen)
    seqs = [base]
    for i in range(1, n_seqs):
        seqs.append(_mutate(rng, base, div, glen))
        seq = seqs[-1].encode()
        _, aln, _ = NativeAligner(graph).align(seq, costs)
        graph.add_alignment_with_weights(f"s{i}", seq, aln, [1] * len(seq))
    return graph, base, seqs


def uniform_workload(costs):
    """bench.py's ``build_uniform`` configuration (seed 7): the graph, the
    four sequences fused into it (the base first) and 1024 reads at 3%
    divergence."""
    rng = random.Random(SEED)
    graph, base, seqs = _fused_graph(rng, costs, GRAPH_LEN, N_SEQS, DIV)
    reads = [_mutate(rng, base, DIV, GRAPH_LEN).encode()
             for _ in range(N_READS)]
    return graph, seqs, reads


def mixed_reads(base):
    """bench.py's mixed-divergence traffic drawn from ``base``: every 20th
    read at 15% divergence, the rest at 2%."""
    rng = random.Random(MIXED_SEED)
    return [_mutate(rng, base, 0.15 if i % 20 == 0 else 0.02).encode()
            for i in range(N_READS)]


def sv_workload(costs):
    """bench.py's mixed-length SV configuration (seed 13): a 5,000-base
    graph fused with its 4 kb-deletion allele, and 1024 reads at 1.5%, every
    other one from the short allele."""
    from poasta_tpu_torch import NativeAligner, POAGraph

    rng = random.Random(SV_SEED)
    base = "".join(rng.choice("ACGT") for _ in range(GRAPH_LEN))
    variant = base[:500] + base[4500:]
    graph = POAGraph()
    graph.add_alignment_with_weights("s0", base.encode(), None,
                                     [1] * GRAPH_LEN)
    _, aln, _ = NativeAligner(graph).align(variant.encode(), costs)
    graph.add_alignment_with_weights("s1", variant.encode(), aln,
                                     [1] * len(variant))
    reads = [_mutate(rng, base if i % 2 else variant, SV_DIV).encode()
             for i in range(N_READS)]
    return graph, reads


def fragment_reads(seqs, n_reads, lo, hi):
    """Fragments of ``lo``..``hi`` bases cut from the graph's sequences
    (seed 19): every 20th at 15% divergence, the rest at 3%."""
    rng = random.Random(FRAG_SEED)
    out = []
    for i in range(n_reads):
        seq = rng.choice(seqs)
        n = rng.randrange(lo, hi + 1)
        a = rng.randrange(0, len(seq) - n + 1)
        out.append(_mutate(rng, seq[a:a + n],
                           0.15 if i % 20 == 0 else DIV).encode())
    return out


def _bound(bytes_moved, ops):
    """The least time the card could take, in ms, and what sets it."""
    by = bytes_moved / HBM_BYTES_PER_S * 1e3
    op = ops / INT32_OPS_PER_S * 1e3
    return {"bound_ms": max(by, op),
            "bound_by": "bytes" if by >= op else "operations",
            "library_ms": None}


# Integer operations per lane and rank that the one-piece recurrence needs,
# whatever the kernel spends: D (add, add, min), the diagonal
# (compare-select, add), A (min), I (add, clamp), M (min), the stored D's
# clamp.
RECURRENCE_OPS = 10
# A truncated prefix-min needs at most three mins per lane whatever its
# window (van Herk / Gil-Werman: a forward and a backward scan over blocks
# of the window's length, and one min to join them).  The kernels' own
# Hillis-Steele rounds, log2(cap) of them, belong to the implementation and
# are not counted.
SCAN_OPS = 3
# The trace fill (B18) beside RECURRENCE_OPS less the clamp it does not
# apply (9): which branch opened D and its column (compare, select), M's
# source (two compares, two selects), I's source (add, compare), and the
# pointer word (four fields shifted into place, two three-input ors).
TRACE_OPS = 9 + 2 + 4 + 2 + 6
# Per predecessor row after the first: a min each for M and D; with the
# argmin (B18) a compare, a select and a min each.
PRED_OPS, TRACE_PRED_OPS = 2, 6
# One decode step, from trace_decode_kernel's body: the lane (subtract, two
# clamps), five fields unpacked (an and, four shift-and pairs), the action
# by state (2), the hop test (3), the op code (3), the next rank (2
# selects), consumes (2), the step word (shift, or), done (3), the next
# state (3), the next offset (1).
DECODE_OPS = 3 + 9 + 2 + 3 + 3 + 2 + 2 + 2 + 3 + 3 + 1
# ... and its bytes: a pointer word and a window start in, a step word out.
DECODE_BYTES = 12


def fill_bound(dg, B, lanes, q_lanes, out_lanes, tilted,
               per_pred=PRED_OPS, per_rank=RECURRENCE_OPS, table_cols=0):
    """Bound of one fill of B reads over ``lanes`` lanes at each of the
    graph's ranks.  Operations per lane and rank: ``per_pred`` for every
    predecessor row after a rank's first, ``per_rank`` (the recurrence and a
    variant's extras), SCAN_OPS, and for an untilted fill the e*j subtract
    and add.  Bytes: the query rows and rank tables in, the output rows
    out, each once."""
    P = int(dg.pred_slots.shape[1])
    n = dg.n_nodes
    extra_preds = int(dg.pred_valid_np[:n, 1:].sum())
    ops = B * lanes * (per_pred * extra_preds + n * (
        per_rank + SCAN_OPS + (0 if tilted else 2)))
    table_ints = n * (2 + 2 * P + table_cols)
    return _bound(4 * (B * q_lanes + table_ints + B * out_lanes), ops)


_PHASE_START = [time.perf_counter()]


def _phase_done(name):
    """Print the host seconds since the previous phase ended (where the
    script's own run time goes)."""
    now = time.perf_counter()
    print(f"[time] {name}: {now - _PHASE_START[0]:.1f} s", flush=True)
    _PHASE_START[0] = now


def _time_ms(fn, reps):
    """Median wall time of ``fn`` on the card in ms (CUDA events)."""
    import torch

    ts = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        ts.append(start.elapsed_time(end))
    return statistics.median(ts)


def _compare(name, kernel_fn, plain_fn, card, reps=5):
    """Kernel against plain version on the same inputs: raw rows must be
    equal; returns the measured numbers.  The kernel's checking call is its
    warm-up; the plain version (seconds of host-driven torch ops, no
    compile step) is called once, and that call is the one timed."""
    import torch

    got = kernel_fn()
    kept = []
    plain_ms = _time_ms(lambda: kept.append(plain_fn()), 1)
    ref = kept[0]
    torch.cuda.synchronize()
    gots = got if isinstance(got, tuple) else (got,)
    refs = ref if isinstance(ref, tuple) else (ref,)
    err = max((int((g.long() - r.long()).abs().max()) if g.numel() else 0)
              for g, r in zip(gots, refs))
    if not all(torch.equal(g, r) for g, r in zip(gots, refs)):
        raise AssertionError(f"{name}: kernel and plain outputs differ "
                             f"(max abs err {err})")
    ms = _time_ms(kernel_fn, reps)
    shapes = [tuple(g.shape) for g in gots]
    print(f"[kernels] {name}: equal outputs {shapes}, kernel "
          f"{ms:.3f} ms, plain {plain_ms:.3f} ms  [{card}]", flush=True)
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "shape": (list(shapes[0]) if len(shapes) == 1
                      else [list(sh) for sh in shapes])}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: torch.cuda.is_available() is "
                           "False")
    sys.path.insert(0, REPO)
    from poasta_tpu_torch import (
        BandedScorer,
        BatchMapper,
        DeviceGraph,
        GapAffine,
        NativeAligner,
        pack_queries,
    )
    from poasta_tpu_torch.aligner import banded as banded_mod
    from poasta_tpu_torch.aligner import wavefront as wavefront_mod
    from poasta_tpu_torch.ops import cuda_fill as cf
    from poasta_tpu_torch.utils import build
    from poasta_tpu_torch.utils.device import card_info, cuda_device

    # ---- 1. setup -------------------------------------------------------
    dev = cuda_device()
    card = card_info()
    print(card, flush=True)
    nvcc = subprocess.run([build.nvcc_path(), "--version"],
                          capture_output=True, text=True, check=True)
    print(f"[setup] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"nvcc {nvcc.stdout.strip().splitlines()[-1]}, "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    costs = GapAffine(4, 2, 6)

    # ---- 2. build -------------------------------------------------------
    built = build.build()
    print(f"[build] {built['lib']} in {built['seconds']:.1f} s", flush=True)
    for line in built["log"].splitlines():
        if "Used" in line or "Compiling entry" in line:
            print(f"[build] {line.strip()}", flush=True)
    build.load()

    # ---- 3. kernels against their plain versions on the card ------------
    graph, seqs, reads = uniform_workload(costs)
    base = seqs[0]
    flat = graph.flatten()
    mapper = BatchMapper(graph, costs, device=dev)
    dg = mapper.dg
    q_all, l_all = pack_queries(reads, device=dev)
    lens = [len(r) for r in reads]
    L = int(q_all.shape[1])
    print(f"[setup] uniform graph: {flat.n_nodes} nodes (Np "
          f"{dg.n_nodes_padded}), W {dg.window}, P "
          f"{int(dg.pred_slots.shape[1])}; {N_READS} reads of "
          f"{min(lens)}-{max(lens)}, L {L}", flush=True)

    def banded_case(g_dg, g_flat, q, ln, ub, capped):
        ws, width, _, _ = banded_mod.band_windows(
            g_flat, int(ln.min()), int(ln.max()), costs, ub)
        prep = cf.prepare_banded(g_dg, costs, (ws // 128) * 128,
                                 width + 128, int(q.shape[1]))
        max_run = banded_mod.ins_run_cap(costs, ub, prep["width"]) \
            if capped else 0
        return prep, max_run

    small_rng = random.Random(3)
    sg, sbase, _ = _fused_graph(small_rng, costs, 260, 4, 0.04)
    s_reads = [_mutate(small_rng, sbase, DIV).encode() for _ in range(64)]
    s_dg = DeviceGraph.build(sg.flatten(), device=dev)
    sq, sl = pack_queries(s_reads, device=dev)
    prep, mr = banded_case(s_dg, sg.flatten(), sq, sl.cpu().numpy(), 120,
                           True)
    print(f"[kernels] B1 small: {s_dg.n_nodes} nodes x 64 reads, Wb "
          f"{prep['width']}, max_run {mr}, plan "
          f"{cf.banded_plan(s_dg.window, prep['width'], prep['margin'])}",
          flush=True)
    _compare("B1 small", lambda: cf.banded_end_rows(s_dg, sq, costs, prep, mr),
             lambda: cf.banded_end_rows_plain(s_dg, sq, costs, prep, mr),
             card)

    q128 = q_all[:128].contiguous()
    prep, mr = banded_case(dg, flat, q128, l_all.cpu().numpy(), 1364, True)
    q_in = torch.nn.functional.pad(q128, (0, max(0, prep["L"] - L)))
    plan = cf.banded_plan(dg.window, prep["width"], prep["margin"])
    print(f"[kernels] B1 first tier: 128 reads, Wb {prep['width']}, margin "
          f"{prep['margin']}, plan {plan}", flush=True)
    for run in (mr, 0):
        _compare(f"B1 first tier max_run {run}",
                 lambda r=run: cf.banded_end_rows(dg, q_in, costs, prep, r),
                 lambda r=run: cf.banded_end_rows_plain(dg, q_in, costs,
                                                        prep, r),
                 card)

    mid_rng = random.Random(5)
    mg, mbase, _ = _fused_graph(mid_rng, costs, 1000, 4, 0.04)
    m_reads = [_mutate(mid_rng, mbase, DIV).encode() for _ in range(256)]
    m_dg = DeviceGraph.build(mg.flatten(), device=dev)
    mq, _ = pack_queries(m_reads, device=dev)
    print(f"[kernels] B2 mid: {m_dg.n_nodes} nodes x 256 reads, L "
          f"{int(mq.shape[1])}, plan "
          f"{cf.fill_plan(m_dg.window, int(mq.shape[1]))}", flush=True)
    _compare("B2 mid", lambda: cf.fill_end_rows(m_dg, mq, costs),
             lambda: cf.fill_end_rows_plain(m_dg, mq, costs), card)

    _phase_done("1-3 set-up, build, kernels at small shapes")
    # ---- 4. main path ---------------------------------------------------
    # the fills' inputs are recorded (last call per run) so that phase 4b
    # can hold each kernel against its plain version at the path's shapes
    mixed = mixed_reads(base)
    qm, lm = pack_queries(mixed, device=dev)
    real_banded, real_fill = banded_mod.banded_scores, wavefront_mod.fill_scores
    captured, run = {}, ["uniform"]

    def rec_banded(g_dg, q, ln, c, p, max_run=0):
        captured[(run[0], "B1")] = (g_dg, q, c, p, max_run)
        return real_banded(g_dg, q, ln, c, p, max_run=max_run)

    def rec_fill(g_dg, q, ln, c):
        captured[(run[0], "B2")] = (g_dg, q, c)
        return real_fill(g_dg, q, ln, c)

    scorer = mapper.scorer
    counts = {}
    with mock.patch.object(banded_mod, "banded_scores", rec_banded), \
            mock.patch.object(wavefront_mod, "fill_scores", rec_fill):
        cf.banded_end_rows.launches = 0
        cf.fill_end_rows.launches = 0
        scores = mapper.score_batch(reads)  # warm-up: converges the ub hint
        ts, raws, tiers = [], [], []
        for _ in range(5):
            scorer.reset_stats()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            scores = mapper.score_batch(reads)
            ts.append(time.perf_counter() - t0)
            raws.append(scorer.stats["cells_filled"])
            tiers.append(scorer.stats["tiers"])
        counts["uniform"] = (cf.banded_end_rows.launches,
                             cf.fill_end_rows.launches)
        run[0] = "mixed"
        scorer.reset_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mixed_scores = scorer.scores(qm, lm, max_retries=1)
        mixed_s = time.perf_counter() - t0
        mixed_stats = dict(scorer.stats)
        b1_main = cf.banded_end_rows.launches
        b2_main = cf.fill_end_rows.launches
    counts["mixed"] = (b1_main - counts["uniform"][0],
                       b2_main - counts["uniform"][1])
    el = statistics.median(ts)
    eff_cells = flat.n_nodes * L * N_READS
    print(f"[main] uniform: {N_READS / el:.2f} reads/s, {eff_cells / el:.4e} "
          f"effective cells/s, {statistics.median(raws) / el:.4e} raw cells/s"
          f", median {el * 1e3:.1f} ms of {[round(t * 1e3, 1) for t in ts]}"
          f", tiers {tiers}, ub hint {scorer._ub_hint}, B1 launches "
          f"{counts['uniform'][0]}, B2 launches {counts['uniform'][1]}  "
          f"[{card}]", flush=True)
    print(f"[main] mixed, max_retries 1: {mixed_s * 1e3:.1f} ms, stats "
          f"{mixed_stats}, B1 launches {counts['mixed'][0]}, B2 launches "
          f"{counts['mixed'][1]}  [{card}]", flush=True)
    for name, s in (("uniform", scores), ("mixed", mixed_scores)):
        if s.shape != (N_READS,) or not (s < cf.INF).all():
            raise AssertionError(f"{name}: main path returned non-finite or "
                                 "misshaped scores")
    if b1_main <= 0 or b2_main <= 0:
        raise AssertionError(f"a kernel of the main path never launched: "
                             f"B1 {b1_main}, B2 {b2_main}")

    with mock.patch.object(banded_mod, "banded_scores",
                           cf.banded_scores_plain), \
            mock.patch.object(wavefront_mod, "fill_scores",
                              cf.fill_scores_plain):
        t0 = time.perf_counter()
        plain_mapper = BatchMapper(graph, costs, device=dev)
        plain = plain_mapper.score_batch(reads)
        plain_s = time.perf_counter() - t0
        plain_mixed = plain_mapper.scorer.scores(qm, lm, max_retries=1)
    if cf.banded_end_rows.launches != b1_main \
            or cf.fill_end_rows.launches != b2_main:
        raise AssertionError("the plain path launched a kernel")
    for name, got, ref in (("uniform", scores, plain),
                           ("mixed", mixed_scores, plain_mixed)):
        if not (got == ref).all():
            bad = int((got != ref).sum())
            raise AssertionError(f"{name}: {bad} of {N_READS} scores differ "
                                 "from the plain path's")
    print(f"[main] all {N_READS} uniform and {N_READS} mixed scores equal "
          f"the plain path's on the card (uniform plain path {plain_s:.1f} "
          f"s, one cold call)", flush=True)

    # the exact engine takes ~13 s a 5 kb read, so it checks one; its banded
    # mode checks 64
    na = NativeAligner(graph)
    exact = na.align(reads[0], costs)[0]
    if exact != int(scores[0]):
        raise AssertionError(f"read 0: native {exact}, port {int(scores[0])}")
    native64 = [na.align_banded(q, costs)[0] for q in reads[:64]]
    if list(map(int, scores[:64])) != native64:
        raise AssertionError("first 64 scores differ from the native "
                             "banded engine's")
    # 15% reads (every 20th) score far above the first tier's ub, so the
    # full fill scored them
    tail = list(range(0, 160, 20))
    native_tail = [na.align_banded(mixed[i], costs)[0] for i in tail]
    if [int(mixed_scores[i]) for i in tail] != native_tail:
        raise AssertionError("mixed 15% reads differ from the native "
                             "banded engine's")
    print("[main] uniform read 0 equals NativeAligner.align, reads 0-63 "
          f"NativeAligner.align_banded; mixed 15% reads {tail} equal "
          "NativeAligner.align_banded", flush=True)

    _phase_done("4 uniform and mixed scoring, plain paths, native checks")
    # ---- 4b. each kernel at the shapes the main path gave it -------------
    results = {}
    g_dg, q, c, p, max_run = captured[("uniform", "B1")]
    print(f"[kernels] B1 main path: {int(q.shape[0])} reads, Lq "
          f"{int(q.shape[1])}, Wb {p['width']}, margin {p['margin']}, "
          f"max_run {max_run}, plan "
          f"{cf.banded_plan(g_dg.window, p['width'], p['margin'])}",
          flush=True)
    results["B1"] = _compare(
        "B1 main path", lambda: cf.banded_end_rows(g_dg, q, c, p, max_run),
        lambda: cf.banded_end_rows_plain(g_dg, q, c, p, max_run), card,
        reps=3)
    results["B1"].update(fill_bound(
        g_dg, int(q.shape[0]), p["width"], int(q.shape[1]), p["width"],
        tilted=True, table_cols=1 + int(g_dg.pred_slots.shape[1])))
    g_dg, q, c = captured[("mixed", "B2")]
    print(f"[kernels] B2 main path (mixed tail): {int(q.shape[0])} reads, L "
          f"{int(q.shape[1])}, plan "
          f"{cf.fill_plan(g_dg.window, int(q.shape[1]))}", flush=True)
    results["B2"] = _compare(
        "B2 main path", lambda: cf.fill_end_rows(g_dg, q, c),
        lambda: cf.fill_end_rows_plain(g_dg, q, c), card, reps=3)
    results["B2"].update(fill_bound(
        g_dg, int(q.shape[0]), int(q.shape[1]), int(q.shape[1]),
        int(q.shape[1]), tilted=False))

    # ---- 5. forced whole-batch full-fill fallback -----------------------
    q64, l64 = q_all[:64].contiguous(), l_all[:64].contiguous()
    fb = BandedScorer(flat, costs, dg=dg)
    before = cf.fill_end_rows.launches
    fb_scores = fb.scores(q64, l64, ub=8, max_retries=1)
    b2_fb = cf.fill_end_rows.launches - before
    if b2_fb <= 0 or fb.stats["fullfill_fallbacks"] != 1:
        raise AssertionError("ub 8 did not reach the full-fill kernel")
    if list(map(int, fb_scores)) != native64:
        raise AssertionError("full-fill fallback scores differ from the "
                             "native engine's")
    print(f"[fallback] ub 8, one attempt: {b2_fb} B2 launch(es), 64 scores "
          f"equal the native engine's", flush=True)

    _phase_done("4b-5 B1 and B2 at the main path's shapes, fallback")
    # ---- 6. alignment: device traceback -------------------------------
    trace_results, lasagna = align_phases(
        card, dev, costs, graph, reads, scores, sg, s_reads)

    # ---- 7. ends-free and drifting-window scoring -------------------------
    ef_results, ef_launches = ends_free_phases(card, dev, costs, graph, seqs)
    results.update(ef_results)

    def by_call(name):
        """A fill kernel's launches in each main-path call that used it."""
        i = {"B1": 0, "B2": 1}.get(name)
        calls = {} if i is None else {
            "score_batch uniform": counts["uniform"][i],
            "scores mixed max_retries=1": counts["mixed"][i],
            "lasagna align uniform": lasagna["launches"][i]}
        calls.update({call: n[name] for call, n in ef_launches.items()})
        return {call: n for call, n in calls.items() if n}

    def fill_entry(name, kernel, source, replaces):
        calls = by_call(name)
        if not calls:
            raise AssertionError(f"{name} launched on no main path")
        return {"name": kernel, "route": "cuda",
                "source": f"poasta_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": sum(calls.values()),
                "launches_by_call": calls, **results[name]}

    banded, full = "banded_kernel.cu", "fill_kernel.cu"
    kernels = [
        fill_entry("B1", "banded_kernel<global>", banded, B1_REPLACES),
        {**fill_entry("B2", "full_fill_kernel<global>", full, B2_REPLACES),
         "forced_fallback_launches": b2_fb},
        fill_entry("B3", "banded_kernel<drift>", banded, B3_REPLACES),
        fill_entry("B4", "full_fill_kernel<bounded>", full, B4_REPLACES),
        fill_entry("B5", "banded_kernel<ends-free>", banded, B5_REPLACES),
        fill_entry("B6", "banded_kernel<drift, ends-free>", banded,
                   B6_REPLACES),
        {"name": "trace_kernel", "route": "cuda",
         "source": "poasta_tpu_torch/csrc/trace_kernel.cu",
         "replaces": B18_REPLACES, "launches": lasagna["launches"][2],
         **trace_results["B18"]},
        {"name": "trace_decode_kernel", "route": "cuda",
         "source": "poasta_tpu_torch/csrc/trace_kernel.cu",
         "replaces": DECODE_REPLACES, "launches": lasagna["launches"][3],
         **trace_results["decode"]},
    ]
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def _trace_pair(dg, inp, costs, Wb, verified, t_max):
    """Closures running B18 and the decode (kernel, plain) on the same
    inputs; the decodes walk the kernel's planes."""
    from poasta_tpu_torch.ops import trace as tr

    import torch

    dev = inp["qpad"].device
    ptr = tr.trace_fill(dg, **inp, costs=costs, Wb=Wb)[1]
    walk = (tr.pred_rank_table(dg, dev), inp["wstarts"], inp["anchor_r"],
            inp["anchor_j"], dg.end_rank_i,
            torch.as_tensor(verified, device=dev), t_max)
    return ((lambda: tr.trace_fill(dg, **inp, costs=costs, Wb=Wb)),
            (lambda: tr.trace_fill_plain(dg, **inp, costs=costs, Wb=Wb)),
            (lambda: tr.trace_decode(ptr, *walk)),
            (lambda: tr.decode_plain(ptr, *walk)))


def write_inputs(graph, reads, directory):
    """The graph as GFA (``graph_to_gfa``) and the reads as FASTA (named
    ``r<i>``) in ``directory``; returns their paths."""
    from poasta_tpu_torch.io.gfa import graph_to_gfa

    gfa = os.path.join(directory, "uniform.gfa")
    fa = os.path.join(directory, "reads.fa")
    with open(gfa, "w") as fh:
        graph_to_gfa(graph, fh)
    with open(fa, "w") as fh:
        for i, r in enumerate(reads):
            fh.write(f">r{i}\n{r.decode()}\n")
    return gfa, fa


def _lasagna_run(argv):
    """The port's CLI in this process; returns its wall seconds."""
    import torch

    from poasta_tpu_torch.cli.lasagna import main as lasagna_main

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rc = lasagna_main(argv)
    torch.cuda.synchronize()
    if rc != 0:
        raise AssertionError(f"lasagna {argv} exited {rc}")
    return time.perf_counter() - t0


def align_phases(card, dev, costs, graph, reads, scores, sg, s_reads):
    """Phases 6a-6d; returns (kernel comparisons, lasagna run record)."""
    import tempfile

    import torch

    from poasta_tpu_torch import BatchMapper, pack_queries
    from poasta_tpu_torch.ops import cuda_fill as cf
    from poasta_tpu_torch.ops import trace as tr
    from poasta_tpu_torch.parallel import mapper as mapper_mod

    # ---- 6a. B18 and the decode at small shapes --------------------------
    s_mapper = BatchMapper(sg, costs, device=dev)
    s_flat, s_dg = s_mapper.flat, s_mapper.dg
    s_scores = s_mapper.score_batch(s_reads)
    sq, sl = pack_queries(s_reads, device=dev)
    for Wb in (256, 4096):
        k_tier, k_full = tr.gap_budgets(s_flat, s_scores, costs, Wb)
        inp, ok = tr.tier_inputs(s_dg, s_flat, sq, sl.cpu().numpy(), k_tier,
                                 Wb)
        aval = tr.trace_fill(s_dg, **inp, costs=costs, Wb=Wb)[0]
        verified = (aval.cpu().numpy() == s_scores) & ok
        t_max = int(-(-(int(sl.max()) + int(k_full.max()) + 8) // 512) * 512)
        fill_k, fill_p, dec_k, dec_p = _trace_pair(s_dg, inp, costs, Wb,
                                                   verified, t_max)
        print(f"[trace] small: {s_dg.n_nodes} nodes x {len(s_reads)} reads, "
              f"W {s_dg.window}, Wb {Wb}, plan "
              f"{tr.trace_plan(s_dg.window, Wb)}, {int(verified.sum())} "
              "verified", flush=True)
        _compare(f"B18 small Wb {Wb}", fill_k, fill_p, card, reps=3)
        _compare(f"decode small Wb {Wb}", dec_k, dec_p, card, reps=3)

    _phase_done("6a trace kernels at small shapes")
    # ---- 6b. main path: the port's lasagna CLI on the uniform config -----
    hybrid = BatchMapper(graph, costs, device=dev)
    for Wb in tr.TIER_WIDTHS:
        print(f"[trace] uniform graph W {hybrid.dg.window}, Wb {Wb}: plan "
              f"{tr.trace_plan(hybrid.dg.window, Wb)}", flush=True)
    tmp = tempfile.mkdtemp(prefix="poasta_smoke_")
    gfa, fa = write_inputs(graph, reads, tmp)
    out_dev, out_host = os.path.join(tmp, "dev.gaf"), os.path.join(tmp,
                                                                  "host.gaf")

    # the launchers are wrapped to record the first batch's kernel inputs
    # (phase 6d); the wrappers' launch counters are untouched
    real_banded = mapper_mod.BatchMapper._align_batch_banded
    real_fill, real_decode = tr._launch_trace, tr._launch_decode
    per_batch, captured = [], {}

    def rec_banded(self, *args, **kwargs):
        out = real_banded(self, *args, **kwargs)
        per_batch.append(dict(self.last_banded_stats))
        return out

    def rec_fill(g_dg, qpad, wstarts, anchor_r, anchor_j, c, Wb):
        captured.setdefault("fill", (g_dg, dict(
            qpad=qpad, wstarts=wstarts, anchor_r=anchor_r,
            anchor_j=anchor_j), c, Wb))
        return real_fill(g_dg, qpad, wstarts, anchor_r, anchor_j, c, Wb)

    def rec_decode(ptr, *walk):
        captured.setdefault("decode", walk)
        return real_decode(ptr, *walk)

    kernels = (cf.banded_end_rows, cf.fill_end_rows, tr.trace_fill,
               tr.trace_decode)
    with mock.patch.object(mapper_mod.BatchMapper, "_align_batch_banded",
                           rec_banded), \
            mock.patch.object(tr, "_launch_trace", rec_fill), \
            mock.patch.object(tr, "_launch_decode", rec_decode):
        for k in kernels:
            k.launches = 0
        dev_s = _lasagna_run(["align", gfa, fa, "-o", out_dev, "-j", "64"])
        launches = [k.launches for k in kernels]
    traced = sum(b["device_traced"] for b in per_batch)
    host = sum(b["host_backtraced"] for b in per_batch)
    print(f"[lasagna] uniform, -j 64, {len(per_batch)} batches: "
          f"{len(reads) / dev_s:.2f} reads/s ({dev_s:.2f} s wall), device "
          f"traced {traced}, host backtraced {host}, per batch "
          f"{[(b['device_traced'], b['host_backtraced']) for b in per_batch]}"
          f", launches B1 {launches[0]}, B2 {launches[1]}, B18 {launches[2]}"
          f", decode {launches[3]}  [{card}]", flush=True)
    if launches[2] <= 0 or launches[3] <= 0:
        raise AssertionError(f"the trace kernels never launched: {launches}")
    if traced < 0.9 * len(reads):
        raise AssertionError(f"only {traced} of {len(reads)} reads traced on "
                             "the device")
    with open(out_dev) as fh:
        dev_gaf = fh.read()
    lines = dev_gaf.splitlines()
    if len(lines) != len(reads):
        raise AssertionError(f"{len(lines)} GAF records for {len(reads)} "
                             "reads")
    for line in lines:
        fields = line.split("\t")
        i = int(fields[0][1:])
        as_i = [f for f in fields if f.startswith("AS:i:")]
        if as_i != [f"AS:i:{int(scores[i])}"]:
            raise AssertionError(f"read {i}: {as_i} but score_batch "
                                 f"{int(scores[i])}")
    print(f"[lasagna] all {len(lines)} AS:i equal score_batch's scores",
          flush=True)

    os.environ["POASTA_DEVICE_TRACE"] = "0"
    try:
        host_s = _lasagna_run(["align", gfa, fa, "-o", out_host, "-j", "64"])
    finally:
        del os.environ["POASTA_DEVICE_TRACE"]
    with open(out_host) as fh:
        if fh.read() != dev_gaf:
            raise AssertionError("GAF with the device trace differs from the "
                                 "native host backtrace's")
    print(f"[lasagna] GAF byte-equal to POASTA_DEVICE_TRACE=0 (all "
          f"{len(reads)} reads, native host backtrace on "
          f"{os.cpu_count()} cores): device trace {dev_s:.2f} s, host "
          f"{host_s:.2f} s wall  [{card}]", flush=True)

    _phase_done("6b the CLI, both routes")
    # ---- 6c. the bench's hybrid config -----------------------------------
    sub = reads[:HYBRID_READS]
    hybrid.align_batch(sub)  # warm-up
    ts = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = hybrid.align_batch(sub)
        torch.cuda.synchronize()
        ts.append(time.perf_counter() - t0)
    if [s for s, _ in out] != [int(s) for s in scores[:HYBRID_READS]]:
        raise AssertionError("hybrid scores differ from score_batch's")
    print(f"[hybrid] align_batch({HYBRID_READS} uniform reads): "
          f"{HYBRID_READS / statistics.median(ts):.2f} reads/s, median "
          f"{statistics.median(ts) * 1e3:.1f} ms of "
          f"{[round(t * 1e3, 1) for t in ts]}, {hybrid.last_banded_stats}  "
          f"[{card}]", flush=True)
    # the two alignment routes alone, on scores computed beforehand
    token = hybrid.prescore(sub)
    route_s = _align_routes(hybrid, sub, token)
    print(f"[hybrid] alignment alone, {HYBRID_READS} prescored reads: device "
          f"trace {route_s['device'] * 1e3:.1f} ms, native host backtrace "
          f"{route_s['host'] * 1e3:.1f} ms on {os.cpu_count()} cores  "
          f"[{card}]", flush=True)

    # ---- 6d. B18 and the decode at the main path's shapes -----------------
    g_dg, inp, c, Wb = captured["fill"]
    walk = captured["decode"]
    print(f"[trace] main path: {int(inp['qpad'].shape[0])} reads, LQ "
          f"{int(inp['qpad'].shape[1])}, Wb {Wb}, t_max {walk[-1]}, plan "
          f"{tr.trace_plan(g_dg.window, Wb)}", flush=True)
    fill_k, fill_p, dec_k, dec_p = _trace_pair(
        g_dg, inp, c, Wb, walk[-2].cpu().numpy(), walk[-1])
    results = {
        "B18": _compare("B18 main path", fill_k, fill_p, card, reps=5),
        "decode": _compare("decode main path", dec_k, dec_p, card, reps=5),
    }
    # B18 writes one pointer word per lane and rank and reads the per-read
    # window starts beside the fill's tables
    n_reads = int(inp["qpad"].shape[0])
    results["B18"].update(fill_bound(
        g_dg, n_reads, Wb, int(inp["qpad"].shape[1]),
        g_dg.n_nodes * Wb + 1, tilted=True, per_pred=TRACE_PRED_OPS,
        per_rank=TRACE_OPS, table_cols=n_reads))
    # decode: one dependent chain per read; its steps are counted from this
    # run's step words
    steps = int((dec_k()[0] != 0).sum())
    results["decode"].update(_bound(DECODE_BYTES * steps, DECODE_OPS * steps))

    _phase_done("6c-6d hybrid, trace kernels at the main path's shapes")
    # ---- 6e. a graph past the JAX package's trace gate ---------------------
    from poasta_tpu_torch import POAGraph

    big_rng = random.Random(BIG_SEED)
    big_base = "".join(big_rng.choice("ACGT") for _ in range(BIG_GRAPH_LEN))
    big = POAGraph()
    big.add_alignment_with_weights("s0", big_base.encode(), None,
                                   [1] * BIG_GRAPH_LEN)
    b_reads = [_mutate(big_rng, big_base, BIG_DIV).encode()
               for _ in range(BIG_READS)]
    b_mapper = BatchMapper(big, costs, device=dev)
    t0 = time.perf_counter()
    token = b_mapper.prescore(b_reads)
    torch.cuda.synchronize()
    score_s = time.perf_counter() - t0
    if token is None:
        raise AssertionError("the 45k-rank batch did not take the banded "
                             "route")
    before = tr.trace_fill.launches
    route_s = _align_routes(b_mapper, b_reads, token)
    if tr.trace_fill.launches <= before:
        raise AssertionError("B18 never launched on the 45k-rank graph")
    print(f"[big] {b_mapper.dg.n_nodes} ranks (Np {b_mapper.dg.n_nodes_padded}"
          f"), {BIG_READS} reads of {min(map(len, b_reads))}-"
          f"{max(map(len, b_reads))}: scoring {score_s:.2f} s; device trace "
          f"{route_s['device']:.3f} s ({tr.trace_fill.launches - before} B18 "
          f"launches), native host backtrace {route_s['host']:.3f} s on "
          f"{os.cpu_count()} cores; alignments equal  [{card}]", flush=True)
    _phase_done("6e 45k-rank graph")
    return results, {"launches": launches, "reads_per_s": len(reads) / dev_s}


def _timed_batches(mapper, reads, n):
    """One warm-up ``score_batch`` (it converges the ub hint), then ``n``
    timed ones: (scores, median seconds, median cells filled)."""
    import torch

    scores = mapper.score_batch(reads)
    ts, raws = [], []
    for _ in range(n):
        mapper.scorer.reset_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        scores = mapper.score_batch(reads)
        ts.append(time.perf_counter() - t0)
        raws.append(mapper.scorer.stats["cells_filled"])
    return scores, statistics.median(ts), statistics.median(raws)


def ends_free_phases(card, dev, costs, graph, seqs):
    """Phases 7a-7d; returns (kernel comparisons of B3-B6, launches of the
    six fill kernels per main-path call)."""
    import torch

    from poasta_tpu_torch import (
        UNBOUNDED,
        BatchMapper,
        EndsFree,
        NativeAligner,
        PoastaAligner,
        included,
        pack_queries,
    )
    from poasta_tpu_torch.aligner import banded as banded_mod
    from poasta_tpu_torch.aligner import wavefront as wavefront_mod
    from poasta_tpu_torch.ops import cuda_fill as cf

    fills = {"B1": cf.banded_end_rows, "B2": cf.fill_end_rows,
             "B3": cf.drift_end_rows, "B4": cf.bounded_best_rows,
             "B5": cf.ef_best_rows, "B6": cf.drift_ef_best_rows}
    launches = {}

    # the widest batch a main-path call gives each new kernel (the last
    # such call, so a learned ub's layout rather than the warm-up's) is kept
    # for 7d, not the checking calls'; the launch counters are untouched
    captured, on_main_path = {}, [False]

    def keep(name, fn, q_at):
        def rec(*args, **kwargs):
            B = int(args[q_at].shape[0])
            if on_main_path[0] and B >= captured.get(name, (0,))[0]:
                captured[name] = (B, args, kwargs)
            return fn(*args, **kwargs)
        return rec

    def zero():
        for k in fills.values():
            k.launches = 0
        on_main_path[0] = True

    def read(call):
        on_main_path[0] = False
        launches[call] = {name: k.launches for name, k in fills.items()}
        return launches[call]

    recorders = [
        mock.patch.object(banded_mod, "drift_scores",
                          keep("B3", cf.drift_scores, 1)),
        mock.patch.object(banded_mod, "drift_ef_scores",
                          keep("B6", cf.drift_ef_scores, 1)),
        mock.patch.object(banded_mod, "ef_scores",
                          keep("B5", cf.ef_scores, 1)),
        mock.patch.object(wavefront_mod, "bounded_scores",
                          keep("B4", cf.bounded_scores, 1)),
    ]
    plain_fills = [
        mock.patch.object(banded_mod, "banded_scores", cf.banded_scores_plain),
        mock.patch.object(banded_mod, "drift_scores", cf.drift_scores_plain),
        mock.patch.object(banded_mod, "drift_ef_scores",
                          cf.drift_ef_scores_plain),
        mock.patch.object(banded_mod, "ef_scores", cf.ef_scores_plain),
        mock.patch.object(wavefront_mod, "fill_scores", cf.fill_scores_plain),
        mock.patch.object(wavefront_mod, "bounded_scores",
                          cf.bounded_scores_plain),
    ]

    def plain_path(fn):
        """``fn()`` with every fill replaced by its plain version; fails if
        a kernel launches all the same."""
        before = [k.launches for k in fills.values()]
        with ExitStack() as stack:
            for patch in plain_fills:
                stack.enter_context(patch)
            t0 = time.perf_counter()
            out = fn()
            secs = time.perf_counter() - t0
        if [k.launches for k in fills.values()] != before:
            raise AssertionError("the plain path launched a kernel")
        return out, secs

    def no_drift(mapper):
        mapper.scorer.DRIFT_MIN_SPREAD = 1 << 30
        return mapper

    def drift_layouts(scorer):
        return sorted((k[3], v[0]) for k, v in scorer._prep_cache.items()
                      if k[0] == "drift" and v[0] is not None)

    with ExitStack() as stack:
        for patch in recorders:
            stack.enter_context(patch)

        # ---- 7a. drifting windows, global span ----------------------------
        gsv, sv_reads = sv_workload(costs)
        lens = [len(r) for r in sv_reads]
        m_drift = BatchMapper(gsv, costs, device=dev)
        print(f"[drift] SV graph: {m_drift.flat.n_nodes} nodes, W "
              f"{m_drift.dg.window}; {N_READS} reads of {min(lens)}-"
              f"{max(lens)}", flush=True)
        zero()
        sv_scores, el, raw = _timed_batches(m_drift, sv_reads, 3)
        n7a = read("score_batch mixed_len")
        sh_scores, el_sh, raw_sh = _timed_batches(
            no_drift(BatchMapper(gsv, costs, device=dev)), sv_reads, 3)
        print(f"[drift] mixed_len score_batch: {N_READS / el:.2f} reads/s "
              f"(median {el * 1e3:.1f} ms), drift off {N_READS / el_sh:.2f} "
              f"reads/s ({el_sh * 1e3:.1f} ms); cells ratio "
              f"{raw_sh / max(raw, 1):.2f} (shared {raw_sh:.4e} / drift "
              f"{raw:.4e}); drift layouts (ub, Wb) "
              f"{drift_layouts(m_drift.scorer)}, ub hint "
              f"{m_drift.scorer._ub_hint}; launches {n7a}  [{card}]",
              flush=True)
        if n7a["B3"] <= 0:
            raise AssertionError(f"7a never launched the drift kernel: {n7a}")
        plain_sv, secs = plain_path(
            lambda: BatchMapper(gsv, costs, device=dev).score_batch(sv_reads))
        na = NativeAligner(gsv)
        sample = [0, 1, 2, 3, N_READS // 2, N_READS // 2 + 1, N_READS - 2,
                  N_READS - 1]
        native = [na.align_banded(sv_reads[i], costs)[0] for i in sample]
        if not ((sv_scores == sh_scores).all()
                and (sv_scores == plain_sv).all()
                and [int(sv_scores[i]) for i in sample] == native):
            raise AssertionError("7a: drift scores differ from the shared "
                                 "windows', the plain path's or the native "
                                 "engine's")
        print(f"[drift] all {N_READS} scores equal with drift off and on the "
              f"plain path ({secs:.1f} s, one cold call); reads {sample} "
              "equal NativeAligner.align_banded", flush=True)

        _phase_done("7a mixed_len")
        # ---- 7b. drifting windows x the bench's bounded span ---------------
        bench_span = EndsFree(UNBOUNDED, included(50), included(0),
                              included(50))
        m_ef = BatchMapper(gsv, costs, device=dev, aln_type=bench_span)
        zero()
        ef_scores, el, raw = _timed_batches(m_ef, sv_reads, 3)
        n7b = read("score_batch mixed_len bounded span")
        efs_scores, el_sh, raw_sh = _timed_batches(
            no_drift(BatchMapper(gsv, costs, device=dev,
                                 aln_type=bench_span)), sv_reads, 3)
        print(f"[drift-ef] bounded span score_batch: {N_READS / el:.2f} "
              f"reads/s (median {el * 1e3:.1f} ms), drift off "
              f"{N_READS / el_sh:.2f} reads/s ({el_sh * 1e3:.1f} ms); cells "
              f"ratio {raw_sh / max(raw, 1):.2f}; drift layouts (ub, Wb) "
              f"{drift_layouts(m_ef.scorer)}; launches {n7b}  [{card}]",
              flush=True)
        if n7b["B6"] <= 0:
            raise AssertionError(f"7b never launched the drift x ends-free "
                                 f"kernel: {n7b}")
        q_sv, l_sv = pack_queries(sv_reads, device=dev)
        exact = wavefront_mod.dp_fill_scores_ends_free(
            m_ef.dg, m_ef.flat, q_sv, l_sv, costs, bench_span).cpu().numpy()
        if not ((ef_scores == efs_scores).all()
                and (ef_scores == exact).all()):
            raise AssertionError("7b: drift x ends-free scores differ from "
                                 "the shared windows' or the exact full "
                                 "fill's")
        # an engine that shares nothing with the fills: the exact A* engine
        # under Dijkstra (see 7c) on the tails of one read from each allele,
        # short because it walks most of the graph per query base
        tails = [sv_reads[0][-48:], sv_reads[1][-64:]]
        engine = PoastaAligner(costs, bench_span, heuristic="dijkstra")
        t0 = time.perf_counter()
        want = [engine.align(gsv, r).score for r in tails]
        if list(map(int, m_ef.score_batch(tails))) != want:
            raise AssertionError("7b: short reads differ from the exact "
                                 "engine's under the bounded span")
        print(f"[drift-ef] all {N_READS} scores equal with drift off and the "
              f"exact bounded full fill's; the last 48 and 64 bases of reads "
              f"0 and 1 equal the exact A* engine's {want} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)

        _phase_done("7b mixed_len bounded span")
        # ---- 7c. semi-global fragments on the uniform graph ------------------
        # With a free graph begin and lengths spread over 2 kb the window is
        # as wide as the row, so the whole batch verifies in one exact
        # full-width tier of B5.  Sorted by length into quarters, as the
        # CLI batches its reads, the long quarters' band is narrower than
        # the row, and with one attempt the reads their first tier does not
        # verify reach the capped ladder over the bounded full fill (B4).
        semi = EndsFree(UNBOUNDED, included(0), UNBOUNDED, UNBOUNDED)
        frags = fragment_reads(seqs, N_READS, 2000, 4000)
        lens = [len(r) for r in frags]
        m_sg = BatchMapper(graph, costs, device=dev, aln_type=semi)
        zero()
        sg_scores, el, raw = _timed_batches(m_sg, frags, 3)
        n7c1 = read("score_batch fragments")
        order = sorted(range(N_READS), key=lambda i: len(frags[i]))
        quarters = [order[k:k + N_READS // 4]
                    for k in range(0, N_READS, N_READS // 4)]
        packed = [pack_queries([frags[i] for i in idx], device=dev)
                  for idx in quarters]
        m_q = BatchMapper(graph, costs, device=dev, aln_type=semi)
        zero()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tail_scores = [m_q.scorer.scores(q, ln, max_retries=1)
                       for q, ln in packed]
        tail_s = time.perf_counter() - t0
        n7c2 = read("scores length-sorted quarters max_retries=1")
        print(f"[semi-global] {N_READS} fragments of {min(lens)}-{max(lens)}:"
              f" score_batch {N_READS / el:.2f} reads/s (median "
              f"{el * 1e3:.1f} ms, {raw / el:.4e} raw cells/s), launches "
              f"{n7c1}; four length-sorted quarters through scores("
              f"max_retries=1) {tail_s * 1e3:.1f} ms cold, stats "
              f"{m_q.scorer.stats}, launches {n7c2}, ub hints "
              f"{m_q.scorer._ub_hint}  [{card}]", flush=True)
        if n7c1["B5"] <= 0 or n7c2["B5"] <= 0 or n7c2["B4"] <= 0:
            raise AssertionError(f"7c: the ends-free banded fill or the "
                                 f"bounded full fill never launched: {n7c1} "
                                 f"{n7c2}")
        q_f, l_f = pack_queries(frags, device=dev)
        exact = wavefront_mod.dp_fill_scores_ends_free(
            m_sg.dg, m_sg.flat, q_f, l_f, costs, semi).cpu().numpy()
        plain_q = BatchMapper(graph, costs, device=dev, aln_type=semi)
        plain_sg, secs = plain_path(
            lambda: [plain_q.scorer.scores(q, ln, max_retries=1)
                     for q, ln in packed])
        for idx, got, ref in zip(quarters, tail_scores, plain_sg):
            if not ((got == ref).all() and (got == sg_scores[idx]).all()):
                raise AssertionError("7c: a quarter's scores differ from the "
                                     "plain path's or from score_batch's")
        if not ((sg_scores == exact).all() and (sg_scores < cf.INF).all()):
            raise AssertionError("7c: semi-global scores differ from the "
                                 "exact full fill's")
        # the exact A* engine needs the Dijkstra heuristic here (mingap is
        # not admissible when ends are free) and then takes minutes on a
        # 3 kb fragment, so it checks short fragments through the same mapper
        short = fragment_reads(seqs, 2, 100, 120)
        engine = PoastaAligner(costs, semi, heuristic="dijkstra")
        t0 = time.perf_counter()
        want = [engine.align(graph, r).score for r in short]
        if list(map(int, m_sg.score_batch(short))) != want:
            raise AssertionError("7c: short fragments differ from the exact "
                                 "engine's")
        print(f"[semi-global] all {N_READS} scores equal the exact bounded "
              f"full fill's and the plain path's ({secs:.1f} s, one cold "
              f"call); 2 fragments of 100-120 bases equal the exact A* "
              f"engine's {want} ({time.perf_counter() - t0:.1f} s)",
              flush=True)

    _phase_done("7c semi-global fragments")
    # ---- 7d. B3-B6 against their plain versions at the main paths' shapes ----
    results = {}
    _, (dg, qpad, ln, c, prep, n_min), kw = captured["B3"]
    nbs = cf.drift_units(ln, n_min)
    mr = kw.get("max_run", 0)
    plan = cf.variant_plan(cf.VARIANT_DRIFT, dg.window, prep["width"],
                           prep["margin"], int(qpad.shape[1]))
    print(f"[kernels] B3 main path: {int(qpad.shape[0])} reads, Lq "
          f"{int(qpad.shape[1])} (mq {prep['mq']}), Wb {prep['width']}, margin"
          f" {prep['margin']}, S {prep['S']}, max_run {mr}, plan {plan}",
          flush=True)
    results["B3"] = _compare(
        "B3 main path", lambda: cf.drift_end_rows(dg, qpad, nbs, c, prep, mr),
        lambda: cf.drift_end_rows_plain(dg, qpad, nbs, c, prep, mr), card,
        reps=3)
    P = int(dg.pred_slots.shape[1])
    results["B3"].update(fill_bound(
        dg, int(qpad.shape[0]), prep["width"], int(qpad.shape[1]) + 1,
        prep["width"], tilted=True, table_cols=3 + P))

    _, (dg, qpad, ln, c, prep, n_min, end_ok, jlo), kw = captured["B6"]
    li, jl = ln.to(torch.int32).contiguous(), jlo.to(torch.int32).contiguous()
    nbs = cf.drift_units(li, n_min)
    mr = kw.get("max_run", 0)
    plan = cf.variant_plan(cf.VARIANT_DRIFT_EF, dg.window, prep["width"],
                           prep["margin"], int(qpad.shape[1]))
    print(f"[kernels] B6 main path: {int(qpad.shape[0])} reads, Lq "
          f"{int(qpad.shape[1])} (mq {prep['mq']}), Wb {prep['width']}, margin"
          f" {prep['margin']}, S {prep['S']}, max_run {mr}, "
          f"{int(end_ok.sum())} permitted ranks, plan {plan}", flush=True)
    results["B6"] = _compare(
        "B6 main path",
        lambda: cf.drift_ef_best_rows(dg, qpad, nbs, li, jl, c, prep, end_ok,
                                      mr),
        lambda: cf.drift_ef_best_rows_plain(dg, qpad, nbs, li, jl, c, prep,
                                            end_ok, mr), card, reps=3)
    # + the end test at permitted ranks: two compares, the un-tilt, a min
    results["B6"].update(fill_bound(
        dg, int(qpad.shape[0]), prep["width"], int(qpad.shape[1]) + 3,
        prep["width"], tilted=True,
        per_rank=RECURRENCE_OPS + 5 * int(end_ok.sum()) / dg.n_nodes,
        table_cols=4 + P))

    _, (dg, q, ln, c, prep, fs, end_ok, jlo), kw = captured["B5"]
    mr = kw.get("max_run", 0)
    plan = cf.variant_plan(cf.VARIANT_EF, dg.window, prep["width"],
                           prep["margin"], int(q.shape[1]))
    print(f"[kernels] B5 main path: {int(q.shape[0])} reads, Lq "
          f"{int(q.shape[1])}, Wb {prep['width']}, margin {prep['margin']}, "
          f"free_start {fs}, max_run {mr}, plan {plan}", flush=True)
    results["B5"] = _compare(
        "B5 main path",
        lambda: cf.ef_best_rows(dg, q, c, prep, fs, end_ok, mr),
        lambda: cf.ef_best_rows_plain(dg, q, c, prep, fs, end_ok, mr), card,
        reps=3)
    P = int(dg.pred_slots.shape[1])
    results["B5"].update(fill_bound(
        dg, int(q.shape[0]), prep["width"], int(q.shape[1]),
        int(q.shape[1]), tilted=True,
        per_rank=RECURRENCE_OPS + int(end_ok.sum()) / dg.n_nodes,
        table_cols=2 + P))

    _, (dg, q, ln, c, fs, end_ok, jlo), kw = captured["B4"]
    mr = kw.get("max_run", 0)
    L = int(q.shape[1])
    print(f"[kernels] B4 main path (the fragments' tail): {int(q.shape[0])} "
          f"reads, L {L}, free_start {fs}, max_run {mr}, plan "
          f"{cf.bounded_plan(dg.window, L)}", flush=True)
    results["B4"] = _compare(
        "B4 main path",
        lambda: cf.bounded_best_rows(dg, q, c, fs, end_ok, mr),
        lambda: cf.bounded_best_rows_plain(dg, q, c, fs, end_ok, mr), card,
        reps=3)
    results["B4"].update(fill_bound(
        dg, int(q.shape[0]), L, L, L, tilted=False,
        per_rank=RECURRENCE_OPS + int(end_ok.sum()) / dg.n_nodes,
        table_cols=1))
    _phase_done("7d B3-B6 at the main paths' shapes")
    return results, launches


def _align_routes(mapper, reads, token):
    """``align_batch`` on prescored reads, first on the default route (every
    read must be traced on the device), then with ``POASTA_DEVICE_TRACE=0``
    (every read through the native host backtrace); the two must give the
    same scores and alignments.  Returns the wall seconds of each."""
    import torch

    secs, outs = {}, {}
    for route in ("device", "host"):
        if route == "host":
            os.environ["POASTA_DEVICE_TRACE"] = "0"
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = mapper.align_batch(reads, prescored=token)
            torch.cuda.synchronize()
            secs[route] = time.perf_counter() - t0
        finally:
            os.environ.pop("POASTA_DEVICE_TRACE", None)
        outs[route] = [(s, list(a)) for s, a in out]
        key = "device_traced" if route == "device" else "host_backtraced"
        if mapper.last_banded_stats[key] != len(reads):
            raise AssertionError(f"{route} route: {mapper.last_banded_stats}")
    if outs["device"] != outs["host"]:
        raise AssertionError("device-traced alignments differ from the native "
                             "host backtrace's")
    return secs


if __name__ == "__main__":
    sys.exit(main())
