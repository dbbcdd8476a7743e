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
from unittest import mock

REPO = os.path.dirname(os.path.abspath(__file__))
GRAPH_LEN, N_SEQS, N_READS, SEED, DIV = 5000, 4, 1024, 7, 0.03
MIXED_SEED = 11
B1_REPLACES = "poasta_tpu/ops/pallas_fill.py:2007"
B2_REPLACES = "poasta_tpu/ops/pallas_fill.py:304"
B18_REPLACES = "poasta_tpu/ops/pallas_trace.py:121"
DECODE_REPLACES = "poasta_tpu/ops/pallas_trace.py:720"
HYBRID_READS = 32
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
    for i in range(1, n_seqs):
        seq = _mutate(rng, base, div, glen).encode()
        _, aln, _ = NativeAligner(graph).align(seq, costs)
        graph.add_alignment_with_weights(f"s{i}", seq, aln, [1] * len(seq))
    return graph, base


def uniform_workload(costs):
    """bench.py's ``build_uniform`` configuration (seed 7): the graph, its
    base sequence and 1024 reads at 3% divergence."""
    rng = random.Random(SEED)
    graph, base = _fused_graph(rng, costs, GRAPH_LEN, N_SEQS, DIV)
    reads = [_mutate(rng, base, DIV, GRAPH_LEN).encode()
             for _ in range(N_READS)]
    return graph, base, reads


def mixed_reads(base):
    """bench.py's mixed-divergence traffic drawn from ``base``: every 20th
    read at 15% divergence, the rest at 2%."""
    rng = random.Random(MIXED_SEED)
    return [_mutate(rng, base, 0.15 if i % 20 == 0 else 0.02).encode()
            for i in range(N_READS)]


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


def _compare(name, kernel_fn, plain_fn, card, reps=5, plain_reps=3):
    """Kernel against plain version on the same inputs: raw rows must be
    equal; returns the measured numbers.  The checking call of each side
    is its warm-up."""
    import torch

    got = kernel_fn()
    ref = plain_fn()
    torch.cuda.synchronize()
    gots = got if isinstance(got, tuple) else (got,)
    refs = ref if isinstance(ref, tuple) else (ref,)
    err = max((int((g.long() - r.long()).abs().max()) if g.numel() else 0)
              for g, r in zip(gots, refs))
    if not all(torch.equal(g, r) for g, r in zip(gots, refs)):
        raise AssertionError(f"{name}: kernel and plain outputs differ "
                             f"(max abs err {err})")
    ms = _time_ms(kernel_fn, reps)
    plain_ms = _time_ms(plain_fn, plain_reps)
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
    graph, base, reads = uniform_workload(costs)
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
    sg, sbase = _fused_graph(small_rng, costs, 260, 4, 0.04)
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
    mg, mbase = _fused_graph(mid_rng, costs, 1000, 4, 0.04)
    m_reads = [_mutate(mid_rng, mbase, DIV).encode() for _ in range(256)]
    m_dg = DeviceGraph.build(mg.flatten(), device=dev)
    mq, _ = pack_queries(m_reads, device=dev)
    print(f"[kernels] B2 mid: {m_dg.n_nodes} nodes x 256 reads, L "
          f"{int(mq.shape[1])}, plan "
          f"{cf.fill_plan(m_dg.window, int(mq.shape[1]))}", flush=True)
    _compare("B2 mid", lambda: cf.fill_end_rows(m_dg, mq, costs),
             lambda: cf.fill_end_rows_plain(m_dg, mq, costs), card)

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

    na = NativeAligner(graph)
    for i in range(4):
        exact = na.align(reads[i], costs)[0]
        if exact != int(scores[i]):
            raise AssertionError(f"read {i}: native {exact}, port "
                                 f"{int(scores[i])}")
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
    print("[main] uniform reads 0-3 equal NativeAligner.align, reads 0-63 "
          f"NativeAligner.align_banded; mixed 15% reads {tail} equal "
          "NativeAligner.align_banded", flush=True)

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
        reps=3, plain_reps=1)
    g_dg, q, c = captured[("mixed", "B2")]
    print(f"[kernels] B2 main path (mixed tail): {int(q.shape[0])} reads, L "
          f"{int(q.shape[1])}, plan "
          f"{cf.fill_plan(g_dg.window, int(q.shape[1]))}", flush=True)
    results["B2"] = _compare(
        "B2 main path", lambda: cf.fill_end_rows(g_dg, q, c),
        lambda: cf.fill_end_rows_plain(g_dg, q, c), card, reps=3,
        plain_reps=1)

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

    # ---- 6. alignment: device traceback -------------------------------
    trace_results, lasagna = align_phases(
        card, dev, costs, graph, reads, scores, sg, s_reads)

    def by_call(i):
        return {"score_batch uniform": counts["uniform"][i],
                "scores mixed max_retries=1": counts["mixed"][i],
                "lasagna align uniform": lasagna["launches"][i]}

    kernels = [
        {"name": "banded_fill_kernel", "route": "cuda",
         "source": "poasta_tpu_torch/csrc/banded_kernel.cu",
         "replaces": B1_REPLACES, "launches": b1_main,
         "launches_by_call": by_call(0), **results["B1"]},
        {"name": "full_fill_kernel", "route": "cuda",
         "source": "poasta_tpu_torch/csrc/fill_kernel.cu",
         "replaces": B2_REPLACES, "launches": b2_main,
         "launches_by_call": by_call(1), "forced_fallback_launches": b2_fb,
         **results["B2"]},
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
    from poasta_tpu.io.gfa import graph_to_gfa

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
        _compare(f"B18 small Wb {Wb}", fill_k, fill_p, card, reps=3,
                 plain_reps=1)
        _compare(f"decode small Wb {Wb}", dec_k, dec_p, card, reps=3,
                 plain_reps=1)

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
        "B18": _compare("B18 main path", fill_k, fill_p, card, reps=5,
                        plain_reps=1),
        "decode": _compare("decode main path", dec_k, dec_p, card, reps=5,
                           plain_reps=1),
    }

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
    return results, {"launches": launches, "reads_per_s": len(reads) / dev_s}


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
