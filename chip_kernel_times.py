"""Times of the fill kernels alone, at the shapes the main paths give them.

    python3 chip_kernel_times.py

For comparing two trees of the port on one card within one call: unpack the
other tree beside this one, run the script from each root in turn (parent,
change, change, parent) and compare the lines.  It uses only the wrappers
of ``poasta_tpu_torch.ops.cuda_fill``, which keep their names whatever
kernel source stands behind them.

On the bench's uniform configuration (as ``chip_smoke.py`` builds it) it
records the inputs that ``BatchMapper.score_batch`` gives the banded fill
on 1024 uniform reads at the learned ub (B1) and, under the semi-global
span, on 1024 fragments of 2,000-4,000 bases (B5), then times, with CUDA
events, median of 5 after a warm-up:

* B1 ``banded_end_rows`` at those inputs (1024 reads, Wb 3328);
* B3 ``drift_end_rows`` and B6 ``drift_ef_best_rows`` at the inputs
  ``score_batch`` gives them on the bench's mixed-length SV traffic (1024
  reads, Wb 2304), the latter under the bench's bounded span;
* B16 ``banded_end_rows_2p`` under ``GapAffine2Piece(4, 2, 8, 1, 24)`` at
  the two tiers the main paths give it: the uniform reads' full-width tier
  (1024 reads, Wb 5120, uncapped) and the mixed traffic's first tier
  through ``BandedScorer.scores(max_retries=1)`` (1024 reads, Wb 4224, cap
  2048: ``chip_smoke.py`` 9b's);
* B17 ``drift_end_rows_2p`` at the mixed-length traffic's two-piece tier
  (1024 reads, Wb 4480);
* B2 ``fill_end_rows`` on 134 mixed-divergence reads at L 5120;
* B4 ``bounded_best_rows`` on 256 fragments at L 4096, uncapped;
* B2f ``free_fill_rows`` and B12f ``free_fill_rows_2p`` with both free
  flags on ``chip_smoke.py`` 10c's inputs (64 pieces of 1,000 bases cut
  from the uniform reads, L 1024);
* B12 ``fill_end_rows_2p`` at the inputs the mixed traffic's two-piece
  tail gives it through ``BandedScorer.scores(max_retries=1)``
  (``chip_smoke.py`` 9b's: the reads its B16 tier did not verify, L 5120);
* B13 ``bounded_best_rows_2p`` at the widest inputs ``score_batch`` gives it
  on the mixed-length SV traffic under the bench's bounded span
  (``chip_smoke.py`` 10a's: 1024 reads, L 5120, 5,002 ranks, cap 2048);
* B5 ``ef_best_rows`` at the recorded inputs (1024 fragments, Wb 4096);
* B7 ``bounded_end_rows`` on the bench's pangenome configuration under the
  semi-global span: 64 reads of ~5 kb, 50,002 ranks, cap 4096, as the
  first batch of ``lasagna align -m semi-global`` gives it;
* B9's size, ``bounded_best_rows`` (B4) on the same inputs, uncapped, as
  ``chip_smoke.py`` phase 11b runs it;
* B14 ``bounded_end_rows_2p`` on the same 64 reads under the two-piece
  costs, cap 2048, as ``chip_smoke.py`` 10b's ``align_batch`` gives it;
* B18 ``trace_fill`` at the inputs ``BatchMapper.align_batch`` gives it on
  64 uniform reads (a batch of ``lasagna align -j 64``: Wb 1024, 6,086
  ranks), and with ``free_start`` on the pangenome configuration's second
  semi-global batch of 64 (traced from its end states: Wb 256, 50,002
  ranks, each read over its rank range where the tree's trace driver
  gives one; the checksum over the rows it walks), whose seeded corridor
  fill gives B8 ``seed_end_states`` its inputs (64 reads, Wb 2560), each
  at the widest call of its batch;
* B11's size, ``banded_end_rows`` (B1) on phase 11a's 40,002-rank graph
  and 64 reads of ~40 kb: at the inputs ``score_batch`` gives it (its
  second call), and at ``scripts/bigbanded_40k.py``'s fixed windows of ub
  3200;
* B16 on one of those reads at the first of those windows (Wb 10,752,
  two-piece): one read a launch, as the MSA assist launches it, at a width
  past the register body's, so the rows body runs;
* the rows body of B1 and B17, on the same graph: B1 on the 64 reads at
  the windows of ub 11,000 (Wb 11,264, past the register body's 10,752),
  and B17 under the two-piece costs on the reads cut by up to 3 kb at the
  end, at drifting windows of ub 3,000 (Wb 6,528, past 6,144).

* the decode ``trace_decode`` at the inputs the same two batches give it
  (64 uniform reads at Wb 1,024; the pangenome's second batch, 64 reads at
  Wb 256 over 50,002 ranks, P 2), with each read's step count, the longest
  read's, and its insertion steps;
* a latency probe: one thread chasing a random cyclic permutation through
  a 1 MB array (L2) and a 1 GiB array (device memory), loads that skip L1,
  and a 16 KB array through L1, in ns a hop; and one thread walking each
  decode shape's planes as the decode does, down one rank's plane a hop
  (B x Wb x 4 bytes) through all of them, then on to the next 128-byte
  line.  The decode's chain floor is its longest read's steps times the
  device-memory hop: the random hop (most hops miss the TLB) gives an
  upper estimate, the plane-stride hop (a 2 MB page serves several ranks)
  the decode's own.

Each line carries a checksum of the kernel's output, so two trees can be
seen to compute the same rows, the rows of both templates their launch
plan, and the card's name and power limit.  The build's register counts
are printed first.  Needs one card; imports no JAX.  Only names that the
unpacked parent's ``chip_smoke.py`` also has are imported from it.

    python3 chip_kernel_times.py decode

times the decode and runs the probe alone (parent against change: copy
this script into the unpacked parent and run it from each root in turn).
"""

import os
import random
import statistics
import sys
from unittest import mock

REPO = os.path.dirname(os.path.abspath(__file__))
# Bands past the register body's reach on phase 11a's graph: B1's windows
# at this ub are 11,264 lanes (past 10,752); B17's, two-piece on those
# reads cut by up to 3 kb at the end, 6,528 (past 6,144).
ROWS_B1_UB, ROWS_B17_UB = 11000, 3000

# The latency probe: one thread follows next[i] `hops` times from where the
# last launch stopped (so no launch walks addresses an earlier one brought
# into a cache), each load skipping L1 (ld.global.cg: an L2 or
# device-memory round trip) or, with `nc`, through it as the decode's
# loads go (ld.global.nc); built with nvcc into build/ beside the port's
# kernels.
CHASE_SRC = r"""
extern "C" __global__ void chase(const int* __restrict__ next,
                                 long long hops, int nc, int* at) {
    int i = *at;
    if (nc)
        for (long long h = 0; h < hops; ++h) i = __ldg(next + i);
    else
        for (long long h = 0; h < hops; ++h) i = __ldcg(next + i);
    *at = i;
}
extern "C" int chase_launch(const int* next, long long hops, int nc,
                            int* at, void* stream) {
    chase<<<1, 1, 0, (cudaStream_t)stream>>>(next, hops, nc, at);
    return (int)cudaGetLastError();
}
"""


def chase_ns(nbytes, hops, card, nc=False, stride=0):
    """ns a hop of one thread chasing a random cyclic permutation through an
    int32 array of ``nbytes`` (``nc``: through L1), or with ``stride`` (a
    multiple of 128 bytes) down the array a stride a hop, from its last
    stride to the next 128-byte line of the first: median of 3 after a
    warm-up, each launch going on where the one before stopped."""
    import ctypes
    import hashlib
    import subprocess

    import torch

    from poasta_tpu_torch.utils import build

    out = os.path.join(REPO, "build", "chase-" + hashlib.sha256(
        CHASE_SRC.encode()).hexdigest()[:12])
    lib_path = os.path.join(out, "libchase.so")
    if not os.path.exists(lib_path):
        os.makedirs(out, exist_ok=True)
        src = os.path.join(out, "chase.cu")
        with open(src, "w") as fh:
            fh.write(CHASE_SRC)
        subprocess.run([build.nvcc_path(), "-gencode",
                        "arch=compute_90a,code=sm_90a", "-O3", "-shared",
                        "-Xcompiler", "-fPIC", "-o", lib_path, src],
                       check=True, timeout=300)
    lib = ctypes.CDLL(lib_path)
    lib.chase_launch.argtypes = [ctypes.c_void_p, ctypes.c_longlong,
                                 ctypes.c_int, ctypes.c_void_p,
                                 ctypes.c_void_p]
    n = nbytes // 4
    if stride:
        S = stride // 4
        n -= n % S
        idx = torch.arange(n, dtype=torch.int32, device="cuda")
        nxt = torch.where(idx >= S, idx - S, n - S + (idx + 32) % S)
        del idx
    else:
        gen = torch.Generator(device="cuda")
        gen.manual_seed(nbytes)
        perm = torch.randperm(n, generator=gen, device="cuda")
        nxt = torch.empty(n, dtype=torch.int32, device="cuda")
        nxt[perm] = torch.roll(perm, -1).to(torch.int32)  # one cycle
        del perm
    at = torch.zeros(1, dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        if lib.chase_launch(nxt.data_ptr(), hops, int(nc), at.data_ptr(),
                            stream):
            raise RuntimeError("chase launch failed")

    from chip_smoke import _time_ms

    run()
    ms = statistics.median(_time_ms(run, 1) for _ in range(3))
    ns = ms * 1e6 / hops
    walk = f"a stride of {stride} B down it" if stride else "random"
    print(f"[probe] {4 * n} B array, {hops} dependent loads ({walk}) "
          f"{'through L1 (nc)' if nc else 'skipping L1 (cg)'}: {ns:.1f} ns "
          f"a hop ({ms:.3f} ms)  [{card}]", flush=True)
    return ns


def decode_times(dev, card):
    """The decode at the inputs a batch of 64 uniform reads and the
    pangenome's second semi-global batch give it, beside the latency
    probe's chain floor."""
    import torch

    from chip_smoke import (
        PAN_BATCH,
        _time_ms,
        pangenome_workload,
        uniform_workload,
    )
    from poasta_tpu_torch import (
        UNBOUNDED,
        BatchMapper,
        EndsFree,
        GapAffine,
        included,
    )
    from poasta_tpu_torch.ops import trace as trace_mod

    costs = GapAffine(4, 2, 6)
    semi = EndsFree(UNBOUNDED, included(0), UNBOUNDED, UNBOUNDED)
    captured = {}
    launch = trace_mod._launch_decode

    def keep(name):
        # the widest call of the batch (the last such)
        def rec(ptr, *walk, **kw):
            if int(ptr.shape[1]) >= int(captured.get(name, (ptr,))[0]
                                        .shape[1]):
                captured[name] = (ptr, walk)
            return launch(ptr, *walk, **kw)
        return rec

    graph, _, reads = uniform_workload(costs)
    with mock.patch.object(trace_mod, "_launch_decode", keep("global")):
        m = BatchMapper(graph, costs, device=dev)
        m.DENSE_TABLE_BUDGET = 0  # the banded route, as the CLI's batches
        m.align_batch(reads[:PAN_BATCH])
    pan_graph, pan_reads = pangenome_workload()
    m = BatchMapper(pan_graph, costs, device=dev, aln_type=semi)
    m.align_batch(pan_reads[:PAN_BATCH])  # the first batch learns the rates
    with mock.patch.object(trace_mod, "_launch_decode", keep("anchored")):
        m.align_batch(pan_reads[PAN_BATCH:2 * PAN_BATCH])
    del m

    dram_ns = chase_ns(1 << 30, 100_000, card)
    chase_ns(1 << 20, 200_000, card)
    chase_ns(1 << 14, 200_000, card, nc=True)
    for name in ("global", "anchored"):
        ptr, walk = captured.pop(name)
        Np, B, Wb = (int(n) for n in ptr.shape)
        P = int(walk[0].shape[0]) // Np
        plane_ns = chase_ns(ptr.numel() * 4, 20_000, card, nc=True,
                            stride=B * Wb * 4)
        ops = trace_mod.trace_decode(ptr, *walk)[0]
        per_read = (ops != 0).sum(dim=1)
        longest = int(per_read.max())
        ins = int(((ops & 15) == trace_mod.OP_INS).sum())
        floor_ms = longest * plane_ns * 1e-6
        print(f"[times] decode {name}: {B} reads, Wb {Wb}, {Np} ranks, P {P}, "
              f"t_max {walk[-1]}, {int(walk[-2].sum())} active; steps "
              f"{int(per_read.sum())}, the longest read's {longest}, "
              f"insertion steps {ins}; chain floor {longest} x "
              f"{plane_ns:.1f} ns (plane stride) = {floor_ms:.3f} ms, "
              f"{longest} x {dram_ns:.1f} ns (random) = "
              f"{longest * dram_ns * 1e-6:.3f} ms  [{card}]", flush=True)
        if hasattr(trace_mod, "decode_plan"):
            print(f"[times] decode {name} plan "
                  f"{trace_mod.decode_plan(B, P)}", flush=True)

        def fn():
            return launch(ptr, *walk)[0]
        out = fn()
        torch.cuda.synchronize()
        if not torch.equal(out, ops):
            raise AssertionError(f"decode {name}: step words differ from "
                                 "trace_decode's")
        ts = [_time_ms(fn, 1) for _ in range(5)]
        med = statistics.median(ts)
        print(f"[times] decode {name}: median {med:.3f} ms of "
              f"{[round(t, 3) for t in ts]}, {med * 1e6 / longest:.1f} ns a "
              f"step of the longest read, {med / floor_ms:.2f}x the "
              f"plane-stride chain floor, "
              f"{med / (longest * dram_ns * 1e-6):.2f}x the random one, "
              f"checksum {int(out.long().sum())}  [{card}]", flush=True)
        del ptr, walk, ops


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: torch.cuda.is_available() is "
                           "False")
    sys.path.insert(0, REPO)
    from chip_smoke import (
        COSTS_2P,
        BB_DIV,
        BB_EDGE_EVERY,
        BB_LEN,
        BB_READS,
        BB_SEED,
        BB_UB,
        FREE_READ_LEN,
        FREE_SEED,
        N_READS,
        PAN_BATCH,
        _mutate,
        _time_ms,
        backbone_graph,
        fragment_reads,
        mixed_reads,
        pangenome_workload,
        sv_workload,
        uniform_workload,
    )
    from poasta_tpu_torch import (
        UNBOUNDED,
        BatchMapper,
        DeviceGraph,
        EndsFree,
        GapAffine,
        included,
        pack_queries,
    )
    from poasta_tpu_torch.aligner import GapAffine2Piece
    from poasta_tpu_torch.aligner import banded as banded_mod
    from poasta_tpu_torch.aligner.wavefront import ends_free_device_params
    from poasta_tpu_torch.ops import cuda_fill as cf
    from poasta_tpu_torch.utils import build
    from poasta_tpu_torch.utils.device import card_info, cuda_device

    dev = cuda_device()
    card = card_info()
    built = build.build()
    entry = ""
    for line in built["log"].splitlines():
        if "Compiling entry" in line:
            entry = line.split("'")[1]
        elif "Used" in line:
            print(f"[build] {entry}: {line.split(':', 1)[1].strip()}",
                  flush=True)

    if argv[1:] == ["decode"]:
        decode_times(dev, card)
        return 0
    costs = GapAffine(4, 2, 6)
    graph, seqs, reads = uniform_workload(costs)
    captured = {}

    def keep(name, fn):
        def rec(*args, **kwargs):
            captured[name] = (args, kwargs)
            return fn(*args, **kwargs)
        return rec

    widest = {}

    def keep_widest(name, fn):
        # the widest batch a launcher was given (the last such call)
        def rec(*args, **kwargs):
            B = int(args[1].shape[0])
            if B >= widest.get(name, 0):
                widest[name] = B
                captured[name] = (args, kwargs)
            return fn(*args, **kwargs)
        return rec

    semi = EndsFree(UNBOUNDED, included(0), UNBOUNDED, UNBOUNDED)
    frags = fragment_reads(seqs, N_READS, 2000, 4000)
    with mock.patch.object(banded_mod, "banded_scores",
                           keep("B1", cf.banded_scores)), \
            mock.patch.object(banded_mod, "ef_scores",
                              keep("B5", cf.ef_scores)):
        mapper = BatchMapper(graph, costs, device=dev)
        mapper.score_batch(reads)  # converges the ub hint
        mapper.score_batch(reads)
        BatchMapper(graph, costs, device=dev,
                    aln_type=semi).score_batch(frags)

    def report(name, what, fn, view=None):
        # the checksum is over ``view(out)`` where given: the rows that
        # are compared
        out = fn()
        torch.cuda.synchronize()
        if view is not None:
            out = view(out)
        ts = [_time_ms(fn, 1) for _ in range(5)]
        print(f"[times] {name} {what}: median {statistics.median(ts):.3f} ms "
              f"of {[round(t, 3) for t in ts]}, checksum "
              f"{int(out.long().sum())}  [{card}]", flush=True)

    def in_range(ptr, r_begin, r_end):
        # B18's planes with each read's rows outside its rank range zeroed
        r = torch.arange(ptr.shape[0], device=ptr.device).view(-1, 1)
        walked = (r >= r_begin.view(1, -1)) & (r <= r_end.view(1, -1))
        return torch.where(walked.unsqueeze(-1), ptr, 0)

    def plan(variant, dg, prep, q):
        return cf.variant_plan(variant, dg.window, prep["width"],
                               prep["margin"], int(q.shape[1]))

    (dg, q, _, c, prep), kw = captured["B1"]
    mr = kw.get("max_run", 0)
    report("B1", f"{int(q.shape[0])} reads, Wb {prep['width']}, max_run {mr},"
           f" plan {plan(cf.VARIANT_GLOBAL, dg, prep, q)}",
           lambda: cf.banded_end_rows(dg, q, c, prep, mr))
    qm, _ = pack_queries(mixed_reads(seqs[0])[:134], device=dev)
    report("B2", f"{int(qm.shape[0])} reads, L {int(qm.shape[1])}",
           lambda: cf.fill_end_rows(dg, qm, costs))
    (dg, q, _, c, prep, fs, end_ok, _), kw = captured["B5"]
    mr = kw.get("max_run", 0)
    q256 = q[:256].contiguous()
    report("B4", f"{int(q256.shape[0])} reads, L {int(q256.shape[1])}, "
           f"free_start {fs}, uncapped",
           lambda: cf.bounded_best_rows(dg, q256, c, fs, end_ok, 0))
    report("B5", f"{int(q.shape[0])} reads, Wb {prep['width']}, max_run {mr},"
           f" plan {plan(cf.VARIANT_EF, dg, prep, q)}",
           lambda: cf.ef_best_rows(dg, q, c, prep, fs, end_ok, mr))

    costs2p = GapAffine2Piece(*COSTS_2P)
    rng = random.Random(FREE_SEED)
    pieces = []
    for r in reads[:64]:
        a = rng.randrange(0, len(r) - FREE_READ_LEN)
        pieces.append(r[a:a + FREE_READ_LEN])
    u_dg = DeviceGraph.build(graph.flatten(), device=dev)
    qf, _ = pack_queries(pieces, device=dev)
    Lf = int(qf.shape[1])
    report("B2f", f"{int(qf.shape[0])} reads, L {Lf}, free_start and "
           f"free_end, plan {cf.bounded_plan(u_dg.window, Lf)}",
           lambda: cf.free_fill_rows(u_dg, qf, costs, True, True))
    plan2p = cf.bounded_plan(u_dg.window, Lf, two_piece=True)
    report("B12f", f"{int(qf.shape[0])} reads, L {Lf}, free_start and "
           f"free_end, plan {plan2p}",
           lambda: cf.free_fill_rows_2p(u_dg, qf, costs2p, True, True))

    # the drifting-window and two-piece rows of the banded template
    bench_span = EndsFree(UNBOUNDED, included(50), included(0), included(50))
    gsv, sv_reads = sv_workload(costs)
    mixed = mixed_reads(seqs[0])
    qm, lm = pack_queries(mixed, device=dev)
    with mock.patch.object(banded_mod, "drift_scores",
                           keep("B3", cf.drift_scores)), \
            mock.patch.object(banded_mod, "drift_ef_scores",
                              keep("B6", cf.drift_ef_scores)), \
            mock.patch.object(banded_mod, "drift_scores_2p",
                              keep("B17", cf.drift_scores_2p)):
        for c, span in ((costs, None), (costs, bench_span), (costs2p, None)):
            m = BatchMapper(gsv, c, device=dev, aln_type=span)
            m.score_batch(sv_reads)  # converges the ub hint
            m.score_batch(sv_reads)
    with mock.patch.object(cf, "_launch_bounded_2p",
                           keep_widest("B13", cf._launch_bounded_2p)):
        m = BatchMapper(gsv, costs2p, device=dev, aln_type=bench_span)
        m.score_batch(sv_reads)  # converges the ub hints
        m.score_batch(sv_reads)
    with mock.patch.object(banded_mod, "banded_scores_2p",
                           keep("B16 uniform", cf.banded_scores_2p)):
        m = BatchMapper(graph, costs2p, device=dev)
        m.score_batch(reads)
        m.score_batch(reads)
    with mock.patch.object(banded_mod, "banded_scores_2p",
                           keep("B16 mixed", cf.banded_scores_2p)), \
            mock.patch.object(cf, "_launch_fill_2p",
                              keep("B12", cf._launch_fill_2p)):
        BatchMapper(graph, costs2p, device=dev).scorer.scores(
            qm, lm, max_retries=1)

    (dg, qpad, ln, c, prep, n_min), kw = captured["B3"]
    mr = kw.get("max_run", 0)
    nbs = cf.drift_units(ln, n_min)
    report("B3", f"{int(qpad.shape[0])} reads, Wb {prep['width']}, margin "
           f"{prep['margin']}, S {prep['S']}, max_run {mr}, plan "
           f"{plan(cf.VARIANT_DRIFT, dg, prep, qpad)}",
           lambda: cf.drift_end_rows(dg, qpad, nbs, c, prep, mr))
    (dg, qpad, ln, c, prep, n_min, end_ok, jlo), kw = captured["B6"]
    mr = kw.get("max_run", 0)
    li, jl = ln.to(torch.int32).contiguous(), jlo.to(torch.int32).contiguous()
    nbs = cf.drift_units(li, n_min)
    report("B6", f"{int(qpad.shape[0])} reads, Wb {prep['width']}, margin "
           f"{prep['margin']}, max_run {mr}, plan "
           f"{plan(cf.VARIANT_DRIFT_EF, dg, prep, qpad)}",
           lambda: cf.drift_ef_best_rows(dg, qpad, nbs, li, jl, c, prep,
                                         end_ok, mr))
    for tier in ("B16 mixed", "B16 uniform"):
        (dg, q, _, c, prep), kw = captured[tier]
        mr = kw.get("max_run", 0)
        report(tier, f"{int(q.shape[0])} reads, Wb {prep['width']}, max_run "
               f"{mr}, plan {plan(cf.VARIANT_GLOBAL_2P, dg, prep, q)}",
               lambda: cf.banded_end_rows_2p(dg, q, c, prep, mr))
    (dg, qpad, ln, c, prep, n_min), kw = captured["B17"]
    mr = kw.get("max_run", 0)
    nbs = cf.drift_units(ln, n_min)
    report("B17", f"{int(qpad.shape[0])} reads, Wb {prep['width']}, margin "
           f"{prep['margin']}, S {prep['S']}, max_run {mr}, plan "
           f"{plan(cf.VARIANT_DRIFT_2P, dg, prep, qpad)}",
           lambda: cf.drift_end_rows_2p(dg, qpad, nbs, c, prep, mr))
    (dg, q, c), _ = captured["B12"]
    L = int(q.shape[1])
    report("B12", f"{int(q.shape[0])} reads (the mixed two-piece tail), L {L},"
           f" plan {cf.fill_plan(dg.window, L, two_piece=True)}",
           lambda: cf.fill_end_rows_2p(dg, q, c))
    (dg, q, c, fs, end_ok, mr), _ = captured["B13"]
    L = int(q.shape[1])
    report("B13", f"{int(q.shape[0])} reads, L {L}, {dg.n_nodes} ranks, "
           f"free_start {fs}, max_run {mr}, {int(end_ok.sum())} permitted "
           f"ranks, plan {cf.bounded_plan(dg.window, L, two_piece=True)}",
           lambda: cf.bounded_best_rows_2p(dg, q, c, fs, end_ok, mr))

    pan_graph, pan_reads = pangenome_workload()
    flat = pan_graph.flatten()
    dg = DeviceGraph.build(flat, device=dev)
    q, lengths = pack_queries(pan_reads[:PAN_BATCH], device=dev)
    fs, end_ok, _ = ends_free_device_params(flat, semi, lengths,
                                            dg.n_nodes_padded)
    report("B7", f"{int(q.shape[0])} reads, L {int(q.shape[1])}, "
           f"{dg.n_nodes} ranks, free_start {fs}, max_run 4096",
           lambda: cf.bounded_end_rows(dg, q, costs, fs, end_ok, 4096)[0])
    report("B9 (B4)", f"{int(q.shape[0])} reads, L {int(q.shape[1])}, "
           f"{dg.n_nodes} ranks, free_start {fs}, uncapped",
           lambda: cf.bounded_best_rows(dg, q, costs, fs, end_ok, 0))
    fs2, end_ok2, _ = ends_free_device_params(flat, semi, lengths,
                                              dg.n_nodes_padded, True)
    L = int(q.shape[1])
    report("B14", f"{int(q.shape[0])} reads, L {L}, {dg.n_nodes} ranks, "
           f"free_start {fs2}, max_run 2048, two-piece, plan "
           f"{cf.bounded_plan(dg.window, L, ends=True, two_piece=True)}",
           lambda: cf.bounded_end_rows_2p(dg, q, costs2p, fs2, end_ok2,
                                          2048)[0])

    # the trace fill (B18) and the seeded corridor fill (B8) at the inputs
    # the main paths give them: a batch of 64 uniform reads, and the
    # pangenome configuration's second semi-global batch (seeded, then
    # traced from its end states with free_start)
    from poasta_tpu_torch.ops import seed as seed_mod
    from poasta_tpu_torch.ops import trace as trace_mod

    launch_trace = trace_mod._launch_trace
    with mock.patch.object(trace_mod, "_launch_trace",
                           keep_widest("B18 global", launch_trace)):
        m = BatchMapper(graph, costs, device=dev)
        m.DENSE_TABLE_BUDGET = 0  # the banded route, as the CLI's batches
        m.align_batch(reads[:PAN_BATCH])
    m = BatchMapper(pan_graph, costs, device=dev, aln_type=semi)
    m.align_batch(pan_reads[:PAN_BATCH])  # the first batch learns the rates
    with mock.patch.object(trace_mod, "_launch_trace",
                           keep_widest("B18 free_start", launch_trace)), \
            mock.patch.object(seed_mod, "_launch_seed",
                              keep_widest("B8", seed_mod._launch_seed)):
        m.align_batch(pan_reads[PAN_BATCH:2 * PAN_BATCH])
    del m
    for name in ("B18 global", "B18 free_start"):
        args, _ = captured[name]
        t_dg, qpad, Wb, fs_t = args[0], args[1], args[6], args[7]
        # the reads' rank ranges, where the tree's trace driver gives them:
        # the checksum is over the rows they walk
        rb, re = args[8:10] if len(args) > 9 else (None, None)
        walked, view = "every rank", (lambda out: out[1])
        if rb is not None:
            share = int((re - rb + 1).sum()) / (int(qpad.shape[0])
                                                 * t_dg.n_nodes)
            walked = f"rank ranges, walked share {share:.4f}"
            view = (lambda out, rb=rb, re=re: in_range(out[1], rb, re))
        report(name, f"{int(qpad.shape[0])} reads, LQ {int(qpad.shape[1])}, "
               f"Wb {Wb}, {t_dg.n_nodes} ranks, free_start {fs_t}, {walked}, "
               f"plan {trace_mod.trace_plan(t_dg.window, Wb)}",
               lambda: trace_mod.trace_fill(*args), view)
    args, _ = captured["B8"]
    s_dg, qs, r_begin, r_end, Wb, mr = (args[0], args[1], args[5], args[6],
                                        args[10], args[11])
    span = r_end - r_begin
    report("B8", f"{int(qs.shape[0])} reads, L {int(qs.shape[1])}, Wb {Wb}, "
           f"max_run {mr}, ranges of {int(span.min())}-{int(span.max())} "
           f"ranks ({int(span.sum())} in all), plan "
           f"{seed_mod.seed_plan(s_dg.window, Wb)}",
           lambda: seed_mod.seed_end_states(*args))
    captured.clear()

    rng = random.Random(BB_SEED)
    graph, base = backbone_graph(rng, BB_LEN, BB_EDGE_EVERY)
    reads = [_mutate(rng, base, BB_DIV).encode() for _ in range(BB_READS)]
    with mock.patch.object(banded_mod, "banded_scores",
                           keep("B11", cf.banded_scores)):
        mapper = BatchMapper(graph, costs, device=dev)
        mapper.score_batch(reads)  # learns the ub
        mapper.score_batch(reads)
    (dg, q, _, c, prep), kw = captured.pop("B11")
    mr = kw.get("max_run", 0)
    report("B11 (B1)", f"{int(q.shape[0])} reads, L {int(q.shape[1])}, "
           f"{dg.n_nodes} ranks, Wb {prep['width']}, max_run {mr}",
           lambda: cf.banded_end_rows(dg, q, c, prep, mr))
    q1 = q[:1].contiguous()
    report("B16 one read, rows body", f"1 read, L {int(q.shape[1])}, "
           f"{dg.n_nodes} ranks, Wb {prep['width']}, max_run {mr}, plan "
           f"{plan(cf.VARIANT_GLOBAL_2P, dg, prep, q1)}",
           lambda: cf.banded_end_rows_2p(dg, q1, costs2p, prep, mr))
    del mapper
    flat = graph.flatten()
    dg = DeviceGraph.build(flat, device=dev)
    q, lengths = pack_queries(reads, device=dev)
    lens = lengths.cpu().numpy()
    ws, width, _, _ = banded_mod.band_windows(
        flat, int(lens.min()), int(lens.max()), costs, BB_UB)
    prep = cf.prepare_banded(dg, costs, (ws // 128) * 128, width + 128,
                             int(q.shape[1]))
    report("B11 (B1) fixed windows", f"{int(q.shape[0])} reads, L "
           f"{int(q.shape[1])}, {dg.n_nodes} ranks, Wb {prep['width']}, "
           "uncapped",
           lambda: cf.banded_end_rows(dg, q, costs, prep, 0))

    # the rows body of the one-piece and drifting two-piece variants: B1 at
    # a tier past its register body's 10,752 lanes, B17 past 6,144
    ws, width, _, _ = banded_mod.band_windows(
        flat, int(lens.min()), int(lens.max()), costs, ROWS_B1_UB)
    prep = cf.prepare_banded(dg, costs, (ws // 128) * 128, width + 128,
                             int(q.shape[1]))
    report("B1 rows body", f"{int(q.shape[0])} reads, L {int(q.shape[1])}, "
           f"{dg.n_nodes} ranks, Wb {prep['width']} (ub {ROWS_B1_UB}), "
           f"uncapped, plan {plan(cf.VARIANT_GLOBAL, dg, prep, q)}",
           lambda: cf.banded_end_rows(dg, q, costs, prep, 0))
    cut = random.Random(BB_SEED + 1)
    short = [r[:len(r) - cut.randrange(0, 3000)] for r in reads]
    q, lengths = pack_queries(short, device=dev)
    lens = lengths.cpu().numpy()
    n_min, n_max = int(lens.min()), int(lens.max())
    S = banded_mod.drift_steps_for(n_min, n_max)
    ws, width, s_ranks = banded_mod.band_windows_drift(
        flat, n_min, n_max, costs2p, ROWS_B17_UB, S)
    L = int(q.shape[1])
    Lp = max(L, -(-(int(ws.max()) + width) // 128) * 128)
    prep = cf.prepare_banded_drift(dg, costs2p, ws, width, s_ranks, S, Lp)
    qpad = torch.nn.functional.pad(q, (prep["mq"], Lp - L)).contiguous()
    nbs = cf.drift_units(lengths, n_min)
    report("B17 rows body", f"{int(qpad.shape[0])} reads of {n_min}-{n_max},"
           f" {dg.n_nodes} ranks, Wb {width} (ub {ROWS_B17_UB}), margin "
           f"{prep['margin']}, S {S}, uncapped, plan "
           f"{plan(cf.VARIANT_DRIFT_2P, dg, prep, qpad)}",
           lambda: cf.drift_end_rows_2p(dg, qpad, nbs, costs2p, prep, 0))
    del captured
    decode_times(dev, card)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
