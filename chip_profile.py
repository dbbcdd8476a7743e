"""Where the time of the main paths goes on the card.

    python3 chip_profile.py

Builds the bench's uniform configuration (as ``chip_smoke.py`` does),
converges the scorer's ub hint with two unprofiled batches, then profiles
two ``BatchMapper.score_batch`` batches of 1024 reads with
``torch.profiler``.  For each it prints the host wall time, the device time
of the top operations by name, the device's busy and idle shares of the
wall, and the same batch's unprofiled wall.  It does the same for one
batch each of ``chip_smoke.py``'s ends-free and drifting-window traffic:
the mixed-length SV reads under the global span and under the bench's
bounded ends-free span, and the semi-global fragments on the uniform
graph.  Then it profiles the port's ``lasagna align`` CLI on the uniform
graph and reads (``-j 64``) the same way, and splits its host wall by
stage (GFA load, mapper set-up, scoring on the worker thread, alignment,
GAF text).  Last, ``chip_smoke.py``'s pangenome configuration under the
CLI's semi-global span: one seeded ``align_batch`` of 64 reads (after one
batch through the full fill and one seeded warm-up), then the CLI with
``-m semi-global`` on 256 reads, each with the host time of the seeding
stages (k-mer hits, cluster proposals, the corridor fill, the
certificate), the anchored trace and ``align_anchored``.  Then two-piece
costs (``chip_smoke.py``'s phase 9, ``GapAffine2Piece(4, 2, 8, 1, 24)``):
one uniform and one mixed-length ``score_batch`` batch, phase 10a's
mixed-length batch under the bench's bounded span and 10b's pangenome
``align_batch`` of 64 reads under the semi-global span, and the port's
``poasta align --engine banded --device-assist on`` on phase 9e's 16
sequences of 10 kb, with the host time of the native fill, the fusion and
the background scoring.  Needs one card; imports no JAX.
"""

import os
import sys
import tempfile
import time
from contextlib import ExitStack
from unittest import mock

REPO = os.path.dirname(os.path.abspath(__file__))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: torch.cuda.is_available() is "
                           "False")
    sys.path.insert(0, REPO)
    from chip_smoke import (
        N_READS,
        fragment_reads,
        sv_workload,
        uniform_workload,
    )
    from poasta_tpu_torch import (
        UNBOUNDED,
        BatchMapper,
        EndsFree,
        GapAffine,
        included,
    )
    from poasta_tpu_torch.utils.device import card_info, cuda_device

    card = card_info()
    dev = cuda_device()
    costs = GapAffine(4, 2, 6)
    graph, seqs, reads = uniform_workload(costs)
    profile_batches("uniform", BatchMapper(graph, costs, device=dev), reads,
                    2, card)
    gsv, sv_reads = sv_workload(costs)
    profile_batches("mixed_len", BatchMapper(gsv, costs, device=dev),
                    sv_reads, 1, card)
    bench_span = EndsFree(UNBOUNDED, included(50), included(0), included(50))
    profile_batches("mixed_len bounded span",
                    BatchMapper(gsv, costs, device=dev, aln_type=bench_span),
                    sv_reads, 1, card)
    semi = EndsFree(UNBOUNDED, included(0), UNBOUNDED, UNBOUNDED)
    profile_batches("fragments semi-global",
                    BatchMapper(graph, costs, device=dev, aln_type=semi),
                    fragment_reads(seqs, N_READS, 2000, 4000), 1, card)
    profile_lasagna(graph, reads, card)
    profile_pangenome(dev, costs, semi, card)
    profile_two_piece(dev, graph, reads, gsv, sv_reads, card)
    return 0


def profile_batches(what, mapper, reads, reps, card):
    """Two unprofiled ``score_batch`` calls (they converge the ub hint),
    then ``reps`` profiled ones, each followed by an unprofiled one."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    mapper.score_batch(reads)
    mapper.score_batch(reads)
    for rep in range(reps):
        mapper.scorer.reset_stats()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            mapper.score_batch(reads)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        _report(f"{what} batch {rep}", prof, wall,
                f"stats {mapper.scorer.stats}", card)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mapper.score_batch(reads)
        torch.cuda.synchronize()
        print(f"[profile]   unprofiled wall "
              f"{(time.perf_counter() - t0) * 1e3:.3f} ms", flush=True)


def _report(what, prof, wall, extra, card):
    """Device busy/idle share of ``wall`` and the top device activities.
    Device-side activities only (kernels, copies): a host op's "self
    device time" repeats the time of the work it launched."""
    from torch.autograd import DeviceType

    per_name, spans = {}, []
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA or "Activity Buffer" in ev.name:
            continue
        start, end = ev.time_range.start, ev.time_range.end
        spans.append((start, end))
        tot, cnt = per_name.get(ev.name, (0.0, 0))
        per_name[ev.name] = (tot + end - start, cnt + 1)
    if not spans:
        raise RuntimeError("the profiler recorded no device activity")
    busy_us, reach = 0.0, float("-inf")
    for start, end in sorted(spans):  # union of the device intervals
        if end > reach:
            busy_us += end - max(start, reach)
            reach = end
    busy = busy_us / 1e6
    print(f"[profile] {what}: wall {wall * 1e3:.3f} ms, device busy "
          f"{busy * 1e3:.3f} ms ({100 * busy / wall:.2f}%), idle "
          f"{100 * (1 - busy / wall):.2f}%, {extra}  [{card}]", flush=True)
    for name, (tot, cnt) in sorted(per_name.items(),
                                   key=lambda kv: -kv[1][0])[:8]:
        print(f"[profile]   {tot / 1e3:10.3f} ms  x{cnt}  {name[:90]}",
              flush=True)


def _timed(stages, owner, name, label):
    """Patch ``owner.name`` to add each call's host wall to
    ``stages[label]`` as (seconds, calls)."""
    real = getattr(owner, name)

    def wrapper(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return real(*args, **kwargs)
        finally:
            tot, cnt = stages.get(label, (0.0, 0))
            stages[label] = (tot + time.perf_counter() - t0, cnt + 1)
    return mock.patch.object(owner, name, wrapper)


def _print_stages(plan, stages):
    for _, _, label in plan:
        tot, cnt = stages.get(label, (0.0, 0))
        print(f"[profile]   host {tot * 1e3:10.3f} ms  x{cnt}  {label}",
              flush=True)


def _cli_plan():
    import poasta_tpu_torch.io as io_mod
    from poasta_tpu_torch.parallel import mapper as mapper_mod

    M = mapper_mod.BatchMapper
    return [(io_mod, "load_graph_from_gfa", "GFA load"),
            (M, "__init__", "mapper set-up"),
            (M, "prescore", "scoring (worker thread)"),
            (M, "align_batch", "align_batch (main thread)"),
            (mapper_mod, "trace_align", "  of it: trace_align"),
            (io_mod, "alignment_to_gaf", "GAF records")]


def _seed_plan():
    """The stages of the seeded ends-free path, by the names the mapper
    calls them under."""
    from poasta_tpu_torch.native import NativeAligner
    from poasta_tpu_torch.parallel import mapper as mapper_mod

    return [(mapper_mod.KmerIndex, "__init__", "  k-mer index (once)"),
            (mapper_mod.KmerIndex, "seed_hits", "  seed_hits"),
            (mapper_mod, "propose_clusters", "  propose_clusters"),
            (mapper_mod, "seed_scores", "  seed_scores (schedule + B8)"),
            (mapper_mod, "certify_reads", "  certify_reads"),
            (mapper_mod, "dp_fill_ends_free_with_ends", "  full fill (B7)"),
            (NativeAligner, "align_anchored", "  align_anchored")]


def profile_lasagna(graph, reads, card, what="uniform", extra_argv=(),
                    extra_plan=()):
    """One profiled run of ``lasagna align`` (``-j 64``), with the host
    wall of each stage summed over its calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import write_inputs
    from poasta_tpu_torch.cli.lasagna import main as lasagna_main

    tmp = tempfile.mkdtemp(prefix="poasta_profile_")
    gfa, fa = write_inputs(graph, reads, tmp)
    stages = {}
    plan = _cli_plan() + list(extra_plan)
    argv = ["align", gfa, fa, "-o", os.path.join(tmp, "out.gaf"), "-j", "64",
            *extra_argv]
    lasagna_main(argv)  # warm-up: the first run pays the CUDA context
    with ExitStack() as stack:
        for owner, name, label in plan:
            stack.enter_context(_timed(stages, owner, name, label))
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            if lasagna_main(argv) != 0:
                raise RuntimeError("lasagna align failed")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    _report(f"lasagna align {what}, {len(reads)} reads, -j 64 "
            f"{' '.join(extra_argv)}", prof, wall,
            f"{len(reads) / wall:.2f} reads/s", card)
    _print_stages(plan, stages)


def profile_pangenome(dev, costs, semi, card):
    """The pangenome configuration under the semi-global span: one seeded
    ``align_batch`` of 64 reads, then the CLI on all 256."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import PAN_BATCH, pangenome_workload
    from poasta_tpu_torch import BatchMapper
    from poasta_tpu_torch.parallel import mapper as mapper_mod

    graph, reads = pangenome_workload()
    mapper = BatchMapper(graph, costs, device=dev, aln_type=semi)
    batch = reads[:PAN_BATCH]
    mapper.align_batch(batch)  # the full fill teaches the seed rates
    mapper.align_batch(batch)  # seeded warm-up
    stages = {}
    plan = _seed_plan() + [(mapper_mod, "trace_align", "  trace_align")]
    with ExitStack() as stack:
        for owner, name, label in plan:
            stack.enter_context(_timed(stages, owner, name, label))
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            mapper.align_batch(batch)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    _report(f"pangenome seeded align_batch, {PAN_BATCH} reads", prof, wall,
            f"{PAN_BATCH / wall:.2f} reads/s, seed stats "
            f"{mapper.last_seed_stats}, anchored path "
            f"{mapper.last_ends_free_stats}", card)
    _print_stages(plan, stages)
    profile_lasagna(graph, reads, card, what="pangenome",
                    extra_argv=("-m", "semi-global"),
                    extra_plan=_seed_plan())


def profile_two_piece(dev, graph, reads, gsv, sv_reads, card):
    """Two-piece costs: one uniform and one mixed-length ``score_batch``;
    under ends-free spans (``chip_smoke.py`` 10a, 10b) one mixed-length
    ``score_batch`` under the bench's bounded span and one ``align_batch``
    of 64 pangenome reads under the semi-global span (after a warm-up);
    then the MSA CLI with the device assist, its host wall by stage."""
    import contextlib
    import io

    import torch
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import COSTS_2P, PAN_BATCH, msa_fasta, pangenome_workload
    from poasta_tpu_torch import UNBOUNDED, BatchMapper, EndsFree, included
    from poasta_tpu_torch.aligner import GapAffine2Piece
    from poasta_tpu_torch.aligner import fusion_assist as fa
    from poasta_tpu_torch.cli.poasta import main as poasta_main
    from poasta_tpu_torch.graphs import POAGraph
    from poasta_tpu_torch.native import NativeAligner

    costs = GapAffine2Piece(*COSTS_2P)
    profile_batches("uniform two-piece",
                    BatchMapper(graph, costs, device=dev), reads, 1, card)
    profile_batches("mixed_len two-piece",
                    BatchMapper(gsv, costs, device=dev), sv_reads, 1, card)
    bench_span = EndsFree(UNBOUNDED, included(50), included(0), included(50))
    profile_batches("mixed_len bounded span two-piece (10a)",
                    BatchMapper(gsv, costs, device=dev, aln_type=bench_span),
                    sv_reads, 1, card)
    pan_graph, pan_reads = pangenome_workload()
    semi = EndsFree(UNBOUNDED, included(0), UNBOUNDED, UNBOUNDED)
    mapper = BatchMapper(pan_graph, costs, device=dev, aln_type=semi)
    batch = pan_reads[:PAN_BATCH]
    mapper.align_batch(batch)  # warm-up: learns the ub hint
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        mapper.align_batch(batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    _report(f"pangenome two-piece align_batch (10b), {PAN_BATCH} reads",
            prof, wall, f"{PAN_BATCH / wall:.2f} reads/s, anchored path "
            f"{mapper.last_ends_free_stats}", card)
    del mapper
    tmp = tempfile.mkdtemp(prefix="poasta_profile_msa_")
    fasta = msa_fasta(tmp)
    argv = ["align", "--engine", "banded", "--device-assist", "on", "-n",
            "4", "-g", "8,24", "-e", "2,1", "-O", "fasta", "-o",
            os.path.join(tmp, "msa.fa"), fasta]
    plan = [(NativeAligner, "align_banded", "native align_banded (main)"),
            (POAGraph, "add_alignment_with_weights", "fusion (main)"),
            (fa.DeviceSeedPrefetcher, "prefetch", "prefetch: flatten (main)"),
            (fa.DeviceSeedPrefetcher, "_score",
             "device scoring (worker thread)")]
    stats = []
    real_close = fa.DeviceSeedPrefetcher.close

    def rec_close(self):
        real_close(self)
        stats.append(dict(self.stats))

    stages = {}
    with ExitStack() as stack:
        for owner, name, label in plan:
            stack.enter_context(_timed(stages, owner, name, label))
        stack.enter_context(mock.patch.object(fa.DeviceSeedPrefetcher,
                                              "close", rec_close))
        stack.enter_context(contextlib.redirect_stderr(io.StringIO()))
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            if poasta_main(argv) != 0:
                raise RuntimeError("poasta align failed")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    _report("poasta align --engine banded --device-assist on, 16 x 10 kb, "
            "two-piece", prof, wall, f"prefetches {stats[-1]}", card)
    _print_stages(plan, stages)


if __name__ == "__main__":
    sys.exit(main())
