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
GAF text).  Needs one card; imports no JAX.
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


def profile_lasagna(graph, reads, card):
    """One profiled run of ``lasagna align`` on the uniform config, with
    the host wall of each stage summed over its calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    import poasta_tpu_torch.io as io_mod
    from chip_smoke import write_inputs
    from poasta_tpu_torch.cli.lasagna import main as lasagna_main
    from poasta_tpu_torch.parallel import mapper as mapper_mod

    tmp = tempfile.mkdtemp(prefix="poasta_profile_")
    gfa, fa = write_inputs(graph, reads, tmp)
    stages = {}

    def timed(owner, name, label):
        real = getattr(owner, name)

        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return real(*args, **kwargs)
            finally:
                tot, cnt = stages.get(label, (0.0, 0))
                stages[label] = (tot + time.perf_counter() - t0, cnt + 1)
        return mock.patch.object(owner, name, wrapper)

    M = mapper_mod.BatchMapper
    plan = [(io_mod, "load_graph_from_gfa", "GFA load"),
            (M, "__init__", "mapper set-up"),
            (M, "prescore", "scoring (worker thread)"),
            (M, "align_batch", "align_batch (main thread)"),
            (mapper_mod, "trace_align", "  of it: trace_align"),
            (io_mod, "alignment_to_gaf", "GAF records")]
    argv = ["align", gfa, fa, "-o", os.path.join(tmp, "out.gaf"), "-j", "64"]
    lasagna_main(argv)  # warm-up: the first run pays the CUDA context
    with ExitStack() as stack:
        for owner, name, label in plan:
            stack.enter_context(timed(owner, name, label))
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            if lasagna_main(argv) != 0:
                raise RuntimeError("lasagna align failed")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    _report(f"lasagna align, {len(reads)} reads, -j 64", prof, wall,
            f"{len(reads) / wall:.2f} reads/s", card)
    for _, _, label in plan:
        tot, cnt = stages.get(label, (0.0, 0))
        print(f"[profile]   host {tot * 1e3:10.3f} ms  x{cnt}  {label}",
              flush=True)


if __name__ == "__main__":
    sys.exit(main())
