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
* B2 ``fill_end_rows`` on 134 mixed-divergence reads at L 5120;
* B4 ``bounded_best_rows`` on 256 fragments at L 4096, uncapped;
* B5 ``ef_best_rows`` at the recorded inputs (1024 fragments, Wb 4096).

Each line carries a checksum of the kernel's output, so two trees can be
seen to compute the same rows, and the card's name and power limit.  The
build's register counts are printed first.  Needs one card; imports no JAX.
"""

import os
import statistics
import sys
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
        _time_ms,
        fragment_reads,
        mixed_reads,
        uniform_workload,
    )
    from poasta_tpu_torch import (
        UNBOUNDED,
        BatchMapper,
        EndsFree,
        GapAffine,
        included,
        pack_queries,
    )
    from poasta_tpu_torch.aligner import banded as banded_mod
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

    costs = GapAffine(4, 2, 6)
    graph, seqs, reads = uniform_workload(costs)
    captured = {}

    def keep(name, fn):
        def rec(*args, **kwargs):
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

    def report(name, what, fn):
        out = fn()
        torch.cuda.synchronize()
        ts = [_time_ms(fn, 1) for _ in range(5)]
        print(f"[times] {name} {what}: median {statistics.median(ts):.3f} ms "
              f"of {[round(t, 3) for t in ts]}, checksum "
              f"{int(out.long().sum())}  [{card}]", flush=True)

    (dg, q, _, c, prep), kw = captured["B1"]
    mr = kw.get("max_run", 0)
    report("B1", f"{int(q.shape[0])} reads, Wb {prep['width']}, max_run {mr}",
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
    report("B5", f"{int(q.shape[0])} reads, Wb {prep['width']}, max_run {mr}",
           lambda: cf.ef_best_rows(dg, q, c, prep, fs, end_ok, mr))
    return 0


if __name__ == "__main__":
    sys.exit(main())
