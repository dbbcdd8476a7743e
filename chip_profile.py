"""Where the time of one main-path batch goes on the card.

    python3 chip_profile.py

Builds the bench's uniform configuration (as ``chip_smoke.py`` does),
converges the scorer's ub hint with two unprofiled batches, then profiles
two ``BatchMapper.score_batch`` batches of 1024 reads with
``torch.profiler``.  For each it prints the host wall time, the device time
of the top operations by name, the device's busy and idle shares of the
wall, and the same batch's unprofiled wall.  Needs one card; imports no
JAX.
"""

import os
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))


def main() -> int:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: torch.cuda.is_available() is "
                           "False")
    sys.path.insert(0, REPO)
    from chip_smoke import uniform_workload
    from poasta_tpu_torch import BatchMapper, GapAffine
    from poasta_tpu_torch.utils.device import card_info, cuda_device

    card = card_info()
    costs = GapAffine(4, 2, 6)
    graph, _, reads = uniform_workload(costs)
    mapper = BatchMapper(graph, costs, device=cuda_device())
    mapper.score_batch(reads)
    mapper.score_batch(reads)
    for rep in range(2):
        mapper.scorer.reset_stats()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            mapper.score_batch(reads)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        # device-side activities only (kernels, copies): a host op's
        # "self device time" repeats the time of the work it launched
        per_name, spans = {}, []
        for ev in prof.events():
            if ev.device_type != DeviceType.CUDA \
                    or "Activity Buffer" in ev.name:
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
        print(f"[profile] batch {rep}: wall {wall * 1e3:.3f} ms, device busy "
              f"{busy * 1e3:.3f} ms ({100 * busy / wall:.2f}%), idle "
              f"{100 * (1 - busy / wall):.2f}%, stats {mapper.scorer.stats}"
              f"  [{card}]", flush=True)
        for name, (tot, cnt) in sorted(per_name.items(),
                                       key=lambda kv: -kv[1][0])[:8]:
            print(f"[profile]   {tot / 1e3:10.3f} ms  x{cnt}  {name[:90]}",
                  flush=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mapper.score_batch(reads)
        torch.cuda.synchronize()
        print(f"[profile]   unprofiled wall "
              f"{(time.perf_counter() - t0) * 1e3:.3f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
