"""The control of a cell's check: the reference put in the program's place
under a static band, the step that drops the ladder's verify-and-retry.

    python3 -m benchmark.control --workload <cell> --seeds 11,12,13

For each seed it makes the cell's inputs as a run does, takes the reads
the cell's check compares with the reference (every read of a scoring
cell's batches; a mapping cell's check sample, drawn the same way from
its chunks), and scores them twice: exactly, and with every row held to
|j - c(r)| <= ``control_band`` about the read's diagonal (global: j =
depth(r) * n / the graph's depth; free ends: j = depth(r) - the read's
locus).  It prints the control's ``score_mismatches`` beside the limit the
check holds the program to; a control that comes out correct is a fault
of the check.  The benchmark's runs never run it.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from .graphgen import STREAM_SAMPLE, build_graph, rng_for
from .readgen import make_batches
from .reference.dp import best_scores
from .reference.gfa import parse_gfa
from .registry import Registry


def readings(reg: Registry, name: str, seed: int, device: str = "cuda"):
    """(the control's score_mismatches, reads compared) on one seed."""
    cell = reg.cell(name)
    config, mix = reg.config(cell["config"]), reg.mix(cell["traffic"])
    gfa, haps, backbone = build_graph(config["graph"], seed)
    batches, _, origins = make_batches(mix, haps, backbone, seed)
    graph = parse_gfa(gfa)
    reads = [r for b in batches for r in b]
    meta = [o for b in origins for o in b]
    if "check_sample" in cell:
        rng = rng_for(seed, STREAM_SAMPLE)
        size = min(int(cell["check_sample"]), len(reads))
        pick = sorted(rng.choice(len(reads), size=size,
                                 replace=False).tolist())
        reads, meta = [reads[i] for i in pick], [meta[i] for i in pick]
    free = config["span"] != "global"
    lengths = np.asarray([len(r) for r in reads], dtype=np.float64)
    if free:
        scale, offset = np.ones_like(lengths), np.asarray(
            [m[1] for m in meta], dtype=np.float64)
    else:
        scale = lengths / float(graph.depth.max())
        offset = np.zeros_like(lengths)
    costs = config["costs"]
    exact = best_scores(graph, reads, costs, free, device=device)
    banded = best_scores(graph, reads, costs, free, device=device,
                         band=(int(cell["control_band"]), scale, offset))
    return int((banded != exact).sum()), len(reads)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m benchmark.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True,
                   help="comma-separated seeds, three or more")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    reg = Registry()
    for seed in (int(s) for s in args.seeds.split(",")):
        bad, n = readings(reg, args.workload, seed, args.device)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control_score_mismatches": bad, "compared": n,
                          "limit": 0, "correct": bad <= 0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
