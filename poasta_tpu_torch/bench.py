"""Throughput bench of the port: the repository's ``bench.py`` through
``poasta_tpu_torch`` on one CUDA card.

    python -m poasta_tpu_torch.bench [--device cpu]

Prints ONE JSON line on standard output::

    {"metric": ..., "value": N, "unit": "cells/s", "vs_baseline": N, ...}

with the keys of ``bench.py``'s line but its int16 toolchain probe (the
port has no such kernel), plus ``backend``, ``torch``, ``cuda``, ``nvcc``
and ``card`` (the first card's ``nvidia-smi --query-gpu=name,power.limit``
line; null on the CPU).  The configurations, their inputs and the metric
definitions are ``bench.py``'s:

* uniform -- a ~6k-node graph of four 5 kb sequences (seed 7), 1024 reads
  at 3%, scored by ``BandedScorer.scores``: ``value`` is effective cells/s
  (``n_nodes x L x reads / median``), ``raw_cells_per_sec`` counts the
  cells the fills computed;
* host baseline -- the native exact engine on the first 16 reads, each
  score equal to the device's; ``vs_baseline`` is reads/s over its
  ``1/median_per_read_s``;
* hybrid -- ``BatchMapper.align_batch`` on the first 32 reads, scores
  equal to the device's;
* mixed_div -- its own graph (seed 11: a base and one sequence at 2%),
  1024 reads, every 20th at 15% and the rest at 2%, through the full
  ladder;
* mixed_len / ef_mixed_len -- a 5 kb graph with its 4 kb-deletion allele
  (seed 13), 1024 reads at 1.5% from both alleles, on drifting windows
  and again on shared ones (scores equal), globally and under a bounded
  ends-free span;
* pangenome -- a 50 kb backbone with an edge v -> v+3 every 500 nodes
  (seed 17), 64 reads of 5 kb at 1.5%, aligned semi-globally by
  ``BatchMapper.align_batch`` (two warm-up calls, then seeded).

Each timed region is the median of its calls after a warm-up call (kernel
builds and first launches stay outside it) and ends with the results on
the host.  The kernels are built first, so a fresh checkout needs this
command alone.  Unlike ``bench.py`` it never reports a host-only line
without a card, and never turns a failed configuration into an
``*_error`` key: any failure prints the one error line and re-raises, so
the run exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import random
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from .aligner.costs import UNBOUNDED, EndsFree, GapAffine, included
from .aligner.banded import BandedScorer
from .aligner.wavefront import pack_queries
from .graphs import POAGraph
from .native import NativeAligner
from .parallel.mapper import BatchMapper
from .utils.device import card_info, resolve_device

METRIC = "poa_affine_fill_cells_per_sec_per_chip"
# Every configuration's sizes, bench.py's own; main() builds at these.
SIZES = {
    "uniform": {"graph_len": 5000, "n_seqs": 4, "n_reads": 1024, "seed": 7},
    "host_sample": 16,
    "hybrid_sample": 32,
    "mixed_div": {"graph_len": 5000, "n_reads": 1024, "seed": 11},
    "mixed_len": {"graph_len": 5000, "del_start": 500, "del_end": 4500,
                  "n_reads": 1024, "seed": 13},
    "pangenome": {"n": 50_000, "every": 500, "n_reads": 64,
                  "read_len": 5000, "seed": 17},
}
# timed calls after the warm-up, per configuration (bench.py's counts)
ITERS = {"uniform": 6, "hybrid": 5, "mixed_div": 5, "mixed_len": 5,
         "pangenome": 5}


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


def _fuse(graph, seq, costs, name):
    _, alignment, _ = NativeAligner(graph).align(seq, costs)
    graph.add_alignment_with_weights(name, seq, alignment, [1] * len(seq))


def _base_graph(rng, graph_len):
    base = "".join(rng.choice("ACGT") for _ in range(graph_len))
    graph = POAGraph()
    graph.add_alignment_with_weights("s0", base.encode(), None,
                                     [1] * graph_len)
    return graph, base


def build_uniform(costs, graph_len=5000, n_seqs=4, n_reads=1024, seed=7):
    """The headline configuration: ``n_seqs`` sequences (the base first)
    fused at 3% and ``n_reads`` reads at 3%, each cut to ``graph_len``."""
    rng = random.Random(seed)
    graph, base = _base_graph(rng, graph_len)
    for i in range(1, n_seqs):
        _fuse(graph, _mutate(rng, base, 0.03, graph_len).encode(), costs,
              f"s{i}")
    reads = [_mutate(rng, base, 0.03, graph_len).encode()
             for _ in range(n_reads)]
    return graph, reads


def build_mixed_div(costs, graph_len=5000, n_reads=1024, seed=11):
    """The mixed-divergence configuration: the base and one sequence at 2%;
    every 20th read at 15%, the rest at 2%."""
    rng = random.Random(seed)
    graph, base = _base_graph(rng, graph_len)
    _fuse(graph, _mutate(rng, base, 0.02).encode(), costs, "s1")
    reads = [_mutate(rng, base, 0.15 if i % 20 == 0 else 0.02).encode()
             for i in range(n_reads)]
    return graph, reads


def build_mixed_len(costs, graph_len=5000, del_start=500, del_end=4500,
                    n_reads=1024, seed=13):
    """The mixed-length SV configuration: the base fused with its allele
    that lacks ``base[del_start:del_end]``; reads at 1.5%, every other one
    from the short allele."""
    rng = random.Random(seed)
    graph, base = _base_graph(rng, graph_len)
    variant = base[:del_start] + base[del_end:]
    _fuse(graph, variant.encode(), costs, "s1")
    reads = [_mutate(rng, base if i % 2 else variant, 0.015).encode()
             for i in range(n_reads)]
    return graph, reads


def build_pangenome(n=50_000, every=500, n_reads=64, read_len=5000,
                    seed=17):
    """The pangenome configuration: an ``n``-base backbone with an edge
    v -> v+3 every ``every`` nodes, and ``n_reads`` reads of ``read_len``
    bases at 1.5% from random loci."""
    rng = random.Random(seed)
    graph, base = _base_graph(rng, n)
    for v in range(0, n - 3, every):
        graph.add_edge(v, v + 3, 0, 1)
    graph.post_process()
    reads = []
    for _ in range(n_reads):
        a = rng.randrange(0, n - read_len)
        reads.append(_mutate(rng, base[a:a + read_len], 0.015).encode())
    return graph, reads


def _time_scores(scorer, qshift, lengths, iters):
    """Median of ``iters`` timed ``scorer.scores`` calls after a warm-up
    call (kernel builds, first launches, the ub hint's convergence), and
    the median cells they filled; with the last call's scores."""
    scorer.scores(qshift, lengths)
    ts, raws = [], []
    for _ in range(iters):
        scorer.reset_stats()
        t0 = time.perf_counter()
        scores = scorer.scores(qshift, lengths)
        ts.append(time.perf_counter() - t0)
        raws.append(scorer.stats["cells_filled"])
    return np.asarray(scores), statistics.median(ts), statistics.median(raws)


def _time_calls(fn, warm, iters):
    """``fn()`` ``warm`` times, then ``iters`` timed calls: (last output,
    their walls)."""
    for _ in range(warm):
        fn()
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        out = fn()
        ts.append(time.perf_counter() - t0)
    return out, ts


def _equal(what, got, want):
    """An exactness gate: raises (never an assert statement, which ``-O``
    strips) when the port's results differ."""
    if got != want:
        raise AssertionError(f"{what}: {got} != {want}")


def run_uniform(costs, device):
    """The headline configuration; returns its keys and, for the host
    baseline and hybrid configurations, (graph, reads, scores, reads/s)."""
    graph, reads = build_uniform(costs, **SIZES["uniform"])
    flat = graph.flatten()
    scorer = BandedScorer(flat, costs, device=device)
    qshift, lengths = pack_queries(reads, device=device)
    scores, elapsed, raw_cells = _time_scores(scorer, qshift, lengths,
                                              ITERS["uniform"])
    n_cells = flat.n_nodes * int(qshift.shape[1]) * len(reads)
    reads_per_sec = len(reads) / elapsed
    keys = {"value": round(n_cells / elapsed),
            "raw_cells_per_sec": round(raw_cells / elapsed),
            "reads_per_sec": round(reads_per_sec, 2)}
    return keys, (graph, reads, scores, reads_per_sec)


def run_host_baseline(graph, reads, scores, costs):
    """The native exact engine on a sample of the reads, one at a time:
    each score equals the device's; the rate is 1/median per-read time."""
    na = NativeAligner(graph)
    sample = reads[:SIZES["host_sample"]]
    per_read = []
    for i, q in enumerate(sample):
        t0 = time.perf_counter()
        score, _, _ = na.align(q, costs)
        per_read.append(time.perf_counter() - t0)
        _equal(f"host baseline, read {i}: native score vs device score",
               score, int(scores[i]))
    return {"host_baseline_reads_per_sec":
            round(1.0 / statistics.median(per_read), 4),
            "host_baseline_sample": len(sample),
            "host_baseline_protocol": "1/median_per_read_s"}


def run_hybrid(graph, reads, scores, costs, device):
    """``BatchMapper.align_batch`` on a sample of the uniform reads (one
    warm-up call): device scores, then the route's traceback."""
    mapper = BatchMapper(graph, costs, device=device)
    sample = reads[:SIZES["hybrid_sample"]]
    out, ts = _time_calls(lambda: mapper.align_batch(sample), 1,
                          ITERS["hybrid"])
    _equal("hybrid: align_batch scores vs device scores",
           [int(s) for s, _ in out], [int(s) for s in scores[:len(sample)]])
    return {"hybrid_align_reads_per_sec":
            round(len(sample) / statistics.median(ts), 2),
            "hybrid_align_spread": [round(min(ts), 4), round(max(ts), 4)]}


def run_mixed_div(costs, device):
    """Mixed divergence on its own graph, through the full ladder."""
    graph, reads = build_mixed_div(costs, **SIZES["mixed_div"])
    scorer = BandedScorer(graph.flatten(), costs, device=device)
    qshift, lengths = pack_queries(reads, device=device)
    _, elapsed, raw = _time_scores(scorer, qshift, lengths,
                                   ITERS["mixed_div"])
    return {"mixed_div_reads_per_sec": round(len(reads) / elapsed, 2),
            "mixed_div_raw_cells_per_sec": round(raw / elapsed)}


def _drift_and_shared(flat, qshift, lengths, costs, device, aln_type=None):
    """The batch on drifting windows, then on shared ones (the drift
    threshold out of reach on that instance): scores equal; returns (reads/s
    on drifting windows, cells ratio, time ratio), each shared over
    drifting."""
    timed = []
    for shared in (False, True):
        scorer = BandedScorer(flat, costs, device=device, aln_type=aln_type)
        if shared:
            scorer.DRIFT_MIN_SPREAD = 1 << 30
        timed.append(_time_scores(scorer, qshift, lengths,
                                  ITERS["mixed_len"]))
    (s_drift, el_drift, raw_drift), (s_shared, el_shared, raw_shared) = timed
    if not np.array_equal(s_drift, s_shared):
        bad = int((s_drift != s_shared).sum())
        raise AssertionError(f"drifting windows: {bad} scores differ from "
                             "the shared windows'")
    return (int(qshift.shape[0]) / el_drift,
            raw_shared / max(raw_drift, 1), el_shared / el_drift)


def run_mixed_len(costs, device):
    """Mixed lengths (an SV allele), globally and under the bounded
    ends-free span ``EndsFree(unbounded, included(50), included(0),
    included(50))``."""
    graph, reads = build_mixed_len(costs, **SIZES["mixed_len"])
    flat = graph.flatten()
    qshift, lengths = pack_queries(reads, device=device)
    rps, cells, speed = _drift_and_shared(flat, qshift, lengths, costs,
                                          device)
    keys = {"mixed_len_reads_per_sec": round(rps, 2),
            "mixed_len_drift_cells_ratio": round(cells, 2),
            "mixed_len_drift_speedup": round(speed, 2)}
    span = EndsFree(("unbounded", None), included(50), included(0),
                    included(50))
    rps, cells, speed = _drift_and_shared(flat, qshift, lengths, costs,
                                          device, aln_type=span)
    keys.update({"ef_mixed_len_reads_per_sec": round(rps, 2),
                 "ef_drift_cells_ratio": round(cells, 2),
                 "ef_drift_speedup": round(speed, 2)})
    return keys


def run_pangenome(costs, device):
    """Semi-global alignment against the pangenome backbone: two warm-up
    calls (the first learns the seed rates), then the timed ones, which
    seed."""
    sizes = SIZES["pangenome"]
    graph, reads = build_pangenome(**sizes)
    span = EndsFree(UNBOUNDED, included(0), UNBOUNDED, UNBOUNDED)
    mapper = BatchMapper(graph, costs, aln_type=span, device=device)
    _, ts = _time_calls(lambda: mapper.align_batch(reads), 2,
                        ITERS["pangenome"])
    seed = mapper.last_seed_stats or {}
    return {"pangenome_semiglobal_reads_per_sec":
            round(len(reads) / statistics.median(ts), 2),
            "pangenome_spread": [round(min(ts), 4), round(max(ts), 4)],
            "pangenome_graph_nodes": sizes["n"],
            "seed_engaged": seed.get("seeded", 0) > 0,
            "pangenome_seeded": seed.get("seeded"),
            "pangenome_seed_tail": seed.get("seed_tail"),
            "pangenome_seed_k": seed.get("seed_k")}


def _progress(name, t0):
    print(f"[bench] {name}: {time.perf_counter() - t0:.1f} s",
          file=sys.stderr, flush=True)


def run(device) -> dict:
    """Every configuration in ``bench.py``'s order on ``device``; the
    line's keys."""
    costs = GapAffine(4, 2, 6)
    t0 = time.perf_counter()
    keys, (graph, reads, scores, reads_per_sec) = run_uniform(costs, device)
    _progress("uniform", t0)
    host = run_host_baseline(graph, reads, scores, costs)
    _progress("host baseline", t0)
    keys.update(host)
    keys.update(run_hybrid(graph, reads, scores, costs, device))
    _progress("hybrid", t0)
    keys.update(run_mixed_div(costs, device))
    _progress("mixed_div", t0)
    keys.update(run_mixed_len(costs, device))
    _progress("mixed_len, ef_mixed_len", t0)
    keys.update(run_pangenome(costs, device))
    _progress("pangenome", t0)
    return {"metric": METRIC, "value": keys.pop("value"), "unit": "cells/s",
            "vs_baseline": round(
                reads_per_sec / max(host["host_baseline_reads_per_sec"],
                                    1e-9), 2),
            **keys}


def _versions(device) -> dict:
    """The backend and the versions the numbers were taken with."""
    on_card = device.type == "cuda"
    nvcc = None
    if on_card:
        from .utils import build

        res = subprocess.run([build.nvcc_path(), "--version"],
                             capture_output=True, text=True, check=True)
        nvcc = res.stdout.strip().splitlines()[-1]
    return {"backend": "torch-cuda" if on_card else "torch-cpu",
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "nvcc": nvcc, "card": card_info() if on_card else None}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m poasta_tpu_torch.bench",
        description="bench.py's configurations through the port; prints "
                    "one JSON line")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="'cuda' (default) is the first card, an error when "
                        "PyTorch sees none; 'cpu' runs the kernels' plain "
                        "PyTorch versions")
    args = p.parse_args(argv)
    try:
        device = resolve_device(None if args.device == "cuda" else "cpu")
        if device.type == "cuda":
            from .utils import build

            build.load()  # builds first where this source is not built yet
        line = run(device)
        line.update(_versions(device))
    except BaseException as exc:
        # the one line still comes out, then the failure: a failed gate or
        # configuration never exits 0
        print(json.dumps({"metric": METRIC, "value": 0, "unit": "cells/s",
                          "vs_baseline": 0,
                          "error": f"{type(exc).__name__}: "
                                   f"{str(exc)[:200]}"}), flush=True)
        raise
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
