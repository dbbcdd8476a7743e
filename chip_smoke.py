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
  and a short read against the exact A* engine;
* 7c 1024 fragments of 2,000-4,000 bases cut from the uniform graph's four
  sequences (95% at 3%, 5% at 15%) under the CLI's semi-global span:
  ``score_batch`` on all of them (one exact full-width tier of the
  ends-free banded fill B5), then, sorted by length into quarters as the
  CLI batches reads, ``BandedScorer.scores(max_retries=1)``: a quarter of
  short fragments is again one exact full-width B5 tier; a quarter of long
  ones has a band narrower than the row, and what its one B5 tier does not
  verify takes the capped ladder over the bounded full fill B4; against
  the plain path, the exact full fill, and the exact A* engine on a short
  fragment through the same mapper;
* 7d holds B3, B4, B5 and B6 against their plain versions at the inputs
  7a-7c gave them.

Phase 8 drives ends-free alignment, the fourth main path, on the bench's
pangenome configuration uncut (seed 17: a 50,000-base linear graph with an
edge ``v -> v+3`` every 500 nodes, reads of 5,000 bases at 1.5%, the CLI's
semi-global span), with 256 reads so that the CLI at ``-j 64`` runs four
batches: the first learns the score rates through the bounded full fill
with end states (B7), the others seed through the corridor fill (B8), and
every batch is traced from its end states (B18 with ``free_start``):

* 8a ``BatchMapper(..., aln_type=semi-global).align_batch`` on 64 reads,
  three calls: the seeded calls must seed (``seeded > 0``), every (score,
  end rank, end offset) of the seeded scoring equals the uncapped full
  fill's, every alignment costs its score, and no read falls back;
* 8b the port's CLI, ``-m semi-global -j 64``, 256 reads, from GFA load to
  the last GAF line, with every launch counter zeroed just before and read
  just after: every ``AS:i`` equals ``score_batch``'s, and the GAF is
  byte-equal to the runs with ``POASTA_DEVICE_TRACE=0`` and with
  ``POASTA_SEED=0`` (three routes, one answer);
* 8c two reads of 150 and 300 bases on a 3,000-base graph of the same
  shape (seeding forced by ``POASTA_SEED=all``) under both CLI spans
  against the exact A* engine under Dijkstra;
* 8d holds B7, B8 and B18 with ``free_start`` against their plain versions
  at the inputs 8b gave them (B8 and B18 on 8 reads of their calls: the
  plain versions take about a millisecond a rank whatever the batch).

Phase 9 drives two-piece costs under the global span, the fifth main path,
with ``GapAffine2Piece(4, 2, 8, 1, 24)`` (``poasta align -n 4 -g 8,24 -e
2,1``), each run with every launch counter zeroed just before and read
just after:

* 9a ``BatchMapper.score_batch`` on the uniform configuration's 1024 reads
  (one warm-up, five timed): the banded fill B16, against the plain path on
  64 reads and the native engine on 16;
* 9b the mixed-divergence traffic through ``BandedScorer.scores(...,
  max_retries=1)``: one B16 tier, then the full-width fill B12 for the
  reads it did not verify, against the plain path and the native engine;
* 9c the mixed-length SV traffic through ``score_batch``: drifting windows
  (B17), against drift switched off and the native engine;
* 9d ``align_batch`` on 64 uniform reads: every read takes the native
  backtrace (the trace kernel is one-piece); every alignment costs its
  score, and every score equals ``score_batch``'s;
* 9e the port's MSA CLI, ``python -m poasta_tpu_torch.cli.poasta align
  --engine banded --device-assist on -n 4 -g 8,24 -e 2,1``, on 16
  sequences of 10 kb (seed 23) at 3%, every fourth with a 1.5 kb deletion,
  with ``-O fasta``: the bytes equal the ``--device-assist off`` run's,
  and every score the assist handed over equals the native engine's
  against the graph it was computed on;
* 9f holds B12, B16 and B17 against their plain versions at the inputs
  9a-9c gave them.

Phase 10 drives two-piece costs under ends-free spans, the sixth main
path, with the same costs, each run with every launch counter zeroed just
before and read just after (no banded, seeded or traced kernel serves it):

* 10a the mixed-length SV traffic under the bench's bounded span through
  ``BatchMapper.score_batch`` (a warm-up, then three timed): the capped
  ladder over the bounded fill B13; reads 0-7 against B13's plain version
  uncapped; then ``align_batch`` on 64 reads: the ladder over B14, every
  read through the native anchored corridor; every alignment costs its
  score, and every score is ``score_batch``'s;
* 10b the pangenome configuration under the CLI's semi-global span:
  ``align_batch`` on 64 reads, a warm-up and a timed call: B14 over 50,002
  ranks (the TPU's streamed twin B15's size), no seeded fill (B8) and no
  trace (B18) launched, every read anchored, every alignment costing its
  score;
* 10c the free graph ends of the global fill (B2f: B4 under the end mask;
  B12f: B13 under it) through ``dp_fill_scores(free_start=, free_end=)`` on
  the uniform graph with 64 pieces of 1,000 bases cut from its reads, all
  four flag pairs under both cost models; each against its plain version
  per flag pair, then B13 and B14 at the inputs 10a and 10b gave them (B14
  on 8 reads of its call).

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

import contextlib
import io
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
B7_REPLACES = "poasta_tpu/ops/pallas_fill.py:637"
B8_REPLACES = "poasta_tpu/ops/pallas_seed.py:48"
PAN_LEN, PAN_READS, PAN_READ_LEN, PAN_SEED, PAN_DIV = (50000, 256, 5000, 17,
                                                       0.015)
PAN_EDGE_EVERY, PAN_BATCH = 500, 64
# the penalties of poasta align -n 4 -g 8,24 -e 2,1: GapAffine2Piece(
# mismatch, gap_extend, gap_open, gap_extend2, gap_open2)
COSTS_2P = (4, 2, 8, 1, 24)
B12_REPLACES = "poasta_tpu/ops/pallas_fill.py:1837"
B16_REPLACES = "poasta_tpu/ops/pallas_fill.py:3527"
B17_REPLACES = "poasta_tpu/ops/pallas_fill.py:3330"
MSA_SEQS, MSA_LEN, MSA_SEED, MSA_DIV, MSA_CUT = 16, 10000, 23, 0.03, 1500
B13_REPLACES = "poasta_tpu/ops/pallas_fill.py:1300"
B14_REPLACES = "poasta_tpu/ops/pallas_fill.py:1457"
B2F_REPLACES = "poasta_tpu/ops/pallas_fill.py:304"
B12F_REPLACES = "poasta_tpu/ops/pallas_fill.py:1837"
# phase 10c: 64 pieces of this many bases cut from the uniform reads
FREE_SEED, FREE_READ_LEN = 29, 1000
FREE_FLAGS = [(False, False), (True, False), (False, True), (True, True)]


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


def backbone_graph(rng, n):
    """A linear graph of ``n`` random bases with an edge v -> v+3 every
    ``PAN_EDGE_EVERY`` nodes; returns (graph, base)."""
    from poasta_tpu_torch import POAGraph

    base = "".join(rng.choice("ACGT") for _ in range(n))
    graph = POAGraph()
    graph.add_alignment_with_weights("s0", base.encode(), None, [1] * n)
    for v in range(0, n - 3, PAN_EDGE_EVERY):
        graph.add_edge(v, v + 3, 0, 1)
    graph.post_process()
    return graph, base


def pangenome_workload():
    """bench.py's pangenome semi-global configuration (seed 17), with 256
    reads where the bench draws 64: the first 64 are the bench's."""
    rng = random.Random(PAN_SEED)
    graph, base = backbone_graph(rng, PAN_LEN)
    reads = []
    for _ in range(PAN_READS):
        a = rng.randrange(0, PAN_LEN - PAN_READ_LEN)
        reads.append(_mutate(rng, base[a:a + PAN_READ_LEN], PAN_DIV).encode())
    return graph, reads


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
# The bounded full fill with end ranks (B7) at a permitted rank, in place of
# B4's one min: a compare, and a select each for the value and the rank.
ENDS_OPS = 3
# The seeded corridor fill (B8) at a rank that may end an alignment: the
# window test (two compares, an and), the candidate (un-tilt add, clamp) and
# the ordered update (value compare, offset compare, and/or, three selects).
SEED_END_OPS = 3 + 2 + 7
# The two-piece recurrence (B12, B16, B17) per lane and rank: D1 (add, add,
# min), D2 (min, add), the diagonal (compare-select, add), A (two mins), I
# (add, clamp), M (min), the stored D1 and D2 clamps; its rows are untilted,
# so fill_bound adds the scan's tilt and un-tilt (2).  Per predecessor row
# after the first: a min each for M, D1 and D2.
RECURRENCE_OPS_2P = 3 + 2 + 2 + 2 + 2 + 1 + 2
PRED_OPS_2P = 3


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


def _native_scores(na, reads, costs):
    """``NativeAligner.align_banded`` scores of ``reads``, a thread a core
    (the engine releases the interpreter lock; the mapper calls it so)."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=os.cpu_count() or 4) as pool:
        return list(pool.map(lambda r: na.align_banded(r, costs)[0], reads))


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
    native64 = _native_scores(na, reads[:64], costs)
    if list(map(int, scores[:64])) != native64:
        raise AssertionError("first 64 scores differ from the native "
                             "banded engine's")
    # 15% reads (every 20th) score far above the first tier's ub, so the
    # full fill scored them
    tail = list(range(0, 160, 20))
    native_tail = _native_scores(na, [mixed[i] for i in tail], costs)
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

    # ---- 8. ends-free alignment on the pangenome configuration ------------
    pan_results, pan_launches, pan_workload = pangenome_phases(card, dev,
                                                               costs)

    # ---- 9. two-piece costs under the global span --------------------------
    tp_results, tp_launches = two_piece_phases(card, dev, graph, reads, base)

    # ---- 10. two-piece costs under ends-free spans; free graph ends ---------
    ef2_results, ef2_launches = ends_free_two_piece_phases(
        card, dev, graph, reads, *pan_workload)

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
         "launches_by_call": {
             "lasagna align uniform": lasagna["launches"][3],
             "lasagna align -m semi-global pangenome":
                 pan_launches["decode"]},
         **trace_results["decode"]},
        {"name": "full_fill_kernel<bounded, ends>", "route": "cuda",
         "source": f"poasta_tpu_torch/csrc/{full}", "replaces": B7_REPLACES,
         "launches": pan_launches["B7"], **pan_results["B7"]},
        {"name": "seed_fill_kernel", "route": "cuda",
         "source": "poasta_tpu_torch/csrc/seed_kernel.cu",
         "replaces": B8_REPLACES, "launches": pan_launches["B8"],
         **pan_results["B8"]},
        {"name": "trace_kernel<free_start>", "route": "cuda",
         "source": "poasta_tpu_torch/csrc/trace_kernel.cu",
         "replaces": B18_REPLACES, "launches": pan_launches["B18"],
         **pan_results["B18"]},
    ]
    for name, kernel, source, replaces in (
            ("B12", "full_fill_kernel<two-piece>", full, B12_REPLACES),
            ("B16", "banded_kernel<two-piece>", banded, B16_REPLACES),
            ("B17", "banded_kernel<drift, two-piece>", banded,
             B17_REPLACES)):
        calls = {call: n[name] for call, n in tp_launches.items() if n[name]}
        kernels.append({"name": kernel, "route": "cuda",
                        "source": f"poasta_tpu_torch/csrc/{source}",
                        "replaces": replaces,
                        "launches": sum(calls.values()),
                        "launches_by_call": calls, **tp_results[name]})
    for name, kernel, replaces in (
            ("B13", "full_fill_kernel<bounded, two-piece>", B13_REPLACES),
            ("B14", "full_fill_kernel<bounded, ends, two-piece>",
             B14_REPLACES),
            ("B2f", "full_fill_kernel<bounded> under free_end_mask",
             B2F_REPLACES),
            ("B12f", "full_fill_kernel<bounded, two-piece> under "
             "free_end_mask", B12F_REPLACES)):
        calls = {call: n[name] for call, n in ef2_launches.items() if n[name]}
        kernels.append({"name": kernel, "route": "cuda",
                        "source": f"poasta_tpu_torch/csrc/{full}",
                        "replaces": replaces,
                        "launches": sum(calls.values()),
                        "launches_by_call": calls, **ef2_results[name]})
    for k in kernels:
        if k["launches"] <= 0:
            raise AssertionError(f"{k['name']} launched on no main path")
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

    def rec_fill(g_dg, qpad, wstarts, anchor_r, anchor_j, c, Wb,
                 free_start=False):
        captured.setdefault("fill", (g_dg, dict(
            qpad=qpad, wstarts=wstarts, anchor_r=anchor_r,
            anchor_j=anchor_j), c, Wb))
        return real_fill(g_dg, qpad, wstarts, anchor_r, anchor_j, c, Wb,
                         free_start)

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
        native = _native_scores(na, [sv_reads[i] for i in sample], costs)
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
        # under Dijkstra (see 7c) on the tail of one read, short because it
        # walks most of the graph per query base (one read: 11 s)
        tails = [sv_reads[0][-48:]]
        engine = PoastaAligner(costs, bench_span, heuristic="dijkstra")
        t0 = time.perf_counter()
        want = [engine.align(gsv, r).score for r in tails]
        if list(map(int, m_ef.score_batch(tails))) != want:
            raise AssertionError("7b: short reads differ from the exact "
                                 "engine's under the bounded span")
        print(f"[drift-ef] all {N_READS} scores equal with drift off and the "
              f"exact bounded full fill's; the last 48 bases of read 0 equal "
              f"the exact A* engine's {want} "
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
        # 3 kb fragment, so it checks a short fragment through the same
        # mapper (18 s)
        short = fragment_reads(seqs, 1, 100, 120)
        engine = PoastaAligner(costs, semi, heuristic="dijkstra")
        t0 = time.perf_counter()
        want = [engine.align(graph, r).score for r in short]
        if list(map(int, m_sg.score_batch(short))) != want:
            raise AssertionError("7c: short fragments differ from the exact "
                                 "engine's")
        print(f"[semi-global] all {N_READS} scores equal the exact bounded "
              f"full fill's and the plain path's ({secs:.1f} s, one cold "
              f"call); a fragment of 100-120 bases equals the exact A* "
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


def pangenome_phases(card, dev, costs):
    """Phases 8a-8d; returns (kernel comparisons of B7, B8 and B18 with
    ``free_start``, their launches in the CLI run of 8b)."""
    import tempfile

    import numpy as np
    import torch

    from poasta_tpu_torch import (
        UNBOUNDED,
        BatchMapper,
        EndsFree,
        PoastaAligner,
        included,
        pack_queries,
    )
    from poasta_tpu_torch.aligner import wavefront as wavefront_mod
    from poasta_tpu_torch.ops import cuda_fill as cf
    from poasta_tpu_torch.ops import seed as sd
    from poasta_tpu_torch.ops import trace as tr
    from poasta_tpu_torch.parallel import mapper as mapper_mod

    semi = EndsFree(UNBOUNDED, included(0), UNBOUNDED, UNBOUNDED)
    free = EndsFree(UNBOUNDED, UNBOUNDED, UNBOUNDED, UNBOUNDED)
    wrappers = {"B7": cf.bounded_end_rows, "B8": sd.seed_end_states,
                "B18": tr.trace_fill, "decode": tr.trace_decode}

    def zero():
        for w in wrappers.values():
            w.launches = 0

    def read():
        return {name: w.launches for name, w in wrappers.items()}

    graph, reads = pangenome_workload()
    lens = [len(r) for r in reads]
    mapper = BatchMapper(graph, costs, device=dev, aln_type=semi)
    dg, flat = mapper.dg, mapper.flat
    print(f"[pangenome] graph: {flat.n_nodes} nodes (Np {dg.n_nodes_padded}), "
          f"W {dg.window}, P {int(dg.pred_slots.shape[1])}; {PAN_READS} reads "
          f"of {min(lens)}-{max(lens)}", flush=True)
    _phase_done("8 pangenome set-up")

    # ---- 8a. align_batch: one batch through B7, then seeded ---------------
    batch = reads[:PAN_BATCH]
    zero()
    outs, secs, seed_stats = [], [], []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs.append(mapper.align_batch(batch))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        seed_stats.append(mapper.last_seed_stats)
        if mapper.last_ends_free_stats["exact_fallback"] != 0 \
                or mapper.last_ends_free_stats["anchored_ok"] != PAN_BATCH:
            raise AssertionError(f"8a: {mapper.last_ends_free_stats}")
    n8a = read()
    print(f"[pangenome] align_batch({PAN_BATCH} reads) x3: "
          f"{[round(t, 3) for t in secs]} s "
          f"({PAN_BATCH / secs[-1]:.2f} reads/s on the last), seed stats "
          f"{seed_stats[1:]}, anchored path {mapper.last_ends_free_stats}, "
          f"seed rates {mapper._seed_rate}, launches {n8a}  [{card}]",
          flush=True)
    if seed_stats[0] is not None:
        raise AssertionError("8a: the first batch seeded without rates")
    for st in seed_stats[1:]:
        if not st or st["seeded"] <= 0:
            raise AssertionError(f"8a: the seeded path is inert: {st}")
    if min(n8a.values()) <= 0:
        raise AssertionError(f"8a: a kernel never launched: {n8a}")
    pairs = [[(s, list(a)) for s, a in out] for out in outs]
    if pairs[0] != pairs[1] or pairs[1] != pairs[2]:
        raise AssertionError("8a: the seeded calls' alignments differ from "
                             "the full fill's")
    for read_, (score, aln) in zip(batch, outs[-1]):
        cost = wavefront_mod.alignment_cost(graph, read_, aln, costs)
        if cost != score:
            raise AssertionError(f"8a: an alignment costs {cost}, scored "
                                 f"{score}")
    q, ln = pack_queries(batch, device=dev)
    seeded = mapper._ends_free_scores(batch, q, ln)
    exact = [t.cpu().numpy() for t in
             wavefront_mod.dp_fill_ends_free_with_ends(dg, flat, q, ln, costs,
                                                       semi)]
    for name, got, want in zip(("scores", "end ranks", "end offsets"), seeded,
                               exact):
        if not (got == want).all():
            raise AssertionError(f"8a: seeded {name} differ from the "
                                 "uncapped full fill's")
    print(f"[pangenome] all {PAN_BATCH} (score, end rank, end offset) of the "
          f"seeded scoring ({mapper.last_seed_stats['seeded']} seeded) equal "
          "the uncapped full fill's; every alignment costs its score; no "
          "exact fallback", flush=True)
    _phase_done("8a align_batch, seeded")

    # ---- 8b. main path: the port's CLI, -m semi-global --------------------
    tmp = tempfile.mkdtemp(prefix="poasta_smoke_pan_")
    gfa, fa = write_inputs(graph, reads, tmp)
    per_batch, captured, on_main_path = [], {}, [False]
    real_ef = mapper_mod.BatchMapper._align_batch_ends_free
    real = {"B7": cf._launch_bounded_ends, "B8": sd._launch_seed,
            "B18": tr._launch_trace}

    def rec_ef(self, *args, **kwargs):
        out = real_ef(self, *args, **kwargs)
        per_batch.append((dict(self.last_ends_free_stats),
                          self.last_seed_stats))
        return out

    def keep(name, q_at=1):
        # the widest batch's inputs of the run (the last such call)
        def rec(*args, **kwargs):
            B = int(args[q_at].shape[0])
            if on_main_path[0] and B >= captured.get(name, (0,))[0]:
                captured[name] = (B, args, kwargs)
            return real[name](*args, **kwargs)
        return rec

    def cli(out_name, env=None):
        out_path = os.path.join(tmp, out_name)
        os.environ.update(env or {})
        try:
            secs = _lasagna_run(["align", gfa, fa, "-o", out_path, "-m",
                                 "semi-global", "-j", str(PAN_BATCH)])
        finally:
            for k in env or {}:
                del os.environ[k]
        with open(out_path) as fh:
            return secs, fh.read()

    with mock.patch.object(mapper_mod.BatchMapper, "_align_batch_ends_free",
                           rec_ef), \
            mock.patch.object(cf, "_launch_bounded_ends", keep("B7")), \
            mock.patch.object(sd, "_launch_seed", keep("B8")), \
            mock.patch.object(tr, "_launch_trace", keep("B18")):
        zero()
        on_main_path[0] = True
        dev_s, dev_gaf = cli("dev.gaf")
        on_main_path[0] = False
        launches = read()
    traced = sum(ef["device_traced"] for ef, _ in per_batch)
    print(f"[lasagna] pangenome, -m semi-global -j {PAN_BATCH}, "
          f"{len(per_batch)} batches: {PAN_READS / dev_s:.2f} reads/s "
          f"({dev_s:.2f} s wall, GFA load to last GAF line), device traced "
          f"{traced} of {PAN_READS}, per batch (traced, device s, host s) "
          f"{[(ef['device_traced'], round(ef['device_s'], 3), round(ef['host_s'], 3)) for ef, _ in per_batch]}"
          f", seed stats {[sd_ for _, sd_ in per_batch]}, launches "
          f"{launches}  [{card}]", flush=True)
    if min(launches.values()) <= 0:
        raise AssertionError(f"8b: a kernel of the path never launched: "
                             f"{launches}")
    if any(ef["exact_fallback"] for ef, _ in per_batch):
        raise AssertionError("8b: a read fell back to the exact engine")
    if not all(sd_ and sd_["seeded"] > 0 for _, sd_ in per_batch[1:]):
        raise AssertionError("8b: a batch after the first did not seed")
    scores = BatchMapper(graph, costs, device=dev,
                         aln_type=semi).score_batch(reads)
    lines = dev_gaf.splitlines()
    if len(lines) != PAN_READS:
        raise AssertionError(f"{len(lines)} GAF records for {PAN_READS} reads")
    for line in lines:
        fields = line.split("\t")
        i = int(fields[0][1:])
        as_i = [f for f in fields if f.startswith("AS:i:")]
        if as_i != [f"AS:i:{int(scores[i])}"]:
            raise AssertionError(f"read {i}: {as_i} but score_batch "
                                 f"{int(scores[i])}")
    host_s, host_gaf = cli("host.gaf", {"POASTA_DEVICE_TRACE": "0"})
    full_s, full_gaf = cli("full.gaf", {"POASTA_SEED": "0"})
    if host_gaf != dev_gaf or full_gaf != dev_gaf:
        raise AssertionError("8b: the three routes' GAF differ")
    print(f"[lasagna] all {PAN_READS} AS:i equal score_batch's; GAF "
          f"byte-equal to POASTA_DEVICE_TRACE=0 ({host_s:.2f} s wall, "
          f"align_anchored on {os.cpu_count()} cores) and to POASTA_SEED=0 "
          f"({full_s:.2f} s wall, B7 every batch); seeded and traced "
          f"{dev_s:.2f} s  [{card}]", flush=True)
    _phase_done("8b the CLI, three routes")

    # ---- 8c. short reads against the exact engine ---------------------------
    rng = random.Random(PAN_SEED + 1)
    s_graph, s_base = backbone_graph(rng, 3000)
    short = []
    for n in (150, 300):
        a = rng.randrange(0, 3000 - n)
        short.append(_mutate(rng, s_base[a:a + n], PAN_DIV).encode())
    t0 = time.perf_counter()
    os.environ["POASTA_SEED"] = "all"
    try:
        for name, span in (("semi-global", semi), ("ends-free", free)):
            m = BatchMapper(s_graph, costs, device=dev, aln_type=span)
            m.align_batch(short)
            got = [s for s, _ in m.align_batch(short)]
            engine = PoastaAligner(costs, span, heuristic="dijkstra")
            want = [engine.align(s_graph, r).score for r in short]
            if got != want:
                raise AssertionError(f"8c {name}: {got} but the exact engine "
                                     f"{want}")
            if name == "semi-global" and not (
                    m.last_seed_stats and m.last_seed_stats["seeded"] > 0):
                raise AssertionError(f"8c: short reads did not seed: "
                                     f"{m.last_seed_stats}")
            print(f"[pangenome] 2 reads of 150 and 300 bases on a 3,000-base "
                  f"graph, {name}: scores {got} equal the exact A* engine's "
                  f"under Dijkstra; seed stats {m.last_seed_stats}",
                  flush=True)
    finally:
        del os.environ["POASTA_SEED"]
    print(f"[pangenome] 8c took {time.perf_counter() - t0:.1f} s", flush=True)
    _phase_done("8c short reads, exact engine")

    # ---- 8d. B7, B8, B18 free_start at the main path's shapes ---------------
    results = {}
    _, (g_dg, q, c, fs, end_ok, max_run), _ = captured["B7"]
    L = int(q.shape[1])
    print(f"[kernels] B7 main path: {int(q.shape[0])} reads, L {L}, "
          f"{g_dg.n_nodes} ranks, free_start {fs}, max_run {max_run}, plan "
          f"{cf.bounded_plan(g_dg.window, L, ends=True)}", flush=True)
    results["B7"] = _compare(
        "B7 main path",
        lambda: cf.bounded_end_rows(g_dg, q, c, fs, end_ok, max_run),
        lambda: cf.bounded_end_rows_plain(g_dg, q, c, fs, end_ok, max_run),
        card, reps=3)
    # B4's count with the end test's three operations for its one, and a
    # second (B, L) row written
    results["B7"].update(fill_bound(
        g_dg, int(q.shape[0]), L, L, 2 * L, tilted=False,
        per_rank=RECURRENCE_OPS + ENDS_OPS * int(end_ok.sum()) / g_dg.n_nodes,
        table_cols=1))

    _, args, _ = captured["B8"]
    (g_dg, q, wst, ln, jlo, r_begin, r_end, c, fs, end_ok, Wb, max_run) = args
    span = r_end - r_begin
    print(f"[kernels] B8 main path (a tight tier): {int(q.shape[0])} reads, L "
          f"{int(q.shape[1])}, Wb {Wb}, max_run {max_run}, rank ranges of "
          f"{int(span.min())}-{int(span.max())} ranks ({int(span.sum())} in "
          f"all), plan {sd.seed_plan(g_dg.window, Wb)}", flush=True)
    full_ms = _time_ms(
        lambda: sd.seed_end_states(g_dg, q, wst, ln, jlo, r_begin, r_end, c,
                                   fs, end_ok, Wb, max_run), 5)
    # the plain version walks the union of the reads' ranges at about a
    # millisecond a rank whatever the batch (a minute over this call's 64
    # loci): the call's 8 reads whose ranges begin lowest in the graph
    low8 = torch.argsort(r_begin)[:8]
    q, wst, ln, jlo, r_begin, r_end = (
        t.index_select(0, low8).contiguous()
        for t in (q, wst, ln, jlo, r_begin, r_end))
    ranks = int((r_end - r_begin).sum())
    print(f"[kernels] B8: the whole call {full_ms:.3f} ms; compared and "
          f"timed on its 8 lowest reads, ranks {int(r_begin.min())}-"
          f"{int(r_end.max())} ({ranks} in their ranges)", flush=True)
    results["B8"] = _compare(
        "B8 main path (8 lowest reads)",
        lambda: sd.seed_end_states(g_dg, q, wst, ln, jlo, r_begin, r_end, c,
                                   fs, end_ok, Wb, max_run),
        lambda: sd.seed_end_states_plain(g_dg, q, wst, ln, jlo, r_begin,
                                         r_end, c, fs, end_ok, Wb, max_run),
        card, reps=5)
    # over the ranks the reads' own ranges cover: the tilted recurrence
    # (its stored D unclamped: one operation less), the scan, the end test
    # at the ranks that may end, and the graph's mean count of further
    # predecessor rows; in: each read's row, its window starts and the rank
    # tables over its range, and five words a read; out: three words a read
    n = g_dg.n_nodes
    P = int(g_dg.pred_slots.shape[1])
    extra_preds = int(g_dg.pred_valid_np[:n, 1:].sum()) / n
    may_end = int(end_ok[:n].sum()) / n
    results["B8"].update(_bound(
        4 * (q.numel() + ranks * (1 + 3 + 2 * P) + 8 * int(q.shape[0])),
        ranks * Wb * (RECURRENCE_OPS - 1 + SCAN_OPS + PRED_OPS * extra_preds
                      + SEED_END_OPS * may_end)))
    results["B8"].update(reads_compared=int(q.shape[0]),
                         whole_call_ms=full_ms)

    _, args, kwargs = captured["B18"]
    g_dg, qpad, wst, ar, aj, c, Wb = args[:7]
    fs = args[7] if len(args) > 7 else kwargs.get("free_start", False)
    if not fs:
        raise AssertionError("8d: the path's trace ran without free_start")
    # the plain version walks 50k ranks at about a millisecond each whatever
    # the batch, and holds planes of its own: the first 8 reads of the call
    keep8 = slice(0, 8)
    inp = dict(qpad=qpad[keep8].contiguous(), wstarts=wst[keep8].contiguous(),
               anchor_r=ar[keep8].contiguous(), anchor_j=aj[keep8].contiguous())
    print(f"[trace] pangenome main path: {int(qpad.shape[0])} reads in the "
          f"call, compared and timed on its first 8; LQ {int(qpad.shape[1])}"
          f", Wb {Wb}, free_start {fs}, plan "
          f"{tr.trace_plan(g_dg.window, Wb)}", flush=True)
    results["B18"] = _compare(
        "B18 free_start main path (first 8 reads)",
        lambda: tr.trace_fill(g_dg, **inp, costs=c, Wb=Wb, free_start=True),
        lambda: tr.trace_fill_plain(g_dg, **inp, costs=c, Wb=Wb,
                                    free_start=True), card, reps=3)
    results["B18"].update(fill_bound(
        g_dg, 8, Wb, int(qpad.shape[1]), g_dg.n_nodes * Wb + 1, tilted=True,
        per_pred=TRACE_PRED_OPS, per_rank=TRACE_OPS, table_cols=8))
    results["B18"]["reads_compared"] = 8
    _phase_done("8d B7, B8, B18 free_start at the main path's shapes")
    return results, launches, (graph, reads)


def msa_fasta(directory):
    """The MSA input of phase 9e: 16 sequences of 10 kb (seed 23) at 3%
    divergence from one base, every fourth with a 1.5 kb deletion."""
    rng = random.Random(MSA_SEED)
    base = "".join(rng.choice("ACGT") for _ in range(MSA_LEN))
    path = os.path.join(directory, "msa.fa")
    with open(path, "w") as fh:
        for i in range(MSA_SEQS):
            s = _mutate(rng, base, MSA_DIV)
            if i % 4 == 3:
                a = rng.randrange(len(s) // 10, len(s) - MSA_CUT - len(s) // 10)
                s = s[:a] + s[a + MSA_CUT:]
            fh.write(f">seq{i}\n{s}\n")
    return path


def _lead_cost(aln, costs):
    """The cost of the leading insertion run a backtrace does not emit as
    pairs (the query prefix aligned against the virtual start node)."""
    lead = next((p.qpos for p in aln if p.qpos is not None), 0)
    return 0 if lead == 0 else (costs.gap_open + costs.gap_extend
                                + (lead - 1) * min(costs.gap_extend,
                                                   costs.gap_extend2))


def two_piece_phases(card, dev, graph, reads, base):
    """Phases 9a-9f; returns (kernel comparisons of B12, B16 and B17, their
    launches per main-path call)."""
    import tempfile

    import torch

    from poasta_tpu_torch import (
        BatchMapper,
        GapAffine,
        NativeAligner,
        pack_queries,
    )
    from poasta_tpu_torch.aligner import GapAffine2Piece
    from poasta_tpu_torch.aligner import banded as banded_mod
    from poasta_tpu_torch.aligner import fusion_assist as fa
    from poasta_tpu_torch.aligner import wavefront as wavefront_mod
    from poasta_tpu_torch.cli.poasta import main as poasta_main
    from poasta_tpu_torch.ops import cuda_fill as cf

    costs = GapAffine2Piece(*COSTS_2P)
    fills = {"B12": cf.fill_end_rows_2p, "B16": cf.banded_end_rows_2p,
             "B17": cf.drift_end_rows_2p}
    launches, captured, on_main_path = {}, {}, [False]

    def keep(name, fn):
        # the widest batch of the main-path calls (the last such call)
        def rec(*args, **kwargs):
            B = int(args[1].shape[0])
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

    def plain_path(fn):
        """``fn()`` with every two-piece fill replaced by its plain
        version; fails if a kernel launches all the same."""
        before = [k.launches for k in fills.values()]
        with mock.patch.object(banded_mod, "banded_scores_2p",
                               cf.banded_scores_2p_plain), \
                mock.patch.object(banded_mod, "drift_scores_2p",
                                  cf.drift_scores_2p_plain), \
                mock.patch.object(wavefront_mod, "fill_scores_2p",
                                  cf.fill_scores_2p_plain):
            t0 = time.perf_counter()
            out = fn()
            secs = time.perf_counter() - t0
        if [k.launches for k in fills.values()] != before:
            raise AssertionError("the plain path launched a kernel")
        return out, secs

    recorders = [
        mock.patch.object(banded_mod, "banded_scores_2p",
                          keep("B16", cf.banded_scores_2p)),
        mock.patch.object(banded_mod, "drift_scores_2p",
                          keep("B17", cf.drift_scores_2p)),
        mock.patch.object(wavefront_mod, "fill_scores_2p",
                          keep("B12", cf.fill_scores_2p)),
    ]
    with ExitStack() as stack:
        for patch in recorders:
            stack.enter_context(patch)

        # ---- 9a. score_batch, uniform traffic -------------------------------
        m_u = BatchMapper(graph, costs, device=dev)
        zero()
        u_scores, el, raw = _timed_batches(m_u, reads, 5)
        n9a = read("score_batch uniform two-piece")
        print(f"[two-piece] uniform score_batch: {N_READS / el:.2f} reads/s "
              f"(median {el * 1e3:.1f} ms, {raw / el:.4e} raw cells/s), ub "
              f"hint {m_u.scorer._ub_hint}, last fill width "
              f"{m_u.scorer._last_fill_width}, launches {n9a}  [{card}]",
              flush=True)
        if n9a["B16"] <= 0:
            raise AssertionError(f"9a never launched B16: {n9a}")
        plain64, secs = plain_path(
            lambda: BatchMapper(graph, costs, device=dev).score_batch(
                reads[:64]))
        na = NativeAligner(graph)
        sample = list(range(0, N_READS, N_READS // 16))
        t0 = time.perf_counter()
        native = _native_scores(na, [reads[i] for i in sample], costs)
        if not ((plain64 == u_scores[:64]).all()
                and [int(u_scores[i]) for i in sample] == native
                and (u_scores < cf.INF).all()):
            raise AssertionError("9a: two-piece scores differ from the plain "
                                 "path's or the native engine's")
        print(f"[two-piece] reads 0-63 equal the plain path's ({secs:.1f} s),"
              f" reads {sample} NativeAligner.align_banded's "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
        _phase_done("9a two-piece uniform")

        # ---- 9b. mixed divergence, one banded tier then the full fill -------
        mixed = mixed_reads(base)
        qm, lm = pack_queries(mixed, device=dev)
        m_mix = BatchMapper(graph, costs, device=dev)
        zero()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mixed_scores = m_mix.scorer.scores(qm, lm, max_retries=1)
        mixed_s = time.perf_counter() - t0
        n9b = read("scores mixed max_retries=1 two-piece")
        print(f"[two-piece] mixed, max_retries 1: {mixed_s * 1e3:.1f} ms, "
              f"stats {m_mix.scorer.stats}, launches {n9b}  [{card}]",
              flush=True)
        if n9b["B12"] <= 0:
            raise AssertionError(f"9b never launched B12: {n9b}")
        plain_mix, secs = plain_path(
            lambda: BatchMapper(graph, costs, device=dev).scorer.scores(
                qm, lm, max_retries=1))
        tail = list(range(0, min(160, N_READS), 20))
        native = _native_scores(na, [mixed[i] for i in tail], costs)
        if not ((plain_mix == mixed_scores).all()
                and [int(mixed_scores[i]) for i in tail] == native):
            raise AssertionError("9b: mixed scores differ from the plain "
                                 "path's or the native engine's")
        print(f"[two-piece] all {N_READS} mixed scores equal the plain path's"
              f" ({secs:.1f} s); 15% reads {tail} equal "
              "NativeAligner.align_banded's", flush=True)
        _phase_done("9b two-piece mixed")

        # ---- 9c. mixed lengths: drifting windows ----------------------------
        gsv, sv_reads = sv_workload(GapAffine(4, 2, 6))
        m_sv = BatchMapper(gsv, costs, device=dev)
        zero()
        sv_scores, el, raw = _timed_batches(m_sv, sv_reads, 3)
        n9c = read("score_batch mixed_len two-piece")
        off = BatchMapper(gsv, costs, device=dev)
        off.scorer.DRIFT_MIN_SPREAD = 1 << 30
        sh_scores, el_sh, raw_sh = _timed_batches(off, sv_reads, 1)
        layouts = sorted((k[3], v[0])
                         for k, v in m_sv.scorer._prep_cache.items()
                         if k[0] == "drift" and v[0] is not None)
        print(f"[two-piece] mixed_len score_batch: {N_READS / el:.2f} reads/s "
              f"(median {el * 1e3:.1f} ms), drift off {N_READS / el_sh:.2f} "
              f"reads/s ({el_sh * 1e3:.1f} ms); cells ratio "
              f"{raw_sh / max(raw, 1):.2f}; drift layouts (ub, Wb) {layouts};"
              f" launches {n9c}  [{card}]", flush=True)
        if n9c["B17"] <= 0:
            raise AssertionError(f"9c never launched B17: {n9c}")
        na_sv = NativeAligner(gsv)
        sv_sample = [0, 1, N_READS // 2, N_READS // 2 + 1, N_READS - 2,
                     N_READS - 1]
        native = _native_scores(na_sv, [sv_reads[i] for i in sv_sample],
                                costs)
        if not ((sv_scores == sh_scores).all()
                and [int(sv_scores[i]) for i in sv_sample] == native):
            raise AssertionError("9c: drift scores differ from drift off's "
                                 "or the native engine's")
        print(f"[two-piece] all {N_READS} mixed_len scores equal with drift "
              f"off; reads {sv_sample} equal NativeAligner.align_banded's",
              flush=True)

        # ---- 9d. align_batch ------------------------------------------------
        batch = reads[:64]
        zero()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = m_u.align_batch(batch)
        align_s = time.perf_counter() - t0
        n9d = read("align_batch uniform two-piece")
        if [s for s, _ in out] != [int(s) for s in u_scores[:64]]:
            raise AssertionError("9d: align_batch scores differ from "
                                 "score_batch's")
        for r, (score, aln) in zip(batch, out):
            cost = wavefront_mod.alignment_cost(graph, r, aln, costs)
            if cost + _lead_cost(aln, costs) != score:
                raise AssertionError(f"9d: an alignment costs {cost}, scored "
                                     f"{score}")
        print(f"[two-piece] align_batch(64 uniform reads): {align_s:.2f} s "
              f"({64 / align_s:.2f} reads/s), {m_u.last_banded_stats}, "
              f"launches {n9d}; every alignment costs its score  [{card}]",
              flush=True)
        _phase_done("9c-9d two-piece mixed_len, align_batch")

        # ---- 9e. the port's poasta align: MSA with the device assist --------
        tmp = tempfile.mkdtemp(prefix="poasta_smoke_msa_")
        fasta = msa_fasta(tmp)
        # every device score of the -O fasta run is kept with the native
        # engine built on the graph it was computed on (a snapshot): taken
        # or late, each must be exact
        scored, snapshots, assist_stats, keep_graphs = [], {}, [], [True]
        real_prefetch, real_score = (fa.DeviceSeedPrefetcher.prefetch,
                                     fa.DeviceSeedPrefetcher._score)
        real_close = fa.DeviceSeedPrefetcher.close

        def rec_prefetch(self, g, seq):
            if keep_graphs[0] and not (self._future is not None
                                       and not self._future.done()):
                snapshots[id(seq)] = NativeAligner(g)
            return real_prefetch(self, g, seq)

        def rec_score(self, flat, seq, hint):
            score = real_score(self, flat, seq, hint)
            if keep_graphs[0]:
                scored.append((seq, score))
            return score

        def rec_close(self):
            real_close(self)
            assist_stats.append(dict(self.stats))

        def msa(out_type, assist):
            out_path = os.path.join(tmp, f"{assist}.{out_type}")
            argv = ["align", "--engine", "banded", "--device-assist", assist,
                    "-n", "4", "-g", "8,24", "-e", "2,1", "-O", out_type,
                    "-o", out_path, fasta]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with contextlib.redirect_stderr(io.StringIO()):
                rc = poasta_main(argv)
            secs = time.perf_counter() - t0
            if rc != 0:
                raise AssertionError(f"poasta {argv} exited {rc}")
            with open(out_path, "rb") as fh:
                return secs, fh.read()

        walls = {}
        with mock.patch.object(fa.DeviceSeedPrefetcher, "prefetch",
                               rec_prefetch), \
                mock.patch.object(fa.DeviceSeedPrefetcher, "_score",
                                  rec_score), \
                mock.patch.object(fa.DeviceSeedPrefetcher, "close",
                                  rec_close):
            for out_type in ("fasta",):
                zero()
                walls[(out_type, "on")], on_bytes = msa(out_type, "on")
                n9e = read(f"poasta align -O {out_type} assist on")
                walls[(out_type, "off")], off_bytes = msa(out_type, "off")
                keep_graphs[0] = False
                if on_bytes != off_bytes:
                    raise AssertionError(f"9e: -O {out_type} with the assist "
                                         "differs from without")
                on_s, off_s = walls[(out_type, "on")], walls[(out_type, "off")]
                print(f"[msa] -O {out_type}: assist on {on_s:.2f} s, off "
                      f"{off_s:.2f} s wall, bytes "
                      f"equal ({len(on_bytes)} B); prefetches "
                      f"{assist_stats[-1]}; launches {n9e}  [{card}]",
                      flush=True)
        if not scored or min(st["finished"] for st in assist_stats) <= 0:
            raise AssertionError(f"9e: the assist scored nothing: "
                                 f"{assist_stats}")
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=os.cpu_count() or 4) as pool:
            wants = list(pool.map(
                lambda p: snapshots[id(p[0])].align_banded(p[0], costs)[0],
                scored))
        for (seq, score), want in zip(scored, wants):
            if want != score:
                raise AssertionError(f"9e: a device score {score} is not the "
                                     f"native engine's {want}")
        print(f"[msa] all {len(scored)} device scores of the -O fasta run "
              f"({assist_stats[0]['taken']} taken, the rest late) equal "
              "NativeAligner.align_banded's against the graph each was "
              "computed on", flush=True)
        _phase_done("9e poasta align MSA")

    # ---- 9f. B12, B16, B17 against their plain versions --------------------
    results = {}
    _, (dg, q, ln, c, prep), kw = captured["B16"]
    mr = kw.get("max_run", 0)
    P = int(dg.pred_slots.shape[1])
    print(f"[kernels] B16 main path: {int(q.shape[0])} reads, Lq "
          f"{int(q.shape[1])}, Wb {prep['width']}, margin {prep['margin']}, "
          f"max_run {mr}, plan "
          f"{cf.banded_plan(dg.window, prep['width'], prep['margin'], True)}",
          flush=True)
    results["B16"] = _compare(
        "B16 main path", lambda: cf.banded_end_rows_2p(dg, q, c, prep, mr),
        lambda: cf.banded_end_rows_2p_plain(dg, q, c, prep, mr), card,
        reps=3)
    results["B16"].update(fill_bound(
        dg, int(q.shape[0]), prep["width"], int(q.shape[1]), prep["width"],
        tilted=False, per_pred=PRED_OPS_2P, per_rank=RECURRENCE_OPS_2P,
        table_cols=1 + P))

    _, (dg, qpad, ln, c, prep, n_min), kw = captured["B17"]
    nbs = cf.drift_units(ln, n_min)
    mr = kw.get("max_run", 0)
    plan = cf.variant_plan(cf.VARIANT_DRIFT_2P, dg.window, prep["width"],
                           prep["margin"], int(qpad.shape[1]))
    print(f"[kernels] B17 main path: {int(qpad.shape[0])} reads, Lq "
          f"{int(qpad.shape[1])} (mq {prep['mq']}), Wb {prep['width']}, margin"
          f" {prep['margin']}, S {prep['S']}, max_run {mr}, plan {plan}",
          flush=True)
    results["B17"] = _compare(
        "B17 main path",
        lambda: cf.drift_end_rows_2p(dg, qpad, nbs, c, prep, mr),
        lambda: cf.drift_end_rows_2p_plain(dg, qpad, nbs, c, prep, mr), card,
        reps=3)
    results["B17"].update(fill_bound(
        dg, int(qpad.shape[0]), prep["width"], int(qpad.shape[1]) + 1,
        prep["width"], tilted=False, per_pred=PRED_OPS_2P,
        per_rank=RECURRENCE_OPS_2P, table_cols=3 + P))

    _, (dg, q, ln, c), _ = captured["B12"]
    L = int(q.shape[1])
    print(f"[kernels] B12 main path (the mixed tail): {int(q.shape[0])} reads,"
          f" L {L}, plan {cf.fill_plan(dg.window, L, two_piece=True)}",
          flush=True)
    results["B12"] = _compare(
        "B12 main path", lambda: cf.fill_end_rows_2p(dg, q, c),
        lambda: cf.fill_end_rows_2p_plain(dg, q, c), card, reps=3)
    results["B12"].update(fill_bound(
        dg, int(q.shape[0]), L, L, L, tilted=False, per_pred=PRED_OPS_2P,
        per_rank=RECURRENCE_OPS_2P))
    _phase_done("9f B12, B16, B17 at the main paths' shapes")
    return results, launches


def ends_free_two_piece_phases(card, dev, uniform_graph, uniform_reads,
                               pan_graph, pan_reads):
    """Phases 10a-10c; returns (kernel comparisons of B13, B14, B2f and B12f,
    their launches per main-path call)."""
    import numpy as np
    import torch

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
    from poasta_tpu_torch.aligner import wavefront as wavefront_mod
    from poasta_tpu_torch.ops import cuda_fill as cf
    from poasta_tpu_torch.ops import seed as sd
    from poasta_tpu_torch.ops import trace as tr

    costs = GapAffine2Piece(*COSTS_2P)
    costs_1p = GapAffine(4, 2, 6)
    bounded = EndsFree(UNBOUNDED, included(50), included(0), included(50))
    semi = EndsFree(UNBOUNDED, included(0), UNBOUNDED, UNBOUNDED)
    wrappers = {"B13": cf.bounded_best_rows_2p, "B14": cf.bounded_end_rows_2p,
                "B2f": cf.free_fill_rows, "B12f": cf.free_fill_rows_2p,
                "B8": sd.seed_end_states, "B18": tr.trace_fill}
    launches, captured, on_main_path = {}, {}, [False]
    real = {"B13": cf._launch_bounded_2p, "B14": cf._launch_bounded_ends_2p}

    def keep(name):
        # the widest batch of the main-path calls (the last such call)
        def rec(*args, **kwargs):
            B = int(args[1].shape[0])
            if on_main_path[0] and B >= captured.get(name, (0,))[0]:
                captured[name] = (B, args, kwargs)
            return real[name](*args, **kwargs)
        return rec

    def zero():
        for w in wrappers.values():
            w.launches = 0
        on_main_path[0] = True

    def read(call):
        on_main_path[0] = False
        launches[call] = {name: w.launches for name, w in wrappers.items()}
        return launches[call]

    def check_alignments(name, graph, reads, out, scores, mapper):
        stats = mapper.last_ends_free_stats
        if stats["device_traced"] != 0 or stats["anchored_ok"] != len(reads) \
                or mapper.last_seed_stats is not None:
            raise AssertionError(f"{name}: {stats}, seed stats "
                                 f"{mapper.last_seed_stats}")
        if [s for s, _ in out] != [int(s) for s in scores]:
            raise AssertionError(f"{name}: align_batch scores differ from "
                                 "score_batch's")
        for r, (score, aln) in zip(reads, out):
            cost = wavefront_mod.alignment_cost(graph, r, aln, costs)
            if cost != score:
                raise AssertionError(f"{name}: an alignment costs {cost}, "
                                     f"scored {score}")

    with mock.patch.object(cf, "_launch_bounded_2p", keep("B13")), \
            mock.patch.object(cf, "_launch_bounded_ends_2p", keep("B14")):
        # ---- 10a. mixed_len under the bench's bounded span ------------------
        gsv, sv_reads = sv_workload(costs_1p)
        m_sv = BatchMapper(gsv, costs, device=dev, aln_type=bounded)
        zero()
        sv_scores, el, raw = _timed_batches(m_sv, sv_reads, 3)
        n10a = read("score_batch mixed_len bounded two-piece")
        print(f"[ef two-piece] mixed_len, bounded span, score_batch: "
              f"{N_READS / el:.2f} reads/s (median {el * 1e3:.1f} ms of 3 "
              f"after a warm-up, {raw / el:.4e} raw cells/s), stats "
              f"{m_sv.scorer.stats}, ub hints {m_sv.scorer._ub_hint}, "
              f"launches {n10a}  [{card}]", flush=True)
        if n10a["B13"] <= 0 or not (sv_scores < cf.INF).all():
            raise AssertionError(f"10a: B13 never launched or a score is "
                                 f"INF: {n10a}")
        q8, l8 = pack_queries(sv_reads[:8], device=dev)
        fs, end_ok, jlo = wavefront_mod.ends_free_device_params(
            m_sv.flat, bounded, l8, m_sv.dg.n_nodes_padded, True)
        t0 = time.perf_counter()
        plain8 = cf.bounded_scores_2p_plain(m_sv.dg, q8, l8, costs, fs,
                                            end_ok, jlo).cpu().numpy()
        if not (plain8 == sv_scores[:8]).all():
            raise AssertionError(f"10a: scores {sv_scores[:8]} but B13's "
                                 f"plain version {plain8}")
        print(f"[ef two-piece] reads 0-7 equal B13's plain version, uncapped "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
        batch = sv_reads[:PAN_BATCH]
        zero()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = m_sv.align_batch(batch)
        align_s = time.perf_counter() - t0
        n10a_al = read("align_batch mixed_len bounded two-piece")
        check_alignments("10a", gsv, batch, out, sv_scores[:PAN_BATCH], m_sv)
        print(f"[ef two-piece] mixed_len, bounded span, align_batch"
              f"({PAN_BATCH}): {align_s:.2f} s ({PAN_BATCH / align_s:.2f} "
              f"reads/s), {m_sv.last_ends_free_stats}, launches {n10a_al}; "
              f"every alignment costs its score, every score is "
              f"score_batch's  [{card}]", flush=True)
        if n10a_al["B14"] <= 0:
            raise AssertionError(f"10a: B14 never launched: {n10a_al}")
        _phase_done("10a two-piece mixed_len, bounded span")

        # ---- 10b. pangenome, semi-global: no seeding, no trace ---------------
        m_pan = BatchMapper(pan_graph, costs, device=dev, aln_type=semi)
        batch = pan_reads[:PAN_BATCH]
        secs, outs = [], []
        for i in range(2):
            zero()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs.append(m_pan.align_batch(batch))
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            n10b = read(f"align_batch pangenome semi-global two-piece "
                        f"{'warm-up' if i == 0 else 'timed'}")
            if n10b["B14"] <= 0 or n10b["B8"] or n10b["B18"]:
                raise AssertionError(f"10b: launches {n10b}")
        pan_scores = [s for s, _ in outs[1]]
        if [s for s, _ in outs[0]] != pan_scores:
            raise AssertionError("10b: the two calls' scores differ")
        check_alignments("10b", pan_graph, batch, outs[1], pan_scores, m_pan)
        print(f"[ef two-piece] pangenome, semi-global, align_batch"
              f"({PAN_BATCH}) x2: {[round(t, 3) for t in secs]} s "
              f"({PAN_BATCH / secs[1]:.2f} reads/s timed), "
              f"{m_pan.last_ends_free_stats}, 0 seeded, 0 traced, ub hints "
              f"{m_pan._ef_ub_hint}, launches {n10b}  [{card}]", flush=True)
        _phase_done("10b two-piece pangenome align_batch")

        # ---- 10c. B2f and B12f: the free-end full fills ----------------------
        rng = random.Random(FREE_SEED)
        short = []
        for r in uniform_reads[:64]:
            a = rng.randrange(0, len(r) - FREE_READ_LEN)
            short.append(r[a:a + FREE_READ_LEN])
        u_dg = DeviceGraph.build(uniform_graph.flatten(), device=dev)
        qf, lf = pack_queries(short, device=dev)
        free_scores = {}
        for label, c in (("one-piece", costs_1p), ("two-piece", costs)):
            for flags in FREE_FLAGS:
                zero()
                free_scores[(label, flags)] = wavefront_mod.dp_fill_scores(
                    u_dg, qf, lf, c, free_start=flags[0],
                    free_end=flags[1]).cpu().numpy()
                read(f"dp_fill_scores {label} free_start={flags[0]} "
                     f"free_end={flags[1]}")
        for label in ("one-piece", "two-piece"):
            glob = free_scores[(label, (False, False))]
            for flags in FREE_FLAGS[1:]:
                if not (free_scores[(label, flags)] <= glob).all():
                    raise AssertionError(f"10c: {label} {flags} scores above "
                                         "the global ones")
        print(f"[ef two-piece] dp_fill_scores on the uniform graph "
              f"({u_dg.n_nodes} ranks), 64 reads of {FREE_READ_LEN} bases, "
              f"L {int(qf.shape[1])}: mean scores "
              f"{ {f'{k[0]} {k[1]}': round(float(v.mean()), 1) for k, v in free_scores.items()} }",
              flush=True)

    # ---- the kernels against their plain versions --------------------------
    results = {}
    for name, label, c, wrapper in (
            ("B2f", "one-piece", costs_1p, cf.free_fill_rows),
            ("B12f", "two-piece", costs, cf.free_fill_rows_2p)):
        by_flags = {}
        for flags in FREE_FLAGS:
            cmp = _compare(
                f"{name} free_start={flags[0]} free_end={flags[1]}",
                lambda f=flags: wrapper(u_dg, qf, c, *f),
                lambda f=flags: cf.free_fill_rows_plain(u_dg, qf, c, *f),
                card, reps=3)
            at_lengths = cf._at_lengths(wrapper(u_dg, qf, c, *flags), lf)
            if not (at_lengths.cpu().numpy()
                    == free_scores[(label, flags)]).all():
                raise AssertionError(f"10c: {name} {flags} rows disagree "
                                     "with dp_fill_scores")
            by_flags[f"{flags[0]}, {flags[1]}"] = cmp
        results[name] = dict(by_flags["True, True"])
        results[name]["ms_by_flags"] = {k: v["ms"]
                                        for k, v in by_flags.items()}
        mask = cf.free_end_mask(u_dg, True)
        L = int(qf.shape[1])
        two = c.is_two_piece
        results[name].update(fill_bound(
            u_dg, int(qf.shape[0]), L, L, L, tilted=False,
            per_pred=PRED_OPS_2P if two else PRED_OPS,
            per_rank=(RECURRENCE_OPS_2P if two else RECURRENCE_OPS)
            + int(mask.sum()) / u_dg.n_nodes, table_cols=1))
        print(f"[kernels] {name}: plan "
              f"{cf.bounded_plan(u_dg.window, L, two_piece=two)}", flush=True)

    _, (g_dg, q, c, fs, end_ok, max_run), _ = captured["B13"]
    L = int(q.shape[1])
    print(f"[kernels] B13 main path (10a): {int(q.shape[0])} reads, L {L}, "
          f"{g_dg.n_nodes} ranks, free_start {fs}, max_run {max_run}, "
          f"{int(end_ok.sum())} permitted ranks, plan "
          f"{cf.bounded_plan(g_dg.window, L, two_piece=True)}", flush=True)
    results["B13"] = _compare(
        "B13 main path",
        lambda: cf.bounded_best_rows_2p(g_dg, q, c, fs, end_ok, max_run),
        lambda: cf.bounded_best_rows_2p_plain(g_dg, q, c, fs, end_ok,
                                              max_run), card, reps=3)
    results["B13"].update(fill_bound(
        g_dg, int(q.shape[0]), L, L, L, tilted=False, per_pred=PRED_OPS_2P,
        per_rank=RECURRENCE_OPS_2P + int(end_ok.sum()) / g_dg.n_nodes,
        table_cols=1))

    _, (g_dg, q, c, fs, end_ok, max_run), _ = captured["B14"]
    L = int(q.shape[1])
    full_ms = _time_ms(lambda: cf.bounded_end_rows_2p(g_dg, q, c, fs, end_ok,
                                                      max_run), 3)
    # the plain version walks 50k ranks at about a millisecond each whatever
    # the batch: the first 8 reads of the call
    q8 = q[:8].contiguous()
    print(f"[kernels] B14 main path (10b): {int(q.shape[0])} reads in the "
          f"call ({full_ms:.3f} ms), compared and timed on its first 8; L {L},"
          f" {g_dg.n_nodes} ranks, free_start {fs}, max_run {max_run}, plan "
          f"{cf.bounded_plan(g_dg.window, L, ends=True, two_piece=True)}",
          flush=True)
    results["B14"] = _compare(
        "B14 main path (first 8 reads)",
        lambda: cf.bounded_end_rows_2p(g_dg, q8, c, fs, end_ok, max_run),
        lambda: cf.bounded_end_rows_2p_plain(g_dg, q8, c, fs, end_ok,
                                             max_run), card, reps=3)
    results["B14"].update(fill_bound(
        g_dg, 8, L, L, 2 * L, tilted=False, per_pred=PRED_OPS_2P,
        per_rank=RECURRENCE_OPS_2P
        + ENDS_OPS * int(end_ok.sum()) / g_dg.n_nodes, table_cols=1))
    results["B14"].update(reads_compared=8, whole_call_ms=full_ms,
                          whole_call_reads=int(q.shape[0]))
    _phase_done("10c B2f, B12f; B13, B14 at the main paths' shapes")
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
