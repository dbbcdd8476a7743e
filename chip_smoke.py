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
  reads in the proportions of the bench's mixed-divergence traffic (95%
  at 2%, 5% at 15%, seed 11) drawn from the uniform graph's base: one
  banded tier, then the full-width fill for the reads it did not verify.
  (bench.py's own ``mixed_div`` configuration, with its own graph and the
  full ladder, runs in phase 14.)

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
  one 6b batch gave them, and prints the decode's steps and its longest
  read's (the chain's floor counts those);
* 6e aligns reads of a 45k-rank graph (past the JAX package's 1 MiB trace
  gate) on the default route, and again with ``POASTA_DEVICE_TRACE=0``:
  alignments must be equal, and every read traced on the device; the B18
  call with the most reads is timed again alone beside its bound (the
  size of the reference's streamed trace kernel B19).  Where B1's tier
  passes 10,752 lanes, its rows body is timed on the last such call and
  held against its plain version on one read.

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
* 8d holds B7, B8, B18 with ``free_start`` and the decode against their
  plain versions at the inputs 8b gave them (B8 and B18 on 8 reads of
  their calls: the plain versions take about a millisecond a rank
  whatever the batch; the decode on the whole widest call).

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
  9a-9c gave them, and B16's rows body at 9e's last one-read launch that
  took it.

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

Phase 11 runs the two TPU kernels that exist only past the reference's
1 MiB scalar-prefetch gate by their port counterparts, at their own sizes
(the card reads the rank tables from global memory at any size, so the port
has no streamed twin), each run with the launch counters zeroed just
before and read just after:

* 11a ``scripts/bigbanded_40k.py``'s regime for B11 ``_banded_kernel_big``
  (seed 23: a 40,000-base backbone with an edge ``v -> v+3`` every 977
  nodes, P = 2, and 64 reads of the whole backbone at 1%, ~40 kb):
  ``BatchMapper.score_batch`` twice, the user's path (tiers, placement,
  wall and device memory printed; no read may fall to the full fill),
  then B1 at the inputs ``score_batch`` gave it (the row's time and
  bound), timed on the 64 reads and held against its plain version on 2;
  then B1 on the script's fixed windows (``band_windows`` at ub 3200,
  an extra field of the row), timed on the 64 reads; those scores bound
  ``score_batch``'s from above, and reads 0-3 equal
  ``NativeAligner.align_banded``;
* 11b B9 ``_fill_kernel_bounded_big``'s: ``dp_fill_scores_ends_free``
  under the CLI's semi-global span on phase 8's graph (50,002 ranks, P 2)
  and 8a's 64 reads, one B4 launch at L 5,120, whose scores must equal
  8a's uncapped B7 scores; B4 is held against its plain version on 2
  reads, uncapped as the call launched it.

Phase 12 drives the mesh, single-controller over two entries of the one
card (``make_mesh(devices=[cuda:0, cuda:0], dp=2)``: the split, a launch a
shard and the gather, with the real kernels; two shards on one card are no
speed claim), each meshed call with the launch counters zeroed just before
and read just after, and every output held against the same call
unmeshed:

* 12a ``BatchMapper(graph, costs, mesh=...)`` on the uniform configuration:
  ``score_batch`` on the 1024 reads (the reference's mesh route, the
  sharded full fill: B2 a shard) equals phase 4's scores, and
  ``align_batch`` on 64 reads (the banded route: B1 a shard, printed per
  shard; the trace on cuda:0) equals the unmeshed alignments;
* 12b ``make_sharded_score_fn`` on 128 uniform reads (B2 a shard) and
  with the four free-flag pairs on phase 10c's 64 pieces of 1,000 bases
  (B2f a shard) equals ``dp_fill_scores``;
* 12c the pangenome configuration's 64 reads under the CLI's semi-global
  span: ``score_batch`` (B4 a shard over 50,002 ranks) equals 8a's
  scores, and the port's CLI under the mesh (a replica a shard: the
  capped B7 and the anchored trace on each entry) writes GAF byte-equal
  to ``--mesh off``;
* 12d two-piece ``score_batch`` on 64 uniform reads (B16 a shard) equals
  the unmeshed scores;
* 12e the sp demonstrator (dp = 1, sp = 2: the halo, gathered prefix-min
  and min over slabs in plain PyTorch, as the reference runs it as an XLA
  scan) on 64 uniform reads equals phase 4's scores, with its time;
* 12f ``lasagna align --distributed`` as two processes on the card (gloo
  on a free localhost port) over 256 uniform reads: the parts, merged in
  round-robin order, are byte-equal to the single-process GAF;
* 12g ``--mesh auto`` over every card where more than one is visible.

Phase 13 drives the mapping path at the size ``PERF.md`` gives for its
users, ``scripts/pangenome_200k.py``'s graph (seed 37: a 200,000-base
backbone with an edge ``v -> v+3`` every 500 nodes, 200,002 ranks, where
the seed index takes k 11) with 512 reads of 5,000 bases at 1.5%
(``scripts/pangenome_bigbatch.py``'s batch; the first 64 are the
script's), under the CLI's semi-global span, each run with the launch
counters zeroed just before and read just after; it prints the host time
of each stage (graph, ``post_process``, ``flatten``,
``DeviceGraph.build``, ``pack_queries``, ``KmerIndex``, the GFA written
and loaded) and its own time:

* 13a the script's probe on the first 64 reads: the uncapped full fill
  ``dp_fill_ends_free_with_ends`` (B7) gives the reference triple (score,
  end rank, end offset); ``_fill_ends_free_capped`` equals it; after
  ``_learn_seed_ub`` a warm-up and three timed ``_ends_free_scores``
  calls seed (B8 at k 11, ``seeded > 0``) and each equals it;
* 13b ``prescore`` and ``align_batch`` on the 64 through both routes:
  every read traced on the card and equal to the native host backtrace,
  every alignment costing its score; the widest B18 call's planes hold
  more than 2^31 int32 elements and a verified read's corridor lies wholly
  at ranks past element 2^31 (rank 131,072 at 64 reads x 256 lanes); the
  decode held against its plain version on those planes, B8 on its call's
  2 lowest reads; B18 and B7 timed at the path's inputs (their plain
  versions would walk 200,002 ranks in host-driven steps, minutes: here
  the uncapped and seeded fills and the native backtrace hold them, and
  8d holds them against their plain versions at 50,002 ranks);
* 13c the port's CLI, ``-m semi-global``, three times on the 512 reads:
  ``-j 512`` (one batch: the trace splits its 512 reads into the
  sub-batches ``tier_bytes_per_read`` and ``free_bytes`` give, asserted
  equal to the count of B18 launches at Wb 256 and at least 2), ``-j 64``
  (8 batches pipelined, the prescore worker seeding the next batch while
  the trace runs) and ``-j 512`` with ``POASTA_SEED=0``: the three GAF
  byte-equal, the first 64 ``AS:i`` equal to 13a's scores.

Phase 14 runs the port's bench entry, ``python -m
poasta_tpu_torch.bench``, as ``main([])`` in process at bench.py's sizes
(uniform scoring, the native host baseline, hybrid ``align_batch``,
mixed_div through the full ladder, mixed_len and ef_mixed_len on drifting
and shared windows, the pangenome's seeded semi-global ``align_batch``),
with every launch counter zeroed just before it and read after each
configuration.  It prints the entry's line as ``[bench] {...}`` and
checks it: every key of bench.py's recorded line (``BENCH_r05.json``) but
the int16 probe's, the port's five, no ``error``, ``seed_engaged`` true,
mixed_div's tiered retry engaged (more than one B1 tier a call: the full
ladder verifies its 15% tail in wider B1 tiers, so its B2 stays phase
4's).  It holds mixed_div's last timed call against
the same ladder with the plain versions and its 15% reads against
``NativeAligner.align_banded``, and every hybrid and pangenome alignment
against its score (the entry itself asserts bench.py's gates: the native
engine on 16 reads, hybrid scores, drift equal to shared windows).

The ``kernels`` line gives, for every kernel, its launches on the main
paths (phase 12's meshed calls and phase 14's configurations among them), its time and its plain version's at the main path's shapes, and
``bound_ms``: the least time the card could take for the same work, the
larger of the bytes the function must move (each input read once, each
output written once) over 3.35 TB/s and the integer operations its
recurrence needs (``RECURRENCE_OPS`` and the constants beside it: what the
function needs, not what the kernel spends) over the card's int32 rate
(``INT32_OPS_PER_S``).  No single PyTorch call computes any of these
recurrences, so ``library_ms`` is null throughout.  Each row of the banded
template (B1, B3, B5, B6, B16, B17 and B11) also gives, at its shape, the
body the plan chose, its threads, lanes a thread, barriers a rank (and at
a drift re-frame) and shared memory (``banded_fields``), and counts the
launches of its register body.  Each row of the full-fill template (B2,
B4, B7, B9, B12, B13, B14, B2f, B12f), of the trace fill (B18, both
forms, and B19's size) and of the seeded fill (B8) gives the same fields
at its shape (``fill_fields``), and ``redesigned`` where the plan chose
the register body (the trace and seeded fills have no other).  A main
path's launches that the plan sends to a rows body
(``banded_rows_kernel``: bands past the register body's 6,144-10,752
lanes; ``full_fill_rows_kernel``: rows past 8,192, 6,144 for B14) have
rows of their own: B16's one-read launches of 9e, and B1's of 6e where
its tier passes 10,752 lanes, each held against its plain version at the
last such call.  Phase 13 adds four rows of its size (B7 at 200,002 ranks,
B10's; B8 at k 11; B18 ``free_start`` at 200,002 ranks, B19's; the decode
past 2^31 plane elements) with their launches in phase 13's calls.
Every rows-body launch of the run, of either template, is counted, and
the script fails if one came from a path with no such row.

Any failure raises.  The last line is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.

Needs one card; imports no JAX.
"""

import contextlib
import inspect
import io
import json
import os
import random
import socket
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
# phase 11a: scripts/bigbanded_40k.py's shape (a 40,000-base backbone with
# an edge v -> v+3 every 977 nodes, 64 reads of the whole backbone at 1%)
# and its fixed windows (band_windows at ub 3200)
BB_SEED, BB_LEN, BB_EDGE_EVERY, BB_READS, BB_DIV, BB_UB = (23, 40000, 977,
                                                           64, 0.01, 3200)
B9_REPLACES = "poasta_tpu/ops/pallas_fill.py:816"
B11_REPLACES = "poasta_tpu/ops/pallas_fill.py:2202"
# phase 12f: lasagna align --distributed over this many uniform reads
DIST_READS = 256
# the plain versions walk every rank in host-driven steps whatever the
# batch: phases 11 and 13 hold each kernel against them on this many reads
BIG_PLAIN_READS = 2
# phase 13: scripts/pangenome_200k.py's graph (seed 37, a 200,000-base
# backbone with an edge v -> v+3 every 500 nodes) and, going on with the
# same generator, 512 reads (the batch scripts/pangenome_bigbatch.py calls
# lasagna-realistic) of 5,000 bases at 1.5%: the first 64 are the script's
P200_SEED, P200_LEN, P200_READS, P200_BATCH = 37, 200_000, 512, 64
# int32 elements past which a plane offset no longer fits in an int
PLANE_ELEMENTS_INT = 2 ** 31
B10_REPLACES = "poasta_tpu/ops/pallas_fill.py:1046"
B19_REPLACES = "poasta_tpu/ops/pallas_trace.py:387"


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


def backbone_graph(rng, n, every=PAN_EDGE_EVERY, times=None):
    """A linear graph of ``n`` random bases with an edge v -> v+3 every
    ``every`` nodes; returns (graph, base).  ``times``, a dict, receives
    the host seconds of the graph's construction and of ``post_process``."""
    from poasta_tpu_torch import POAGraph

    t0 = time.perf_counter()
    base = "".join(rng.choice("ACGT") for _ in range(n))
    graph = POAGraph()
    graph.add_alignment_with_weights("s0", base.encode(), None, [1] * n)
    for v in range(0, n - 3, every):
        graph.add_edge(v, v + 3, 0, 1)
    t1 = time.perf_counter()
    graph.post_process()
    if times is not None:
        times["POAGraph"] = t1 - t0
        times["post_process"] = time.perf_counter() - t1
    return graph, base


def pangenome_workload(seed=PAN_SEED, n=PAN_LEN, n_reads=PAN_READS,
                       read_len=PAN_READ_LEN, times=None):
    """bench.py's pangenome semi-global configuration (seed 17), with 256
    reads where the bench draws 64: the first 64 are the bench's.  Other
    arguments give the same construction at another seed and size: a
    backbone of ``n`` bases, then ``n_reads`` reads of ``read_len`` bases at
    1.5% drawn after it from the same generator.  ``times`` as in
    :func:`backbone_graph`."""
    rng = random.Random(seed)
    graph, base = backbone_graph(rng, n, times=times)
    reads = []
    for _ in range(n_reads):
        a = rng.randrange(0, n - read_len)
        reads.append(_mutate(rng, base[a:a + read_len], PAN_DIV).encode())
    return graph, reads


def pangenome_200k_workload(n=P200_LEN, n_reads=P200_READS,
                            read_len=PAN_READ_LEN, times=None):
    """scripts/pangenome_200k.py's configuration (seed 37, 200,000 bases)
    with 512 reads: the first 64 are the script's."""
    return pangenome_workload(P200_SEED, n, n_reads, read_len, times)


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
# One decode step, from the walk's rule (decode_plain): the lane (subtract, two
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


def walked_fields(res, r_begin, r_end, n_nodes):
    """A ranged trace fill's walked share (its reads' ranks over reads x
    ranks) and ``bound_walked_ms``: ``res``'s bound, which counts every
    rank's cells, scaled to the cells the ranges walk."""
    share = int((r_end.long() - r_begin.long() + 1).clamp(min=0).sum()) / (
        int(r_begin.shape[0]) * n_nodes)
    return {"walked_share": share,
            "bound_walked_ms": res["bound_ms"] * share}


def in_range(ptr, r_begin, r_end):
    """``ptr`` (Np, B, Wb) with each read's rows outside its rank range
    zeroed, as the plain trace fill leaves them: what B18's planes are
    compared on."""
    import torch

    r = torch.arange(ptr.shape[0], device=ptr.device).view(-1, 1)
    walked = (r >= r_begin.view(1, -1)) & (r <= r_end.view(1, -1))
    return torch.where(walked.unsqueeze(-1), ptr, 0)


# A plan's fields in the kernels line, for a row of either template.
PLAN_FIELDS = ("body", "threads", "lanes_per_thread", "barriers_per_rank",
               "smem_bytes", "placement")


def banded_fields(plan):
    """The kernels line's fields of a row of the banded template
    (csrc/banded_kernel.cu): its body, block shape, barriers a rank (a
    drift re-frame's apart) and shared memory at the row's shape."""
    fields = {k: plan[k] for k in PLAN_FIELDS}
    if "barriers_at_reframe" in plan:
        fields["barriers_at_reframe"] = plan["barriers_at_reframe"]
    fields["redesigned"] = (
        "for Hopper: lanes in registers, van Herk scan"
        if plan["body"] == "registers"
        else "for Hopper: van Herk scan over thread chunks, int4 passes")
    return fields


def fill_fields(plan):
    """The kernels line's fields of a row of the full-fill template
    (csrc/fill_kernel.cu), the trace fill (trace_kernel.cu) or the seeded
    fill (seed_kernel.cu), as banded_fields gives them for the banded
    rows."""
    fields = {k: plan[k] for k in PLAN_FIELDS}
    fields["redesigned"] = (
        "for Hopper: lanes in registers, van Herk scan"
        if plan["body"] == "registers"
        else "no: the first body, block_prefix_min")
    return fields


# The wrappers of the banded template, by row.  Each counts in
# ``rows_launches`` the launches its plan sent to the rows body
# (banded_rows_kernel): a kernel of its own, with rows of its own in the
# kernels line where a main path launches it.
BANDED_WRAPPERS = {"B1": "banded_end_rows", "B3": "drift_end_rows",
                   "B5": "ef_best_rows", "B6": "drift_ef_best_rows",
                   "B16": "banded_end_rows_2p", "B17": "drift_end_rows_2p"}
# Every rows-body launch of the run, by row (a patch of the launch, which
# no phase zeroes); those of main paths that a rows-body row of the
# kernels line reports; and the script's own (that row's comparison and
# timing).  main() fails unless the first is the sum of the others: no
# rows-body launch goes unchecked.
ROWS_SEEN, ROWS_MAIN, ROWS_OWN = {}, {}, {}
# The rows-body rows of the kernels line, by row: the comparison, time and
# bound of a main path's rows-body launch at its own shape.
ROWS_RESULTS = {}
ROWS_KERNELS = {"B1": "banded_rows_kernel<global>",
                "B16": "banded_rows_kernel<two-piece>"}
# The wrappers of the full-fill template, by row: their rows-body launches
# (full_fill_rows_kernel: rows past 8,192 lanes, 6,144 for B14) are
# audited the same way.
FILL_WRAPPERS = {"B2": "fill_end_rows", "B4": "bounded_best_rows",
                 "B7": "bounded_end_rows", "B12": "fill_end_rows_2p",
                 "B13": "bounded_best_rows_2p", "B14": "bounded_end_rows_2p",
                 "B2f": "free_fill_rows", "B12f": "free_fill_rows_2p"}


def _count_rows_launches(cf):
    """Patches of ``cf._launch_variant`` and ``cf._launch_full_fill`` that
    add each rows-body launch to ROWS_SEEN."""
    real_variant, real_fill = cf._launch_variant, cf._launch_full_fill
    names = {getattr(cf, w): b for b, w in {**BANDED_WRAPPERS,
                                            **FILL_WRAPPERS}.items()}

    def seen(wrapper, before):
        b = names[wrapper]
        ROWS_SEEN[b] = ROWS_SEEN.get(b, 0) + wrapper.rows_launches - before

    def variant_launch(variant, wrapper, *args, **kwargs):
        before = wrapper.rows_launches
        out = real_variant(variant, wrapper, *args, **kwargs)
        seen(wrapper, before)
        return out

    def fill_launch(wrapper, *args, **kwargs):
        before = wrapper.rows_launches
        out = real_fill(wrapper, *args, **kwargs)
        seen(wrapper, before)
        return out
    return [mock.patch.object(cf, "_launch_variant", variant_launch),
            mock.patch.object(cf, "_launch_full_fill", fill_launch)]


@contextlib.contextmanager
def _own_rows_launches():
    """Books the rows-body launches made inside the block to ROWS_OWN."""
    before = dict(ROWS_SEEN)
    yield
    for b, n in ROWS_SEEN.items():
        ROWS_OWN[b] = ROWS_OWN.get(b, 0) + n - before.get(b, 0)


def _check_rows_launches():
    """Fails unless every rows-body launch was a main path's with a row of
    its own, or that row's check."""
    for b, n in ROWS_SEEN.items():
        main_n = sum(ROWS_MAIN.get(b, {}).values())
        if n != main_n + ROWS_OWN.get(b, 0):
            raise AssertionError(
                f"{b}: {n} rows-body launches, {main_n} on main paths with a "
                f"rows-body row and {ROWS_OWN.get(b, 0)} of their checks: a "
                "path sent a band to the rows body with no row to hold it")


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


def _compare(name, kernel_fn, plain_fn, card, reps=5, view=None):
    """Kernel against plain version on the same inputs: raw rows must be
    equal (``view``, where given, picks from both outputs what is
    compared); returns the measured numbers.  The kernel's checking call is
    its warm-up; the plain version (seconds of host-driven torch ops, no
    compile step) is called once, and that call is the one timed."""
    import torch

    got = kernel_fn()
    kept = []
    plain_ms = _time_ms(lambda: kept.append(plain_fn()), 1)
    ref = kept[0]
    if view is not None:
        got, ref = view(got), view(ref)
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
    rows_audit = _count_rows_launches(cf)
    for patch in rows_audit:
        patch.start()

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
    plan = cf.banded_plan(g_dg.window, p["width"], p["margin"])
    print(f"[kernels] B1 main path: {int(q.shape[0])} reads, Lq "
          f"{int(q.shape[1])}, Wb {p['width']}, margin {p['margin']}, "
          f"max_run {max_run}, plan {plan}", flush=True)
    results["B1"] = _compare(
        "B1 main path", lambda: cf.banded_end_rows(g_dg, q, c, p, max_run),
        lambda: cf.banded_end_rows_plain(g_dg, q, c, p, max_run), card,
        reps=3)
    results["B1"].update(fill_bound(
        g_dg, int(q.shape[0]), p["width"], int(q.shape[1]), p["width"],
        tilted=True, table_cols=1 + int(g_dg.pred_slots.shape[1])),
        max_run=max_run, **banded_fields(plan))
    g_dg, q, c = captured[("mixed", "B2")]
    plan = cf.fill_plan(g_dg.window, int(q.shape[1]))
    print(f"[kernels] B2 main path (mixed tail): {int(q.shape[0])} reads, L "
          f"{int(q.shape[1])}, plan {plan}", flush=True)
    results["B2"] = _compare(
        "B2 main path", lambda: cf.fill_end_rows(g_dg, q, c),
        lambda: cf.fill_end_rows_plain(g_dg, q, c), card, reps=3)
    results["B2"].update(fill_bound(
        g_dg, int(q.shape[0]), int(q.shape[1]), int(q.shape[1]),
        int(q.shape[1]), tilted=False), **fill_fields(plan))

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
    pan_results, pan_launches, pan_workload, pan_state = pangenome_phases(
        card, dev, costs)

    # ---- 9. two-piece costs under the global span --------------------------
    tp_results, tp_launches = two_piece_phases(card, dev, graph, reads, base)

    # ---- 10. two-piece costs under ends-free spans; free graph ends ---------
    ef2_results, ef2_launches = ends_free_two_piece_phases(
        card, dev, graph, reads, *pan_workload)

    # ---- 11. B9 and B11 at their own sizes ---------------------------------
    big_results, big_launches = big_phases(card, dev, costs,
                                           pan_workload[1], pan_state)

    # ---- 12. the mesh and --distributed ------------------------------------
    mesh_launches = mesh_phases(card, dev, costs, graph, reads, scores,
                                pan_workload, pan_state)

    # ---- 13. the mapping path at 200,000 nodes -----------------------------
    scale_results, scale_launches = scale_phases(card, dev, costs)

    # ---- 14. the port's bench entry ----------------------------------------
    bench_launches = bench_phase(card, costs)

    def mesh_calls(name):
        """A kernel's launches in each meshed call that used it."""
        return {call: n[name] for call, n in mesh_launches.items()
                if n.get(name)}

    def bench_calls(name):
        """A kernel's launches in each configuration of the bench entry
        (phase 14) that used it."""
        return {f"bench {cfg}": n[name] for cfg, n in bench_launches.items()
                if n.get(name)}

    def by_call(name):
        """A fill kernel's launches in each main-path call that used it."""
        i = {"B1": 0, "B2": 1}.get(name)
        calls = {} if i is None else {
            "score_batch uniform": counts["uniform"][i],
            "scores mixed max_retries=1": counts["mixed"][i],
            "lasagna align uniform": lasagna["launches"][i]}
        calls.update({call: n[name] for call, n in ef_launches.items()})
        calls.update(mesh_calls(name))
        calls.update(bench_calls(name))
        return {call: n for call, n in calls.items() if n}

    def fill_entry(name, kernel, source, replaces):
        calls = by_call(name)
        if not calls:
            raise AssertionError(f"{name} launched on no main path")
        return {"name": kernel, "route": "cuda",
                "source": f"poasta_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": sum(calls.values()),
                "launches_by_call": calls, **results[name]}

    # the trace fill's launches in the bench: global in hybrid, free_start
    # in pangenome
    hybrid_bench = {k: bench_launches.get("hybrid", {}).get(k, 0)
                    for k in ("B18", "decode")}
    pan_bench = {k: bench_launches.get("pangenome", {}).get(k, 0)
                 for k in ("B7", "B8", "B18", "decode")}
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
         "replaces": B18_REPLACES,
         "launches": lasagna["launches"][2] + hybrid_bench["B18"],
         "launches_by_call": {"lasagna align uniform": lasagna["launches"][2],
                              "bench hybrid": hybrid_bench["B18"]},
         **trace_results["B18"],
         "past_the_gate_6e": trace_results["B19"]},
        {"name": "decode_warp_kernel", "route": "cuda",
         "source": "poasta_tpu_torch/csrc/decode_kernel.cu",
         "replaces": DECODE_REPLACES,
         "launches": (lasagna["launches"][3] + pan_launches["decode"]
                      + hybrid_bench["decode"] + pan_bench["decode"]),
         "launches_by_call": {
             "lasagna align uniform": lasagna["launches"][3],
             "lasagna align -m semi-global pangenome":
                 pan_launches["decode"],
             "bench hybrid": hybrid_bench["decode"],
             "bench pangenome": pan_bench["decode"]},
         **trace_results["decode"],
         "pangenome_8d": pan_results["decode"]},
        {"name": "full_fill_kernel<bounded, ends>", "route": "cuda",
         "source": f"poasta_tpu_torch/csrc/{full}", "replaces": B7_REPLACES,
         "launches": (pan_launches["B7"] + sum(mesh_calls("B7").values())
                      + pan_bench["B7"]),
         "launches_by_call": {
             "lasagna align -m semi-global pangenome": pan_launches["B7"],
             **mesh_calls("B7"), "bench pangenome": pan_bench["B7"]},
         **pan_results["B7"]},
        {"name": "seed_fill_kernel", "route": "cuda",
         "source": "poasta_tpu_torch/csrc/seed_kernel.cu",
         "replaces": B8_REPLACES,
         "launches": pan_launches["B8"] + pan_bench["B8"],
         "launches_by_call": {
             "lasagna align -m semi-global pangenome": pan_launches["B8"],
             "bench pangenome": pan_bench["B8"]},
         **pan_results["B8"]},
        {"name": "trace_kernel<free_start>", "route": "cuda",
         "source": "poasta_tpu_torch/csrc/trace_kernel.cu",
         "replaces": B18_REPLACES,
         "launches": pan_launches["B18"] + pan_bench["B18"],
         "launches_by_call": {
             "lasagna align -m semi-global pangenome": pan_launches["B18"],
             "bench pangenome": pan_bench["B18"]},
         **pan_results["B18"]},
    ]
    for name, kernel, source, replaces in (
            ("B12", "full_fill_kernel<two-piece>", full, B12_REPLACES),
            ("B16", "banded_kernel<two-piece>", banded, B16_REPLACES),
            ("B17", "banded_kernel<drift, two-piece>", banded,
             B17_REPLACES)):
        calls = {call: n[name] for call, n in tp_launches.items() if n[name]}
        calls.update(mesh_calls(name))
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
        calls.update(mesh_calls(name))
        kernels.append({"name": kernel, "route": "cuda",
                        "source": f"poasta_tpu_torch/csrc/{full}",
                        "replaces": replaces,
                        "launches": sum(calls.values()),
                        "launches_by_call": calls, **ef2_results[name]})
    for name, kernel, source, replaces in (
            ("B9", "full_fill_kernel<bounded> at 50,002 ranks", full,
             B9_REPLACES),
            ("B11", "banded_kernel<global> at 40k ranks x 40 kb reads", banded,
             B11_REPLACES)):
        calls = big_launches[name]
        kernels.append({"name": kernel, "route": "cuda",
                        "source": f"poasta_tpu_torch/csrc/{source}",
                        "replaces": replaces,
                        "launches": sum(calls.values()),
                        "launches_by_call": calls, **big_results[name]})
    for name, key, kernel, source, replaces in (
            ("B10", "B7", "full_fill_kernel<bounded, ends> at 200,002 ranks "
             "(B10's size)", full, B10_REPLACES),
            ("B8", "B8", "seed_fill_kernel at k 11 over 200,002 ranks",
             "seed_kernel.cu", B8_REPLACES),
            ("B19", "B18", "trace_kernel<free_start> at 200,002 ranks (B19's "
             "size)", "trace_kernel.cu", B19_REPLACES),
            ("decode", "decode", "decode_warp_kernel past 2^31 plane "
             "elements", "decode_kernel.cu", DECODE_REPLACES)):
        calls = {call: n[key] for call, n in scale_launches.items() if n[key]}
        kernels.append({"name": kernel, "route": "cuda",
                        "source": f"poasta_tpu_torch/csrc/{source}",
                        "replaces": replaces,
                        "launches": sum(calls.values()),
                        "launches_by_call": calls, **scale_results[name]})
    replaces = {"B1": B1_REPLACES, "B16": B16_REPLACES}
    for name, res in ROWS_RESULTS.items():
        calls = ROWS_MAIN[name]
        kernels.append({"name": ROWS_KERNELS[name], "route": "cuda",
                        "source": f"poasta_tpu_torch/csrc/{banded}",
                        "replaces": replaces[name],
                        "launches": sum(calls.values()),
                        "launches_by_call": calls, **res})
    for patch in rows_audit:
        patch.stop()
    _check_rows_launches()
    print(f"[kernels] rows-body launches: {ROWS_SEEN}, on main paths "
          f"{ROWS_MAIN}, their checks {ROWS_OWN}", flush=True)
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


def _decode_fields(dec_k, walk, card):
    """The decode's bound and launch shape on the inputs ``dec_k`` walks
    (``walk``: its arguments after the planes): one dependent chain a
    read, its steps counted from this run's step words (the longest
    read's steps set the chain's floor)."""
    from poasta_tpu_torch.ops import trace as tr

    pred_ranks, wstarts, active = walk[0], walk[1], walk[-2]
    B, Np = (int(n) for n in wstarts.shape)
    ops = dec_k()[0]
    per_read = (ops != 0).sum(dim=1)
    steps, longest = int(per_read.sum()), int(per_read.max())
    plan = tr.decode_plan(B, int(pred_ranks.shape[0]) // Np)
    print(f"[kernels] decode: {steps} steps over {int(active.sum())} of {B} "
          f"reads, the longest read's {longest}; plan {plan}  [{card}]",
          flush=True)
    return {**_bound(DECODE_BYTES * steps, DECODE_OPS * steps),
            "steps": steps, "longest_read_steps": longest,
            "warps_per_block": plan["warps_per_block"],
            "reads_per_warp": plan["reads_per_warp"]}


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
    from poasta_tpu_torch.aligner import banded as banded_mod
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
                 free_start=False, r_begin=None, r_end=None):
        # the global span: every rank walked, no range to keep
        captured.setdefault("fill", (g_dg, dict(
            qpad=qpad, wstarts=wstarts, anchor_r=anchor_r,
            anchor_j=anchor_j), c, Wb))
        return real_fill(g_dg, qpad, wstarts, anchor_r, anchor_j, c, Wb,
                         free_start, r_begin, r_end)

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
        per_rank=TRACE_OPS, table_cols=n_reads),
        **fill_fields(tr.trace_plan(g_dg.window, Wb)))
    results["decode"].update(_decode_fields(dec_k, walk, card))

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
    # B1's launches that the plan sends to the rows body (bands past
    # 10,752 lanes), and the last such call
    b1_rows, real_b1 = [], banded_mod.banded_scores

    def rec_b1(g_dg, q, ln, c, p, max_run=0):
        if cf.banded_plan(g_dg.window, p["width"],
                          p["margin"])["body"] == "rows":
            b1_rows[:] = [(g_dg, q, c, p, max_run)]
        return real_b1(g_dg, q, ln, c, p, max_run=max_run)

    cf.banded_end_rows.rows_launches = 0
    with mock.patch.object(banded_mod, "banded_scores", rec_b1):
        t0 = time.perf_counter()
        token = b_mapper.prescore(b_reads)
        torch.cuda.synchronize()
        score_s = time.perf_counter() - t0
        if token is None:
            raise AssertionError("the 45k-rank batch did not take the banded "
                                 "route")
        before = tr.trace_fill.launches
        big_calls = []
        real_trace = tr._launch_trace

        def keep_trace(*args, **kwargs):
            big_calls.append((args, kwargs))
            return real_trace(*args, **kwargs)

        with mock.patch.object(tr, "_launch_trace", keep_trace):
            route_s = _align_routes(b_mapper, b_reads, token)
    b1_rows_n = cf.banded_end_rows.rows_launches
    if tr.trace_fill.launches <= before:
        raise AssertionError("B18 never launched on the 45k-rank graph")
    if b1_rows_n:
        # held against its plain version on one read (the plain version
        # walks the 45k ranks in host-driven steps), timed on the call
        g_dg, q, c, p, mr = b1_rows[0]
        plan = cf.banded_plan(g_dg.window, p["width"], p["margin"])
        q1 = q[:1].contiguous()
        with _own_rows_launches():
            ms = _time_ms(lambda: cf.banded_end_rows(g_dg, q, c, p, mr), 3)
            res = _compare(
                "B1 rows body at 6e's tier, 1 read",
                lambda: cf.banded_end_rows(g_dg, q1, c, p, mr),
                lambda: cf.banded_end_rows_plain(g_dg, q1, c, p, mr), card,
                reps=3)
        res.update(
            reads_compared=1, ms_compared=res["ms"], ms=ms,
            shape=[int(q.shape[0]), p["width"]], max_run=mr,
            ranks=g_dg.n_nodes, **banded_fields(plan),
            **fill_bound(g_dg, int(q.shape[0]), p["width"], int(q.shape[1]),
                         p["width"], tilted=True,
                         table_cols=1 + int(g_dg.pred_slots.shape[1])))
        if res["body"] != "rows":
            raise AssertionError(f"6e B1 rows body: plan {plan}")
        print(f"[big] 6e B1 rows body: {ms:.3f} ms for {int(q.shape[0])} "
              f"reads at Wb {p['width']}, max_run {mr}, plan {plan} (bound "
              f"{res['bound_ms']:.3f} ms)  [{card}]", flush=True)
        ROWS_RESULTS["B1"] = res
        ROWS_MAIN["B1"] = {"6e prescore and align, 45k-rank graph": b1_rows_n}
    # B18 past the reference's gate (its streamed twin B19's size): the
    # call with the most reads again, timed alone (timing only: the counted
    # runs compare B18 in 6d and 8d), and its bound
    sig = inspect.signature(tr._launch_trace)
    bound = [sig.bind(*a, **k).arguments for a, k in big_calls]
    largest = max(bound, key=lambda b: (b["qpad"].shape[0], b["Wb"]))
    g_dg, qpad, Wb = largest["dg"], largest["qpad"], largest["Wb"]
    n_reads = int(qpad.shape[0])
    results["B19"] = {"ms": _time_ms(lambda: tr.trace_fill(**largest), 3),
                      "timing_only": True,
                      "reads": n_reads, "Wb": Wb, "ranks": g_dg.n_nodes,
                      **fill_bound(g_dg, n_reads, Wb, int(qpad.shape[1]),
                                   g_dg.n_nodes * Wb + 1, tilted=True,
                                   per_pred=TRACE_PRED_OPS,
                                   per_rank=TRACE_OPS, table_cols=n_reads),
                      **fill_fields(tr.trace_plan(g_dg.window, Wb))}
    print(f"[big] {b_mapper.dg.n_nodes} ranks (Np {b_mapper.dg.n_nodes_padded}"
          f"), {BIG_READS} reads of {min(map(len, b_reads))}-"
          f"{max(map(len, b_reads))}: scoring {score_s:.2f} s; device trace "
          f"{route_s['device']:.3f} s ({tr.trace_fill.launches - before} B18 "
          f"launches), native host backtrace {route_s['host']:.3f} s on "
          f"{os.cpu_count()} cores; alignments equal; B1 rows-body launches "
          f"{b1_rows_n}; the largest B18 call "
          f"({n_reads} reads, Wb {Wb}) {results['B19']['ms']:.3f} ms, bound "
          f"{results['B19']['bound_ms']:.3f} ms  [{card}]", flush=True)
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
        prep["width"], tilted=True, table_cols=3 + P), max_run=mr,
        **banded_fields(plan))

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
        table_cols=4 + P), max_run=mr, **banded_fields(plan))

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
        table_cols=2 + P), max_run=mr, **banded_fields(plan))

    _, (dg, q, ln, c, fs, end_ok, jlo), kw = captured["B4"]
    mr = kw.get("max_run", 0)
    L = int(q.shape[1])
    plan = cf.bounded_plan(dg.window, L, max_run=mr)
    print(f"[kernels] B4 main path (the fragments' tail): {int(q.shape[0])} "
          f"reads, L {L}, free_start {fs}, max_run {mr}, plan {plan}",
          flush=True)
    results["B4"] = _compare(
        "B4 main path",
        lambda: cf.bounded_best_rows(dg, q, c, fs, end_ok, mr),
        lambda: cf.bounded_best_rows_plain(dg, q, c, fs, end_ok, mr), card,
        reps=3)
    results["B4"].update(fill_bound(
        dg, int(q.shape[0]), L, L, L, tilted=False,
        per_rank=RECURRENCE_OPS + int(end_ok.sum()) / dg.n_nodes,
        table_cols=1), **fill_fields(plan))
    _phase_done("7d B3-B6 at the main paths' shapes")
    return results, launches


def pangenome_phases(card, dev, costs):
    """Phases 8a-8d; returns (kernel comparisons of B7, B8, B18 with
    ``free_start`` and the decode, their launches in the CLI run of 8b, the
    workload, and what phase 11b reuses: the graph's device layout, 8a's
    uncapped B7 triple of its batch, the cap of 8b's B7 call)."""
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
            "B18": tr._launch_trace, "decode": tr._launch_decode}

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
            mock.patch.object(tr, "_launch_trace", keep("B18")), \
            mock.patch.object(tr, "_launch_decode", keep("decode", 2)):
        zero()
        on_main_path[0] = True
        dev_s, dev_gaf = cli("dev.gaf")
        on_main_path[0] = False
        launches = read()
    traced = sum(ef["device_traced"] for ef, _ in per_batch)
    print(f"[lasagna] pangenome, -m semi-global -j {PAN_BATCH}, "
          f"{len(per_batch)} batches: {PAN_READS / dev_s:.2f} reads/s "
          f"({dev_s:.2f} s wall, GFA load to last GAF line), device traced "
          f"{traced} of {PAN_READS}, per batch traced "
          f"{[ef['device_traced'] for ef, _ in per_batch]}"
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
    plan = cf.bounded_plan(g_dg.window, L, ends=True, max_run=max_run)
    print(f"[kernels] B7 main path: {int(q.shape[0])} reads, L {L}, "
          f"{g_dg.n_nodes} ranks, free_start {fs}, max_run {max_run}, plan "
          f"{plan}", flush=True)
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
        table_cols=1), **fill_fields(plan))

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
                         whole_call_ms=full_ms,
                         **fill_fields(sd.seed_plan(g_dg.window, Wb)))

    _, args, kwargs = captured["B18"]
    g_dg, qpad, wst, ar, aj, c, Wb, fs, rb, re = args
    if not fs or rb is None:
        raise AssertionError("8d: the path's trace ran without free_start "
                             "or walked every rank")
    # the plain version walks the ranks at about a millisecond each
    # whatever the batch, and holds planes of its own: the first 8 reads of
    # the call, over their rank ranges; compared on aval and the rows each
    # read walks
    keep8 = slice(0, 8)
    inp = {k: v[keep8].contiguous() for k, v in (
        ("qpad", qpad), ("wstarts", wst), ("anchor_r", ar), ("anchor_j", aj),
        ("r_begin", rb), ("r_end", re))}
    walked = int((re - rb + 1).sum()) / (int(qpad.shape[0]) * g_dg.n_nodes)
    print(f"[trace] pangenome main path: {int(qpad.shape[0])} reads in the "
          f"call, compared and timed on its first 8 (ranks "
          f"{int(inp['r_begin'].min())}-{int(inp['r_end'].max())}); walked "
          f"share of the call's ranks {walked:.4f}; LQ {int(qpad.shape[1])}"
          f", Wb {Wb}, free_start {fs}, plan "
          f"{tr.trace_plan(g_dg.window, Wb)}", flush=True)
    results["B18"] = _compare(
        "B18 free_start main path (first 8 reads, their ranges)",
        lambda: tr.trace_fill(g_dg, **inp, costs=c, Wb=Wb, free_start=True),
        lambda: tr.trace_fill_plain(g_dg, **inp, costs=c, Wb=Wb,
                                    free_start=True), card, reps=3,
        view=lambda out: (out[0], in_range(
            out[1], inp["r_begin"], inp["r_end"])))
    results["B18"].update(fill_bound(
        g_dg, 8, Wb, int(qpad.shape[1]), g_dg.n_nodes * Wb + 1, tilted=True,
        per_pred=TRACE_PRED_OPS, per_rank=TRACE_OPS, table_cols=8),
        **fill_fields(tr.trace_plan(g_dg.window, Wb)))
    results["B18"].update(walked_fields(results["B18"], inp["r_begin"],
                                        inp["r_end"], g_dg.n_nodes))
    print(f"[kernels] B18 free_start main path, first 8 reads: walked share "
          f"{results['B18']['walked_share']:.4f}; bound "
          f"{results['B18']['bound_ms']:.3f} ms over every rank's cells, "
          f"{results['B18']['bound_walked_ms']:.3f} ms over the walked ones "
          f" [{card}]", flush=True)
    results["B18"]["reads_compared"] = 8

    # the decode at the widest call's inputs (the planes of that call's
    # B18, walked from the reads' end states)
    _, (ptr, *walk), _ = captured["decode"]
    print(f"[trace] pangenome decode main path: {int(ptr.shape[1])} reads, "
          f"Wb {int(ptr.shape[2])}, t_max {walk[-1]}", flush=True)
    def dec_k():
        return tr.trace_decode(ptr, *walk)

    results["decode"] = _compare(
        "decode pangenome main path", dec_k,
        lambda: tr.decode_plain(ptr, *walk), card, reps=5)
    results["decode"].update(_decode_fields(dec_k, walk, card))
    del ptr, dec_k
    captured.pop("decode")
    _phase_done("8d B7, B8, B18 free_start, the decode at the main path's "
                "shapes")
    # phase 11b runs B4 over this graph on 8a's batch
    return results, launches, (graph, reads), {
        "dg": dg, "flat": flat, "batch_exact": exact}


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
        # the widest batch of the main-path calls (the last such call);
        # apart, B16's last call that the plan sends to the rows body
        def rec(*args, **kwargs):
            B = int(args[1].shape[0])
            if on_main_path[0] and B >= captured.get(name, (0,))[0]:
                captured[name] = (B, args, kwargs)
            if on_main_path[0] and name == "B16" and cf.banded_plan(
                    args[0].window, args[4]["width"], args[4]["margin"],
                    True)["body"] == "rows":
                captured["B16 rows"] = (B, args, kwargs)
            return fn(*args, **kwargs)
        return rec

    def zero():
        for k in fills.values():
            k.launches = 0
        for name in ("B16", "B17"):
            fills[name].rows_launches = 0
        on_main_path[0] = True

    def read(call):
        # the banded rows count register-body launches; "B16 rows" and
        # "B17 rows" the rows body's
        on_main_path[0] = False
        launches[call] = {name: k.launches for name, k in fills.items()}
        for name in ("B16", "B17"):
            launches[call][f"{name} rows"] = fills[name].rows_launches
            launches[call][name] -= fills[name].rows_launches
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
    plan = cf.banded_plan(dg.window, prep["width"], prep["margin"], True)
    print(f"[kernels] B16 main path: {int(q.shape[0])} reads, Lq "
          f"{int(q.shape[1])}, Wb {prep['width']}, margin {prep['margin']}, "
          f"max_run {mr}, plan {plan}", flush=True)
    results["B16"] = _compare(
        "B16 main path", lambda: cf.banded_end_rows_2p(dg, q, c, prep, mr),
        lambda: cf.banded_end_rows_2p_plain(dg, q, c, prep, mr), card,
        reps=3)
    results["B16"].update(fill_bound(
        dg, int(q.shape[0]), prep["width"], int(q.shape[1]), prep["width"],
        tilted=False, per_pred=PRED_OPS_2P, per_rank=RECURRENCE_OPS_2P,
        table_cols=1 + P), max_run=mr, **banded_fields(plan))

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
        per_rank=RECURRENCE_OPS_2P, table_cols=3 + P), max_run=mr,
        **banded_fields(plan))

    # B16's rows body (bands past the register body's 8,192 lanes): the
    # MSA assist's one-read launches on 9e's growing graph, its last one
    rows_calls = {call: n["B16 rows"] for call, n in launches.items()
                  if n["B16 rows"]}
    if rows_calls:
        _, (dg, q, ln, c, prep), kw = captured["B16 rows"]
        mr = kw.get("max_run", 0)
        P = int(dg.pred_slots.shape[1])
        plan = cf.banded_plan(dg.window, prep["width"], prep["margin"], True)
        print(f"[kernels] B16 rows body (9e's last such launch): "
              f"{int(q.shape[0])} read, {dg.n_nodes} ranks, Lq "
              f"{int(q.shape[1])}, Wb {prep['width']}, margin "
              f"{prep['margin']}, max_run {mr}, plan {plan}", flush=True)
        with _own_rows_launches():
            res = _compare(
                "B16 rows body",
                lambda: cf.banded_end_rows_2p(dg, q, c, prep, mr),
                lambda: cf.banded_end_rows_2p_plain(dg, q, c, prep, mr), card,
                reps=3)
        res.update(fill_bound(
            dg, int(q.shape[0]), prep["width"], int(q.shape[1]),
            prep["width"], tilted=False, per_pred=PRED_OPS_2P,
            per_rank=RECURRENCE_OPS_2P, table_cols=1 + P), max_run=mr,
            ranks=dg.n_nodes, **banded_fields(plan))
        if res["body"] != "rows":
            raise AssertionError(f"B16 rows body: plan {plan}")
        ROWS_RESULTS["B16"], ROWS_MAIN["B16"] = res, rows_calls

    _, (dg, q, ln, c), _ = captured["B12"]
    L = int(q.shape[1])
    plan = cf.fill_plan(dg.window, L, two_piece=True)
    print(f"[kernels] B12 main path (the mixed tail): {int(q.shape[0])} reads,"
          f" L {L}, plan {plan}", flush=True)
    results["B12"] = _compare(
        "B12 main path", lambda: cf.fill_end_rows_2p(dg, q, c),
        lambda: cf.fill_end_rows_2p_plain(dg, q, c), card, reps=3)
    results["B12"].update(fill_bound(
        dg, int(q.shape[0]), L, L, L, tilted=False, per_pred=PRED_OPS_2P,
        per_rank=RECURRENCE_OPS_2P), **fill_fields(plan))
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
        plan = cf.bounded_plan(u_dg.window, L, two_piece=two)
        results[name].update(fill_bound(
            u_dg, int(qf.shape[0]), L, L, L, tilted=False,
            per_pred=PRED_OPS_2P if two else PRED_OPS,
            per_rank=(RECURRENCE_OPS_2P if two else RECURRENCE_OPS)
            + int(mask.sum()) / u_dg.n_nodes, table_cols=1),
            **fill_fields(plan))
        print(f"[kernels] {name}: plan {plan}", flush=True)

    _, (g_dg, q, c, fs, end_ok, max_run), _ = captured["B13"]
    L = int(q.shape[1])
    plan = cf.bounded_plan(g_dg.window, L, two_piece=True, max_run=max_run)
    print(f"[kernels] B13 main path (10a): {int(q.shape[0])} reads, L {L}, "
          f"{g_dg.n_nodes} ranks, free_start {fs}, max_run {max_run}, "
          f"{int(end_ok.sum())} permitted ranks, plan {plan}", flush=True)
    results["B13"] = _compare(
        "B13 main path",
        lambda: cf.bounded_best_rows_2p(g_dg, q, c, fs, end_ok, max_run),
        lambda: cf.bounded_best_rows_2p_plain(g_dg, q, c, fs, end_ok,
                                              max_run), card, reps=3)
    results["B13"].update(fill_bound(
        g_dg, int(q.shape[0]), L, L, L, tilted=False, per_pred=PRED_OPS_2P,
        per_rank=RECURRENCE_OPS_2P + int(end_ok.sum()) / g_dg.n_nodes,
        table_cols=1), **fill_fields(plan))

    _, (g_dg, q, c, fs, end_ok, max_run), _ = captured["B14"]
    L = int(q.shape[1])
    full_ms = _time_ms(lambda: cf.bounded_end_rows_2p(g_dg, q, c, fs, end_ok,
                                                      max_run), 3)
    # the plain version walks 50k ranks at about a millisecond each whatever
    # the batch: the first 8 reads of the call
    q8 = q[:8].contiguous()
    plan = cf.bounded_plan(g_dg.window, L, ends=True, two_piece=True,
                           max_run=max_run)
    print(f"[kernels] B14 main path (10b): {int(q.shape[0])} reads in the "
          f"call ({full_ms:.3f} ms), compared and timed on its first 8; L {L},"
          f" {g_dg.n_nodes} ranks, free_start {fs}, max_run {max_run}, plan "
          f"{plan}", flush=True)
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
                          whole_call_reads=int(q.shape[0]),
                          **fill_fields(plan))
    _phase_done("10c B2f, B12f; B13, B14 at the main paths' shapes")
    return results, launches


def big_phases(card, dev, costs, pan_reads, pan):
    """Phases 11a-11b: the reference's two kernels that exist only past its
    scalar-prefetch gate, run by their port counterparts at their own sizes
    (B11 by B1, B9 by B4); returns (their kernel rows, their launches on
    each phase's main path)."""
    import numpy as np
    import torch

    from poasta_tpu_torch import (
        UNBOUNDED,
        BatchMapper,
        DeviceGraph,
        EndsFree,
        NativeAligner,
        included,
        pack_queries,
    )
    from poasta_tpu_torch.aligner import banded as banded_mod
    from poasta_tpu_torch.aligner import wavefront as wavefront_mod
    from poasta_tpu_torch.ops import cuda_fill as cf

    results, launches = {}, {}
    # ---- 11a. B11's target regime: 40k ranks x 40 kb reads ----------------
    t0 = time.perf_counter()
    rng = random.Random(BB_SEED)
    graph, base = backbone_graph(rng, BB_LEN, BB_EDGE_EVERY)
    reads = [_mutate(rng, base, BB_DIV).encode() for _ in range(BB_READS)]
    host = {"graph and reads": time.perf_counter() - t0}
    t0 = time.perf_counter()
    flat = graph.flatten()
    host["flatten"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    dg = DeviceGraph.build(flat, device=dev)
    host["DeviceGraph.build"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    q, ln = pack_queries(reads, device=dev)
    torch.cuda.synchronize()
    host["pack_queries"] = time.perf_counter() - t0
    lens = ln.cpu().numpy()
    L = int(q.shape[1])
    print(f"[big] 11a graph: {flat.n_nodes} ranks (Np {dg.n_nodes_padded}), W "
          f"{dg.window}, P {int(dg.pred_slots.shape[1])}; {BB_READS} reads of "
          f"{int(lens.min())}-{int(lens.max())}, L {L}; host s "
          f"{ {k: round(v, 3) for k, v in host.items()} }", flush=True)

    # the user's path: score_batch, twice (the first learns the ub); B1's
    # inputs (the last call's) are kept so that its row is taken at the
    # path's own shape
    tiers, b1_call = [], []
    real_banded = banded_mod.banded_scores

    def rec_banded(g_dg, q_, ln_, c, p, max_run=0):
        tiers.append((int(q_.shape[0]), p["width"], p["margin"], max_run))
        b1_call[:] = [(g_dg, q_, c, p, max_run)]
        return real_banded(g_dg, q_, ln_, c, p, max_run=max_run)

    mapper = BatchMapper(graph, costs, device=dev)
    walls, stats = [], []
    mem0 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with mock.patch.object(banded_mod, "banded_scores", rec_banded):
        cf.banded_end_rows.launches = 0
        cf.fill_end_rows.launches = 0
        for _ in range(2):
            mapper.scorer.reset_stats()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            scores = mapper.score_batch(reads)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            stats.append(dict(mapper.scorer.stats))
        launches["B11"] = {"score_batch 40 kb reads":
                           cf.banded_end_rows.launches}
        b2_launches = cf.fill_end_rows.launches
    peak, mem1 = torch.cuda.max_memory_allocated(), torch.cuda.memory_allocated()
    plans = sorted({(B, Wb, mr, cf.banded_plan(dg.window, Wb, m)["placement"])
                    for B, Wb, m, mr in tiers})
    print(f"[big] 11a score_batch({BB_READS} reads) x2: walls "
          f"{[round(w, 3) for w in walls]} s ({BB_READS / walls[-1]:.2f} "
          f"reads/s on the second), stats {stats}, ub hint "
          f"{mapper.scorer._ub_hint}, tiers (reads, Wb, max_run, placement) "
          f"{plans}, B1 launches {cf.banded_end_rows.launches}, B2 launches "
          f"{b2_launches}; device memory before / peak / after "
          f"{mem0} / {peak} / {mem1} B  [{card}]", flush=True)
    if scores.shape != (BB_READS,) or not (scores < cf.INF).all():
        raise AssertionError("11a: non-finite or misshaped scores")
    if cf.banded_end_rows.launches <= 0:
        raise AssertionError("11a: B1 never launched")
    if b2_launches or any(st["fullfill_fallbacks"] for st in stats):
        raise AssertionError(f"11a: a read fell to the full fill: {stats}")
    g_dg, qb, c, p, mr = b1_call.pop()
    # besides the B1 inputs kept here
    kept = mem1 - mem0 - qb.numel() * qb.element_size()
    if kept > 16 * 2 ** 20:
        raise AssertionError(f"11a: {kept} B of device memory kept after "
                             "the calls")

    # B1 at the call score_batch made (the second run's, whose time
    # PERF.md reports), held against its plain version on 2 of its reads
    P = int(dg.pred_slots.shape[1])
    plan = cf.banded_plan(g_dg.window, p["width"], p["margin"])
    ms = _time_ms(lambda: cf.banded_end_rows(g_dg, qb, c, p, mr), 3)
    qb2 = qb[:BIG_PLAIN_READS].contiguous()
    results["B11"] = _compare(
        f"B1 at score_batch's 40 kb tier, {BIG_PLAIN_READS} reads",
        lambda: cf.banded_end_rows(g_dg, qb2, c, p, mr),
        lambda: cf.banded_end_rows_plain(g_dg, qb2, c, p, mr), card, reps=3)
    results["B11"].update(
        reads_compared=BIG_PLAIN_READS, ms_compared=results["B11"]["ms"],
        ms=ms, shape=[int(qb.shape[0]), p["width"]], max_run=mr,
        **banded_fields(plan),
        **fill_bound(g_dg, int(qb.shape[0]), p["width"], int(qb.shape[1]),
                     p["width"], tilted=True, table_cols=1 + P))
    print(f"[big] 11a B1 at score_batch's tier: {ms:.3f} ms for "
          f"{int(qb.shape[0])} reads at Wb {p['width']}, max_run {mr}, plan "
          f"{plan} (bound {results['B11']['bound_ms']:.3f} ms)  [{card}]",
          flush=True)

    # B1 on the script's fixed windows
    ws, width, _, _ = banded_mod.band_windows(
        flat, int(lens.min()), int(lens.max()), costs, BB_UB)
    t0 = time.perf_counter()
    prep = cf.prepare_banded(dg, costs, (ws // 128) * 128, width + 128, L)
    prep_s = time.perf_counter() - t0
    plan = cf.banded_plan(dg.window, prep["width"], prep["margin"])
    print(f"[big] 11a fixed windows at ub {BB_UB}: Wb {prep['width']}, margin "
          f"{prep['margin']}, prepare_banded {prep_s:.3f} s, plan {plan}",
          flush=True)
    # banded scores are upper bounds, exact where they verify (<= ub)
    fixed = cf.banded_scores(dg, q, ln, costs, prep).cpu().numpy()
    ok = fixed <= BB_UB
    if not (fixed >= scores).all() or not (fixed[ok] == scores[ok]).all():
        raise AssertionError("11a: the fixed windows' scores undercut or, "
                             "verified, differ from score_batch's")
    # timed only: B1 is held against its plain version at score_batch's
    # tier above, and these windows are the script's, not a path's
    fixed_ms = _time_ms(lambda: cf.banded_end_rows(dg, q, costs, prep, 0), 3)
    results["B11"]["fixed_windows"] = {
        "ms": fixed_ms,
        "shape": [BB_READS, prep["width"]], **banded_fields(plan),
        "ub": BB_UB, "verified": int(ok.sum()),
        **fill_bound(dg, BB_READS, prep["width"], L, prep["width"],
                     tilted=True, table_cols=1 + P)}
    na = NativeAligner(graph)
    t0 = time.perf_counter()
    native = _native_scores(na, reads[:4], costs)
    if [int(s) for s in scores[:4]] != native:
        raise AssertionError(f"11a: reads 0-3 {list(scores[:4])}, native "
                             f"{native}")
    print(f"[big] 11a B1 at the fixed windows {fixed_ms:.3f} ms for "
          f"{BB_READS} reads at Wb {prep['width']} (bound "
          f"{results['B11']['fixed_windows']['bound_ms']:.3f} ms); their "
          f"scores bound score_batch's from above ({int(ok.sum())} of "
          f"{BB_READS} verified at ub {BB_UB}, equal); score_batch's reads "
          f"0-3 equal NativeAligner.align_banded "
          f"({time.perf_counter() - t0:.1f} s)  [{card}]", flush=True)
    del mapper, dg, q, prep, g_dg, qb, qb2
    torch.cuda.empty_cache()
    _phase_done("11a B1 at 40k ranks x 40 kb reads")

    # ---- 11b. B9's size: B4 over the pangenome graph's 50,002 ranks -------
    semi = EndsFree(UNBOUNDED, included(0), UNBOUNDED, UNBOUNDED)
    dg, flat = pan["dg"], pan["flat"]
    q, ln = pack_queries(pan_reads[:PAN_BATCH], device=dev)
    L = int(q.shape[1])
    cf.bounded_best_rows.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = wavefront_mod.dp_fill_scores_ends_free(dg, flat, q, ln, costs, semi)
    torch.cuda.synchronize()
    call_s = time.perf_counter() - t0
    launches["B9"] = {"dp_fill_scores_ends_free pangenome":
                      cf.bounded_best_rows.launches}
    if cf.bounded_best_rows.launches != 1:
        raise AssertionError(f"11b: {cf.bounded_best_rows.launches} B4 "
                             "launches")
    if not np.array_equal(got.cpu().numpy(), pan["batch_exact"][0]):
        raise AssertionError("11b: B4's scores differ from 8a's B7 scores")
    fs, end_ok, _ = wavefront_mod.ends_free_device_params(
        flat, semi, ln, dg.n_nodes_padded)
    plan = cf.bounded_plan(dg.window, L)
    print(f"[big] 11b dp_fill_scores_ends_free({PAN_BATCH} reads, L {L}, "
          f"{dg.n_nodes} ranks, P {int(dg.pred_slots.shape[1])}): "
          f"{call_s:.3f} s, 1 B4 launch, plan {plan}; scores equal 8a's B7 "
          f"scores  [{card}]", flush=True)
    ms = _time_ms(lambda: cf.bounded_best_rows(dg, q, costs, fs, end_ok, 0), 3)
    q2 = q[:BIG_PLAIN_READS].contiguous()
    # uncapped, as the call above launched it
    cmp = _compare(
        f"B4 at 50,002 ranks, {BIG_PLAIN_READS} reads, max_run 0",
        lambda: cf.bounded_best_rows(dg, q2, costs, fs, end_ok, 0),
        lambda: cf.bounded_best_rows_plain(dg, q2, costs, fs, end_ok, 0),
        card, reps=3)
    results["B9"] = {
        "max_abs_err": cmp["max_abs_err"], "ms": ms,
        "plain_ms": cmp["plain_ms"], "ms_compared": cmp["ms"],
        "reads_compared": BIG_PLAIN_READS, "shape": [PAN_BATCH, L],
        **fill_fields(plan),
        **fill_bound(dg, PAN_BATCH, L, L, L, tilted=False,
                     per_rank=RECURRENCE_OPS + int(end_ok.sum()) / dg.n_nodes,
                     table_cols=1)}
    print(f"[big] 11b B4 {ms:.3f} ms for {PAN_BATCH} reads (bound "
          f"{results['B9']['bound_ms']:.3f} ms)  [{card}]", flush=True)
    _phase_done("11b B4 at 50,002 ranks")
    return results, launches

def _merge_round_robin(paths):
    """The lines of per-process round-robin parts, in input order."""
    lines = []
    for path in paths:
        with open(path) as fh:
            lines.append(fh.read().splitlines())
    out, i = [], 0
    while any(lines):
        if lines[i % len(lines)]:
            out.append(lines[i % len(lines)].pop(0))
        i += 1
    return "\n".join(out) + "\n" if out else ""


def mesh_phases(card, dev, costs, graph, reads, scores, pan_workload, pan):
    """Phases 12a-12g: the mesh, single-controller over two entries of the
    one card (dp = 2), and ``lasagna --distributed`` as two processes on it.
    Every output is held against the same call unmeshed; each kernel was
    held against its plain version in its own phase.  Returns each meshed
    call's launches by kernel."""
    import tempfile
    from unittest import mock

    import numpy as np
    import torch

    from poasta_tpu_torch import (
        UNBOUNDED,
        BatchMapper,
        EndsFree,
        included,
        pack_queries,
    )
    from poasta_tpu_torch.aligner import GapAffine2Piece
    from poasta_tpu_torch.aligner import banded as banded_mod
    from poasta_tpu_torch.aligner import wavefront as wavefront_mod
    from poasta_tpu_torch.ops import cuda_fill as cf
    from poasta_tpu_torch.parallel import make_mesh, make_sharded_score_fn
    from poasta_tpu_torch.parallel import mapper as mapper_mod

    mesh = make_mesh(devices=[dev, dev], dp=2)
    note = ("two shards on one card: no speed claim, the split and the "
            "gather are what runs")
    semi = EndsFree(UNBOUNDED, included(0), UNBOUNDED, UNBOUNDED)
    wrappers = {"B1": cf.banded_end_rows, "B2": cf.fill_end_rows,
                "B3": cf.drift_end_rows, "B2f": cf.free_fill_rows,
                "B4": cf.bounded_best_rows, "B7": cf.bounded_end_rows,
                "B16": cf.banded_end_rows_2p, "B17": cf.drift_end_rows_2p}
    launches = {}

    def zero():
        for w in wrappers.values():
            w.launches = 0

    def count():
        return {b: w.launches for b, w in wrappers.items() if w.launches}

    def read(call):
        launches[call] = {b: w.launches for b, w in wrappers.items()}
        return count()

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def pairs(out):
        return [(s, [(p.rpos, p.qpos) for p in a]) for s, a in out]

    # ---- 12a. BatchMapper(mesh=) on the uniform configuration ----------
    meshed = BatchMapper(graph, costs, mesh=mesh)
    one = BatchMapper(graph, costs, device=dev)
    meshed.score_batch(reads)  # warm-ups (the unmeshed one learns its ub)
    one.score_batch(reads)
    zero()
    got, t_mesh = timed(lambda: meshed.score_batch(reads))
    n = read("score_batch mesh dp=2 uniform")
    _, t_one = timed(lambda: one.score_batch(reads))
    if not np.array_equal(got, scores):
        raise AssertionError("12a: meshed score_batch differs from phase "
                             "4's scores")
    if n.get("B2") != 2:
        raise AssertionError(f"12a: score_batch launched {n}, not B2 on each "
                             "of 2 shards")
    print(f"[mesh] 12a score_batch({N_READS} uniform reads), dp=2 on one "
          f"card: the sharded full fill (the reference's mesh route), "
          f"{t_mesh * 1e3:.1f} ms, launches {n}; unmeshed (banded) "
          f"{t_one * 1e3:.1f} ms; scores equal phase 4's  [{card}; {note}]",
          flush=True)
    sub = reads[:64]
    one.align_batch(sub)  # warm-ups: each learns this profile's ub
    meshed.align_batch(sub)
    want, t_one = timed(lambda: one.align_batch(sub))
    shard_rows = []
    real_banded = banded_mod.banded_scores

    def rec_banded(g_dg, q, *args, **kwargs):
        shard_rows.append(int(q.shape[0]))
        return real_banded(g_dg, q, *args, **kwargs)

    with mock.patch.object(banded_mod, "banded_scores", rec_banded):
        zero()
        got, t_mesh = timed(lambda: meshed.align_batch(sub))
        n = read("align_batch mesh dp=2 uniform")
    if pairs(got) != pairs(want):
        raise AssertionError("12a: meshed alignments differ from unmeshed")
    if not n.get("B1") or n["B1"] % 2 or len(shard_rows) != n["B1"]:
        raise AssertionError(f"12a: align_batch launched {n}, B1 calls "
                             f"{shard_rows}")
    per_shard = {f"shard {i}": shard_rows[i::2] for i in range(2)}
    print(f"[mesh] 12a align_batch(64 uniform reads), dp=2: {t_mesh * 1e3:.1f}"
          f" ms, unmeshed {t_one * 1e3:.1f} ms; B1 launches per shard "
          f"(reads each) {per_shard}, launches {n}, "
          f"{meshed.last_banded_stats}; alignments equal unmeshed (B3: the "
          f"batch spreads {max(map(len, sub)) - min(map(len, sub))} bases, "
          f"under the drift threshold "
          f"{banded_mod.BandedScorer.DRIFT_MIN_SPREAD}"
          f")  [{card}; {note}]", flush=True)
    _phase_done("12a BatchMapper(mesh=) uniform")

    # ---- 12b. make_sharded_score_fn: B2 and B2f on each shard -----------
    dg = one.dg
    q, ln = pack_queries(reads[:128], device=dev)
    want = wavefront_mod.dp_fill_scores(dg, q, ln, costs).cpu().numpy()
    fn = make_sharded_score_fn(dg, costs, mesh)
    zero()
    got, t_mesh = timed(lambda: fn(q, ln).cpu().numpy())
    n = read("make_sharded_score_fn dp=2 128 uniform")
    if not np.array_equal(got, want) or n.get("B2") != 2:
        raise AssertionError(f"12b: sharded scores differ or launches {n}")
    rng = random.Random(FREE_SEED)
    short = []
    for r in reads[:64]:
        a = rng.randrange(0, len(r) - FREE_READ_LEN)
        short.append(r[a:a + FREE_READ_LEN])
    qf, lf = pack_queries(short, device=dev)
    for fs, fe in FREE_FLAGS:
        want = wavefront_mod.dp_fill_scores(dg, qf, lf, costs, fs,
                                            fe).cpu().numpy()
        zero()
        got = make_sharded_score_fn(dg, costs, mesh, fs, fe)(qf, lf)
        n = read(f"make_sharded_score_fn dp=2 free_start={fs} "
                 f"free_end={fe}")
        if not np.array_equal(got.cpu().numpy(), want) \
                or n.get("B2f" if fs or fe else "B2") != 2:
            raise AssertionError(f"12b {fs, fe}: scores differ or launches "
                                 f"{n}")
    print(f"[mesh] 12b make_sharded_score_fn dp=2: 128 uniform reads "
          f"{t_mesh * 1e3:.1f} ms (B2 a shard), and the four free-flag pairs "
          f"on 64 x {FREE_READ_LEN} bases (B2f a shard): all equal the "
          f"unmeshed dp_fill_scores  [{card}; {note}]", flush=True)
    _phase_done("12b make_sharded_score_fn")

    # ---- 12c. semi-global alignment on the pangenome graph --------------
    pan_graph, pan_reads = pan_workload
    batch = pan_reads[:PAN_BATCH]
    pan_mesh = BatchMapper(pan_graph, costs, mesh, aln_type=semi)
    zero()
    got, t_mesh = timed(lambda: pan_mesh.score_batch(batch))
    n = read("score_batch mesh dp=2 semi-global pangenome")
    if not np.array_equal(got, pan["batch_exact"][0]) or n.get("B4") != 2:
        raise AssertionError(f"12c: meshed semi-global scores differ from "
                             f"8a's, or launches {n}")
    print(f"[mesh] 12c score_batch({PAN_BATCH} pangenome reads, "
          f"semi-global), dp=2: {t_mesh * 1e3:.1f} ms (B4 a shard over "
          f"{pan['flat'].n_nodes} ranks), launches {n}; scores equal 8a's  "
          f"[{card}; {note}]", flush=True)
    tmp = tempfile.mkdtemp(prefix="poasta_smoke_mesh_")
    gfa, fa = write_inputs(pan_graph, batch, tmp)
    outs, secs = {}, {}
    for name in ("off", "mesh"):
        out = os.path.join(tmp, f"{name}.gaf")
        argv = ["align", gfa, fa, "-o", out, "-m", "semi-global", "-j",
                str(PAN_BATCH), "--mesh", "off"]
        if name == "off":
            zero()
            secs[name] = _lasagna_run(argv)
            n_off = count()
        else:
            # the CLI's own path under the two-entry mesh (a spec of the
            # one card cannot ask for dp = 2; the CLI imports the parser
            # from the mapper at the call)
            with mock.patch.object(mapper_mod, "parse_mesh_spec",
                                   lambda spec, device=None: mesh):
                zero()
                secs[name] = _lasagna_run(argv)
                n = read("lasagna align -m semi-global mesh dp=2 pangenome")
        with open(out) as fh:
            outs[name] = fh.read()
    if outs["mesh"] != outs["off"] or len(outs["off"].splitlines()) != \
            PAN_BATCH:
        raise AssertionError("12c: the meshed semi-global GAF differs from "
                             "the unmeshed one")
    if n.get("B7", 0) < 2:
        raise AssertionError(f"12c: the meshed CLI launched {n}, not B7 on "
                             "each of its 2 replicas")
    print(f"[mesh] 12c lasagna align -m semi-global ({PAN_BATCH} pangenome "
          f"reads) with the dp=2 mesh: {secs['mesh']:.2f} s, unmeshed "
          f"{secs['off']:.2f} s; launches {n} (a replica a shard: its "
          f"capped ladder and anchored trace on its entry), unmeshed "
          f"{n_off}; GAF byte-equal  [{card}; {note}]", flush=True)
    _phase_done("12c semi-global pangenome under the mesh")

    # ---- 12d. two-piece score_batch: B16 on each shard -------------------
    costs_2p = GapAffine2Piece(*COSTS_2P)
    want = BatchMapper(graph, costs_2p, device=dev).score_batch(sub)
    tp_mesh = BatchMapper(graph, costs_2p, mesh)
    zero()
    got, t_mesh = timed(lambda: tp_mesh.score_batch(sub))
    n = read("score_batch mesh dp=2 two-piece uniform")
    if not np.array_equal(got, want) or not n.get("B16") or n["B16"] % 2:
        raise AssertionError(f"12d: two-piece meshed scores differ or "
                             f"launches {n}")
    print(f"[mesh] 12d two-piece score_batch(64 uniform reads), dp=2: "
          f"{t_mesh * 1e3:.1f} ms, launches {n}, tiers "
          f"{tp_mesh.scorer.stats['tiers']}; scores equal unmeshed  "
          f"[{card}; {note}]", flush=True)
    _phase_done("12d two-piece under the mesh")

    # ---- 12e. the sp demonstrator ---------------------------------------
    q64, l64 = pack_queries(sub, device=dev)
    sp_fn = make_sharded_score_fn(dg, costs, make_mesh(devices=[dev, dev],
                                                       dp=1, sp=2))
    got, t_sp = timed(lambda: sp_fn(q64, l64).cpu().numpy())
    if not np.array_equal(got, scores[:64]):
        raise AssertionError("12e: the sp demonstrator's scores differ")
    print(f"[mesh] 12e sp demonstrator (dp=1, sp=2; plain PyTorch, no "
          f"kernel, as the reference's XLA scan): 64 uniform reads x "
          f"{dg.n_nodes} ranks, L {int(q64.shape[1])} in two slabs of "
          f"{int(q64.shape[1]) // 2}: {t_sp:.2f} s; scores equal phase 4's  "
          f"[{card}; {note}]", flush=True)
    _phase_done("12e sp demonstrator")

    # ---- 12f. lasagna align --distributed: two processes, one card ------
    tmp = tempfile.mkdtemp(prefix="poasta_smoke_dist_")
    dist_reads = reads[:DIST_READS]
    gfa, fa = write_inputs(graph, dist_reads, tmp)
    single = os.path.join(tmp, "single.gaf")
    t_single = _lasagna_run(["align", gfa, fa, "-o", single, "--mesh",
                             "off"])
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    dist_out = os.path.join(tmp, "dist.gaf")
    env = dict(os.environ, PYTHONPATH=REPO)
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "poasta_tpu_torch.cli.lasagna", "align", gfa,
         fa, "-o", dist_out, "--distributed", "--coordinator-address",
         f"127.0.0.1:{port}", "--num-processes", "2", "--process-id",
         str(pid)], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for pid in range(2)]
    try:
        errs = [p.communicate(timeout=300)[1] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    t_dist = time.perf_counter() - t0
    for p, err in zip(procs, errs):
        if p.returncode != 0:
            raise AssertionError(f"12f: a process exited {p.returncode}: "
                                 f"{err[-2000:]}")
    with open(single) as fh:
        want = fh.read()
    parts = [f"{dist_out}.part{pid}" for pid in range(2)]
    if _merge_round_robin(parts) != want \
            or len(want.splitlines()) != len(dist_reads):
        raise AssertionError("12f: the merged parts differ from the "
                             "single-process GAF")
    print(f"[mesh] 12f lasagna align --distributed, 2 processes (gloo on "
          f"localhost) on one card, {len(dist_reads)} uniform reads: "
          f"{t_dist:.2f} s wall "
          f"from launch to exit (imports, graph load and card set-up in each "
          f"process), single process in this one {t_single:.2f} s; parts "
          f"merged round-robin byte-equal  [{card}; {note}]", flush=True)

    # ---- 12g. --mesh auto over every card --------------------------------
    cards = torch.cuda.device_count()
    if cards > 1:
        auto = os.path.join(tmp, "auto.gaf")
        t_auto = _lasagna_run(["-v", "align", gfa, fa, "-o", auto, "--mesh",
                               "auto"])
        with open(auto) as fh:
            if fh.read() != want:
                raise AssertionError("12g: --mesh auto GAF differs")
        print(f"[mesh] 12g --mesh auto over {cards} cards: {t_auto:.2f} s, "
              f"GAF byte-equal  [{card}]", flush=True)
    else:
        print("[mesh] 12g --mesh auto: one card visible, so auto builds no "
              "mesh (12a-12e used two entries of it)", flush=True)
    _phase_done("12f-12g --distributed, --mesh auto")
    return launches


def scale_phases(card, dev, costs):
    """Phases 13a-13c: the mapping path at scripts/pangenome_200k.py's
    200,000 nodes, with the 512-read batches of
    scripts/pangenome_bigbatch.py.  Returns (the kernel rows of this size:
    B7 as B10, B8 at k 11, B18 ``free_start`` as B19, the decode past 2^31
    plane elements; their launches in each main-path call)."""
    import tempfile

    import numpy as np
    import torch

    from poasta_tpu_torch import (
        UNBOUNDED,
        BatchMapper,
        DeviceGraph,
        EndsFree,
        included,
        pack_queries,
    )
    from poasta_tpu_torch.aligner import wavefront as wavefront_mod
    from poasta_tpu_torch.aligner.seeds import KmerIndex
    from poasta_tpu_torch.io.gfa import load_graph_from_gfa
    from poasta_tpu_torch.ops import cuda_fill as cf
    from poasta_tpu_torch.ops import seed as sd
    from poasta_tpu_torch.ops import trace as tr
    from poasta_tpu_torch.parallel import mapper as mapper_mod

    t_phase = time.perf_counter()
    semi = EndsFree(UNBOUNDED, included(0), UNBOUNDED, UNBOUNDED)
    wrappers = {"B7": cf.bounded_end_rows, "B8": sd.seed_end_states,
                "B18": tr.trace_fill, "decode": tr.trace_decode}
    launches = {}

    def zero():
        for w in wrappers.values():
            w.launches = 0

    def read(call):
        launches[call] = {name: w.launches for name, w in wrappers.items()}
        return launches[call]

    def triples_equal(got, want):
        return all(np.array_equal(np.asarray(g), np.asarray(w))
                   for g, w in zip(got, want))

    # ---- 13a. the reference's probe ------------------------------------
    host = {}
    t0 = time.perf_counter()
    graph, reads = pangenome_200k_workload(times=host)
    host["graph and reads"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    flat = graph.flatten()
    host["flatten"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    DeviceGraph.build(flat, device=dev)
    torch.cuda.synchronize()
    host["DeviceGraph.build"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    mapper = BatchMapper(graph, costs, device=dev, aln_type=semi)
    host["BatchMapper"] = time.perf_counter() - t0
    dg, flat = mapper.dg, mapper.flat
    batch = reads[:P200_BATCH]
    t0 = time.perf_counter()
    q, ln = pack_queries(batch, device=dev)
    torch.cuda.synchronize()
    host["pack_queries"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    KmerIndex(flat)
    host["KmerIndex"] = time.perf_counter() - t0
    lengths_np = np.fromiter(map(len, batch), dtype=np.int64)
    lens = [len(r) for r in reads]
    print(f"[200k] graph: {flat.n_nodes} nodes (Np {dg.n_nodes_padded}), W "
          f"{dg.window}, P {int(dg.pred_slots.shape[1])}; {P200_READS} reads "
          f"of {min(lens)}-{max(lens)}, L {int(q.shape[1])}; host s "
          f"{ {k: round(v, 3) for k, v in host.items()} }", flush=True)

    # the kernels' inputs on the path (the widest call of each), for 13b
    captured = {}
    real = {"B7": cf._launch_bounded_ends, "B8": sd._launch_seed,
            "B18": tr._launch_trace, "decode": tr._launch_decode}

    def keep(name, q_at=1):
        # the path's widest call (the last of equal width), its output too
        def rec(*args, **kwargs):
            out = real[name](*args, **kwargs)
            B = int(args[q_at].shape[0])
            if B >= captured.get(name, (0,))[0]:
                captured[name] = (B, args, kwargs, out)
            return out
        return rec

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    with mock.patch.object(cf, "_launch_bounded_ends", keep("B7")), \
            mock.patch.object(sd, "_launch_seed", keep("B8")):
        zero()
        exact, t_exact = timed(lambda: tuple(
            t.cpu().numpy() for t in wavefront_mod.dp_fill_ends_free_with_ends(
                dg, flat, q, ln, costs, semi)))
        read(f"13a uncapped full fill ({P200_BATCH} reads)")
        zero()
        capped, t_capped = timed(
            lambda: mapper._fill_ends_free_capped(q, ln, lengths_np))
        read(f"13a capped full fill ({P200_BATCH} reads)")
        if not triples_equal(capped, exact):
            raise AssertionError("13a: the capped full fill differs from the "
                                 "uncapped one")
        mapper._learn_seed_ub(lengths_np, capped[0])
        seed_secs, seed_stats = [], []
        zero()
        for _ in range(4):
            got, secs = timed(lambda: mapper._ends_free_scores(batch, q, ln))
            if not triples_equal(got, exact):
                raise AssertionError("13a: the seeded (score, end rank, end "
                                     "offset) differ from the full fill's")
            seed_secs.append(secs)
            seed_stats.append(mapper.last_seed_stats)
        read(f"13a seeded scoring x4 ({P200_BATCH} reads)")
    st = seed_stats[-1]
    if not all(s and s["seeded"] > 0 for s in seed_stats):
        raise AssertionError(f"13a: the seeded path is inert: {seed_stats}")
    print(f"[200k] 13a {P200_BATCH} reads: uncapped full fill {t_exact:.3f} s, "
          f"capped {t_capped:.3f} s (ub hints {mapper._ef_ub_hint}), seeded "
          f"warm-up {seed_secs[0]:.3f} s then {[round(t, 3) for t in seed_secs[1:]]}"
          f" s; k {st['seed_k']}, seed stats {st}; every (score, end rank, "
          f"end offset) equals the uncapped full fill's  [{card}]", flush=True)
    _phase_done("13a the reference's 200k probe")

    # ---- 13b. alignments past 2^31 plane elements ------------------------
    out = []
    with mock.patch.object(tr, "_launch_trace", keep("B18")), \
            mock.patch.object(tr, "_launch_decode", keep("decode", 2)):
        zero()
        token = mapper.prescore(batch)
        if not triples_equal(token[1], exact):
            raise AssertionError("13b: prescore's triple differs from 13a's")
        route_s = _align_routes(mapper, batch, token, out)
        n13b = read(f"13b prescore and align_batch ({P200_BATCH} reads), "
                    "both routes")
    for read_, (score, aln), want in zip(batch, out, exact[0]):
        cost = wavefront_mod.alignment_cost(graph, read_, aln, costs)
        if cost != score or score != int(want):
            raise AssertionError(f"13b: an alignment costs {cost}, scored "
                                 f"{score}, full fill {int(want)}")
    B, args, kwargs, (aval, ptr) = captured.pop("B18")
    g_dg, qpad, wst, ar, aj, c, Wb, fs, rb, re = args
    if rb is None:
        raise AssertionError("13b: the widest trace call walked every rank")
    Np = int(ptr.shape[0])
    elements = Np * B * Wb
    # the first rank whose rows lie wholly past 2^31 elements
    past = -(-PLANE_ELEMENTS_INT // (B * Wb))
    if B != P200_BATCH:
        raise AssertionError(f"13b: the widest trace call held {B} reads, "
                             f"not the batch's {P200_BATCH}")
    # each read's corridor in that call (the first tier, every read
    # pending), as tier_inputs scheduled it
    sc_np = np.asarray(exact[0], np.int64)
    k_tier, _ = tr.gap_budgets(flat, sc_np, costs, Wb)
    dmin, dmax = tr._sched_potentials(flat, Np, dev)
    ar_np = ar.cpu().numpy().astype(np.int64)

    def put(v):
        return torch.as_tensor(np.asarray(v, dtype=np.int64), device=dev)

    _, ok, _, r_lo, _, has = tr._schedule_body(
        dmin, dmax, put(lengths_np), put(k_tier), put(aj.cpu().numpy()),
        put(flat.min_dist_from_start[ar_np]),
        put(flat.max_dist_from_start[ar_np]), flat.n_nodes, Wb)
    verified = (aval.cpu().numpy() == sc_np) & ok.cpu().numpy()
    r_lo = r_lo.cpu().numpy()
    beyond = verified & has.cpu().numpy() & (r_lo >= past)
    print(f"[200k] 13b align_batch({P200_BATCH} prescored reads): device "
          f"trace {route_s['device']:.3f} s, native host backtrace "
          f"{route_s['host']:.3f} s on {os.cpu_count()} cores, alignments "
          f"equal, each costs its score; launches {n13b}; the widest B18 call "
          f"(Wb {Wb}, free_start {fs}): planes ({Np}, {B}, {Wb}) = "
          f"{elements} elements ({elements / PLANE_ELEMENTS_INT:.3f} x "
          f"2^31); "
          f"{int(verified.sum())} of {B} reads verified, {int(beyond.sum())} "
          f"of them with a corridor wholly at ranks >= {past} (lowest rank "
          f"{int(r_lo[beyond].min()) if beyond.any() else None})  [{card}]",
          flush=True)
    if not fs or elements <= PLANE_ELEMENTS_INT:
        raise AssertionError(f"13b: the B18 call's planes hold {elements} "
                             "elements, not past 2^31, or it was not "
                             "free_start")
    if not beyond.any():
        raise AssertionError("13b: no verified read's corridor lies past "
                             f"rank {past}")
    results = {}
    inp = dict(qpad=qpad, wstarts=wst, anchor_r=ar, anchor_j=aj, r_begin=rb,
               r_end=re)
    del ptr, aval
    ms = _time_ms(lambda: tr.trace_fill(g_dg, **inp, costs=c, Wb=Wb,
                                        free_start=True), 3)
    plan = tr.trace_plan(g_dg.window, Wb)
    results["B19"] = {
        "max_abs_err": max(abs(wavefront_mod.alignment_cost(
            graph, r_, a_, costs) - s_) for r_, (s_, a_) in zip(batch, out)),
        "ms": ms, "plain_ms": None,
        "held_by": "the native host backtrace (alignments equal) and "
                   "alignment_cost (each costs its score); plain version "
                   "held at 50,002 ranks (8d)",
        "shape": [Np, B, Wb], "plane_elements": elements,
        "first_rank_past_2_31": past,
        "reads_wholly_past_2_31": int(beyond.sum()),
        **fill_fields(plan),
        **fill_bound(g_dg, B, Wb, int(qpad.shape[1]),
                     g_dg.n_nodes * Wb + 1, tilted=True,
                     per_pred=TRACE_PRED_OPS, per_rank=TRACE_OPS,
                     table_cols=8)}
    results["B19"].update(walked_fields(results["B19"], rb, re,
                                        g_dg.n_nodes))
    print(f"[kernels] B18 free_start at {g_dg.n_nodes} ranks: {ms:.3f} ms for "
          f"{B} reads at Wb {Wb} over their rank ranges (walked share "
          f"{results['B19']['walked_share']:.4f}; bound "
          f"{results['B19']['bound_ms']:.3f} ms over every rank's cells, "
          f"{results['B19']['bound_walked_ms']:.3f} ms over the walked "
          f"ones; plan {plan})  [{card}]", flush=True)
    del inp

    # the decode on the planes of the call that went past 2^31 elements
    _, args, _, _ = captured.pop("decode")
    ptr, walk = args[0], args[1:]
    if tuple(ptr.shape) != (Np, B, Wb):
        raise AssertionError(f"13b: the last decode walked planes "
                             f"{tuple(ptr.shape)}, not ({Np}, {B}, {Wb})")

    def dec_k():
        return tr.trace_decode(ptr, *walk)

    results["decode"] = _compare(
        "decode past 2^31 plane elements", dec_k,
        lambda: tr.decode_plain(ptr, *walk), card, reps=5)
    results["decode"].update(_decode_fields(dec_k, walk, card),
                             plane_elements=elements)
    del ptr, walk, dec_k

    # B8 at k 11: the whole call timed, held on its 2 lowest reads
    _, args, _, _ = captured.pop("B8")
    (g_dg, qs, wst, ln8, jlo, r_begin, r_end, c, fs, end_ok, Wb8,
     max_run) = args
    span = r_end - r_begin
    full_ms = _time_ms(
        lambda: sd.seed_end_states(g_dg, qs, wst, ln8, jlo, r_begin, r_end, c,
                                   fs, end_ok, Wb8, max_run), 5)
    low = torch.argsort(r_begin)[:BIG_PLAIN_READS]
    qs2, wst2, ln2, jlo2, rb2, re2 = (
        t.index_select(0, low).contiguous()
        for t in (qs, wst, ln8, jlo, r_begin, r_end))
    ranks = int((re2 - rb2).sum())
    print(f"[kernels] B8 at k {st['seed_k']}: {int(qs.shape[0])} reads, Wb "
          f"{Wb8}, max_run {max_run}, rank ranges of {int(span.min())}-"
          f"{int(span.max())} ranks; the whole call {full_ms:.3f} ms; held "
          f"on its {BIG_PLAIN_READS} lowest reads (ranks {int(rb2.min())}-"
          f"{int(re2.max())})", flush=True)
    results["B8"] = _compare(
        f"B8 at k {st['seed_k']} ({BIG_PLAIN_READS} lowest reads)",
        lambda: sd.seed_end_states(g_dg, qs2, wst2, ln2, jlo2, rb2, re2, c,
                                   fs, end_ok, Wb8, max_run),
        lambda: sd.seed_end_states_plain(g_dg, qs2, wst2, ln2, jlo2, rb2, re2,
                                         c, fs, end_ok, Wb8, max_run),
        card, reps=5)
    n = g_dg.n_nodes
    P = int(g_dg.pred_slots.shape[1])
    extra_preds = int(g_dg.pred_valid_np[:n, 1:].sum()) / n
    may_end = int(end_ok[:n].sum()) / n
    all_ranks = int(span.sum())
    # as 8d, over the whole call (the row's ms is the whole call's)
    results["B8"].update(_bound(
        4 * (qs.numel() + all_ranks * (1 + 3 + 2 * P) + 8 * int(qs.shape[0])),
        all_ranks * Wb8 * (RECURRENCE_OPS - 1 + SCAN_OPS + PRED_OPS
                           * extra_preds + SEED_END_OPS * may_end)))
    results["B8"].update(ms_compared=results["B8"]["ms"], ms=full_ms,
                         reads_compared=BIG_PLAIN_READS,
                         shape=[int(qs.shape[0]), Wb8], seed_k=st["seed_k"],
                         **fill_fields(sd.seed_plan(g_dg.window, Wb8)))
    del qs, wst, qs2, wst2

    # B7 at 200,002 ranks (B10's size): the capped call 13a made
    _, args, _, _ = captured.pop("B7")
    g_dg, q7, c, fs, end_ok, max_run = args
    L = int(q7.shape[1])
    ms = _time_ms(lambda: cf.bounded_end_rows(g_dg, q7, c, fs, end_ok,
                                              max_run), 3)
    plan = cf.bounded_plan(g_dg.window, L, ends=True, max_run=max_run)
    results["B10"] = {
        "max_abs_err": max(int(np.abs(np.asarray(a, np.int64)
                                      - np.asarray(b, np.int64)).max())
                           for a, b in zip(capped, exact)),
        "ms": ms, "plain_ms": None,
        "held_by": "the uncapped full fill and the seeded fill (13a: "
                   "scores, end ranks, end offsets equal); plain version "
                   "held at 50,002 ranks (8d)",
        "shape": [int(q7.shape[0]), L], "ranks": g_dg.n_nodes,
        "max_run": max_run, **fill_fields(plan),
        **fill_bound(g_dg, int(q7.shape[0]), L, L, 2 * L, tilted=False,
                     per_rank=RECURRENCE_OPS + ENDS_OPS * int(end_ok.sum())
                     / g_dg.n_nodes, table_cols=1)}
    print(f"[kernels] B7 at {g_dg.n_nodes} ranks (B10's size): {ms:.3f} ms "
          f"for {int(q7.shape[0])} reads, L {L}, max_run {max_run} (bound "
          f"{results['B10']['bound_ms']:.3f} ms, plan {plan})  [{card}]",
          flush=True)
    del q7, q, ln, token, mapper, dg, captured
    torch.cuda.empty_cache()
    _phase_done("13b alignments past 2^31 plane elements")

    # ---- 13c. the CLI at 512 reads -------------------------------------
    tmp = tempfile.mkdtemp(prefix="poasta_smoke_200k_")
    t0 = time.perf_counter()
    gfa, fa = write_inputs(graph, reads, tmp)
    host["write GFA and FASTA"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    load_graph_from_gfa(gfa)
    host["GFA load"] = time.perf_counter() - t0
    frees, b18_calls, seeded = [], [], []
    real_free = tr.free_bytes
    real_scores = mapper_mod.BatchMapper._ends_free_scores

    def rec_free(d):
        v = real_free(d)
        frees.append(v)
        return v

    def rec_trace(*args, **kwargs):
        b18_calls.append((int(args[1].shape[0]), args[6], args[0]))
        return real["B18"](*args, **kwargs)

    def rec_scores(self, *args):
        out = real_scores(self, *args)
        seeded.append(self.last_seed_stats)
        return out

    def cli(out_name, j, env=None):
        out_path = os.path.join(tmp, out_name)
        os.environ.update(env or {})
        try:
            secs = _lasagna_run(["align", gfa, fa, "-o", out_path, "-m",
                                 "semi-global", "-j", str(j)])
        finally:
            for k in env or {}:
                del os.environ[k]
        with open(out_path) as fh:
            return secs, fh.read()

    runs = {}
    one, many = f"-j {P200_READS}", f"-j {P200_BATCH}"
    for name, j, env in ((one, P200_READS, None), (many, P200_BATCH, None),
                         (f"{one}, POASTA_SEED=0", P200_READS,
                          {"POASTA_SEED": "0"})):
        del frees[:], b18_calls[:], seeded[:]
        with mock.patch.object(tr, "free_bytes", rec_free), \
                mock.patch.object(tr, "_launch_trace", rec_trace), \
                mock.patch.object(mapper_mod.BatchMapper, "_ends_free_scores",
                                  rec_scores):
            zero()
            secs, text = cli(f"j{j}{'' if env is None else '_seed0'}.gaf", j,
                             env)
            n = read(f"lasagna align -m semi-global {name} (200k)")
        runs[name] = {"secs": secs, "gaf": text, "launches": n,
                      "frees": list(frees), "b18": [(b, w) for b, w, _
                                                    in b18_calls],
                      "seeded": [s and s["seeded"] for s in seeded]}
        if name == one:
            per_read = tr.tier_bytes_per_read(b18_calls[0][2], 256)
            expected = tr.sub_batch_count(P200_READS, per_read, frees[0])
            at256 = sum(1 for _, w, _ in b18_calls if w == 256)
            runs[name].update(expected=expected, at256=at256,
                              per_read=per_read)
        del b18_calls[:]
        print(f"[200k] 13c lasagna align -m semi-global {name}: {secs:.2f} s "
              f"wall, {P200_READS / secs:.2f} reads/s; launches {n}; B18 "
              f"calls (reads, Wb) {runs[name]['b18']}; free bytes at each "
              f"tier {runs[name]['frees']}; seeded per batch "
              f"{runs[name]['seeded']}  [{card}]", flush=True)
    r512 = runs[one]
    print(f"[200k] 13c {one}: B18 at Wb 256 launched {r512['at256']} times; "
          f"expected {r512['expected']} = ceil({P200_READS} / (free "
          f"{r512['frees'][0]} B // 2 // {r512['per_read']} B a read))",
          flush=True)
    if r512["at256"] != r512["expected"] or r512["at256"] < 2:
        raise AssertionError(f"13c: the {one} trace did not split into the "
                             "sub-batches its free memory gives")
    if not all(s > 0 for s in runs[many]["seeded"][1:]):
        raise AssertionError(f"13c: a {many} batch after the first did not "
                             f"seed: {runs[many]['seeded']}")
    gaf = r512["gaf"]
    if any(r["gaf"] != gaf for r in runs.values()):
        raise AssertionError("13c: the three runs' GAF differ")
    lines = gaf.splitlines()
    if len(lines) != P200_READS:
        raise AssertionError(f"13c: {len(lines)} GAF records for "
                             f"{P200_READS} reads")
    for line in lines:
        fields = line.split("\t")
        i = int(fields[0][1:])
        if i < P200_BATCH:
            as_i = [f for f in fields if f.startswith("AS:i:")]
            if as_i != [f"AS:i:{int(exact[0][i])}"]:
                raise AssertionError(f"13c: read {i}: {as_i}, 13a "
                                     f"{int(exact[0][i])}")
    print(f"[200k] 13c the three runs' GAF byte-equal ({len(gaf)} B); the "
          f"first {P200_BATCH} AS:i equal 13a's scores; host s "
          f"{ {k: round(v, 3) for k, v in host.items()} }  [{card}]",
          flush=True)
    _phase_done(f"13c the CLI at {P200_READS} reads")
    print(f"[time] phase 13 in all: {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return results, launches


# Phase 14: the bench's line carries bench.py's recorded keys
# (BENCH_r05.json's "parsed") less its int16 probe's, plus the port's five.
BENCH_INT16_KEYS = {"int16_kernel_supported", "int16_probe_toolchain"}
BENCH_PORT_KEYS = {"backend", "torch", "cuda", "nvcc", "card"}
# its configurations, in bench.py's order (poasta_tpu_torch/bench.py run_*)
BENCH_CONFIGS = ("uniform", "host_baseline", "hybrid", "mixed_div",
                 "mixed_len", "pangenome")


def bench_phase(card, costs):
    """Phase 14: the port's bench entry, ``python -m
    poasta_tpu_torch.bench``, as ``main([])`` in process at bench.py's
    sizes, with every launch counter zeroed just before it and read after
    each of its configurations.  Checks its one line (every key, no
    ``error``, the seeded corridors engaged, mixed_div's tiered retry),
    holds mixed_div's last timed call against the same ladder run with
    the plain versions and its 15% reads against the native banded
    engine, and every hybrid and pangenome alignment against its score.
    Returns the launches by configuration."""
    import numpy as np

    from poasta_tpu_torch import BandedScorer, NativeAligner, bench
    from poasta_tpu_torch.aligner import banded as banded_mod
    from poasta_tpu_torch.aligner import wavefront as wavefront_mod
    from poasta_tpu_torch.ops import cuda_fill as cf
    from poasta_tpu_torch.ops import seed as sd
    from poasta_tpu_torch.ops import trace as tr

    t_phase = time.perf_counter()
    wrappers = {
        "B1": cf.banded_end_rows, "B2": cf.fill_end_rows,
        "B3": cf.drift_end_rows, "B4": cf.bounded_best_rows,
        "B5": cf.ef_best_rows, "B6": cf.drift_ef_best_rows,
        "B7": cf.bounded_end_rows, "B8": sd.seed_end_states,
        "B12": cf.fill_end_rows_2p, "B13": cf.bounded_best_rows_2p,
        "B14": cf.bounded_end_rows_2p, "B16": cf.banded_end_rows_2p,
        "B17": cf.drift_end_rows_2p, "B2f": cf.free_fill_rows,
        "B12f": cf.free_fill_rows_2p, "B18": tr.trace_fill,
        "decode": tr.trace_decode}
    current, launches, built, scored, outputs = [None], {}, {}, {}, {}

    def counted(name, fn):
        def run(*args, **kwargs):
            current[0] = name
            before = {k: w.launches for k, w in wrappers.items()}
            out = fn(*args, **kwargs)
            launches[name] = {k: w.launches - before[k]
                              for k, w in wrappers.items()
                              if w.launches != before[k]}
            return out
        return run

    def recorded(store, fn):
        def run(*args, **kwargs):
            out = fn(*args, **kwargs)
            store.setdefault(current[0], []).append((args, out))
            return out
        return run

    buf = io.StringIO()
    with ExitStack() as stack:
        for name in BENCH_CONFIGS:
            fn = f"run_{name}"
            stack.enter_context(mock.patch.object(
                bench, fn, counted(name, getattr(bench, fn))))
        for store, fn in ((built, "build_uniform"), (built, "build_mixed_div"),
                          (built, "build_pangenome"),
                          (scored, "_time_scores"), (outputs, "_time_calls")):
            stack.enter_context(mock.patch.object(
                bench, fn, recorded(store, getattr(bench, fn))))
        for w in wrappers.values():
            w.launches = 0
        try:
            with contextlib.redirect_stdout(buf):
                rc = bench.main([])
        finally:
            lines = buf.getvalue().splitlines()
            print(f"[bench] {lines[-1] if lines else ''}", flush=True)
    total = {k: w.launches for k, w in wrappers.items() if w.launches}
    if rc != 0 or len(lines) != 1:
        raise AssertionError(f"14: main returned {rc} with {len(lines)} "
                             "lines on standard output, not one")
    line = json.loads(lines[0])
    with open(os.path.join(REPO, "BENCH_r05.json")) as fh:
        want = set(json.load(fh)["parsed"]) - BENCH_INT16_KEYS \
            | BENCH_PORT_KEYS
    if set(line) != want or "error" in line:
        raise AssertionError(f"14: keys missing {sorted(want - set(line))}, "
                             f"not expected {sorted(set(line) - want)}")
    if line["backend"] != "torch-cuda" or line["card"] != card:
        raise AssertionError(f"14: backend {line['backend']}, card "
                             f"{line['card']}")
    if line["seed_engaged"] is not True:
        raise AssertionError("14: the pangenome calls did not seed")
    summed = {}
    for n in launches.values():
        for k, v in n.items():
            summed[k] = summed.get(k, 0) + v
    if summed != total:
        raise AssertionError(f"14: launches outside the configurations: "
                             f"{total} against {summed}")
    # the tiered retry engaged: every timed call took more than one B1 tier
    (scorer, _, _, _), _ = scored["mixed_div"][0]
    n_calls = bench.ITERS["mixed_div"] + 1
    if scorer.stats["tiers"] < 2 \
            or launches.get("mixed_div", {}).get("B1", 0) < 2 * n_calls:
        raise AssertionError(f"14: mixed_div took one tier a call: "
                             f"{scorer.stats}, {launches}")
    print(f"[bench] launches by configuration {launches}", flush=True)

    # mixed_div's last timed call, again with the plain versions from the
    # scorer's learned hints and window tables (so, where the last call left
    # the hint where it found it, the same tiers and tail): equal scores
    (scorer, qm, lm, _), (got, _, _) = scored["mixed_div"][0]
    plain = BandedScorer(scorer.flat, costs, dg=scorer.dg)
    plain._ub_hint = dict(scorer._ub_hint)
    plain._prep_cache = dict(scorer._prep_cache)
    stats = dict(scorer.stats)
    t0 = time.perf_counter()
    with mock.patch.object(banded_mod, "banded_scores",
                           cf.banded_scores_plain), \
            mock.patch.object(wavefront_mod, "fill_scores",
                              cf.fill_scores_plain):
        want_scores = plain.scores(qm, lm)
    plain_s = time.perf_counter() - t0
    if not np.array_equal(got, want_scores):
        raise AssertionError(f"14: mixed_div: {int((got != want_scores).sum())}"
                             " scores differ from the plain path's")
    (graph, reads) = built["mixed_div"][0][1]
    tail = list(range(0, 160, 20))
    na = NativeAligner(graph)
    native = _native_scores(na, [reads[i] for i in tail], costs)
    if [int(got[i]) for i in tail] != native:
        raise AssertionError("14: mixed_div 15% reads differ from the native "
                             "banded engine's")
    print(f"[bench] mixed_div: {len(got)} scores equal the plain path's "
          f"(ladder {stats}, plain {plain.stats}: "
          f"{'the same' if stats == plain.stats else 'not the same'}; plain "
          f"{plain_s:.1f} s); 15% reads {tail} equal "
          "NativeAligner.align_banded", flush=True)
    for name, build_name, n in (
            ("hybrid", "uniform", bench.SIZES["hybrid_sample"]),
            ("pangenome", "pangenome", None)):
        (graph, reads) = built[build_name][0][1]
        out = outputs[name][0][1][0]
        for read, (score, aln) in zip(reads[:n], out):
            cost = wavefront_mod.alignment_cost(graph, read, aln, costs)
            if cost != score:
                raise AssertionError(f"14: {name}: an alignment costs {cost}"
                                     f", its score {score}")
    print("[bench] every hybrid and pangenome alignment costs its score",
          flush=True)
    _phase_done("14 the bench entry")
    print(f"[time] phase 14 in all: {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return launches


def _align_routes(mapper, reads, token, device_out=None):
    """``align_batch`` on prescored reads, first on the default route (every
    read must be traced on the device), then with ``POASTA_DEVICE_TRACE=0``
    (every read through the native host backtrace); the two must give the
    same scores and alignments.  Returns the wall seconds of each; a list
    ``device_out`` receives the device route's output."""
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
        if route == "device" and device_out is not None:
            device_out[:] = out
        key = "device_traced" if route == "device" else "host_backtraced"
        if mapper.last_banded_stats[key] != len(reads):
            raise AssertionError(f"{route} route: {mapper.last_banded_stats}")
    if outs["device"] != outs["host"]:
        raise AssertionError("device-traced alignments differ from the native "
                             "host backtrace's")
    return secs


if __name__ == "__main__":
    sys.exit(main())
