"""`lasagna` CLI of the port: align reads to a static GFA graph, emit GAF.

    python -m poasta_tpu_torch.cli.lasagna align graph.gfa reads.fa -o out.gaf

Flag-compatible with ``poasta_tpu.cli.lasagna`` and byte-equal in its
output, with one flag of its own: ``--device {cuda,cpu}``.  The wavefront
engine batches reads (``-j`` sets the batch size) onto the CUDA cards and
exits with an error when PyTorch sees none; ``--device cpu`` runs the same
path with the kernels' plain PyTorch versions.  ``--engine exact`` runs
the host A* engine per read.  ``-m global|semi-global|ends-free`` picks
the span (semi-global: the whole query against free graph ends, the
read-mapping span; ends-free: every end free); under a span other than
global the exact engine runs the Dijkstra heuristic, as the minimum-gap
heuristic is not admissible when ends are free.

``--mesh`` shards each batch over a device mesh (``parse_mesh_spec``):
``auto`` is dp over every visible card, ``off`` one device, ``DP[,SP]``
explicit axis sizes; under ``--device cpu`` a ``DP[,SP]`` spec builds
DP*SP CPU entries.  A mesh rounds the batch size up to 64 * dp.  Under
``-m semi-global`` or ``ends-free`` a dp-only mesh (``auto``'s, and each
host's under ``--distributed``) keeps one replica of the one-card path a
card: each batch's scoring, its seeding tail pool and its alignment split
into a block a card, each run on its own card (seeded corridors, the
capped tail, the anchored trace and decode), and the records come back in
input order, byte-equal to ``--mesh off``'s.  ``-v`` then adds a line a
card: the reads it aligned and its time in each stage.

``--distributed`` joins a ``torch.distributed`` process group (gloo: no
collective runs inside a fill) at ``tcp://--coordinator-address`` with
``--num-processes`` and ``--process-id``, or without an address from the
environment a ``torchrun`` launch sets (``env://``).  Each process aligns
the round-robin slice of the reads its rank selects and writes
``<output>.part<rank>``; concatenate the parts in round-robin order.
``--shard-index/--shard-count`` regenerate one such part alone, without a
process group (a part lost to a failed process).
"""

from __future__ import annotations

import argparse
import contextlib
import itertools
import sys

from ..utils import spans
from ..utils.device import NoDeviceError
from ..utils.errors import PoastaError

# the id of each chunk _flush_sorted aligns in this process (span attrs)
_CHUNK_IDS = itertools.count()


def span_of(name: str):
    """The alignment span a ``-m`` value names: None for the global span,
    else an ``EndsFree``."""
    from ..aligner import UNBOUNDED, EndsFree, included

    if name == "semi-global":
        return EndsFree(UNBOUNDED, included(0), UNBOUNDED, UNBOUNDED)
    if name == "ends-free":
        return EndsFree(UNBOUNDED, UNBOUNDED, UNBOUNDED, UNBOUNDED)
    return None


def align_subcommand(args):
    from ..aligner import GapAffine, Global, PoastaAligner
    from ..bubbles import BubbleIndex
    from ..io import (
        NodeSegmentResolver,
        alignment_to_gaf,
        load_graph_from_gfa,
        read_fasta,
        read_fastq,
    )
    from ..parallel.mapper import BatchMapper, make_mesh, parse_mesh_spec
    from ..utils.device import resolve_device

    graph, segments = load_graph_from_gfa(
        args.graph, reverse_links=args.reverse_links)
    if graph.node_count() == 0:
        raise SystemExit(f"Error: graph {args.graph!r} contains no segments")
    resolver = NodeSegmentResolver(graph, segments)
    costs = GapAffine(args.cost_mismatch, args.cost_gap_extend,
                      args.cost_gap_open)
    # decided before any file is opened: a missing card raises unless the
    # caller named the CPU (the exact engine runs on the host)
    device = None if args.engine == "exact" else resolve_device(
        None if args.device == "cuda" else "cpu")

    path = str(args.sequences)
    base = path[:-3] if path.endswith(".gz") else path
    is_fastq = base.endswith((".fastq", ".fq"))
    reader = read_fastq(args.sequences) if is_fastq \
        else read_fasta(args.sequences)

    # multi-process layout: dp has no communication inside a fill, so the
    # processes need no collective at all; each aligns the round-robin
    # slice of the read stream its rank selects and writes its own part,
    # <output>.part<rank>.  The standalone shard mode does the same for one
    # index without a process group: parts are a pure function of (input
    # order, shard count, shard index), so a lost one is regenerated by
    # re-running just that index.  Decided before opening any file, so no
    # process truncates the shared output path.
    out_path = args.output
    shard_idx, shard_cnt = args.shard_index, args.shard_count
    multi_process = False
    if (shard_idx is None) != (shard_cnt is None):
        raise ValueError(
            "--shard-index and --shard-count must be given together")
    if shard_cnt is not None:
        if args.distributed:
            raise ValueError(
                "--shard-index/--shard-count cannot be combined with "
                "--distributed (the process index already selects the "
                "shard)")
        if not (0 <= shard_idx < shard_cnt):
            raise ValueError(
                f"--shard-index {shard_idx} out of range for "
                f"--shard-count {shard_cnt}")
    elif args.engine != "exact":
        import torch.distributed as dist

        if dist.is_initialized() and dist.get_world_size() > 1:
            multi_process = True
            shard_idx, shard_cnt = dist.get_rank(), dist.get_world_size()
    if shard_cnt is not None:
        reader = (rec for i, rec in enumerate(reader)
                  if i % shard_cnt == shard_idx)
        if args.output:
            out_path = f"{args.output}.part{shard_idx}"

    # the wavefront engine's mesh, also decided before any file is opened
    mesh = None
    if multi_process:
        # each process runs a dp mesh over its own cards; an explicit
        # global spec cannot be honoured per process, so it is refused
        # rather than replaced by another layout
        if args.mesh not in ("auto", "off", "1", "none"):
            raise ValueError(
                f"--mesh {args.mesh!r} cannot be honored per-host "
                "under --distributed; use --mesh auto (dp over each "
                "host's local devices) or --mesh off")
        import torch

        local = torch.cuda.device_count() if device.type == "cuda" \
            else 1
        mesh = make_mesh(dp=local, sp=1) \
            if args.mesh == "auto" and local > 1 else None
    else:
        mesh = parse_mesh_spec(args.mesh, device=device)

    out = open(out_path, "w") if out_path else sys.stdout

    def emit_record(name, seq, score, alignment):
        rec = alignment_to_gaf(graph, segments, name, seq, alignment,
                               resolver)
        if rec is not None:
            rec.additional_fields.append(("AS", "i", str(score)))
            out.write(str(rec) + "\n")

    aln_type = span_of(args.alignment_span)
    try:
        if args.engine == "exact":
            bubble_index = BubbleIndex(graph)
            aligner = PoastaAligner(
                costs, aln_type if aln_type is not None else Global(),
                heuristic="mingap" if aln_type is None else "dijkstra")
            for name, seq in reader:
                res = aligner.align_with_existing_bubbles(graph, seq,
                                                          bubble_index)
                emit_record(name, seq, res.score, res.alignment)
            return
        batch_size = args.batch_size
        if mesh is not None:
            # round the batch size up so that every full batch splits into
            # 64-read blocks over dp (tail batches split unevenly)
            dp = mesh.shape["dp"]
            quantum = 64 * dp
            batch_size = ((batch_size + quantum - 1) // quantum) * quantum
            if args.verbose:
                print(f"INFO: mesh dp={dp} sp={mesh.shape['sp']} "
                      f"({len(mesh.devices.flat)} devices), "
                      f"batch size {batch_size}", file=sys.stderr)
        if args.verbose:
            print(f"INFO: device {device}, batch size {batch_size}",
                  file=sys.stderr)
        mapper = BatchMapper(graph, costs, mesh=mesh, device=device,
                             batch_size=batch_size, aln_type=aln_type)
        # super-batches are sorted by read length before splitting into
        # device batches (shared windows pay for the length spread);
        # output is restored to input order
        super_size = batch_size * 16
        chunk = []
        for rec in reader:
            if not rec[1]:
                print(f"WARNING: skipping empty read {rec[0]!r}",
                      file=sys.stderr)
                continue
            chunk.append(rec)
            if len(chunk) >= super_size:
                _flush_sorted(mapper, chunk, batch_size, emit_record,
                              args.verbose)
                chunk = []
        if chunk:
            _flush_sorted(mapper, chunk, batch_size, emit_record,
                          args.verbose)
    finally:
        if out_path:
            out.close()


def _flush_sorted(mapper, chunk, batch_size, emit_record, verbose=0):
    """Align one super-batch in length order and emit it in input order.

    Pipelined batches: a worker thread scores batch k+1 while the main
    thread aligns batch k (scoring calls stay serialised on that one
    thread: the scorer's caches are not written concurrently).  The reads
    the seeded corridors leave unresolved join the chunk's
    :class:`~..parallel.mapper.TailPool`; once the last batch is scored,
    the worker fills them all in one launch while the main thread aligns
    that batch, and the main thread then aligns the pool.  Spans:
    ``lasagna.chunk`` over ``lasagna.sort``, per batch k
    ``lasagna.prescore_wait`` (the main thread blocked on the scorer
    thread) and ``lasagna.align``, for a pool its ``lasagna.prescore_wait``
    (attr ``batch`` "pool") and ``lasagna.align_pool``, then
    ``lasagna.emit``; the scorer thread's spans take the chunk as parent
    and the batch they score.  ``verbose`` records them and prints the
    chunk's stage line."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from ..parallel.mapper import TailPool

    with spans.recording() if verbose else contextlib.nullcontext():
        with spans.span("lasagna.chunk", chunk=next(_CHUNK_IDS)) as top:
            with spans.span("lasagna.sort"):
                order = sorted(range(len(chunk)),
                               key=lambda i: len(chunk[i][1]))
                batches = [order[at:at + batch_size]
                           for at in range(0, len(order), batch_size)]
                queries = [[chunk[i][1] for i in idxs] for idxs in batches]
            results = [None] * len(chunk)
            pool = TailPool()
            pooled = []  # the chunk rows of the pool's reads, in its order

            def prescore(k):
                with spans.attach(top, batch=k):
                    return mapper.prescore(queries[k], pool=pool)

            def fill_pool():
                with spans.attach(top):
                    return mapper.fill_tail_pool(pool)

            pipeline = len(batches) > 1 \
                and mapper.supports_prescore(queries[0])
            with ThreadPoolExecutor(max_workers=1) as scorer_thread:
                fut = scorer_thread.submit(prescore, 0) if pipeline else None
                for k, idxs in enumerate(batches):
                    pre = None
                    if fut is not None:
                        with spans.span("lasagna.prescore_wait", batch=k):
                            pre = fut.result()
                    fut = None
                    if pipeline and k + 1 < len(batches):
                        fut = scorer_thread.submit(prescore, k + 1)
                    elif pipeline and pool.reads:
                        # every batch is scored: the pool is whole
                        fut = scorer_thread.submit(fill_pool)
                    with spans.span("lasagna.align", batch=k):
                        out = mapper.align_batch(queries[k], prescored=pre)
                    rows = TailPool.deferred(pre)
                    pooled += [idxs[b] for b in rows]
                    for i, r in zip(np.delete(idxs, rows), out, strict=True):
                        results[i] = r
                if fut is not None:
                    with spans.span("lasagna.prescore_wait", batch="pool"):
                        pre = fut.result()
                    with spans.span("lasagna.align_pool", reads=len(pooled)):
                        out = mapper.align_batch(pool.reads, prescored=pre)
                    for i, r in zip(pooled, out, strict=True):
                        results[i] = r
            with spans.span("lasagna.emit"):
                for (name, seq), (score, alignment) in zip(chunk, results):
                    emit_record(name, seq, score, alignment)
    if verbose:
        recorded = spans.drain()
        print(stage_line(len(chunk), recorded), file=sys.stderr)
        for line in card_lines(recorded):
            print(line, file=sys.stderr)


# the spans of a fill, each one launch (or one launch a shard) and its
# readback
FILL_SPANS = ("ladder.fill", "ladder.full_fill", "seed.fill", "trace.fill")


def stage_line(n_reads: int, recorded: dict) -> str:
    """``lasagna -v``'s line for one chunk, from what :func:`_flush_sorted`
    recorded (``spans.drain()``): the wall, the host stages, the fills
    (the cells they were handed, and the share of the trace fills' cells
    that their rank ranges walked), the alignment routes and the seeding
    outcome."""
    secs, n = {}, {}
    for s in recorded["spans"]:
        secs[s.name] = secs.get(s.name, 0.0) + (s.end_ns - s.start_ns) / 1e9
        n[s.name] = n.get(s.name, 0) + 1
    c = recorded["counts"]

    def t(*names):
        return sum(secs.get(name, 0.0) for name in names)

    cells = sum(v for k, v in c.items() if k.startswith("cells."))
    # the share of the trace fills' cells their rank ranges walked
    handed = c.get("cells.trace_fill", 0)
    walked = f"{c.get('trace.cells_walked', 0) / handed:.4f}" if handed \
        else "-"
    return (
        f"INFO: aligned {n_reads} reads in {t('lasagna.chunk'):.2f}s "
        f"(prescore wait {t('lasagna.prescore_wait'):.2f}s, align "
        f"{t('lasagna.align'):.2f}s, emit {t('lasagna.emit'):.2f}s, seeding "
        f"host {t('seed.hits', 'seed.clusters', 'seed.certify'):.2f}s, "
        f"trace host {t('trace.inputs', 'trace.replay'):.2f}s; device "
        f"fills: {sum(n.get(f, 0) for f in FILL_SPANS)}, cells: {cells}, "
        f"trace cells walked {walked}, tiers: {n.get('ladder.tier', 0)}; "
        f"device traced {c.get('reads.device_traced', 0)}, host backtraced "
        f"{c.get('reads.host_backtraced', 0)}; seeded "
        f"{c.get('reads.seeded', 0)}, tail {c.get('reads.seed_tail', 0)}, "
        f"certificate failed {c.get('reads.cert_failed', 0)}, pooled "
        f"{c.get('reads.tail_pooled', 0)})")


def card_lines(recorded: dict) -> list:
    """``lasagna -v``'s line for each card of a mesh's replicas, from the
    chunk's ``mesh.shard`` spans: the reads it aligned and its time in
    each stage (none without replicas)."""
    cards = {}
    for s in recorded["spans"]:
        if s.name == "mesh.shard":
            c = cards.setdefault(s.attrs["card"], {
                "reads": 0, "prescore": 0.0, "pool": 0.0, "align": 0.0})
            c[s.attrs["stage"]] += (s.end_ns - s.start_ns) / 1e9
            if s.attrs["stage"] == "align":
                c["reads"] += s.attrs["reads"]
    return [f"INFO: card {card}: aligned {c['reads']} reads (mesh.shard "
            f"prescore {c['prescore']:.2f}s, pool {c['pool']:.2f}s, align "
            f"{c['align']:.2f}s)" for card, c in sorted(cards.items())]


def build_parser():
    p = argparse.ArgumentParser(
        prog="lasagna", description="Read-to-graph aligner (PyTorch/CUDA)")
    p.add_argument("-v", "--verbose", action="count", default=0)
    sub = p.add_subparsers(dest="command")

    a = sub.add_parser("align", help="Align reads to a graph, output GAF")
    a.add_argument("-v", "--verbose", action="count",
                   default=argparse.SUPPRESS)
    a.add_argument("graph")
    a.add_argument("sequences")
    a.add_argument("-j", "--num-threads", dest="batch_size", type=int,
                   default=64,
                   help="device batch size (reference: worker thread count)")
    a.add_argument("-o", "--output", default=None)
    a.add_argument("-O", "--output-type", dest="output_type", default="gaf",
                   choices=["gaf"])
    a.add_argument("-m", "--alignment-span", dest="alignment_span",
                   default="global",
                   choices=["global", "semi-global", "ends-free"])
    a.add_argument("-n", dest="cost_mismatch", type=int, default=4)
    a.add_argument("-g", dest="cost_gap_open", type=int, default=6)
    a.add_argument("-e", dest="cost_gap_extend", type=int, default=2)
    a.add_argument("--engine", default="wavefront",
                   choices=["wavefront", "exact"])
    a.add_argument("--reverse-links", dest="reverse_links",
                   default="reject", choices=["reject", "double"],
                   help="GFA links touching the reverse strand: 'reject' "
                        "errors like the reference; 'double' (extension) "
                        "adds reverse-complement segment copies")
    a.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the wavefront engine runs: 'cuda' (default) "
                        "is the first card, an error when PyTorch sees "
                        "none; 'cpu' runs the kernels' plain PyTorch "
                        "versions (the one flag the reference CLI lacks)")
    a.add_argument("--mesh", default="auto", metavar="auto|off|DP[,SP]",
                   help="device mesh for the wavefront engine: 'auto' "
                        "shards the read batch over every visible card "
                        "(dp axis), 'off' forces one device, 'DP,SP' sets "
                        "explicit data/sequence-parallel axis sizes (DP*SP "
                        "CPU entries under --device cpu)")
    a.add_argument("--distributed", action="store_true",
                   help="join a torch.distributed process group (gloo) "
                        "before aligning: each process aligns its rank's "
                        "round-robin slice of the reads and writes "
                        "<output>.part<rank> (address and ranks from the "
                        "flags below, or the torchrun environment)")
    a.add_argument("--coordinator-address", default=None,
                   help="host:port of process 0 (with --distributed)")
    a.add_argument("--num-processes", type=int, default=None,
                   help="total process count (with --distributed)")
    a.add_argument("--process-id", type=int, default=None,
                   help="this process's index (with --distributed)")
    a.add_argument("--shard-index", type=int, default=None,
                   help="align only round-robin slice K of the read stream "
                        "and write <output>.partK, without a process group "
                        "(regenerates a part lost to a failed process)")
    a.add_argument("--shard-count", type=int, default=None,
                   help="total shard count for --shard-index")
    return p


def join_process_group(args) -> None:
    """``torch.distributed.init_process_group`` on the gloo backend: at
    ``tcp://`` + ``--coordinator-address`` with ``--num-processes`` and
    ``--process-id``, or without an address from the environment a
    ``torchrun`` launch sets (``env://``)."""
    import torch.distributed as dist

    if args.coordinator_address is None:
        dist.init_process_group("gloo", init_method="env://")
        return
    if args.num_processes is None or args.process_id is None:
        raise ValueError("--coordinator-address needs --num-processes and "
                         "--process-id")
    dist.init_process_group(
        "gloo", init_method=f"tcp://{args.coordinator_address}",
        world_size=args.num_processes, rank=args.process_id)


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.command != "align":
        print("No subcommand given.", file=sys.stderr)
        return 1
    if args.distributed and args.shard_count is not None:
        # refused before the rendezvous: a mis-wired recovery run errs
        # instead of joining a group
        print("Error: --shard-index/--shard-count cannot be combined with "
              "--distributed (the process index already selects the "
              "shard)", file=sys.stderr)
        return 1
    try:
        if args.distributed:
            join_process_group(args)
        try:
            align_subcommand(args)
        finally:
            if args.distributed:
                import torch.distributed as dist

                if dist.is_initialized():
                    dist.destroy_process_group()
    except (OSError, ValueError, PoastaError, NoDeviceError) as exc:
        print(f"Error: {exc}", file=sys.stderr)
        return 1
    return 0


def main_entry() -> None:
    """console_scripts entry point (sys.exit for shell status)."""
    sys.exit(main())


if __name__ == "__main__":
    sys.exit(main())
