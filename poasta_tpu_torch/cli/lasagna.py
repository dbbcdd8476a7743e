"""`lasagna` CLI of the port: align reads to a static GFA graph, emit GAF.

    python -m poasta_tpu_torch.cli.lasagna align graph.gfa reads.fa -o out.gaf

Flag-compatible with ``poasta_tpu.cli.lasagna`` and byte-equal in its
output, with one flag of its own: ``--device {cuda,cpu}``.  The wavefront
engine batches reads (``-j`` sets the batch size) onto one CUDA card and
exits with an error when PyTorch sees none; ``--device cpu`` runs the same
path with the kernels' plain PyTorch versions.  ``--engine exact`` runs
the host A* engine per read.

Ported: ``-m global|semi-global|ends-free`` (semi-global: the whole query
against free graph ends, the read-mapping span; ends-free: every end
free), ``--engine wavefront|exact`` and the host-only round-robin
``--shard-index/--shard-count``.  ``--distributed`` and a ``--mesh`` that
needs more than one device exit with status 1; every spec the reference
maps to no mesh on one device runs single-device (``auto``, ``off``,
``none``, ``1`` in any case and spacing, and ``DP,SP`` with DP*SP = 1).
Under a span other than global the exact engine runs the Dijkstra
heuristic: the minimum-gap-cost heuristic is not admissible when ends are
free.
"""

from __future__ import annotations

import argparse
import sys

from ..utils.device import NOT_PORTED, NoDeviceError
from ..utils.errors import PoastaError


def mesh_devices(spec: str):
    """The devices a ``--mesh`` spec asks for, as the reference's
    ``parse_mesh_spec`` reads it on one device: 1 for every spec it maps
    to no mesh there (``auto``, ``off``, ``none``, ``1``, and ``DP[,SP]``
    with DP*SP = 1), else DP*SP; None for a spec it cannot parse or a
    size below 1."""
    spec = spec.strip().lower()
    if spec in ("auto", "off", "1", "none"):
        return 1
    parts = spec.split(",")
    try:
        dp = int(parts[0])
        sp = int(parts[1]) if len(parts) > 1 else 1
    except ValueError:
        return None
    return dp * sp if dp >= 1 and sp >= 1 else None


def unported_option(args):
    """The message for an option this port does not carry yet, or None."""
    if args.distributed:
        return f"--distributed: {NOT_PORTED}"
    n = mesh_devices(args.mesh)
    if n is None:
        return f"bad --mesh spec {args.mesh!r} (use auto|off|DP[,SP])"
    if n != 1:
        return (f"--mesh {args.mesh}: {NOT_PORTED} (one card: a spec of one "
                "device, such as auto, off, none, 1 or 1,1)")
    return None


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
    from ..parallel.mapper import BatchMapper
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

    # standalone shard mode: align round-robin slice K of the read stream
    # and write <output>.partK; shards are a pure function of (input
    # order, shard count, shard index), so a lost one is regenerated by
    # re-running just that index.  Decided before opening any file.
    out_path = args.output
    shard_idx, shard_cnt = args.shard_index, args.shard_count
    if (shard_idx is None) != (shard_cnt is None):
        raise ValueError(
            "--shard-index and --shard-count must be given together")
    if shard_cnt is not None:
        if not (0 <= shard_idx < shard_cnt):
            raise ValueError(
                f"--shard-index {shard_idx} out of range for "
                f"--shard-count {shard_cnt}")
        reader = (rec for i, rec in enumerate(reader)
                  if i % shard_cnt == shard_idx)
        if args.output:
            out_path = f"{args.output}.part{shard_idx}"

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
        if args.verbose:
            print(f"INFO: device {device}, batch size {batch_size}",
                  file=sys.stderr)
        mapper = BatchMapper(graph, costs, device=device,
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
    thread: the scorer's caches are not written concurrently)."""
    import time

    from concurrent.futures import ThreadPoolExecutor

    t0 = time.perf_counter()
    order = sorted(range(len(chunk)), key=lambda i: len(chunk[i][1]))
    results = [None] * len(chunk)
    batches = [order[at:at + batch_size]
               for at in range(0, len(order), batch_size)]
    queries = [[chunk[i][1] for i in idxs] for idxs in batches]
    traced = backtraced = 0

    pipeline = len(batches) > 1 and mapper.supports_prescore(queries[0])
    with ThreadPoolExecutor(max_workers=1) as scorer_thread:
        fut = (scorer_thread.submit(mapper.prescore, queries[0])
               if pipeline else None)
        for k, idxs in enumerate(batches):
            pre = fut.result() if fut is not None else None
            if pipeline and k + 1 < len(batches):
                fut = scorer_thread.submit(mapper.prescore, queries[k + 1])
            else:
                fut = None
            out = mapper.align_batch(queries[k], prescored=pre)
            traced += mapper.last_banded_stats["device_traced"]
            backtraced += mapper.last_banded_stats["host_backtraced"]
            for i, r in zip(idxs, out):
                results[i] = r
    for (name, seq), (score, alignment) in zip(chunk, results):
        emit_record(name, seq, score, alignment)
    if verbose:
        dt = time.perf_counter() - t0
        s = mapper.scorer.stats
        msg = (f"INFO: aligned {len(chunk)} reads in {dt:.2f}s (device "
               f"fills: {s['fills']}, cells: {s['cells_filled']}, tiers: "
               f"{s['tiers']}; device traced {traced}, host backtraced "
               f"{backtraced})")
        mapper.scorer.reset_stats()
        ef = mapper.last_ends_free_stats
        if ef:
            msg += (f" [anchored path: device {ef['device_s']:.2f}s,"
                    f" host {ef['host_s']:.2f}s,"
                    f" ok {ef['anchored_ok']},"
                    f" exact-fallback {ef['exact_fallback']}]")
        sd = mapper.last_seed_stats
        if sd:
            msg += (f" [seeded corridors: {sd['seeded']} seeded,"
                    f" {sd['seed_tail']} tail, k={sd['seed_k']},"
                    f" attempts {sd.get('seed_attempts', 1)}]")
        print(msg, file=sys.stderr)


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
                   help="one card only: auto, off, none, 1 and DP,SP with "
                        "DP*SP = 1 all run single-device; a mesh of more "
                        f"devices is {NOT_PORTED}")
    a.add_argument("--distributed", action="store_true",
                   help=f"multi-process dp ({NOT_PORTED})")
    a.add_argument("--coordinator-address", default=None,
                   help="host:port of process 0 (with --distributed)")
    a.add_argument("--num-processes", type=int, default=None,
                   help="total process count (with --distributed)")
    a.add_argument("--process-id", type=int, default=None,
                   help="this process's index (with --distributed)")
    a.add_argument("--shard-index", type=int, default=None,
                   help="align only round-robin slice K of the read stream "
                        "and write <output>.partK")
    a.add_argument("--shard-count", type=int, default=None,
                   help="total shard count for --shard-index")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.command != "align":
        print("No subcommand given.", file=sys.stderr)
        return 1
    msg = unported_option(args)
    if msg is not None:
        print(f"Error: {msg}", file=sys.stderr)
        return 1
    try:
        align_subcommand(args)
    except (OSError, ValueError, PoastaError, NoDeviceError) as exc:
        print(f"Error: {exc}", file=sys.stderr)
        return 1
    return 0


def main_entry() -> None:
    """console_scripts entry point (sys.exit for shell status)."""
    sys.exit(main())


if __name__ == "__main__":
    sys.exit(main())
