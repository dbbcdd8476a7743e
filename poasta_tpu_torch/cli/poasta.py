"""`poasta` CLI of the port: multiple sequence alignment and POA graph
tooling.

    python -m poasta_tpu_torch.cli.poasta align [-I graph] [-o out]
        [-O poasta|poasta-rs|fasta|gfa|gfav1|dot]
        [-m global|semi-global|ends-free] [-n N] [-g G[,G2]] [-e E[,E2]]
        [-H dijkstra|mingap|path] [-d DIR] [--engine exact|banded]
        [--device-assist auto|on|off] [--device cuda|cpu] sequences.fa
    python -m poasta_tpu_torch.cli.poasta view graph -O FORMAT [-o out]
    python -m poasta_tpu_torch.cli.poasta stats graph

Flag-compatible with ``poasta_tpu.cli.poasta`` and byte-equal in its
output, with one flag of its own: ``--device {cuda,cpu}``.  The card serves
one thing here, the device assist of ``--engine banded``: while the native
engine aligns a sequence, the card scores the next one against the current
graph, and that score seeds the next native fill's band
(:mod:`..aligner.fusion_assist`).  The assist needs the device the flag
names: without a card, ``--device cuda`` (the default) exits with status 1
wherever the assist may run; ``--device cpu`` runs it with the kernels'
plain PyTorch versions.  ``--device-assist auto`` turns it on for
``--device cuda`` on a host with two or more cores when a sequence has
8,192 bases or more.

The native exact engine serves the global span (``mingap`` and
``dijkstra``) and ``--engine banded``; it is built at first use, and a
failed build raises instead of falling back to the Python engine.
"""

from __future__ import annotations

import argparse
import io
import os
import sys

from ..utils.device import NoDeviceError
from ..utils.errors import PoastaError

# the assist's auto gate: a sequence at least this long
ASSIST_MIN_LEN = 8192


def _load_any_graph(path):
    from ..io import is_fasta_path, load_graph, load_graph_from_fasta_msa

    if is_fasta_path(path):
        return load_graph_from_fasta_msa(path)
    with open(path, "rb") as fh:
        return load_graph(fh)


def _parse_penalties(s: str):
    return [int(v.strip()) for v in str(s).split(",")]


def _make_aligner(args, debug_sink=None):
    from ..aligner import (
        EndsFree,
        GapAffine,
        GapAffine2Piece,
        Global,
        PoastaAligner,
        parse_heuristic,
    )

    heuristic = parse_heuristic(args.heuristic)
    if heuristic is None:
        raise SystemExit(
            "Invalid heuristic type. Valid options are: dijkstra, mingap, path"
        )
    span = Global() if args.alignment_span == "global" else EndsFree()

    gap_open = _parse_penalties(args.cost_gap_open)
    gap_extend = _parse_penalties(args.cost_gap_extend)
    mismatch = args.cost_mismatch
    if len(gap_open) == 2 and len(gap_extend) == 2:
        if gap_extend[0] <= gap_extend[1]:
            print(
                f"Warning: gap_extend1 ({gap_extend[0]}) should be greater than "
                f"gap_extend2 ({gap_extend[1]}) for two-piece model",
                file=sys.stderr,
            )
            print("Using standard affine gap model instead.", file=sys.stderr)
            costs = GapAffine(mismatch, gap_extend[0], gap_open[0])
        else:
            costs = GapAffine2Piece(
                mismatch, gap_extend[0], gap_open[0], gap_extend[1], gap_open[1]
            )
    elif len(gap_open) == 1 and len(gap_extend) == 1:
        costs = GapAffine(mismatch, gap_extend[0], gap_open[0])
    else:
        raise SystemExit(
            "Gap penalties must both be single values (affine) or both "
            "comma-separated pairs (two-piece affine)"
        )
    return PoastaAligner(costs, span, heuristic=heuristic, debug_sink=debug_sink)


def _emit(graph, output_type: str, out_path):
    from ..io import (
        format_as_dot,
        graph_to_gfa,
        graph_to_gfav1,
        poa_graph_to_fasta,
        save_graph,
    )

    if output_type in ("poasta", "poasta-rs"):
        if output_type == "poasta-rs":
            # the reference's bincode layout, so graphs built here resume
            # in the Rust binary
            from ..io.bincode import dump_rust_poasta as save_graph  # noqa: F811
        if out_path is None and sys.stdout.isatty():
            print(
                "WARNING: not writing binary graph data to terminal standard output!",
                file=sys.stderr,
            )
            return
        if out_path is None:
            save_graph(graph, sys.stdout.buffer)
        else:
            with open(out_path, "wb") as fh:
                save_graph(graph, fh)
        return

    buf = io.StringIO()
    if output_type == "fasta":
        poa_graph_to_fasta(graph, buf)
    elif output_type == "gfa":
        graph_to_gfa(graph, buf)
    elif output_type == "gfav1":
        graph_to_gfav1(graph, buf)
    elif output_type == "dot":
        format_as_dot(graph, buf)
    else:
        raise SystemExit(f"unknown output type {output_type}")

    if out_path is None:
        sys.stdout.write(buf.getvalue())
    else:
        os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
        with open(out_path, "w") as fh:
            fh.write(buf.getvalue())


def _make_assist(args, costs, records):
    """The device assist of ``--engine banded``, or None when it is off.

    ``--device-assist on`` runs it on the device ``--device`` names;
    ``auto`` only on the card, with a spare host core for the native fill
    and a sequence of :data:`ASSIST_MIN_LEN` bases or more.  The device is
    resolved first, so a missing card exits whatever the gate decides."""
    from ..aligner.fusion_assist import DeviceSeedPrefetcher
    from ..utils.device import resolve_device

    if args.device_assist == "off":
        return None
    device = resolve_device(None if args.device == "cuda" else "cpu")
    want = args.device_assist == "on" or (
        device.type == "cuda" and (os.cpu_count() or 1) >= 2
        and any(len(s) >= ASSIST_MIN_LEN for _, s in records))
    return DeviceSeedPrefetcher(costs, device=device) if want else None


def align_subcommand(args):
    from ..graphs import POAGraph
    from ..io import read_fasta
    from ..utils.debug import DebugOutputWriter

    debug_sink = DebugOutputWriter(args.debug_output) if args.debug_output else None
    aligner = _make_aligner(args, debug_sink=debug_sink)
    graph = _load_any_graph(args.graph) if args.graph else POAGraph()

    # the native engine is byte-identical to the Python engine (same search
    # and backtrace) where it covers the configuration
    use_native = (args.alignment_span == "global" and debug_sink is None
                  and aligner.heuristic_name in ("mingap", "dijkstra"))
    # --engine banded: exact scores by the native verify-and-retry banded
    # fill, with co-optimal tie-breaks that may differ from the A* engine's
    use_banded = args.engine == "banded"
    if use_banded and (args.alignment_span != "global"
                       or debug_sink is not None):
        raise SystemExit(
            "--engine banded supports global alignment without debug output")

    records = list(read_fasta(args.sequences))
    assist = _make_assist(args, aligner.costs, records) if use_banded \
        else None
    try:
        _fuse(graph, aligner, records, debug_sink, use_native, use_banded,
              assist)
    finally:
        if assist is not None:
            assist.close()
    if assist is not None and args.verbose:
        print(f"INFO: device assist {assist.stats}", file=sys.stderr)
    _emit(graph, args.output_type or "poasta", args.output)
    if debug_sink is not None:
        debug_sink.close()


def _fuse(graph, aligner, records, debug_sink, use_native, use_banded,
          assist):
    """Align each record to the graph and fuse it in, in file order."""
    from ..native import NativeAligner

    last_banded_score = None
    for idx, (name, seq) in enumerate(records):
        weights = [1] * len(seq)
        if debug_sink is not None:
            debug_sink.new_sequence(name, seq, graph)
        if graph.is_empty():
            graph.add_alignment_with_weights(name, seq, None, weights)
            continue
        if use_banded and graph.node_count() > 0:
            # sequences of one MSA have similar divergence: the previous
            # score (+ slack) usually makes the first fill verify, and a
            # low seed only costs a retry; a prefetched device score is an
            # upper bound and beats both
            ub_dev = assist.take(seq) if assist is not None else None
            if assist is not None and idx + 1 < len(records):
                assist.prefetch(graph, records[idx + 1][1])
            if ub_dev is not None:
                ub = ub_dev
            elif last_banded_score is not None:
                ub = int(last_banded_score * 3 / 2) + 64
            else:
                ub = None
            score, alignment = NativeAligner(graph).align_banded(
                seq, aligner.costs, ub=ub)
            last_banded_score = score
        elif use_native and graph.node_count() > 0:
            score, alignment, _stats = NativeAligner(graph).align(
                seq, aligner.costs, heuristic=aligner.heuristic_name)
        else:
            result = aligner.align(graph, seq)
            score, alignment = result.score, result.alignment
        print(
            f"DEBUG: Aligned '{name}' (len={len(seq)}) - "
            f"Score: Score({score}), "
            f"Alignment length: {len(alignment)}",
            file=sys.stderr,
        )
        if alignment is not None and not any(p.is_aligned() for p in alignment):
            # co-optimal alignments of an unrelated sequence can collapse to
            # pure indel runs, which fusion cannot anchor: fuse the sequence
            # as a fresh unaligned chain, as the reference package does
            print(
                f"WARNING: '{name}' shares no aligned column with the "
                "graph; fusing it unaligned",
                file=sys.stderr,
            )
            graph.add_alignment_with_weights(name, seq, None, weights)
        else:
            graph.add_alignment_with_weights(name, seq, alignment, weights)


def view_subcommand(args):
    from ..io import graph_to_dot

    graph = _load_any_graph(args.graph)
    if args.output_type == "dot":
        # the view subcommand uses the annotated visualization DOT
        buf = io.StringIO()
        graph_to_dot(graph, buf)
        if args.output is None:
            sys.stdout.write(buf.getvalue())
        else:
            with open(args.output, "w") as fh:
                fh.write(buf.getvalue())
        return
    _emit(graph, args.output_type, args.output)


def stats_subcommand(args):
    graph = _load_any_graph(args.graph)
    print(f"node_count: {graph.node_count()}", file=sys.stderr)
    print(
        f"node_count_with_start: {graph.node_count_with_start_and_end()}",
        file=sys.stderr,
    )
    print(f"edge_count: {graph.edge_count()}", file=sys.stderr)
    nodes = list(graph.all_nodes())
    avg_in = sum(graph.in_degree(n) for n in nodes) / len(nodes)
    avg_out = sum(graph.out_degree(n) for n in nodes) / len(nodes)
    print(f"avg_in_degree: {avg_in:.2f}", file=sys.stderr)
    print(f"avg_out_degree: {avg_out:.2f}", file=sys.stderr)


def build_parser():
    p = argparse.ArgumentParser(
        prog="poasta",
        description="Fast and exact partial order alignment (PyTorch/CUDA)")
    p.add_argument("-v", "--verbose", action="count", default=0)
    sub = p.add_subparsers(dest="command")

    a = sub.add_parser("align", help="Perform MSA and create or update POA graphs")
    a.add_argument("sequences")
    a.add_argument("-I", "--graph", default=None)
    a.add_argument("-o", "--output", default=None)
    a.add_argument("-O", "--output-type", dest="output_type", default=None,
                   choices=["poasta", "poasta-rs", "fasta", "gfa", "gfav1", "dot"])
    a.add_argument("-d", "--debug-output", dest="debug_output", default=None)
    a.add_argument("-m", "--alignment-span", dest="alignment_span", default="global",
                   choices=["global", "semi-global", "ends-free"])
    a.add_argument("-n", dest="cost_mismatch", type=int, default=4)
    a.add_argument("-g", dest="cost_gap_open", default="6")
    a.add_argument("-e", dest="cost_gap_extend", default="2")
    a.add_argument("-H", "--heuristic", default="mingap")
    a.add_argument("--device-assist", dest="device_assist", default="auto",
                   choices=["auto", "on", "off"],
                   help="with --engine banded: score each next sequence on "
                        "the device in the background as an exact band "
                        "seed (auto: on for sequences of 8,192 bases or "
                        "more on the card, with a spare host core)")
    a.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="device of the assist (default cuda: the card, "
                        "exit 1 without one; cpu: the kernels' plain "
                        "PyTorch versions)")
    a.add_argument("--engine", default="exact", choices=["exact", "banded"],
                   help="exact: reference-parity A* (default); banded: "
                        "verify-and-retry banded fill: true optimal "
                        "scores, much faster on long divergent sequences; "
                        "co-optimal tie-breaks may differ, and for "
                        "two-piece penalties the A* engine's scores can "
                        "be higher (its two-piece heuristic reproduces the "
                        "reference's inadmissible quirk)")

    v = sub.add_parser("view", help="Convert POA graphs to various output formats")
    v.add_argument("graph")
    v.add_argument("-o", "--output", default=None)
    v.add_argument("-O", "--output-type", dest="output_type", required=True,
                   choices=["poasta", "poasta-rs", "fasta", "gfa", "gfav1", "dot"])

    s = sub.add_parser("stats", help="Print graph statistics")
    s.add_argument("graph")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    try:
        if args.command == "align":
            align_subcommand(args)
        elif args.command == "view":
            view_subcommand(args)
        elif args.command == "stats":
            stats_subcommand(args)
        else:
            print("No subcommand given.", file=sys.stderr)
            return 1
    except (OSError, ValueError, PoastaError, NoDeviceError) as exc:
        # user-input errors and a missing card exit cleanly (the reference
        # prints anyhow's "Error: ..." line, not a backtrace)
        print(f"Error: {exc}", file=sys.stderr)
        return 1
    return 0


def main_entry() -> None:
    """console_scripts entry point (sys.exit for shell status)."""
    sys.exit(main())


if __name__ == "__main__":
    sys.exit(main())
