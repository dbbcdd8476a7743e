"""The benchmark's interface to the port: every name of
``poasta_tpu_torch`` that an adapter calls, imported in this one place
and only when an adapter starts (nothing of the port loads at import)."""

from __future__ import annotations

from types import SimpleNamespace


def names() -> SimpleNamespace:
    from poasta_tpu_torch.aligner.costs import GapAffine
    from poasta_tpu_torch.cli.lasagna import _flush_sorted, span_of
    from poasta_tpu_torch.io import (
        NodeSegmentResolver,
        alignment_to_gaf,
        load_graph_from_gfa,
    )
    from poasta_tpu_torch.parallel.mapper import BatchMapper

    return SimpleNamespace(
        GapAffine=GapAffine, span_of=span_of, flush_sorted=_flush_sorted,
        NodeSegmentResolver=NodeSegmentResolver,
        alignment_to_gaf=alignment_to_gaf,
        load_graph_from_gfa=load_graph_from_gfa, BatchMapper=BatchMapper)


def mapper(ctx, port: SimpleNamespace):
    """(graph, segments, BatchMapper) of the run's GFA under the
    configuration's costs, span and batch size, as ``lasagna`` builds
    them."""
    graph, segments = port.load_graph_from_gfa(ctx.gfa_path)
    c = ctx.config["costs"]
    costs = port.GapAffine(c["mismatch"], c["gap_extend"], c["gap_open"])
    return graph, segments, port.BatchMapper(
        graph, costs, batch_size=ctx.config["batch_size"],
        aln_type=port.span_of(ctx.config["span"]), device=ctx.device)
