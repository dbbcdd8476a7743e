"""``lasagna align`` on a host of the cell's cards under ``--mesh auto``:
``lasagna_loop``'s caller, its steps, warm-up, counters and outputs, with
the mapper built over a dp mesh of the cards the run is given
(``ctx.devices``; the port's ``make_mesh``, dp = the number of cards, sp
1), as ``lasagna`` builds it on such a host.  The mapper keeps a replica
of the one-card path a card (``BatchMapper.replicas``), and each call
hands one chunk to ``_flush_sorted``, which deals each batch to them, a
block a card.  The warm-up aligns the warm-up reads twice, a block a card:
every replica teaches its seed rates, then makes its seeded launches.
Traced runs count the seeded reads of every card (``last_seed_stats`` sums
its cards').  A port without replicas runs the reference's mesh route
here: unseeded full fills a shard, the trace on the first card."""

from __future__ import annotations

import os

from . import lasagna_loop
from . import port as port_mod


def start(ctx):
    return Caller(ctx)


class Caller(lasagna_loop.Caller):
    def __init__(self, ctx):
        from poasta_tpu_torch.utils.mesh import make_mesh

        if ctx.config["mesh"] != "auto":
            raise ValueError(f"mesh {ctx.config['mesh']!r}: this adapter "
                             "builds lasagna's --mesh auto")
        port = port_mod.names()
        self.port = port
        self.graph, self.segments = port.load_graph_from_gfa(ctx.gfa_path)
        c = ctx.config["costs"]
        self.mapper = port.BatchMapper(
            self.graph,
            port.GapAffine(c["mismatch"], c["gap_extend"], c["gap_open"]),
            mesh=make_mesh(devices=ctx.devices, dp=len(ctx.devices)),
            batch_size=ctx.config["batch_size"],
            aln_type=port.span_of(ctx.config["span"]))
        self.resolver = port.NodeSegmentResolver(self.graph, self.segments)
        self.batch_size = ctx.config["batch_size"]
        self.batches, self.warm = ctx.batches, ctx.warm
        self.path = os.path.join(ctx.tmpdir, "out.gaf")
        self.out = open(self.path, "w")
        self.chunks, self.handed = [], []
        self.emit = ctx.spans.wrap(self._emit_record, "emit_record")
        self.seeded = self.scored = 0
        if ctx.spans.enabled:
            m = self.mapper
            m.prescore = self._seed_count(m.prescore, lambda kw: True)
            m.align_batch = ctx.spans.wrap(self._seed_count(
                m.align_batch, lambda kw: kw.get("prescored") is None),
                "align_batch")
            m.prescore = ctx.spans.wrap(m.prescore, "prescore")
