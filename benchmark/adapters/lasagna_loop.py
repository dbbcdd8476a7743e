"""``lasagna align``'s batch loop: each call hands one chunk of reads
(``batch_size`` x ``chunk_batches``, as ``align_subcommand`` gathers them)
to the port's ``_flush_sorted`` with an ``emit_record`` that writes GAF
exactly as ``lasagna``'s does, to a file in the run's temporary directory.
The traffic's batches are the chunks, cycled in order.  The warm-up aligns
the warm-up reads twice: the first call teaches the seed rates, the
second builds the k-mer index and makes the seeded launches.

Traced runs wrap ``emit_record``, ``BatchMapper.align_batch`` and
``prescore`` (spans), and read ``last_seed_stats`` after each call that
scored a batch."""

from __future__ import annotations

import os

from . import port as port_mod


def start(ctx):
    return Caller(ctx)


class Caller:
    def __init__(self, ctx):
        port = port_mod.names()
        self.port = port
        self.graph, self.segments, self.mapper = port_mod.mapper(ctx, port)
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

    def _emit_record(self, name, seq, score, alignment):
        rec = self.port.alignment_to_gaf(self.graph, self.segments, name,
                                         seq, alignment, self.resolver)
        if rec is not None:
            rec.additional_fields.append(("AS", "i", str(score)))
            self.out.write(str(rec) + "\n")

    def _seed_count(self, fn, scores_here):
        """``fn`` that adds the batch's seeded reads to the count when the
        call scores the batch itself (``scores_here(kwargs)``)."""
        def counted(queries, **kwargs):
            fresh = scores_here(kwargs)
            if fresh:
                self.mapper.last_seed_stats = None
            out = fn(queries, **kwargs)
            if fresh:
                stats = self.mapper.last_seed_stats
                self.seeded += stats["seeded"] if stats else 0
                self.scored += len(queries)
            return out
        return counted

    def warm_up(self):
        for _ in range(2):
            self.mapper.align_batch(self.warm)
        self.seeded = self.scored = 0

    def step(self) -> int:
        c = len(self.chunks)
        k = c % len(self.batches)
        chunk = [(f"c{c}r{i}", seq) for i, seq in enumerate(self.batches[k])]
        self.port.flush_sorted(self.mapper, chunk, self.batch_size,
                               self.emit)
        self.chunks.append(k)
        self.handed += [(name, k, i) for i, (name, _) in enumerate(chunk)]
        return len(chunk)

    def counters(self) -> dict:
        return {"seeded": self.seeded, "scored": self.scored,
                "chunks": len(self.chunks)}

    def outputs(self) -> dict:
        self.out.close()
        return {"kind": "gaf", "path": self.path, "reads": self.handed}

    def close(self):
        if not self.out.closed:
            self.out.close()
        self.mapper = self.graph = self.resolver = None
