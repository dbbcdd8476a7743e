"""The port's recorder (``poasta_tpu_torch.utils.spans``) on the CPU: off
it records nothing; under ``torch.profiler`` it records spans of every
thread with their parents and attributes and adds no row of its own to
the profiler's trace; ``lasagna``'s batch loop yields its spans in order;
the cell counters equal the launch arithmetic of the fills made; ``lasagna
-v`` prints its stage line and leaves the scorer's counters alone."""

import random
import re
import sys
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from poasta_tpu_torch import BatchMapper
from poasta_tpu_torch.aligner import GapAffine
from poasta_tpu_torch.cli import lasagna
from poasta_tpu_torch.graphs import POAGraph
from poasta_tpu_torch.io.gfa import graph_to_gfa
from poasta_tpu_torch.ops import seed as seed_mod
from poasta_tpu_torch.ops import trace as trace_mod
from poasta_tpu_torch.parallel import mapper as mapper_mod
from poasta_tpu_torch.utils import spans

torch.set_num_threads(1)

COSTS = GapAffine(4, 2, 6)


@pytest.fixture(autouse=True)
def empty_recorder():
    spans.drain()
    yield
    spans.drain()


def _mutate(rng, s, d):
    out = []
    for ch in s:
        r = rng.random()
        if r < d:
            continue
        out.append(rng.choice("ACGT") if r < 2 * d else ch)
    return "".join(out) or "A"


def _mapping_workload(seed=53, n=700, n_reads=8, read_len=240):
    """A linear graph with skip edges and reads cut from it at 2%, one of
    them random (it fails its certificate: a seeded tail)."""
    rng = random.Random(seed)
    base = "".join(rng.choice("ACGT") for _ in range(n))
    g = POAGraph()
    g.add_alignment_with_weights("s0", base.encode(), None, [1] * n)
    for v in range(0, n - 3, 97):
        g.add_edge(v, v + 3, 0, 1)
    g.post_process()
    reads = []
    for _ in range(n_reads):
        a = rng.randrange(0, n - read_len)
        reads.append(_mutate(rng, base[a:a + read_len - rng.randrange(30)],
                             0.02).encode())
    reads[2] = "".join(rng.choice("ACGT") for _ in range(160)).encode()
    return g, reads


def _semi_mapper(g):
    return BatchMapper(g, COSTS, batch_size=4, device="cpu",
                       aln_type=lasagna.span_of("semi-global"))


def _chunk(reads):
    return [(f"r{i}", r) for i, r in enumerate(reads)]


def test_off_records_nothing():
    assert not spans.active()
    off = spans.span("t.off", chunk=1)
    assert spans.span("t.other") is off  # no object made
    with off as sp:
        assert sp is None
        spans.count("t.n", 3)
        assert spans.attach(sp, batch=1) is off
    assert spans.drain() == {"spans": [], "counts": {}}


def test_profiler_records_every_thread_and_adds_no_row():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert spans.active()
        with spans.span("t.main", chunk=7) as top:
            def work():
                with spans.attach(top, batch=3):
                    with spans.span("t.worker", x=1) as sp:
                        spans.count("t.n", 2)
                        return sp, threading.get_ident()

            with ThreadPoolExecutor(max_workers=1) as pool:
                worker, tid = pool.submit(work).result()
    assert not spans.active()
    rec = spans.drain()
    assert [s.name for s in rec["spans"]] == ["t.worker", "t.main"]
    main = rec["spans"][1]
    assert main is top and main.parent is None
    assert main.thread == threading.get_ident() and main.attrs == {"chunk": 7}
    assert worker.parent == main.id and worker.thread == tid != main.thread
    assert worker.attrs == {"chunk": 7, "batch": 3, "x": 1}
    assert main.start_ns <= worker.start_ns <= worker.end_ns <= main.end_ns
    assert rec["counts"] == {"t.n": 2}
    names = {ev.name for ev in prof.events()}
    assert not names & {"t.main", "t.worker"}


def test_flush_sorted_spans_in_order(monkeypatch):
    """``_flush_sorted`` on a small semi-global graph, pipelined: one
    ``lasagna.chunk`` over ``lasagna.sort``, per batch a
    ``lasagna.prescore_wait`` and a ``lasagna.align``, the wait for the
    pooled tail (the random read) and its ``lasagna.align_pool``, then one
    ``lasagna.emit``; the scorer thread's ``mapper.prescore`` spans take
    the chunk as parent and the batch they score, its ``seed.tail_pool``
    the chunk and the pool's reads.  No profiler row bears a program
    span's name."""
    monkeypatch.setenv("POASTA_SEED", "all")
    monkeypatch.setattr(mapper_mod.os, "cpu_count", lambda: 2)
    g, reads = _mapping_workload(n=300, read_len=120)
    mapper = _semi_mapper(g)
    emitted = []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        lasagna._flush_sorted(mapper, _chunk(reads), 4,
                              lambda *rec: emitted.append(rec[0]))
    rec = spans.drain()
    assert sorted(emitted) == sorted(f"r{i}" for i in range(len(reads)))
    by_id = {s.id: s for s in rec["spans"]}
    (chunk,) = [s for s in rec["spans"] if s.name == "lasagna.chunk"]
    assert chunk.parent is None
    kids = sorted((s for s in rec["spans"] if s.parent == chunk.id
                   and s.thread == chunk.thread), key=lambda s: s.start_ns)
    assert [(s.name, s.attrs.get("batch")) for s in kids] == [
        ("lasagna.sort", None),
        ("lasagna.prescore_wait", 0), ("lasagna.align", 0),
        ("lasagna.prescore_wait", 1), ("lasagna.align", 1),
        ("lasagna.prescore_wait", "pool"), ("lasagna.align_pool", None),
        ("lasagna.emit", None)]
    pre = sorted((s for s in rec["spans"] if s.name == "mapper.prescore"),
                 key=lambda s: s.start_ns)
    assert [s.attrs for s in pre] == [
        {"chunk": chunk.attrs["chunk"], "batch": k} for k in (0, 1)]
    assert all(s.parent == chunk.id and s.thread != chunk.thread
               for s in pre)
    (pool,) = [s for s in rec["spans"] if s.name == "seed.tail_pool"]
    assert pool.attrs == {"chunk": chunk.attrs["chunk"], "reads": 1}
    assert pool.parent == chunk.id and pool.thread == pre[0].thread
    assert pool.start_ns >= pre[-1].end_ns
    assert kids[-2].attrs["reads"] == 1
    assert rec["counts"]["reads.tail_pooled"] == 1
    assert "seed.tail" not in {s.name for s in rec["spans"]}
    # the pool's alignment has leaves under it: its idle time is explained
    assert any(by_id[s.parent].name == "mapper.align_batch"
               and by_id[by_id[s.parent].parent] is kids[-2]
               for s in rec["spans"] if s.parent in by_id
               and by_id[s.parent].parent in by_id)
    # every span lies inside its parent, and the names are the layers'
    for s in rec["spans"]:
        assert s.start_ns <= s.end_ns
        if s.parent is not None:
            p = by_id[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
    names = {s.name for s in rec["spans"]}
    assert {"mapper.align_batch", "mapper.pack", "seed.hits",
            "seed.clusters", "seed.fill", "seed.certify", "trace.sub_batch",
            "trace.inputs", "trace.fill", "trace.decode", "trace.replay",
            "mapper.anchored_host", "seed.tail_pool", "lasagna.align_pool",
            "ladder.full_fill"} <= names
    assert not names & {ev.name for ev in prof.events()}


def test_cell_counters_equal_the_launch_arithmetic(monkeypatch):
    """``cells.trace_fill``, ``cells.seed_fill`` and ``cells.tail_fill``
    against the planes each trace fill returned, each seed fill's rank
    ranges times its width, and ranks x padded length x reads of each
    capped full fill, every cap retry included (the capped ladder driven
    on the CPU); ``trace.cells_walked`` against each trace fill's rank
    ranges (both ends included) times its width, below the cells handed
    (the semi-global span's free graph begin)."""
    monkeypatch.setenv("POASTA_SEED", "all")
    monkeypatch.setattr(mapper_mod.BatchMapper, "_ef_cap_enabled",
                        lambda self: True)
    want = {"cells.trace_fill": 0, "cells.seed_fill": 0,
            "cells.tail_fill": 0, "trace.cells_walked": 0}
    calls = {k: 0 for k in want}
    real_trace, real_seed = trace_mod.trace_fill, seed_mod.seed_end_states
    real_full = mapper_mod.dp_fill_ends_free_with_ends

    def trace_fill(*args, **kwargs):
        aval, ptr = real_trace(*args, **kwargs)
        want["cells.trace_fill"] += ptr.numel()
        calls["cells.trace_fill"] += 1
        span = (kwargs["r_end"].numpy().astype(np.int64)
                - kwargs["r_begin"].numpy().astype(np.int64) + 1)
        want["trace.cells_walked"] += int(np.clip(span, 0, None).sum()) \
            * kwargs["Wb"]
        calls["trace.cells_walked"] += 1
        return aval, ptr

    def seed_end_states(dg, qshift, wstarts, lengths, jlo, r_begin, r_end,
                        costs, free_start, end_ok, Wb, max_run=0):
        span = (r_end.numpy().astype(np.int64)
                - r_begin.numpy().astype(np.int64))
        want["cells.seed_fill"] += int(np.clip(span, 0, None).sum()) * Wb
        calls["cells.seed_fill"] += 1
        return real_seed(dg, qshift, wstarts, lengths, jlo, r_begin, r_end,
                         costs, free_start, end_ok, Wb, max_run)

    def full_fill(dg, flat, qshift, *args, **kwargs):
        B, L = qshift.shape
        want["cells.tail_fill"] += flat.n_nodes * L * B
        calls["cells.tail_fill"] += 1
        return real_full(dg, flat, qshift, *args, **kwargs)

    monkeypatch.setattr(trace_mod, "trace_fill", trace_fill)
    monkeypatch.setattr(seed_mod, "seed_end_states", seed_end_states)
    monkeypatch.setattr(mapper_mod, "dp_fill_ends_free_with_ends", full_fill)
    g, reads = _mapping_workload()
    mapper = _semi_mapper(g)
    with spans.recording():
        mapper.align_batch(reads[:4])  # learns the seed rates
        mapper.align_batch(reads[:4])  # seeds; the random read is the tail
        mapper.align_batch(reads[4:])
    counts = spans.drain()["counts"]
    assert {k: counts[k] for k in want} == want
    assert min(calls.values()) > 0
    assert 0 < counts["trace.cells_walked"] < counts["cells.trace_fill"]
    # the first batch's full fill verifies at a first cap or retries
    assert calls["cells.tail_fill"] >= 2
    assert counts["reads.seed_tail"] >= 1
    assert counts["reads.seeded"] + counts["reads.seed_tail"] == 8


def test_pooled_tail_cells_under_seed_tail_pool(monkeypatch):
    """A pipelined chunk under the capped ladder (driven on the CPU): each
    full fill of its seeded batches runs under one ``seed.tail_pool`` of
    the chunk, none under ``seed.tail``; ``cells.tail_fill`` is still
    ranks x padded length x reads of each full fill, every cap retry of
    the pool included; ``reads.tail_pooled`` is the batches'
    ``reads.seed_tail``."""
    monkeypatch.setenv("POASTA_SEED", "all")
    monkeypatch.setattr(mapper_mod.os, "cpu_count", lambda: 2)
    monkeypatch.setattr(mapper_mod.BatchMapper, "_ef_cap_enabled",
                        lambda self: True)
    want = {"cells": 0, "reads": []}
    real_full = mapper_mod.dp_fill_ends_free_with_ends

    def full_fill(dg, flat, qshift, *args, **kwargs):
        B, L = qshift.shape
        want["cells"] += flat.n_nodes * L * B
        want["reads"].append(B)
        return real_full(dg, flat, qshift, *args, **kwargs)

    g, reads = _mapping_workload()
    mapper = _semi_mapper(g)
    mapper.align_batch(reads[4:])  # learns the rates: both batches seed
    monkeypatch.setattr(mapper_mod, "dp_fill_ends_free_with_ends", full_fill)
    with spans.recording():
        lasagna._flush_sorted(mapper, _chunk(reads), 4, lambda *rec: None)
    rec = spans.drain()
    counts = rec["counts"]
    assert counts["cells.tail_fill"] == want["cells"] > 0
    assert counts["reads.tail_pooled"] == counts["reads.seed_tail"] >= 1
    by_id = {s.id: s for s in rec["spans"]}
    (pool,) = [s for s in rec["spans"] if s.name == "seed.tail_pool"]
    assert pool.attrs["reads"] == counts["reads.tail_pooled"]
    fills = [s for s in rec["spans"] if s.name == "ladder.full_fill"]
    assert len(fills) == len(want["reads"]) >= 1
    for s in fills:
        while s.parent is not None and s.name != "seed.tail_pool":
            s = by_id[s.parent]
        assert s is pool
    assert set(want["reads"]) == {pool.attrs["reads"]}
    assert "seed.tail" not in {s.name for s in rec["spans"]}


def test_trace_cells_walked_once_a_launch(monkeypatch):
    """``trace.cells_walked`` moves once a trace fill, right after its
    ``cells.trace_fill``, by its reads' rank ranges times its width: on an
    anchored trace no more than the cells it was handed, and on a
    global-span trace (no range: every rank) exactly those."""
    g, reads = _mapping_workload(seed=61, n_reads=4)
    real_trace, real_count = trace_mod.trace_fill, spans.count
    log = []

    def trace_fill(*args, **kwargs):
        rb, re = kwargs.get("r_begin"), kwargs.get("r_end")
        log.append(("launch", None if rb is None else int(
            (re.long() - rb.long() + 1).clamp(min=0).sum()) * kwargs["Wb"]))
        return real_trace(*args, **kwargs)

    def count(name, n=1):
        if name in ("cells.trace_fill", "trace.cells_walked"):
            log.append((name, int(n)))
        real_count(name, n)

    monkeypatch.setattr(trace_mod, "trace_fill", trace_fill)
    monkeypatch.setattr(spans, "count", count)
    monkeypatch.setattr(BatchMapper, "DENSE_TABLE_BUDGET", 0)
    for mapper, anchored in ((_semi_mapper(g), True),
                             (BatchMapper(g, COSTS, device="cpu"), False)):
        log.clear()
        with spans.recording():
            mapper.align_batch(reads)
        assert log and len(log) % 3 == 0
        for (launch, ranged), (handed_k, handed), (walked_k, walked) in zip(
                log[0::3], log[1::3], log[2::3]):
            assert (launch, handed_k, walked_k) == (
                "launch", "cells.trace_fill", "trace.cells_walked")
            assert (ranged is not None) == anchored
            if anchored:
                assert 0 < walked == ranged <= handed
            else:
                assert walked == handed


def test_stage_line_prints_the_walked_share():
    """``lasagna -v``'s line gives the walked share of the trace fills'
    cells; its ``cells:`` total sums the ``cells.*`` counters alone."""
    counts = {"cells.trace_fill": 4000, "cells.seed_fill": 600,
              "trace.cells_walked": 120, "reads.device_traced": 3}
    line = lasagna.stage_line(3, {"spans": [], "counts": counts})
    assert "cells: 4600, trace cells walked 0.0300, tiers: 0;" in line
    line = lasagna.stage_line(3, {"spans": [], "counts": {}})
    assert "cells: 0, trace cells walked -, tiers: 0;" in line


def _cli_inputs(tmp_path, g, reads):
    gfa, fa = tmp_path / "graph.gfa", tmp_path / "reads.fa"
    with open(gfa, "w") as fh:
        graph_to_gfa(g, fh)
    fa.write_text("".join(f">r{i}\n{r.decode()}\n"
                          for i, r in enumerate(reads)))
    return str(gfa), str(fa)


def test_lasagna_verbose_stage_line(tmp_path, monkeypatch, capsys):
    """``lasagna -v`` on the global banded route prints one stage line a
    chunk and leaves ``mapper.scorer.stats`` as a run without ``-v`` does;
    the line's tiers are the scorer's, its reads the traced and
    backtraced ones."""
    monkeypatch.setattr(BatchMapper, "DENSE_TABLE_BUDGET", 0)
    made = []
    real_init = BatchMapper.__init__

    def init(self, *args, **kwargs):
        real_init(self, *args, **kwargs)
        made.append(self)

    monkeypatch.setattr(BatchMapper, "__init__", init)
    g, reads = _mapping_workload(seed=59, n_reads=6)
    gfa, fa = _cli_inputs(tmp_path, g, reads)
    base = ["align", gfa, fa, "-j", "2", "--device", "cpu"]
    assert lasagna.main(base + ["-o", str(tmp_path / "a.gaf")]) == 0
    capsys.readouterr()
    assert lasagna.main(base + ["-o", str(tmp_path / "b.gaf"), "-v"]) == 0
    quiet, loud = (m.scorer.stats for m in made)
    assert loud == quiet and loud["fills"] > 0
    assert (tmp_path / "a.gaf").read_text() == (tmp_path / "b.gaf").read_text()
    (line,) = [ln for ln in capsys.readouterr().err.splitlines()
               if ln.startswith("INFO: aligned ")]
    m = re.fullmatch(
        r"INFO: aligned 6 reads in [\d.]+s \(prescore wait [\d.]+s, align "
        r"[\d.]+s, emit [\d.]+s, seeding host [\d.]+s, trace host [\d.]+s; "
        r"device fills: (\d+), cells: (\d+), trace cells walked 1\.0000, "
        r"tiers: (\d+); device traced "
        r"(\d+), host backtraced (\d+); seeded 0, tail 0, certificate "
        r"failed 0, pooled 0\)", line)
    assert m, line
    fills, cells, tiers, traced, host = map(int, m.groups())
    assert tiers == loud["tiers"] and fills >= loud["fills"]
    assert cells > loud["cells_filled"]  # the trace fills' cells beside
    assert traced + host == 6 and traced > 0
    assert not spans.active()


def test_counts_and_spans_from_many_threads():
    """Threads past the cores, switching often: no count and no span
    lost."""
    n_threads, n_each = 16, 400
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with spans.recording(), spans.span("t.root") as root:
            def work(t):
                with spans.attach(root, worker=t):
                    for _ in range(n_each):
                        spans.count("t.n")
                        with spans.span("t.leaf"):
                            pass
            with ThreadPoolExecutor(max_workers=n_threads) as pool:
                for fut in [pool.submit(work, t) for t in range(n_threads)]:
                    fut.result(timeout=60)
    finally:
        sys.setswitchinterval(old)
    rec = spans.drain()
    assert rec["counts"] == {"t.n": n_threads * n_each}
    leaves = [s for s in rec["spans"] if s.name == "t.leaf"]
    assert len(leaves) == n_threads * n_each
    assert all(s.parent == root.id for s in leaves)
    assert sorted({s.attrs["worker"] for s in leaves}) == list(
        range(n_threads))
