"""``lasagna``'s pooled seeding tail on the CPU: ``_flush_sorted`` over a
chunk whose unresolved reads share one capped full fill gives the scores,
end states, alignments and GAF records of aligning its batches one by one
with the inline tail; and the rule that learns the seed rates before the
pool is filled."""

import random

import numpy as np
import pytest
import torch

from poasta_tpu_torch import BatchMapper
from poasta_tpu_torch.aligner import GapAffine
from poasta_tpu_torch.cli import lasagna
from poasta_tpu_torch.graphs import POAGraph
from poasta_tpu_torch.io import (
    NodeSegmentResolver,
    alignment_to_gaf,
    load_graph_from_gfa,
)
from poasta_tpu_torch.io.gfa import graph_to_gfa
from poasta_tpu_torch.ops.dp_rows import INF
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


def _graph_and_reads(n_reads, random_lens, seed=67, n=700, read_len=240):
    """A linear graph with skip edges, reads cut from it at 2%, and random
    reads of ``random_lens`` (each fails its certificate: a seeded tail)
    spread over the chunk."""
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
    for i, ln in enumerate(random_lens):
        reads[3 * i + 1] = "".join(rng.choice("ACGT")
                                   for _ in range(ln)).encode()
    return g, reads


class _Run:
    """A mapper on the GFA round trip of ``g`` (as ``lasagna`` loads it),
    warmed on ``warm`` so that every batch seeds, with its GAF records and
    each read's (score, end rank, end offset) as they reach alignment."""

    def __init__(self, g, tmp_path, warm, batch_size):
        path = tmp_path / "graph.gfa"
        with open(path, "w") as fh:
            graph_to_gfa(g, fh)
        self.graph, self.segments = load_graph_from_gfa(str(path))
        self.resolver = NodeSegmentResolver(self.graph, self.segments)
        self.mapper = BatchMapper(self.graph, COSTS, batch_size=batch_size,
                                  device="cpu",
                                  aln_type=lasagna.span_of("semi-global"))
        self.mapper.align_batch(warm)
        self.gaf, self.ends = {}, {}

    def emit(self, name, seq, score, alignment):
        rec = alignment_to_gaf(self.graph, self.segments, name, seq,
                               alignment, self.resolver)
        if rec is not None:
            rec.additional_fields.append(("AS", "i", str(score)))
        self.gaf[name] = (score, [(p.rpos, p.qpos) for p in alignment],
                          str(rec))


@pytest.fixture
def record_ends(monkeypatch):
    """Each read's (score, end rank, end offset) where it reaches
    ``_align_batch_ends_free``, into the dict of the mapper's run."""
    real = BatchMapper._align_batch_ends_free
    runs = {}

    def spy(self, queries, qshift, lengths, pre_scores=None):
        if pre_scores is None:
            pre_scores = self._ends_free_scores(queries, qshift, lengths)
        run = runs.get(id(self))  # None while a mapper warms up
        for q, sc, er, ej in zip(queries, *pre_scores):
            if run is not None:
                run.ends[q] = (int(sc), int(er), int(ej))
        return real(self, queries, qshift, lengths, pre_scores=pre_scores)

    monkeypatch.setattr(BatchMapper, "_align_batch_ends_free", spy)
    return runs


@pytest.mark.parametrize("ladder", [False, True], ids=["plain", "ladder"])
@pytest.mark.parametrize("case", ["pool", "empty_pool", "single_batch"])
def test_pooled_tail_equals_inline_tail(case, ladder, tmp_path, monkeypatch,
                                        record_ends):
    """The chunk through ``_flush_sorted`` (pooled where it pipelines)
    against its length-sorted batches through ``align_batch`` one by one
    (the inline tail), each mapper warmed alike: the same scores, end
    states, alignments and GAF records; ``reads.tail_pooled`` is the
    batches' ``reads.seed_tail`` in a pipelined chunk and 0 in a single
    batch, whose tail stays inline.  ``ladder``: the capped ladder driven
    on the CPU, as on the card."""
    monkeypatch.setenv("POASTA_SEED", "all")
    monkeypatch.setattr(mapper_mod.os, "cpu_count", lambda: 2)
    monkeypatch.setattr(BatchMapper, "_ef_cap_enabled", lambda self: ladder)
    random_lens = {"pool": (150, 219, 236), "empty_pool": (),
                   "single_batch": (180,)}[case]
    n_reads = 4 if case == "single_batch" else 12
    g, reads = _graph_and_reads(n_reads + 4, random_lens)
    reads, warm = reads[:n_reads], reads[n_reads:]
    chunk = [(f"r{i}", r) for i, r in enumerate(reads)]

    pooled = _Run(g, tmp_path, warm, 4)
    record_ends[id(pooled.mapper)] = pooled
    with spans.recording():
        lasagna._flush_sorted(pooled.mapper, chunk, 4, pooled.emit)
    counts = spans.drain()["counts"]

    inline = _Run(g, tmp_path, warm, 4)
    record_ends[id(inline.mapper)] = inline
    order = sorted(range(len(chunk)), key=lambda i: len(chunk[i][1]))
    for at in range(0, len(order), 4):
        idxs = order[at:at + 4]
        out = inline.mapper.align_batch([chunk[i][1] for i in idxs])
        for i, (score, aln) in zip(idxs, out):
            inline.emit(*chunk[i], score, aln)

    assert pooled.gaf == inline.gaf and len(pooled.gaf) == n_reads
    assert pooled.ends == inline.ends and len(pooled.ends) == n_reads
    tail = counts.get("reads.seed_tail", 0)
    if case == "single_batch":
        assert counts.get("reads.tail_pooled", 0) == 0 and tail >= 1
    else:
        assert counts.get("reads.tail_pooled", 0) == tail
        assert (tail >= len(random_lens)) if random_lens else tail == 0
    assert counts["reads.seeded"] + tail == n_reads


def _rates(lengths, scores, deferred=None):
    m = BatchMapper.__new__(BatchMapper)
    m._seed_rate = None
    m._learn_seed_ub(lengths, scores, deferred=deferred)
    return m._seed_rate


def _batch(rng, B):
    lengths = rng.integers(3000, 5200, B)
    scores = (rng.uniform(0.005, 0.25, B) * lengths).astype(np.int64)
    return lengths, scores


@pytest.mark.parametrize("B,n_tail", [(64, 1), (64, 4), (16, 1), (7, 1)])
def test_rates_equal_the_full_scores_rule_where_the_pool_is_the_top(B,
                                                                    n_tail):
    """Deferred reads that are the batch's highest rates, few enough that
    no percentile index falls on them: the parent rule's rates on the full
    scores, exactly."""
    rng = np.random.default_rng(B * 10 + n_tail)
    lengths, scores = _batch(rng, B)
    top = np.argsort(scores / lengths, kind="stable")[-n_tail:]
    held = scores.copy()
    held[top] = INF  # what the token holds until the pool is filled
    assert _rates(lengths, held, deferred=top) == _rates(lengths, scores)


@pytest.mark.parametrize("seed", [3, 5, 8])
def test_rates_are_never_narrower_than_the_full_scores_rule(seed):
    """Any deferred rows, INF scores among the full ones included: both
    learned rates at least the parent rule's; infinite where a percentile
    index falls on a deferred read."""
    rng = np.random.default_rng(seed)
    for _ in range(200):
        B = int(rng.integers(1, 80))
        lengths, scores = _batch(rng, B)
        scores[rng.random(B) < 0.05] = INF
        deferred = np.nonzero(rng.random(B) < rng.uniform(0, 0.5))[0]
        if not deferred.size:
            continue
        held = scores.copy()
        held[deferred] = INF
        got, want = _rates(lengths, held, deferred), _rates(lengths, scores)
        if want is None:
            continue  # every full score INF: the parent learns nothing
        assert got[0] >= want[0] and got[1] >= want[1], (got, want)
        assert got[0] <= got[1]


def test_infinite_rates_take_the_full_fill_and_learn_again(monkeypatch):
    """After a batch whose deferred reads reach the 90th percentile the
    wide rate is infinite: the next batch takes the full fill, which
    teaches finite rates, and seeds nothing."""
    monkeypatch.setenv("POASTA_SEED", "all")
    g, reads = _graph_and_reads(4, ())
    m = BatchMapper(g, COSTS, batch_size=4, device="cpu",
                    aln_type=lasagna.span_of("semi-global"))
    lengths = np.array([len(r) for r in reads], dtype=np.int64)
    m._learn_seed_ub(lengths, np.full(4, INF), deferred=np.arange(4))
    assert m._seed_rate == (np.inf, np.inf)
    qshift, ln = mapper_mod.pack_queries(reads, device="cpu")
    got = m._ends_free_scores(reads, qshift, ln)
    assert m.last_seed_stats is None and np.isfinite(m._seed_rate[1])
    want = m._fill_ends_free_capped(qshift, ln, lengths)
    for a, b in zip(got, want):
        assert np.array_equal(a, b)
