"""The replicas of a dp mesh on the CPU: ``BatchMapper(mesh=make_mesh(
[cpu] * 4, dp=4), aln_type=semi-global)`` keeps a single-card mapper a
mesh row and deals each batch to them, a block a card, through
``lasagna``'s ``_flush_sorted`` pipeline, with seeding forced
(``POASTA_SEED=all``) on a small pangenome graph.  Pinned: every card
seeds, pools its unresolved reads and traces its own block; the GAF is
byte-equal to ``--mesh off``'s and to ``poasta_tpu``'s CLI under a dp-4
spec, and every ``AS:i`` is the plain reference's optimum
(``benchmark/reference/dp.py``); a card's failure reaches the caller; the
spans and counters of the dealing, and ``lasagna -v``'s line a card."""

import os
import random
import sys
import threading

import jax
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
from poasta_tpu_torch.parallel import make_mesh
from poasta_tpu_torch.parallel import mapper as mapper_mod
from poasta_tpu_torch.utils import spans

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from benchmark.reference.dp import best_scores  # noqa: E402
from benchmark.reference.gfa import parse_gfa  # noqa: E402

torch.set_num_threads(1)

COSTS = GapAffine(4, 2, 6)
CARDS = 4
BLOCK = 64  # reads a card a batch, as lasagna -j 256 deals them at dp=4


@pytest.fixture(autouse=True)
def seed_all(monkeypatch):
    monkeypatch.setenv("POASTA_SEED", "all")
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


def _pangenome(n_reads, n_random, seed=71, n=300, read_len=90):
    """A backbone of ``n`` bases with a skip edge every 61, and reads cut
    from it at 1%; every ``n_reads // n_random``-th read is random (its
    certificate fails: a seeded tail)."""
    rng = random.Random(seed)
    base = "".join(rng.choice("ACGT") for _ in range(n))
    g = POAGraph()
    g.add_alignment_with_weights("s0", base.encode(), None, [1] * n)
    for v in range(0, n - 3, 61):
        g.add_edge(v, v + 3, 0, 1)
    g.post_process()
    reads = []
    for i in range(n_reads):
        a = rng.randrange(0, n - read_len)
        reads.append(_mutate(rng, base[a:a + read_len - rng.randrange(20)],
                             0.01).encode())
    step = max(n_reads // max(n_random, 1), 1)
    for i in range(n_random):
        reads[i * step + 5] = "".join(
            rng.choice("ACGT") for _ in range(read_len - 10)).encode()
    return g, reads


@pytest.fixture(scope="module")
def gfa(tmp_path_factory):
    """(the GFA path, its text, the reads) of the module's pangenome."""
    g, reads = _pangenome(2 * CARDS * BLOCK + CARDS * BLOCK, 6)
    path = tmp_path_factory.mktemp("replicas") / "graph.gfa"
    with open(path, "w") as fh:
        graph_to_gfa(g, fh)
    return str(path), path.read_text(), reads


class _Mapping:
    """A mapper on the GFA (as ``lasagna`` loads it), warmed on one batch,
    and the GAF of a chunk through ``_flush_sorted``."""

    def __init__(self, path, mesh):
        self.graph, self.segments = load_graph_from_gfa(path)
        self.resolver = NodeSegmentResolver(self.graph, self.segments)
        self.mapper = BatchMapper(self.graph, COSTS, mesh=mesh,
                                  batch_size=CARDS * BLOCK, device="cpu",
                                  aln_type=lasagna.span_of("semi-global"))
        self.gaf = []

    def emit(self, name, seq, score, alignment):
        rec = alignment_to_gaf(self.graph, self.segments, name, seq,
                               alignment, self.resolver)
        if rec is not None:
            rec.additional_fields.append(("AS", "i", str(score)))
            self.gaf.append(str(rec))

    def run(self, chunk):
        lasagna._flush_sorted(self.mapper, chunk, CARDS * BLOCK, self.emit)
        return self.gaf


def test_replicas_seed_pool_and_trace_on_every_card(gfa, monkeypatch):
    """Two batches of four 64-read blocks and a pool: each card seeds its
    blocks, fills its own part of the pool and traces its own reads on
    the thread bound to it; the records equal the one-card mapper's."""
    path, _, reads = gfa
    warm, reads = reads[:CARDS * BLOCK], reads[CARDS * BLOCK:]
    chunk = [(f"r{i}", r) for i, r in enumerate(reads)]
    mesh = make_mesh(["cpu"] * CARDS, dp=CARDS)
    meshed, one = _Mapping(path, mesh), _Mapping(path, None)
    reps = meshed.mapper.replicas
    assert len(reps) == CARDS and one.mapper.replicas is None
    assert all(r.mesh is None and r.replicas is None for r in reps)
    assert {id(r.scorer) for r in reps}.isdisjoint({id(meshed.mapper.scorer)})
    assert len({id(r.scorer) for r in reps}) == CARDS
    assert all(r._native is meshed.mapper._native for r in reps)
    assert [r.dg.device for r in reps] == list(mesh.devices[:, 0])
    for m in (meshed.mapper, one.mapper):
        m.align_batch(warm)
    assert all(r._seed_rate is not None for r in reps)

    traced = []
    real = mapper_mod.trace_align

    def spy(dg, flat, qshift, *args, **kwargs):
        card = spans.current().attrs.get("card")
        traced.append((card, threading.get_ident(), dg, qshift.device,
                       int(qshift.shape[0])))
        return real(dg, flat, qshift, *args, **kwargs)

    monkeypatch.setattr(mapper_mod, "trace_align", spy)
    with spans.recording():
        gaf = meshed.run(chunk)
    rec = spans.drain()
    monkeypatch.setattr(mapper_mod, "trace_align", real)
    assert gaf == one.run(chunk) and len(gaf) == len(chunk)

    shards = [s for s in rec["spans"] if s.name == "mesh.shard"]
    by_stage = {}
    for s in shards:
        by_stage.setdefault(s.attrs["stage"], []).append(s)
    # two batches of four blocks each, scored and aligned; the pool on
    # every card that holds a pooled read
    assert sorted(s.attrs["card"] for s in by_stage["prescore"]) == \
        sorted(list(range(CARDS)) * 2)
    assert {s.attrs["reads"] for s in by_stage["prescore"]} == {BLOCK}
    assert sum(s.attrs["reads"] for s in by_stage["align"]) == len(chunk)
    counts = rec["counts"]
    assert counts["reads.sharded"] == len(chunk)
    assert counts["reads.tail_pooled"] == counts["reads.seed_tail"] > 0
    assert counts["reads.seeded"] + counts["reads.seed_tail"] == len(chunk)
    # every card seeded its blocks and filled its own pooled reads
    for name in ("seed.fill", "seed.certify"):
        assert {s.attrs["card"] for s in rec["spans"]
                if s.name == name} == set(range(CARDS)), name
    pools = [s for s in rec["spans"] if s.name == "seed.tail_pool"]
    assert pools and {s.attrs["stage"] for s in pools} == {"pool"}
    assert sum(s.attrs["reads"] for s in pools) == counts["reads.tail_pooled"]
    assert all(s.attrs["reads"] for s in by_stage["pool"])
    # each card's trace runs on its replica's graph, on the thread of that
    # card's block, once for each of its batches and once for its pool
    shard_threads = {(s.attrs["card"], s.thread) for s in by_stage["align"]}
    assert {c for c, *_ in traced} == set(range(CARDS))
    for card, thread, dg, device, n in traced:
        assert dg is reps[card].dg and device == mesh.devices[card, 0]
        assert (card, thread) in shard_threads and 0 < n <= BLOCK
    # the gathers wait on the calling threads, under the callers' spans
    gathers = [s for s in rec["spans"] if s.name == "mesh.gather"]
    assert len(gathers) == len(by_stage["prescore"]) // CARDS \
        + len({s.parent for s in by_stage["align"]}) + 1
    ids = {s.id: s for s in rec["spans"]}
    assert {ids[s.parent].name for s in by_stage["align"]} == {
        "lasagna.align", "lasagna.align_pool"}
    assert {s.parent for s in by_stage["prescore"]} == {
        s.id for s in rec["spans"] if s.name == "lasagna.chunk"}
    stats = meshed.mapper.last_seed_stats
    assert stats["seeded"] == sum(c["seeded"] for c in stats["cards"] if c)


def test_cli_gaf_byte_equal_and_optimal(gfa, tmp_path, capsys):
    """``lasagna align -m semi-global --mesh 4 --device cpu`` (the
    replicas) writes GAF byte-equal to ``--mesh off`` and to
    ``poasta_tpu``'s CLI under ``--mesh 4,2`` on its 8 virtual devices (dp
    4, the batch rounded to 256 alike; its CLI takes a spec of every
    visible device), with
    every ``AS:i`` the plain reference's optimum; ``-v`` prints a line a
    card whose reads add up to the chunk's."""
    from poasta_tpu.cli.lasagna import main as jax_lasagna

    if jax.device_count() < CARDS:
        pytest.skip("needs 4 virtual devices")
    path, text, reads = gfa
    reads = reads[:CARDS * BLOCK + 100]
    fa = tmp_path / "r.fa"
    fa.write_text("".join(f">r{i}\n{q.decode()}\n"
                          for i, q in enumerate(reads)))
    outs = {}
    for name, main, argv in (
            ("mesh", lasagna.main, ["--mesh", "4", "--device", "cpu"]),
            ("off", lasagna.main, ["--mesh", "off", "--device", "cpu"]),
            ("jax", jax_lasagna, ["--mesh", "4,2"])):
        out = tmp_path / f"{name}.gaf"
        verbose = ["-v"] if name == "mesh" else []
        assert main([*verbose, "align", path, str(fa), "-o", str(out),
                     "-m", "semi-global", *argv]) in (0, None)
        outs[name] = out.read_text()
        if name == "mesh":
            err = capsys.readouterr().err
    assert outs["mesh"] == outs["off"] == outs["jax"]
    records = outs["mesh"].splitlines()
    assert len(records) == len(reads)
    got = [int(r.rsplit("AS:i:", 1)[1]) for r in records]
    want = best_scores(parse_gfa(text), reads,
                       {"mismatch": 4, "gap_open": 6, "gap_extend": 2}, True)
    assert got == [int(v) for v in want]
    lines = [ln for ln in err.splitlines() if ln.startswith("INFO: card ")]
    assert [ln.split(":")[1] for ln in lines] == [
        f" card {c}" for c in range(CARDS)]
    assert sum(int(ln.split("aligned ")[1].split()[0]) for ln in lines) \
        == len(reads)
    assert "seeded 0," not in err


class CardFailure(RuntimeError):
    pass


@pytest.mark.parametrize("stage", ["prescore", "fill_tail_pool",
                                   "align_batch"])
def test_a_cards_failure_reaches_the_caller(gfa, stage):
    """One card's block raises in its stage: ``_flush_sorted`` raises that
    error, after the other cards' blocks have ended."""
    path, _, reads = gfa
    # reads of one length keep their order through the sort: two batches
    # of 8, two reads a card, card 2's rows 4, 5, 12 and 13; a random read
    # in each of card 2's blocks, pooled there
    reads = [q[:66] for q in reads if len(q) >= 66][:24]
    rng = random.Random(5)
    for i in (4, 13):
        reads[8 + i] = "".join(rng.choice("ACGT") for _ in range(66)).encode()
    m = _Mapping(path, make_mesh(["cpu"] * CARDS, dp=CARDS))
    m.mapper.align_batch(reads[:8])
    rep = m.mapper.replicas[2]
    real = getattr(rep, stage)
    calls = []

    def broken(*args, **kwargs):
        calls.append(1)
        real(*args, **kwargs)
        raise CardFailure(f"card 2 failed in {stage}")

    setattr(rep, stage, broken)
    chunk = [(f"r{i}", q) for i, q in enumerate(reads[8:])]
    with pytest.raises(CardFailure, match="card 2 failed"):
        lasagna._flush_sorted(m.mapper, chunk, 8, m.emit)
    assert calls


def test_card_lines_from_recorded_shards():
    """``lasagna -v``'s line a card: the reads its align blocks held and
    its time in each stage, from the chunk's ``mesh.shard`` spans."""
    def shard(card, stage, reads, secs):
        return spans.Span("mesh.shard", 0, None, 0,
                          {"card": card, "stage": stage, "reads": reads},
                          0, int(secs * 1e9))

    recorded = {"spans": [shard(1, "prescore", 64, 0.5),
                          shard(0, "align", 64, 1.25),
                          shard(1, "align", 60, 1.0),
                          shard(1, "pool", 3, 0.25),
                          shard(1, "align", 3, 0.5),
                          spans.Span("lasagna.emit", 1, None, 0, {}, 0, 9)],
                "counts": {}}
    assert lasagna.card_lines(recorded) == [
        "INFO: card 0: aligned 64 reads (mesh.shard prescore 0.00s, pool "
        "0.00s, align 1.25s)",
        "INFO: card 1: aligned 63 reads (mesh.shard prescore 0.50s, pool "
        "0.25s, align 1.50s)"]
    assert lasagna.card_lines({"spans": [], "counts": {}}) == []


def test_blocks_and_tokens_of_the_dealing(gfa):
    """The dealing's arithmetic without a fill: contiguous blocks a card
    (the first ``B % dp`` one read longer, none for an absent card), a
    pool's reads found by card, and a dealt token's deferred rows."""
    path, _, _ = gfa
    m = _Mapping(path, make_mesh(["cpu"] * 3, dp=3)).mapper
    assert [(c, r.tolist()) for c, r in m._blocks(8)] == [
        (0, [0, 1, 2]), (1, [3, 4, 5]), (2, [6, 7])]
    assert [(c, r.tolist()) for c, r in m._blocks(2)] == [(0, [0]), (1, [1])]
    token = mapper_mod._Dealt(["a"], [], np.array([4, 9]))
    assert mapper_mod.TailPool.deferred(token).tolist() == [4, 9]
    assert mapper_mod._summed([None, {"a": 1, "b": 2}, {"a": 3, "b": 4}]) \
        == {"a": 4, "b": 6}
    assert mapper_mod._summed([None, None]) is None
    assert m._on_cards("align", []) == []
