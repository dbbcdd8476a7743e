"""CPU tests of the benchmark at tiny sizes: the generators, the reference
against hand-worked cases and the port, the metric arithmetic, the
registry, the import rule, the cards a run reports (over fake cards), the
control and the check's faults; and card tests, marked ``cuda``."""

import ast
import json
import os
import shutil
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, REPO)

from benchmark import control, run as bench_run  # noqa: E402
from benchmark.graphgen import build_graph  # noqa: E402
from benchmark.readgen import make_batches  # noqa: E402
from benchmark.reference.dp import best_scores  # noqa: E402
from benchmark.reference.gfa import parse_gfa  # noqa: E402
from benchmark.registry import Registry  # noqa: E402
from benchmark.tracing import Spans  # noqa: E402
from benchmark.yardstick import (  # noqa: E402
    busy_per_card,
    busy_union,
    idle_gaps,
    mean_busy,
    percentile,
)

COSTS = {"mismatch": 4, "gap_open": 6, "gap_extend": 2}
SEED = 2**31 + 12345
GENE = {"backbone_bases": 300, "haplotypes": 4, "divergence": 0.03,
        "variants": {"snp": 1.125, "insertion": 0.5, "deletion": 0.5,
                     "indel_max": 3}}
PAN = {"backbone_bases": 1200, "skip_every": 300, "skip_span": 3}
TINY = {
    "configs/gene5k.json": ("gene5k", {"graph": GENE, "batch_size": 16}),
    "configs/pan200k.json": ("pan200k", {"graph": PAN, "batch_size": 8}),
    "mixes/score_uniform.json": {"source": "haplotypes", "divergence": 0.03,
                                 "cut_to": 300, "batch_reads": 16,
                                 "batches": 2},
    "mixes/score_mixdiv.json": {"source": "haplotypes", "divergence": 0.02,
                                "tail_every": 5, "tail_divergence": 0.15,
                                "batch_reads": 16, "batches": 2},
    "mixes/map_loci.json": {"source": "loci", "read_bases": 120,
                            "divergence": 0.015,
                            "divergence_spread": "binomial",
                            "batch_reads": 16, "batches": 2,
                            "warmup_reads": 8},
}


@pytest.fixture
def tiny(tmp_path, monkeypatch):
    """A checkout-shaped root holding the benchmark's code and its cells
    at tiny sizes; seeding engages on its small graph."""
    root = tmp_path / "root"
    shutil.copytree(os.path.join(REPO, "benchmark"), root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), root)
    for rel, data in TINY.items():
        path = root / "benchmark" / rel
        if isinstance(data, tuple):
            base = json.loads(path.read_text())
            base.update(data[1])
            data = base
        path.write_text(json.dumps(data))
    monkeypatch.setenv("POASTA_SEED", "all")
    return Registry(str(root))


def run_tiny(reg, cell, trace=False, seed=SEED):
    line, _ = bench_run.run_cell(reg, cell, seed, 0.05, trace,
                                 device="cpu", t_start=time.perf_counter())
    return line


# -- generators ---------------------------------------------------------


@pytest.mark.parametrize("spec,mix", [
    (GENE, TINY["mixes/score_mixdiv.json"]),
    (PAN, TINY["mixes/map_loci.json"])])
def test_generators_deterministic_from_seed(spec, mix):
    a = build_graph(spec, SEED), make_batches(
        mix, *build_graph(spec, SEED)[1:], SEED)
    b = build_graph(spec, SEED), make_batches(
        mix, *build_graph(spec, SEED)[1:], SEED)
    c = build_graph(spec, SEED + 1)
    assert a[0][0] == b[0][0] and a[1][0] == b[1][0] and a[1][1] == b[1][1]
    assert c[0] != a[0][0]
    assert len(a[1][0]) == mix["batches"]
    assert all(len(batch) == mix["batch_reads"] for batch in a[1][0])
    assert all(set(r) <= set(b"ACGT") for batch in a[1][0] for r in batch)


def test_binomial_spread_is_one_set_in_the_seeds_order():
    from benchmark.readgen import binomial_scales

    a = binomial_scales(np.random.default_rng(1), 1024, 0.015, 5000)
    b = binomial_scales(np.random.default_rng(2), 1024, 0.015, 5000)
    assert not np.array_equal(a, b)
    assert np.array_equal(np.sort(a), np.sort(b))
    # _mutate's total edits at 1.5% of 5 kb: mean ~233, sd ~15 (6.5%)
    assert abs(a.mean() - 1) < 1e-3 and 0.06 < a.std() < 0.07


def test_mutate_makes_bench_mutates_expected_edits():
    """``_mutate``'s expected edits at fixed counts: d m deletions, 1.125 d m
    changed bases, d (m - deleted) insertions; the same on every seed."""
    from benchmark.readgen import mutate

    src = np.frombuffer(b"ACGT" * 250, dtype=np.uint8)
    for seed in (1, 2, 3):
        out = mutate(np.random.default_rng(seed), src, 0.1)
        assert out.shape[0] == 1000 - 100 + 90
        # one edit-distance column per edit: at most 100 + 113 + 90
        assert (out[:900] != src[:900]).any()
    assert mutate(np.random.default_rng(1), src, 0.1, cut_to=500).shape[0] \
        == 500


# -- the GFA and the reference --------------------------------------------


@pytest.mark.parametrize("spec", [GENE, PAN])
def test_gfa_read_back_by_both_parsers(spec, tmp_path):
    from poasta_tpu_torch.io import load_graph_from_gfa

    gfa = build_graph(spec, SEED)[0]
    path = tmp_path / "g.gfa"
    path.write_text(gfa)
    ref = parse_gfa(gfa)
    graph, segs = load_graph_from_gfa(str(path))
    assert graph.node_count() == ref.n_nodes
    ix = ref.seg_index()

    def rank(seg, pos):
        return int(ref.seg_first[ix[seg]]) + pos

    node_rank = {}
    for s, name in enumerate(segs.names):
        for t in range(segs.segment_lengths[s]):
            node_rank[segs.start_nodes[s] + t] = rank(name, t)
    port_edges = {(node_rank[u], node_rank[v]) for u in node_rank
                  for v in graph.successors(u) if v in node_rank}
    ref_edges = set()
    for si, preds in enumerate(ref.seg_preds):
        first = int(ref.seg_first[si])
        ref_edges.update((first + t - 1, first + t)
                         for t in range(1, len(ref.seg_seqs[si])))
        for p in preds:
            ref_edges.add((int(ref.seg_first[p]) + len(ref.seg_seqs[p]) - 1,
                           first))
    assert port_edges == ref_edges
    syms = bytes(graph.symbols[u] for u in sorted(node_rank,
                                                  key=node_rank.get))
    assert syms == ref.symbols.tobytes()


def _gfa(segs, links):
    return "".join(f"S\t{n}\t{s}\n" for n, s in segs) + "".join(
        f"L\t{a}\t+\t{b}\t+\t0M\n" for a, b in links)


@pytest.mark.parametrize("read,free,want", [
    (b"ACGT", False, 0),            # exact
    (b"ACTT", False, 4),            # one mismatch
    (b"AGT", False, 8),             # one deletion: o + e
    (b"ACGGT", False, 8),           # one insertion
    (b"AT", False, 10),             # a two-base deletion: o + 2e
    (b"ACGTAA", False, 10),         # a trailing two-base insertion
    (b"CG", True, 0),               # free ends: the middle of the graph
    (b"CGA", True, 4),              # free ends: the last base mismatches
    (b"GC", True, 4),               # G->C, the C free: one mismatch
])
def test_reference_hand_worked_line(read, free, want):
    g = parse_gfa(_gfa([("1", "ACGT")], []))
    assert best_scores(g, [read], COSTS, free)[0] == want


def test_reference_hand_worked_bubble():
    # A -> (C | GG) -> T, and A -> T
    g = parse_gfa(_gfa([("1", "A"), ("2", "C"), ("3", "GG"), ("4", "T")],
                       [("1", "2"), ("1", "3"), ("2", "4"), ("3", "4"),
                        ("1", "4")]))
    got = best_scores(g, [b"ACT", b"AGGT", b"AT", b"AGT", b"AAT"], COSTS,
                      False)
    # AGT: A, C for G (4) beats A, G, a deleted G (8)
    assert got.tolist() == [0, 0, 0, 4, 4]


@pytest.mark.parametrize("spec,mix,span", [
    (GENE, TINY["mixes/score_mixdiv.json"], "global"),
    (PAN, TINY["mixes/map_loci.json"], "semi-global")])
def test_reference_equals_port_on_cpu(spec, mix, span, tmp_path):
    from poasta_tpu_torch import BatchMapper, GapAffine
    from poasta_tpu_torch.cli.lasagna import span_of
    from poasta_tpu_torch.io import load_graph_from_gfa

    gfa, haps, bb = build_graph(spec, SEED)
    batches, _, _ = make_batches(mix, haps, bb, SEED)
    path = tmp_path / "g.gfa"
    path.write_text(gfa)
    graph, _ = load_graph_from_gfa(str(path))
    mapper = BatchMapper(graph, GapAffine(4, 2, 6), device="cpu",
                         aln_type=span_of(span))
    want = np.asarray(mapper.score_batch(batches[0]))
    got = best_scores(parse_gfa(gfa), batches[0], COSTS, span != "global")
    assert np.array_equal(got, want)


# -- metric arithmetic ----------------------------------------------------


def test_metric_arithmetic(tiny):
    calls = [(0.0, 1.0, 10), (1.0, 1.5, 10), (1.5, 4.0, 20)]
    run = bench_run.RunRecord(ctx=None, setup_s=3.0, calls=calls,
                              window_s=4.0, counters={"seeded": 9,
                                                      "scored": 12},
                              spans={})
    assert tiny.metric("reads_per_s.map").read(run) == 40 / 4.0
    assert tiny.metric("reads_per_s.score").read(run) == 40 / 4.0
    assert tiny.metric("batch_p95_ms").read(run) == pytest.approx(
        percentile([1.0, 0.5, 2.5], 95) * 1e3)
    assert percentile([1.0, 0.5, 2.5], 95) == pytest.approx(2.35)
    assert tiny.metric("seeded_pct").read(run) == 75.0
    assert tiny.metric("gaf_emit_ms_per_read").read(run) is None
    assert busy_union([(0, 2), (1, 3), (5, 6), (5.5, 5.7)]) == 4
    assert idle_gaps([(1, 2), (1.5, 3), (5, 6)], 0, 7) == [
        (0, 1), (3, 5), (6, 7)]
    run.device_by_card = {0: [
        ("void banded_reg_kernel<false, 0, false, 4>", 0.0, 0.5),
        ("trace_fill_kernel", 0.5, 1.0)]}
    run.cards = [0]
    run.trace_window = (0.0, 2.0)
    assert tiny.metric("device_idle_pct.map").read(run) == 50.0
    assert tiny.metric("trace_kernels_ms_per_read").read(run) == \
        pytest.approx(0.5e3 / 40)


def test_busy_and_idle_per_card(tiny):
    """Four cards, the fourth idle through the window: a quarter of the
    cards' time is idle.  On one card the per-card arithmetic is the union
    of every row."""
    window = (0.0, 4.0)
    rows = {0: [("a", 0.0, 4.0)],
            1: [("a", 0.0, 2.5), ("b", 2.0, 4.0)],
            2: [("a", -1.0, 5.0)]}
    assert busy_per_card(rows, window) == {0: 4.0, 1: 4.0, 2: 4.0}
    run = bench_run.RunRecord(
        ctx=None, setup_s=0.0, calls=[(0.0, 4.0, 1)], window_s=4.0,
        counters={}, spans={}, device_by_card=rows, cards=[0, 1, 2, 3],
        trace_window=window)
    assert run.device == [r for c in rows for r in rows[c]]
    assert mean_busy(rows, [0, 1, 2, 3], window) == 3.0
    for name in ("device_idle_pct.map", "device_idle_pct.score"):
        assert tiny.metric(name).read(run) == 25.0
    assert bench_run._breakdown(run)["idle_gaps"] == [
        ["outside any span", 4.0]]
    one = [("a", 0.5, 1.0), ("b", 0.75, 1.5), ("c", 3.0, 3.5)]
    union = busy_union([(s, e) for _, s, e in one])
    assert busy_per_card({0: one}, window) == {0: union}
    run = bench_run.RunRecord(
        ctx=None, setup_s=0.0, calls=[(0.0, 4.0, 1)], window_s=4.0,
        counters={}, spans={}, device_by_card={0: one}, cards=[0],
        trace_window=window)
    assert mean_busy({0: one}, [0], window) == union
    for name in ("device_idle_pct.map", "device_idle_pct.score"):
        assert tiny.metric(name).read(run) == 100.0 * (1.0 - union / 4.0)


def test_spans_wrap_only_when_traced():
    def f(x):
        return x + 1
    assert Spans(False).wrap(f, "f") is f
    spans = Spans(True)
    assert spans.wrap(f, "f")(1) == 2 and len(spans.durations["f"]) == 1


# -- the registry: a cell, configuration, mix and metric added as files -----


def test_registry_finds_new_files(tiny):
    root = tiny.root
    spec = json.load(open(os.path.join(root, "BENCHMARK.json")))
    spec["configs"].append({"name": "tiny_line", "source": "a test",
                            "file": "benchmark/configs/tiny_line.json",
                            "reduced": [], "why": "a test"})
    spec["workloads"].append({"name": "tiny_line.score", "config":
                              "tiny_line", "traffic": "tiny_reads",
                              "chips": 1, "why": "a test"})
    spec["end_to_end"].append({"name": "reads_total", "unit": "reads",
                               "better": "higher", "bound": 0.01,
                               "source": "host_clock",
                               "workloads": ["tiny_line.score"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as fh:
        json.dump(spec, fh)
    files = {
        "configs/tiny_line.json": {"graph": {"backbone_bases": 200},
                                   "costs": COSTS, "span": "global",
                                   "batch_size": 8},
        "mixes/tiny_reads.json": {"source": "haplotypes", "divergence": 0.05,
                                  "batch_reads": 8, "batches": 1},
        "workloads/tiny_line.score.json": {"adapter": "score_batch"},
    }
    for rel, data in files.items():
        with open(os.path.join(root, "benchmark", rel), "w") as fh:
            json.dump(data, fh)
    with open(os.path.join(root, "benchmark", "metrics", "reads_total.py"),
              "w") as fh:
        fh.write("def read(run):\n    return run.reads\n")
    reg = Registry(root)
    line = run_tiny(reg, "tiny_line.score")
    assert line["correct"]
    assert line["metrics"]["reads_total"]["value"] == line["attempted"]
    assert set(line["metrics"]) == {"setup_s", "reads_total"}


# -- the import rule --------------------------------------------------------


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_module_the_benchmark_runs_imports_jax():
    banned = set(bench_run.BANNED)
    for dirpath, _, names in os.walk(os.path.join(REPO, "benchmark")):
        if os.path.basename(dirpath) == "tests":
            continue
        for name in names:
            if name.endswith(".py"):
                path = os.path.join(dirpath, name)
                tops = set(_imports(path))
                assert not tops & banned, path
                if os.sep + "reference" in path:
                    assert "poasta_tpu_torch" not in tops, path


def test_banned_modules_by_whole_top_level_name(monkeypatch):
    monkeypatch.setitem(sys.modules, "poasta_tpu_torch_fake", sys)
    assert "poasta_tpu" not in bench_run.loaded_banned()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert "jax" in bench_run.loaded_banned()


def test_cli_refuses_without_a_card(monkeypatch, capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench_run.main(["--workload", "gene5k.score", "--seed", "1",
                           "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""


# -- the cards a run used, over fake cards -----------------------------------

H100 = "NVIDIA H100 80GB HBM3"


class FakeCards:
    """``torch.cuda``'s card functions over ``n`` visible cards of one
    kind; a card's peak is what an adapter allocated there, and each
    synchronised card is noted."""

    def __init__(self, monkeypatch, n):
        import torch

        self.peaks, self.synced = [0] * n, []
        for name, fn in (("is_available", lambda: True),
                         ("device_count", lambda: n),
                         ("max_memory_allocated", lambda i: self.peaks[i]),
                         ("get_device_name", lambda i: H100),
                         ("synchronize", self.synced.append)):
            monkeypatch.setattr(torch.cuda, name, fn)

    def adapter(self, touch):
        """An adapter that allocates (card + 1) MiB on each of the first
        ``touch`` cards the run gives it, and answers nothing."""
        def start(ctx):
            for dev in ctx.devices[:touch]:
                i = int(dev.split(":")[1])
                self.peaks[i] = (i + 1) << 20
            return SimpleNamespace(warm_up=lambda: None, step=lambda: 1,
                                   counters=dict, close=lambda: None,
                                   outputs=lambda: {"kind": "none"})
        return SimpleNamespace(start=start)


@pytest.mark.parametrize("chips,touch", [(1, 1), (4, 4), (4, 1)])
def test_cards_a_run_used(tiny, monkeypatch, capsys, chips, touch):
    """Four cards visible: a cell reports the cards its run allocated on
    and the fullest one's peak, waits only on those, and a run that used
    fewer cards than its cell asks for fails with no result."""
    cards = FakeCards(monkeypatch, 4)
    name = f"gene5k.cards{chips}"
    tiny.spec["workloads"].append({"name": name, "config": "gene5k",
                                   "traffic": "score_uniform",
                                   "chips": chips, "why": "a test"})
    with open(os.path.join(tiny.bench, "workloads", f"{name}.json"),
              "w") as fh:
        json.dump({"adapter": "fake"}, fh)
    monkeypatch.setattr(tiny, "adapter", lambda _: cards.adapter(touch))
    monkeypatch.setattr(tiny, "check", lambda _: SimpleNamespace(
        check=lambda outputs, ctx: [("answers_missing", 0, 0)]))
    monkeypatch.setattr(bench_run, "Registry", lambda: tiny)
    # the ban has its own test; this process may hold JAX from another file
    monkeypatch.setattr(bench_run, "loaded_banned", list)
    # main() pins the build caches in the environment: restore it after
    for var in ("TORCH_EXTENSIONS_DIR", "TRITON_CACHE_DIR", "CUDA_CACHE_PATH"):
        monkeypatch.delenv(var, raising=False)
    rc = bench_run.main(["--workload", name, "--seed", str(SEED),
                         "--seconds", "0.05"])
    out, err = capsys.readouterr()
    assert set(cards.synced) == set(range(touch))
    if touch < chips:
        assert rc != 0 and out == ""
        assert (f"error: cell {name} needs {chips} card(s); the run used "
                f"{touch}") in err
        return
    assert rc == 0
    dev = json.loads(out.splitlines()[-1])["device"]
    assert dev["platform"] == "gpu" and dev["kind"] == H100
    assert dev["count"] == touch
    assert dev["memory_peak_bytes"] == touch << 20
    assert dev["memory_peak_bytes_per_card"] == cards.peaks


def test_traced_card_without_rows_is_not_used(monkeypatch):
    """In a traced run a card with memory but no device row in the window
    does not count as used."""
    cards = FakeCards(monkeypatch, 4)
    cards.peaks[:] = [1, 2, 3, 4]
    rows = {0: [("k", 0.0, 1.0)], 1: [("k", 0.0, 1.0)], 3: []}
    assert bench_run._cards(True, rows) == ([1, 2, 3, 4], [0, 1], H100)
    assert bench_run._cards(True, None) == ([1, 2, 3, 4], [0, 1, 2, 3], H100)


# -- whole runs on the CPU, the control and the faults ----------------------


@pytest.mark.parametrize("cell", ["gene5k.score", "gene5k.score_mixdiv",
                                  "pan200k.map"])
@pytest.mark.parametrize("trace", [False, True])
def test_cells_run_and_are_correct(tiny, cell, trace):
    line = run_tiny(tiny, cell, trace)
    assert line["correct"] and line["failed"] == 0, line["checks"]
    # no device on the CPU: the device-trace readers find nothing
    want = {m["name"] for m in tiny.metrics(cell, trace)
            if m["source"] != "device_trace"}
    if trace:
        assert "breakdown" in line
    assert set(line["metrics"]) == want
    assert list(line)[-1] == "checks"


@pytest.mark.parametrize("cell", ["gene5k.score", "pan200k.map"])
def test_control_comes_out_not_correct(tiny, cell, monkeypatch):
    # the tiny reads' indels all leave a band of width 0
    real = tiny.cell

    def cell_with_band(name):
        return {**real(name), "control_band": 0}
    monkeypatch.setattr(tiny, "cell", cell_with_band)
    for seed in (SEED, SEED + 1, SEED + 2):
        bad, n = control.readings(tiny, cell, seed, device="cpu")
        assert n > 0 and bad > 0


def _patch_scores(monkeypatch, fault):
    from poasta_tpu_torch.parallel.mapper import BatchMapper

    real = BatchMapper.score_batch
    last = {}

    def broken(self, queries):
        out = np.asarray(real(self, queries)).copy()
        if fault == "stale":
            prev = last.get("out")
            last["out"] = out
            return out if prev is None or prev.shape != out.shape else prev
        if fault == "half":
            half = out.shape[0] // 2
            out[half:] = int(out[:half].mean())
        elif fault == "altered":
            out[3] += 1
        return out
    monkeypatch.setattr(BatchMapper, "score_batch", broken)


@pytest.mark.parametrize("fault", ["stale", "half", "altered"])
def test_score_faults_come_out_not_correct(tiny, monkeypatch, fault):
    _patch_scores(monkeypatch, fault)
    line = run_tiny(tiny, "gene5k.score")
    assert not line["correct"], (fault, line["checks"])


def _patch_alignments(monkeypatch, fault):
    from poasta_tpu_torch.aligner.alignment import ArrayAlignment
    from poasta_tpu_torch.parallel.mapper import BatchMapper

    real = BatchMapper.align_batch

    def broken(self, queries, prescored=None):
        out = list(real(self, queries, prescored=prescored))
        if fault == "half":
            empty = ArrayAlignment(np.zeros(0, dtype=np.int64),
                                   np.zeros(0, dtype=np.int64))
            out[len(out) // 2:] = [(s, empty) for s, _ in out[len(out) // 2:]]
        elif fault == "altered":
            out[0] = (out[0][0] + 2, out[0][1])
        return out
    monkeypatch.setattr(BatchMapper, "align_batch", broken)


@pytest.mark.parametrize("fault", ["half", "altered"])
def test_mapping_faults_come_out_not_correct(tiny, monkeypatch, fault):
    _patch_alignments(monkeypatch, fault)
    line = run_tiny(tiny, "pan200k.map")
    assert not line["correct"], (fault, line["checks"])


@pytest.mark.cuda
@pytest.mark.parametrize("spec,mix,free", [
    (GENE, TINY["mixes/score_mixdiv.json"], False),
    (PAN, TINY["mixes/map_loci.json"], True)])
def test_reference_graph_replay_equals_eager(card, spec, mix, free):
    gfa, haps, bb = build_graph(spec, SEED)
    batches, _, _ = make_batches(mix, haps, bb, SEED)
    g = parse_gfa(gfa)
    assert np.array_equal(best_scores(g, batches[0], COSTS, free, device=card),
                          best_scores(g, batches[0], COSTS, free))


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["gene5k.score", "pan200k.map"])
def test_cells_on_the_card(tiny, card, cell):
    line, _ = bench_run.run_cell(tiny, cell, SEED, 0.05, True, device=card,
                                 t_start=time.perf_counter())
    assert line["correct"], line["checks"]
    assert line["device"]["busy_s"] > 0


MESH_ADAPTER = '''"""score_batch under a mesh of the cell's first ``dp``
cards."""

import numpy as np

from benchmark.adapters import port as port_mod


def start(ctx):
    return Caller(ctx)


class Caller:
    def __init__(self, ctx):
        from poasta_tpu_torch.utils.mesh import make_mesh

        port = port_mod.names()
        graph, _ = port.load_graph_from_gfa(ctx.gfa_path)
        c, dp = ctx.config["costs"], ctx.cell["dp"]
        self.mapper = port.BatchMapper(
            graph, port.GapAffine(c["mismatch"], c["gap_extend"],
                                  c["gap_open"]),
            mesh=make_mesh(devices=ctx.devices[:dp], dp=dp),
            aln_type=port.span_of(ctx.config["span"]))
        self.batches, self.calls = ctx.batches, []

    def warm_up(self):
        for batch in self.batches:
            self.mapper.score_batch(batch)

    def step(self):
        k = len(self.calls) % len(self.batches)
        self.calls.append((k, np.asarray(
            self.mapper.score_batch(self.batches[k]))))
        return len(self.batches[k])

    def counters(self):
        return {"calls": len(self.calls)}

    def outputs(self):
        return {"kind": "scores", "calls": self.calls}

    def close(self):
        self.mapper = None
'''

# after the run: which cards hold a CUDA context, and each card's cache
AFTER_MAIN = """import json, sys, torch
from benchmark import run
rc = run.main(sys.argv[1:])
n = torch.cuda.device_count()
print("contexts", json.dumps([torch._C._cuda_hasPrimaryContext(i)
                              for i in range(n)]), file=sys.stderr)
print("reserved", json.dumps([torch.cuda.memory_reserved(i)
                              for i in range(n)]), file=sys.stderr)
sys.exit(rc)
"""


def _run_in_process_of_its_own(root, cell, trace):
    """(exit code, the result line or None, what AFTER_MAIN printed) of
    one run of ``cell`` from ``root``, as the benchmark's command runs."""
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([root, REPO])}
    res = subprocess.run(
        [sys.executable, "-c", AFTER_MAIN, "--workload", cell, "--seed",
         str(SEED), "--seconds", "2", "--trace", str(trace)],
        cwd=root, env=env, capture_output=True, text=True, timeout=900)
    after = {row.split(" ", 1)[0]: json.loads(row.split(" ", 1)[1])
             for row in res.stderr.splitlines()
             if row.startswith(("contexts ", "reserved "))}
    lines = res.stdout.strip().splitlines()
    line = json.loads(lines[-1]) if lines else None
    window = [row for row in res.stderr.splitlines()
              if row.startswith("window: ")]
    print(cell, "trace", trace, "rc", res.returncode, json.dumps(after),
          json.dumps(line and {k: line[k] for k in ("metrics", "device")}),
          *window)
    return res.returncode, line, after, res.stderr


@pytest.mark.cuda
def test_cells_on_four_cards(tiny, card):
    """On a host of four cards: a one-card cell uses card 0 and makes no
    context on the others; a four-card cell under dp=4 reports four cards,
    each with its peak, its idle share the mean of the cards'; the same
    cell under dp=1 fails with no result."""
    import torch

    if torch.cuda.device_count() < 4:
        pytest.skip(f"needs four CUDA cards; torch sees "
                    f"{torch.cuda.device_count()}")
    root, bench = tiny.root, tiny.bench
    spec = json.load(open(os.path.join(root, "BENCHMARK.json")))
    gene = json.load(open(os.path.join(REPO, "benchmark", "configs",
                                       "gene5k.json")))
    spec["configs"].append({"name": "gene5k_mesh", "source": "a test",
                            "file": "benchmark/configs/gene5k_mesh.json",
                            "reduced": [], "why": "a test"})
    cell = "gene5k_mesh.score_dp4"
    spec["workloads"].append({"name": cell, "config": "gene5k_mesh",
                              "traffic": "score_mesh", "chips": 4,
                              "why": "a test"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if m["name"] in ("reads_per_s.score", "device_idle_pct.score"):
            m["workloads"].append(cell)
    files = {"BENCHMARK.json": spec,
             "benchmark/configs/gene5k_mesh.json": gene,
             "benchmark/mixes/score_mesh.json": {
                 "source": "haplotypes", "divergence": 0.03,
                 "cut_to": 5000, "batch_reads": 64, "batches": 2},
             f"benchmark/workloads/{cell}.json": {"adapter": "score_mesh",
                                                 "dp": 4}}
    for rel, data in files.items():
        with open(os.path.join(root, rel), "w") as fh:
            json.dump(data, fh)
    with open(os.path.join(bench, "adapters", "score_mesh.py"), "w") as fh:
        fh.write(MESH_ADAPTER)

    rc, line, after, err = _run_in_process_of_its_own(root, "gene5k.score",
                                                      0)
    assert rc == 0 and line["correct"], err[-2000:]
    assert line["device"]["count"] == 1
    assert after["contexts"] == [True, False, False, False]

    for trace in (0, 1):
        rc, line, after, err = _run_in_process_of_its_own(root, cell, trace)
        assert rc == 0 and line["correct"], err[-2000:]
        dev = line["device"]
        assert dev["count"] == 4 and dev["kind"] == H100
        assert len(dev["memory_peak_bytes_per_card"]) == 4
        assert all(p > 0 for p in dev["memory_peak_bytes_per_card"])
        assert dev["memory_peak_bytes"] == max(
            dev["memory_peak_bytes_per_card"])
        if trace:
            per_card = dev["busy_s_per_card"]
            assert all(b > 0 for b in per_card)
            assert dev["busy_s"] == pytest.approx(sum(per_card) / 4)
            idle = line["metrics"]["device_idle_pct.score"]["value"]
            assert idle == pytest.approx(
                100 * (1 - dev["busy_s"] / dev["window_s"]))

    with open(os.path.join(bench, "workloads", f"{cell}.json"), "w") as fh:
        json.dump({"adapter": "score_mesh", "dp": 1}, fh)
    rc, line, _, err = _run_in_process_of_its_own(root, cell, 0)
    assert rc != 0 and line is None
    assert f"error: cell {cell} needs 4 card(s); the run used 1" in err
