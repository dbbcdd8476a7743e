"""The port's bench entry (``python -m poasta_tpu_torch.bench``) on the
CPU, against the repository's own ``bench.py`` and the JAX package.

* Workload identity: every configuration the port builds (graph flattened,
  reads) is byte-equal to ``bench.py``'s own construction: its
  ``build_uniform``, and its inline configurations rebuilt here with its
  ``_mutate`` and ``_fuse`` in its own generator order.
* Scores: at small sizes every configuration's scores, cells filled and
  alignments through the port (plain PyTorch versions, ``device="cpu"``)
  equal ``poasta_tpu``'s ``BandedScorer`` / ``BatchMapper`` (Pallas
  interpret mode; the banded scorer under an accelerator simulation, as
  ``tests/test_torch_slice.py`` runs it; ``POASTA_SEED=all`` seeds the
  small pangenome graph, as ``tests/test_torch_seed.py`` does).
* The line: its key set is ``BENCH_r05.json``'s less the int16 probe's,
  plus the port's five.
* Failures are not swallowed: a configuration that raises or a native
  score that differs ends the run with the exception after the one error
  line, and the entry exits non-zero without a card.

Tolerance 0 throughout: scores, cells and alignments are integers.
"""

import dataclasses
import inspect
import io
import json
import os
import random
import subprocess
import sys
from contextlib import contextmanager, redirect_stdout
from unittest import mock

import numpy as np
import pytest
import torch

import bench as reference_bench
import jax
from poasta_tpu.aligner import banded as jbd
from poasta_tpu.aligner import costs as jcosts
from poasta_tpu.aligner import wavefront as jwf
from poasta_tpu.graphs import POAGraph as JaxPOAGraph
from poasta_tpu.ops.pallas_fill import set_interpret_mode
from poasta_tpu.parallel import BatchMapper as JaxMapper
from poasta_tpu_torch import BandedScorer, BatchMapper, GapAffine, bench
from poasta_tpu_torch import pack_queries
from poasta_tpu_torch.aligner import costs as tcosts
from poasta_tpu_torch.aligner import wavefront as twf

torch.set_num_threads(1)

COSTS = GapAffine(4, 2, 6)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The keys the port adds to bench.py's line, and the int16 probe's it drops.
PORT_KEYS = {"backend", "torch", "cuda", "nvcc", "card"}
INT16_KEYS = {"int16_kernel_supported", "int16_probe_toolchain"}
ERROR_LINE_KEYS = {"metric", "value", "unit", "vs_baseline", "error"}

# Small sizes for the score comparisons (b), and smaller ones for the runs
# of main() (c, d); both keep the drift threshold (a 512-base length
# spread) within the mixed-length reads; the reference seeds only blocks
# of 8 reads or more (pallas_seed.py:460-463).
SMALL = {
    "uniform": {"graph_len": 300, "n_seqs": 4, "n_reads": 64, "seed": 7},
    "mixed_div": {"graph_len": 300, "n_reads": 64, "seed": 11},
    "mixed_len": {"graph_len": 1000, "del_start": 100, "del_end": 900,
                  "n_reads": 32, "seed": 13},
    "pangenome": {"n": 2000, "every": 500, "n_reads": 8, "read_len": 500,
                  "seed": 17},
}
TINY = {
    "uniform": {"graph_len": 200, "n_seqs": 3, "n_reads": 16, "seed": 7},
    "host_sample": 4,
    "hybrid_sample": 8,
    "mixed_div": {"graph_len": 200, "n_reads": 16, "seed": 11},
    "mixed_len": {"graph_len": 800, "del_start": 100, "del_end": 700,
                  "n_reads": 8, "seed": 13},
    "pangenome": {"n": 1200, "every": 500, "n_reads": 4, "read_len": 300,
                  "seed": 17},
}


@contextmanager
def accel_sim():
    """The JAX package's accelerator route on the CPU (Pallas interpret
    mode under a non-"cpu" backend name), as tests/test_torch_slice.py
    runs it."""
    set_interpret_mode(True)
    try:
        with mock.patch.object(jax, "default_backend",
                               lambda: "interpret-sim"):
            yield
    finally:
        set_interpret_mode(False)


# ---- bench.py's inline configurations, in its own order -------------------

def _reference_mixed_div(costs, graph_len, n_reads, seed):
    """bench.py:229-237 (its literals 5000 and 1024 as parameters)."""
    rng = random.Random(seed)
    base = "".join(rng.choice("ACGT") for _ in range(graph_len))
    gmix = JaxPOAGraph()
    gmix.add_alignment_with_weights("s0", base.encode(), None,
                                    [1] * graph_len)
    reference_bench._fuse(gmix, reference_bench._mutate(
        rng, base, 0.02).encode(), costs, "s1")
    mixed = [
        reference_bench._mutate(rng, base, 0.15 if i % 20 == 0
                                else 0.02).encode()
        for i in range(n_reads)
    ]
    return gmix, mixed


def _reference_mixed_len(costs, graph_len, del_start, del_end, n_reads,
                         seed):
    """bench.py:247-255 (its cut points 500 and 4500 as parameters)."""
    rng = random.Random(seed)
    base = "".join(rng.choice("ACGT") for _ in range(graph_len))
    variant = base[:del_start] + base[del_end:]
    gsv = JaxPOAGraph()
    gsv.add_alignment_with_weights("s0", base.encode(), None,
                                   [1] * graph_len)
    reference_bench._fuse(gsv, variant.encode(), costs, "s1")
    sv_reads = [
        reference_bench._mutate(rng, base if i % 2 else variant,
                                0.015).encode()
        for i in range(n_reads)
    ]
    return gsv, sv_reads


def _reference_pangenome(n, every, n_reads, read_len, seed):
    """bench.py:292-303 (its 50,000, 500, 64 and 5,000 as parameters)."""
    rng = random.Random(seed)
    pbase = "".join(rng.choice("ACGT") for _ in range(n))
    gp = JaxPOAGraph()
    gp.add_alignment_with_weights("s0", pbase.encode(), None, [1] * n)
    for v in range(0, n - 3, every):
        gp.add_edge(v, v + 3, 0, 1)
    gp.post_process()
    preads = []
    for _ in range(n_reads):
        a = rng.randrange(0, n - read_len)
        preads.append(reference_bench._mutate(
            rng, pbase[a:a + read_len], 0.015).encode())
    return gp, preads


REFERENCE = {
    "uniform": lambda costs, **kw: reference_bench.build_uniform(costs, **kw),
    "mixed_div": _reference_mixed_div,
    "mixed_len": _reference_mixed_len,
    "pangenome": lambda costs, **kw: _reference_pangenome(**kw),
}
PORT = {
    "uniform": bench.build_uniform,
    "mixed_div": bench.build_mixed_div,
    "mixed_len": bench.build_mixed_len,
    "pangenome": lambda costs, **kw: bench.build_pangenome(**kw),
}


def _assert_same_workload(port, ref):
    (pg, preads), (jg, jreads) = port, ref
    pf, jf = pg.flatten(), jg.flatten()
    for field in dataclasses.fields(jf):
        a, b = getattr(pf, field.name), getattr(jf, field.name)
        assert a.dtype == b.dtype and np.array_equal(a, b), field.name
    assert preads == jreads


def test_default_sizes_are_bench_py_literals():
    """The workload functions' defaults and main()'s sizes are bench.py's
    values: the deletion's cut points give exactly ``base[:500] +
    base[4500:]``."""
    assert bench.SIZES == {
        "uniform": {"graph_len": 5000, "n_seqs": 4, "n_reads": 1024,
                    "seed": 7},
        "host_sample": 16, "hybrid_sample": 32,
        "mixed_div": {"graph_len": 5000, "n_reads": 1024, "seed": 11},
        "mixed_len": {"graph_len": 5000, "del_start": 500, "del_end": 4500,
                      "n_reads": 1024, "seed": 13},
        "pangenome": {"n": 50_000, "every": 500, "n_reads": 64,
                      "read_len": 5000, "seed": 17}}
    assert bench.ITERS == {"uniform": 6, "hybrid": 5, "mixed_div": 5,
                           "mixed_len": 5, "pangenome": 5}
    for name, fn in PORT.items():
        if name == "pangenome":
            fn = bench.build_pangenome
        defaults = {k: p.default for k, p in
                    inspect.signature(fn).parameters.items()
                    if p.default is not inspect.Parameter.empty}
        assert defaults == bench.SIZES[name], name


@pytest.mark.parametrize("name,sizes", [
    ("uniform", SMALL["uniform"]),
    ("mixed_div", bench.SIZES["mixed_div"]),
    ("mixed_len", bench.SIZES["mixed_len"]),
    ("pangenome", bench.SIZES["pangenome"]),
], ids=["uniform-small", "mixed_div-default", "mixed_len-default",
        "pangenome-default"])
def test_workload_is_bench_py_own(name, sizes):
    """The port's graph (every array of the flattened graph) and reads are
    byte-equal to bench.py's construction; at bench.py's own sizes where a
    build takes seconds here (uniform fuses three 5 kb sequences with the
    exact engine: at a small size)."""
    _assert_same_workload(PORT[name](COSTS, **sizes),
                          REFERENCE[name](COSTS, **sizes))


# ---- (b) scores against poasta_tpu at small sizes ---------------------------

def _scores_both(name, aln_type=None, shared=False):
    """One configuration's batch through the reference's and the port's
    scorers by bench.py's own protocol (``_time_scores``: a warm-up call,
    then a timed one): the last scores and the scorer, per side."""
    port_graph, reads = PORT[name](COSTS, **SMALL[name])
    jax_graph, _ = REFERENCE[name](COSTS, **SMALL[name])
    tq, tl = pack_queries(reads, device="cpu")
    port = BandedScorer(port_graph.flatten(), COSTS, device="cpu",
                        aln_type=aln_type and aln_type[0])
    jq, jl = jwf.pack_queries(reads)
    with accel_sim():
        ref = jbd.BandedScorer(jax_graph.flatten(), COSTS,
                               aln_type=aln_type and aln_type[1])
        if shared:
            port.DRIFT_MIN_SPREAD = ref.DRIFT_MIN_SPREAD = 1 << 30
        want = reference_bench._time_scores(ref, jq, jl, 1)[0]
    got = bench._time_scores(port, tq, tl, 1)[0]
    return got, want, port, ref, reads, port_graph


def _bounded_span(mod):
    return mod.EndsFree(("unbounded", None), mod.included(50),
                        mod.included(0), mod.included(50))


@pytest.mark.parametrize("name,span,shared", [
    ("uniform", None, False),
    ("mixed_div", None, False),
    ("mixed_len", None, False),
    ("mixed_len", None, True),
    ("mixed_len", "bounded", False),
    ("mixed_len", "bounded", True),
], ids=["uniform", "mixed_div", "mixed_len-drift", "mixed_len-shared",
        "ef_mixed_len-drift", "ef_mixed_len-shared"])
def test_scores_equal_the_reference(name, span, shared):
    """Scores equal ``poasta_tpu``'s, and so do the ladder's counters
    (fills, tiers, full-fill fallbacks, attempts, learned ub hints); on
    drifting windows the port's drift layouts ran (the shared run is
    bench.py's reference for them).  ``cells_filled`` is not compared: the
    reference counts the rows of its 64-read blocks, padding included, the
    port the reads it fills."""
    aln_type = (_bounded_span(tcosts), _bounded_span(jcosts)) \
        if span else None
    got, want, port, ref, reads, graph = _scores_both(name, aln_type, shared)
    assert got.dtype == np.int32
    assert np.array_equal(got, np.asarray(want))
    for key in ("fills", "tiers", "fullfill_fallbacks"):
        assert port.stats[key] == ref.stats[key], key
    assert port.last_attempts == ref.last_attempts
    assert port._ub_hint == ref._ub_hint
    drift = any(k[0] == "drift" for k in port._prep_cache
                if isinstance(k, tuple) and k)
    assert drift == (name == "mixed_len" and not shared)
    if span is None:
        # and they are exact: the native engine agrees on a sample
        from poasta_tpu_torch import NativeAligner

        na = NativeAligner(graph)
        sample = range(0, len(reads), 8)
        assert [na.align(reads[i], COSTS)[0] for i in sample] \
            == [int(got[i]) for i in sample]


def _alignments(out):
    return [(int(s), [(p.rpos, p.qpos) for p in a]) for s, a in out]


def test_hybrid_alignments_equal_the_reference(monkeypatch):
    """The hybrid configuration's ``align_batch`` on the card's route (the
    banded route: bench.py's 32 reads of 5 kb are past the dense table
    budget): alignments equal ``poasta_tpu``'s and cost their scores, which
    equal the uniform scores as bench.py asserts."""
    monkeypatch.setattr(BatchMapper, "DENSE_TABLE_BUDGET", 0)
    monkeypatch.setattr(JaxMapper, "DENSE_TABLE_BUDGET", 0)
    port_graph, reads = bench.build_uniform(COSTS, **SMALL["uniform"])
    jax_graph, _ = reference_bench.build_uniform(COSTS, **SMALL["uniform"])
    sample = reads[:16]
    mapper = BatchMapper(port_graph, COSTS, device="cpu")
    got = _alignments(mapper.align_batch(sample))
    assert mapper.last_banded_stats["device_traced"] == len(sample)
    assert got == _alignments(JaxMapper(jax_graph, COSTS).align_batch(sample))
    scores = BandedScorer(port_graph.flatten(), COSTS, device="cpu").scores(
        *pack_queries(sample, device="cpu"))
    assert [s for s, _ in got] == [int(s) for s in scores]
    for read, (score, aln) in zip(sample, mapper.align_batch(sample)):
        assert twf.alignment_cost(port_graph, read, aln, COSTS) == score


def _semi(mod):
    return mod.EndsFree(mod.UNBOUNDED, mod.included(0), mod.UNBOUNDED,
                        mod.UNBOUNDED)


def test_pangenome_alignments_equal_the_reference(monkeypatch):
    """The pangenome configuration's three calls (bench.py's two warm-up
    calls and a timed one) under the semi-global span, seeded from the
    second call on: alignments and seed counters equal ``poasta_tpu``'s,
    and every alignment costs its score."""
    monkeypatch.setenv("POASTA_SEED", "all")
    monkeypatch.setenv("POASTA_SEED_DEBUG", "1")
    port_graph, reads = bench.build_pangenome(**SMALL["pangenome"])
    jax_graph, _ = _reference_pangenome(**SMALL["pangenome"])
    port = BatchMapper(port_graph, COSTS, aln_type=_semi(tcosts),
                       device="cpu")
    set_interpret_mode(True)
    try:
        ref = JaxMapper(jax_graph, COSTS, aln_type=_semi(jcosts))
        for call in range(3):
            got = port.align_batch(reads)
            assert _alignments(got) == _alignments(ref.align_batch(reads))
            if call:
                for key in ("seeded", "seed_tail", "seed_k"):
                    assert port.last_seed_stats[key] \
                        == ref.last_seed_stats[key], key
    finally:
        set_interpret_mode(False)
    assert port.last_seed_stats["seeded"] > 0
    for read, (score, aln) in zip(reads, got):
        assert twf.alignment_cost(port_graph, read, aln, COSTS) == score


# ---- (c) the line, (d) failures --------------------------------------------

@pytest.fixture
def tiny(monkeypatch):
    """main()'s sizes cut to TINY and one timed call a configuration;
    seeding at this graph size."""
    monkeypatch.setattr(bench, "SIZES", TINY)
    monkeypatch.setattr(bench, "ITERS", {k: 1 for k in bench.ITERS})
    monkeypatch.setenv("POASTA_SEED", "all")


def _run_main(argv):
    """main(argv)'s standard output lines, and what it raised (or its
    return value)."""
    buf = io.StringIO()
    try:
        with redirect_stdout(buf):
            result = bench.main(argv)
    except BaseException as exc:  # noqa: BLE001 -- the test inspects it
        result = exc
    return buf.getvalue().splitlines(), result


def _expected_keys():
    with open(os.path.join(REPO, "BENCH_r05.json")) as fh:
        parsed = json.load(fh)["parsed"]
    return set(parsed) - INT16_KEYS | PORT_KEYS


def test_line_carries_bench_py_keys(tiny):
    """One JSON line: BENCH_r05.json's keys less the int16 probe's, plus
    backend, torch, cuda, nvcc and card; no error key."""
    lines, result = _run_main(["--device", "cpu"])
    assert result == 0
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert set(line) == _expected_keys()
    assert line["backend"] == "torch-cpu" and line["card"] is None
    assert line["nvcc"] is None and line["torch"] == torch.__version__
    assert line["host_baseline_sample"] == TINY["host_sample"]
    assert line["pangenome_graph_nodes"] == TINY["pangenome"]["n"]
    assert line["seed_engaged"] is True and line["pangenome_seeded"] > 0
    assert line["value"] > 0 and line["vs_baseline"] > 0


def _assert_error_line(lines, exc_type):
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert set(line) == ERROR_LINE_KEYS
    assert line["value"] == 0 and line["error"].startswith(exc_type)
    assert not any(k.endswith("_error") for k in line)


@pytest.mark.parametrize("config", ["hybrid", "pangenome"])
def test_a_failing_config_ends_the_run(tiny, monkeypatch, config):
    """``align_batch`` raising in the hybrid configuration (global span),
    then in the pangenome one (ends-free): main re-raises after the one
    error line; nothing is turned into a ``*_error`` key (bench.py:226,
    :327 swallow these)."""
    real = BatchMapper.align_batch

    def failing(self, queries, prescored=None):
        if self.ends_free == (config == "pangenome"):
            raise RuntimeError(f"{config} fails")
        return real(self, queries, prescored)

    monkeypatch.setattr(BatchMapper, "align_batch", failing)
    lines, result = _run_main(["--device", "cpu"])
    assert isinstance(result, RuntimeError)
    assert str(result) == f"{config} fails"
    _assert_error_line(lines, "RuntimeError")


def test_a_drift_mismatch_ends_the_run(tiny, monkeypatch):
    """Drifting windows that disagree with the shared ones (bench.py:265;
    its ef twin at :280 sits in a branch that swallows it) end the run."""
    real = bench._time_scores

    def skewed(scorer, qshift, lengths, iters):
        scores, el, raw = real(scorer, qshift, lengths, iters)
        if scorer.ends_free and scorer.DRIFT_MIN_SPREAD == 1 << 30:
            scores = scores + 1
        return scores, el, raw

    monkeypatch.setattr(bench, "_time_scores", skewed)
    lines, result = _run_main(["--device", "cpu"])
    assert isinstance(result, AssertionError)
    assert "drifting windows" in str(result)
    _assert_error_line(lines, "AssertionError")


def test_a_native_score_that_differs_fails_the_run(tiny, monkeypatch):
    """The host baseline's exactness gate (bench.py:197)."""
    real = bench.NativeAligner.align

    def off_by_one(self, seq, costs, *args, **kwargs):
        score, aln, extra = real(self, seq, costs, *args, **kwargs)
        return score + 1, aln, extra

    monkeypatch.setattr(bench.NativeAligner, "align", off_by_one)
    lines, result = _run_main(["--device", "cpu"])
    assert isinstance(result, AssertionError)
    assert "host baseline, read 0" in str(result)
    _assert_error_line(lines, "AssertionError")


def test_without_a_card_the_entry_exits_non_zero():
    """No ``--device cpu`` and no card: the error line, then a non-zero
    exit (bench.py prints host figures under value 0 and exits 0)."""
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run([sys.executable, "-m", "poasta_tpu_torch.bench"],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode != 0
    _assert_error_line(res.stdout.splitlines(), "NoDeviceError")
    assert "NoDeviceError" in res.stderr
