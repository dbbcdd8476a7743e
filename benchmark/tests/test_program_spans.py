"""The readers of the port's own spans and counters
(``benchmark/program_spans.py`` and the metrics that call it): their
arithmetic on a synthetic traced run, the clock mapping under a CPU
profiler, None where the port has no recorder, and a tiny traced run of
the mapping cell on the CPU."""

import os
import sys
import time
from types import SimpleNamespace

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, REPO)
sys.path.insert(0, HERE)

from benchmark import program_spans, run as bench_run  # noqa: E402
from benchmark.registry import Registry  # noqa: E402
from benchmark.tracing import DeviceTrace  # noqa: E402
from test_benchmark_harness import run_tiny, tiny  # noqa: E402,F401

NEW = ("idle_explained_pct.map", "idle_explained_pct.score",
       "prescore_wait_ms_per_read", "seed_host_ms_per_read",
       "trace_host_ms_per_read", "pack_ms_per_call", "tail_fill_ns_per_cell",
       "trace_fill_ns_per_cell", "seed_fill_ns_per_cell")
DEVICE = ("tail_fill_ns_per_cell", "trace_fill_ns_per_cell",
          "seed_fill_ns_per_cell")


def _span(name, sid, parent, thread, start, end):
    # times in s on the host clock, kept as the recorder keeps them (ns)
    return SimpleNamespace(name=name, id=sid, parent=parent, thread=thread,
                           start_ns=round(start * 1e9),
                           end_ns=round(end * 1e9), attrs={})


class FakeRecorder:
    """The recorder's interface as the readers use it: ``drain()``."""

    def __init__(self, spans, counts):
        self.spans, self.counts, self.drains = spans, counts, 0

    def drain(self):
        self.drains += 1
        out = {"spans": self.spans, "counts": self.counts}
        self.spans, self.counts = [], {}
        return out


def _run(trace_window=(5.0, 8.0)):
    """A traced run of two calls, host clock 100 s to 103 s, window 5 s to
    8 s on the profiler's clock (the window's end anchors the clocks); the
    device busy 5.0-5.5 and 6.0-7.0, so idle 5.5-6.0 and 7.0-8.0 (1.5
    s)."""
    device = [("void full_fill_reg_kernel<true, true, false, 8>", 5.0, 5.5),
              ("void trace_fill_kernel<4>(int const*)", 6.0, 7.0)]
    return bench_run.RunRecord(
        ctx=None, setup_s=1.0, calls=[(100.0, 101.5, 10), (101.5, 103.0, 10)],
        window_s=3.0, counters={}, spans={}, device_by_card={0: device},
        cards=[0], trace_window=trace_window)


SPANS = [
    # main thread 1: the chunk over its leaves
    _span("lasagna.prescore_wait", 2, 1, 1, 100.5, 101.0),
    _span("mapper.score_batch", 3, 1, 1, 101.0, 101.5),
    _span("mapper.pack", 4, 3, 1, 101.0, 101.01),
    _span("mapper.score_batch", 5, 1, 1, 101.5, 101.9),
    _span("mapper.pack", 6, 5, 1, 101.5, 101.53),
    _span("lasagna.emit", 7, 1, 1, 102.0, 102.5),
    # the scorer thread 2, its parent the chunk
    _span("seed.hits", 8, 1, 2, 102.25, 102.75),
    _span("trace.inputs", 9, 1, 2, 100.0, 100.1),
    _span("trace.replay", 10, 1, 2, 100.1, 100.3),
    _span("lasagna.chunk", 1, None, 1, 100.0, 103.0),
]
COUNTS = {"cells.tail_fill": 10**9, "cells.trace_fill": 4 * 10**9}


@pytest.fixture
def recorder(monkeypatch):
    rec = FakeRecorder(list(SPANS), dict(COUNTS))
    monkeypatch.setitem(sys.modules, program_spans.RECORDER, rec)
    return rec


def test_readers_on_a_synthetic_run(recorder):
    reg = Registry(REPO)
    run = _run()
    got = {name: reg.metric(name).read(run) for name in NEW}
    assert recorder.drains == 1  # drained once, kept for every reader
    # leaves cover 5.5-6.0 (the wait) and 7.0-7.75 (emit, seed.hits of
    # another thread) of the 1.5 s idle; pack, trace.* fall on busy time
    assert got["idle_explained_pct.map"] == pytest.approx(100 * 1.25 / 1.5)
    assert got["idle_explained_pct.score"] == got["idle_explained_pct.map"]
    assert got["prescore_wait_ms_per_read"] == pytest.approx(500 / 20)
    assert got["seed_host_ms_per_read"] == pytest.approx(500 / 20)
    assert got["trace_host_ms_per_read"] == pytest.approx(300 / 20)
    assert got["pack_ms_per_call"] == pytest.approx(40 / 2)
    assert got["tail_fill_ns_per_cell"] == pytest.approx(0.5e9 / 1e9)
    assert got["trace_fill_ns_per_cell"] == pytest.approx(1e9 / 4e9)
    assert got["seed_fill_ns_per_cell"] is None  # no seed kernel, no count
    by = program_spans.idle_by_span(run)
    assert by["lasagna.prescore_wait"] == pytest.approx(0.5)
    assert by["lasagna.emit"] == pytest.approx(0.5)
    assert by["seed.hits"] == pytest.approx(0.5)
    assert by["mapper.pack"] == by["trace.inputs"] == 0
    # the chunk's self time over the idle left: 7.75-8.0 less nothing
    assert by["lasagna.chunk"] == pytest.approx(0.25)
    assert by["mapper.score_batch"] == 0 and by["none"] == 0


def test_readers_return_none_without_the_recorder(monkeypatch):
    monkeypatch.delitem(sys.modules, program_spans.RECORDER, raising=False)
    reg = Registry(REPO)
    run = _run()
    assert {name: reg.metric(name).read(run) for name in NEW} == dict.fromkeys(
        NEW)
    assert program_spans.idle_by_span(run) is None


def test_readers_return_none_untraced(recorder):
    reg = Registry(REPO)
    assert all(reg.metric(name).read(_run(None)) is None for name in NEW)
    assert recorder.drains == 0


def test_clock_mapping_under_a_cpu_profiler():
    """A profiler span (``bench.probe``) around a port span: the port
    span, mapped onto the profiler's clock, lands within 1 ms of it."""
    from poasta_tpu_torch.utils import spans
    from torch.profiler import record_function

    spans.drain()
    with DeviceTrace(True) as dt:
        with dt.window():
            t0 = time.perf_counter()
            time.sleep(0.01)
            with record_function("bench.probe"), spans.span("t.probe"):
                time.sleep(0.05)
            time.sleep(0.01)
            t1 = time.perf_counter()
    run = bench_run.RunRecord(ctx=None, setup_s=0.0, calls=[(t0, t1, 1)],
                              window_s=t1 - t0, counters={}, spans={})
    run.add_trace(dt.read())
    ((_, p0, p1),) = [h for h in run.host_spans if h[0] == "probe"]
    ((_, _, _, _, s0, s1),) = program_spans.recorded(run)["spans"]
    assert abs(s0 - p0) < 1e-3 and abs(s1 - p1) < 1e-3
    assert s1 - s0 == pytest.approx(0.05, abs=0.02)


def test_tiny_mapping_run_reads_the_program_spans(tiny):  # noqa: F811
    """The mapping cell traced on the CPU at a tiny size: the program-span
    metrics read values; the device readers find no kernel rows."""
    line = run_tiny(tiny, "pan200k.map", trace=True)
    assert line["correct"], line["checks"]
    metrics = line["metrics"]
    for name in ("idle_explained_pct.map", "prescore_wait_ms_per_read",
                 "seed_host_ms_per_read", "trace_host_ms_per_read"):
        assert metrics[name]["value"] >= 0, name
    assert metrics["seed_host_ms_per_read"]["value"] > 0
    assert metrics["trace_host_ms_per_read"]["value"] > 0
    assert 0 < metrics["idle_explained_pct.map"]["value"] <= 100
    assert not set(DEVICE) & set(metrics)
    names = {op for op, _ in line["breakdown"]["device_ops"]}
    assert not any(n.startswith(("lasagna.", "mapper.", "seed.", "ladder.",
                                 "trace.")) for n in names)
