"""The readers of the mesh cell's own metrics, ``shard_skew_pct`` and
``mesh_wait_ms_per_read`` (``benchmark/mesh_spans.py``): their arithmetic
on recorded spans worked by hand, the other readers of the port's spans
still served after them, and None where there is nothing to read."""

import os
import sys
from types import SimpleNamespace

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, REPO)
sys.path.insert(0, HERE)

from benchmark import mesh_spans, program_spans, run as bench_run  # noqa: E402
from test_benchmark_harness import tiny  # noqa: E402,F401
from test_program_spans import FakeRecorder  # noqa: E402


def _span(name, sid, parent, thread, start, end, **attrs):
    # times in s on the host clock, kept as the recorder keeps them (ns)
    return SimpleNamespace(name=name, id=sid, parent=parent, thread=thread,
                           start_ns=round(start * 1e9),
                           end_ns=round(end * 1e9), attrs=attrs)


def _run(cards=4, trace_window=(5.0, 8.0)):
    """A traced run of two calls of 10 reads on ``cards`` cards, host
    clock 100 s to 103 s."""
    return bench_run.RunRecord(
        ctx=SimpleNamespace(devices=[f"cuda:{i}" for i in range(cards)]),
        setup_s=1.0, calls=[(100.0, 101.5, 10), (101.5, 103.0, 10)],
        window_s=3.0, counters={}, spans={}, trace_window=trace_window)


def _shards():
    """Card 0: a 0.5-s prescore block and a 1.0-s align block (1.5 s);
    cards 1 and 2: 1.0 s each; card 3: 0.5 s.  The scorer thread (2)
    waits 0.2 s and the main thread (1) 0.4 s in ``mesh.gather``."""
    return [
        _span("lasagna.chunk", 1, None, 1, 100.0, 103.0),
        _span("mesh.gather", 2, 1, 2, 100.1, 100.3),
        _span("mesh.shard", 3, 1, 11, 100.0, 100.5, card=0,
              stage="prescore", reads=64),
        _span("seed.hits", 4, 3, 11, 100.0, 100.25, card=0,
              stage="prescore", reads=64),
        _span("lasagna.align", 5, 1, 1, 101.0, 102.1),
        _span("mesh.gather", 6, 5, 1, 101.0, 101.4),
        _span("mesh.shard", 7, 5, 12, 101.0, 102.0, card=0, stage="align",
              reads=64),
        _span("mesh.shard", 8, 5, 13, 101.0, 102.0, card=1, stage="align",
              reads=64),
        _span("mesh.shard", 9, 5, 14, 101.0, 102.0, card=2, stage="align",
              reads=64),
        _span("mesh.shard", 10, 1, 15, 102.0, 102.5, card=3, stage="pool",
              reads=3),
    ]


def test_skew_and_wait_worked_by_hand(tiny, monkeypatch):
    """Summed ``mesh.shard`` time a card 1.5, 1.0, 1.0, 0.5 s: the mean
    1.0, so the skew is 100 (1.5 / 1.0 - 1) = 50%.  ``mesh.gather`` 0.6 s
    over 20 reads: 30 ms a read.  The recorder is drained once, and the
    readers of ``program_spans`` read what it held."""
    rec = FakeRecorder(_shards(), {"reads.sharded": 20})
    monkeypatch.setitem(sys.modules, program_spans.RECORDER, rec)
    run = _run()
    assert mesh_spans.shard_seconds(run) == pytest.approx(
        {0: 1.5, 1: 1.0, 2: 1.0, 3: 0.5})
    assert tiny.metric("shard_skew_pct").read(run) == pytest.approx(50.0)
    assert tiny.metric("mesh_wait_ms_per_read").read(run) == \
        pytest.approx(30.0)
    assert rec.drains == 1
    assert program_spans.ms_per_read(run, ("seed.hits",)) == \
        pytest.approx(12.5)
    assert program_spans.recorded(run)["counts"] == {"reads.sharded": 20}
    # the window's end anchors the clocks: the last call ends at 103 s
    spans = program_spans.recorded(run)["spans"]
    assert spans[0][4:] == pytest.approx((5.0, 8.0))


def test_a_card_without_blocks_counts_as_idle(tiny, monkeypatch):
    """Blocks on three of four cards, 1.0 s each: the mean over the
    cell's four cards is 0.75 s, the skew 100 (1.0 / 0.75 - 1) = 33.3%."""
    shards = [s for s in _shards() if s.attrs.get("card") in (1, 2)]
    shards.append(_span("mesh.shard", 20, None, 16, 100.0, 101.0, card=0,
                        stage="align", reads=64))
    monkeypatch.setitem(sys.modules, program_spans.RECORDER,
                        FakeRecorder(shards, {}))
    assert tiny.metric("shard_skew_pct").read(_run()) == \
        pytest.approx(100.0 / 3)


def test_nothing_to_read(tiny, monkeypatch):
    """None, never a raise: spans without any of the mesh's (a port
    older than its replicas), an untraced run, no recorder, a recorder
    drained before without its attributes, cards idle throughout."""
    skew, wait = (tiny.metric(n) for n in ("shard_skew_pct",
                                           "mesh_wait_ms_per_read"))
    others = [s for s in _shards() if not s.name.startswith("mesh.")]
    monkeypatch.setitem(sys.modules, program_spans.RECORDER,
                        FakeRecorder(others, {}))
    run = _run()
    assert skew.read(run) is None and wait.read(run) is None
    assert program_spans.recorded(run)["spans"]  # the others still read
    assert skew.read(_run(trace_window=None)) is None
    assert wait.read(_run(trace_window=None)) is None
    monkeypatch.delitem(sys.modules, program_spans.RECORDER)
    assert skew.read(_run()) is None and wait.read(_run()) is None
    monkeypatch.setitem(sys.modules, program_spans.RECORDER,
                        FakeRecorder(_shards(), {}))
    run = _run()
    program_spans.recorded(run)
    assert skew.read(run) is None
    zero = [_span("mesh.shard", 1, None, 1, 100.0, 100.0, card=0,
                  stage="align", reads=0)]
    monkeypatch.setitem(sys.modules, program_spans.RECORDER,
                        FakeRecorder(zero, {}))
    assert skew.read(_run()) is None
