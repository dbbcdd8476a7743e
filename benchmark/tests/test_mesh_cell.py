"""The four-card mapping cell, ``pan200k.map_dp4``: its run at a tiny size
on four CPU entries, untraced and traced; a mapper without replicas (an
older port) still runs it; and on a host of four cards (marked ``cuda``)
the tiny cell reports all four, each with its peak and its device rows."""

import json
import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, REPO)
sys.path.insert(0, HERE)

from test_benchmark_harness import (  # noqa: E402,F401
    H100,
    _run_in_process_of_its_own,
    run_tiny,
    tiny,
)

CELL = "pan200k.map_dp4"
# two batches of 8 reads a chunk, two a card; 8 warm-up reads, two a card
TINY4 = {
    "configs/pan200k_host4.json": {
        "graph": {"backbone_bases": 600, "skip_every": 150, "skip_span": 3},
        "batch_size": 8},
    "mixes/map_loci_host4.json": {
        "source": "loci", "read_bases": 120, "divergence": 0.015,
        "divergence_spread": "binomial", "batch_reads": 16, "batches": 2,
        "warmup_reads": 8},
}


@pytest.fixture
def tiny4(tiny):
    for rel, data in TINY4.items():
        path = os.path.join(tiny.bench, rel)
        with open(path) as fh:
            base = json.load(fh)
        base.update(data)
        with open(path, "w") as fh:
            json.dump(base, fh)
    return tiny


@pytest.mark.parametrize("trace", [False, True])
def test_mesh_cell_runs_and_is_correct(tiny4, trace):
    line = run_tiny(tiny4, CELL, trace)
    assert line["correct"] and line["failed"] == 0, line["checks"]
    # no device on the CPU: the device-trace readers find nothing
    want = {m["name"] for m in tiny4.metrics(CELL, trace)
            if m["source"] != "device_trace"}
    assert set(line["metrics"]) == want
    if trace:
        assert {"shard_skew_pct", "mesh_wait_ms_per_read",
                "seeded_pct"} <= want
        assert line["metrics"]["seeded_pct"]["value"] > 0
        assert line["metrics"]["shard_skew_pct"]["value"] >= 0


def test_a_mapper_without_replicas_runs_the_reference_route(tiny4,
                                                           monkeypatch):
    """A port whose mapper keeps no replicas (one older than them) runs
    the cell through the reference's mesh route, correct, and the mesh's
    readers find nothing to read: the line leaves their metrics out."""
    from poasta_tpu_torch.parallel.mapper import BatchMapper

    real = BatchMapper.__init__

    def without(self, *args, **kwargs):
        real(self, *args, **kwargs)
        self.replicas = None

    monkeypatch.setattr(BatchMapper, "__init__", without)
    line = run_tiny(tiny4, CELL, True)
    assert line["correct"] and line["failed"] == 0, line["checks"]
    assert "seeded_pct" in line["metrics"]
    assert not {"shard_skew_pct", "mesh_wait_ms_per_read"} & set(
        line["metrics"])


@pytest.mark.cuda
def test_mesh_cell_on_four_cards(tiny4, card):
    """On a host of four cards the tiny cell, traced, reports all four
    used, each with a peak and device rows in the window."""
    import torch

    if torch.cuda.device_count() < 4:
        pytest.skip(f"needs four CUDA cards; torch sees "
                    f"{torch.cuda.device_count()}")
    rc, line, _, err = _run_in_process_of_its_own(tiny4.root, CELL, 1)
    assert rc == 0 and line["correct"], err[-2000:]
    dev = line["device"]
    assert dev["count"] == 4 and dev["kind"] == H100
    assert len(dev["memory_peak_bytes_per_card"]) == 4
    assert all(p > 0 for p in dev["memory_peak_bytes_per_card"])
    assert all(b > 0 for b in dev["busy_s_per_card"])
    assert {"shard_skew_pct", "mesh_wait_ms_per_read",
            "device_idle_pct.map", "seeded_pct"} <= set(line["metrics"])
