"""The PyTorch port's graph layout against the JAX package's: ring-slot
colouring, ``DeviceGraph.build``, ``pack_queries`` and the conversion of a
reference ``DeviceGraph`` (tolerance 0: every array is integer)."""

import os
import random

import numpy as np
import pytest
import torch

from poasta_tpu.aligner import GapAffine
from poasta_tpu.aligner import wavefront as jwf
from poasta_tpu.graphs import POAGraph
from poasta_tpu.io.gfa import load_graph_from_gfa
from poasta_tpu.native import NativeAligner
from poasta_tpu_torch.aligner import wavefront as twf
from poasta_tpu_torch.convert import REFERENCE_KEYS, device_graph_from_reference

torch.set_num_threads(1)

COSTS = GapAffine(4, 2, 6)
GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")
ARRAY_FIELDS = ("symbols", "pred_slots", "pred_valid", "end_rank",
                "pred_slots_flat", "pred_valid_flat", "meta", "write_slots",
                "pred_ranks_np", "pred_valid_np")
SCALAR_FIELDS = ("window", "n_nodes_padded", "n_nodes", "end_rank_i")


def _mutate(rng, s, d):
    out = []
    for ch in s:
        r = rng.random()
        if r < d:
            continue
        out.append(rng.choice("ACGT") if r < 2 * d else ch)
        if rng.random() < d:
            out.append(rng.choice("ACGT"))
    return "".join(out) or "A"


def _fused(seed, glen=200, n_seqs=4, div=0.06):
    rng = random.Random(seed)
    base = "".join(rng.choice("ACGT") for _ in range(glen))
    g = POAGraph()
    g.add_alignment_with_weights("s0", base.encode(), None, [1] * glen)
    for i in range(1, n_seqs):
        s = _mutate(rng, base, div).encode()
        _, aln, _ = NativeAligner(g).align(s, COSTS)
        g.add_alignment_with_weights(f"s{i}", s, aln, [1] * len(s))
    return g


def _graphs():
    yield "fused-3", _fused(3)
    yield "fused-5", _fused(5, glen=150, n_seqs=6, div=0.1)
    yield "fused-8", _fused(8, glen=90, n_seqs=3, div=0.2)
    g, _ = load_graph_from_gfa(os.path.join(GOLDENS, "small_test.gfa"))
    yield "small_test.gfa", g


GRAPHS = dict(_graphs())


def _as_np(v):
    return v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _assert_same_graph(jdg, tdg):
    for f in ARRAY_FIELDS:
        a, b = _as_np(getattr(jdg, f)), _as_np(getattr(tdg, f))
        assert a.shape == b.shape, f
        assert (a == b).all(), f
    for f in SCALAR_FIELDS:
        assert int(getattr(jdg, f)) == int(getattr(tdg, f)), f


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_device_graph_build_matches(name):
    flat = GRAPHS[name].flatten()
    jdg = jwf.DeviceGraph.build(flat)
    tdg = twf.DeviceGraph.build(flat, device="cpu")
    _assert_same_graph(jdg, tdg)
    assert tdg.n_nodes_padded % twf.NODE_BUCKET == 0
    assert tdg.symbols.dtype == torch.int32
    assert tdg.pred_valid.dtype == torch.bool


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_color_ring_slots_matches(seed):
    rng = np.random.default_rng(seed)
    n = 300
    # chains with random longer-lived rows spliced in
    last_use = np.arange(n, dtype=np.int64) + 1
    last_use[-1] = n - 1
    for r in rng.choice(n - 10, size=40, replace=False):
        last_use[r] = min(n - 1, r + int(rng.integers(2, 12)))
    got = twf._color_ring_slots(n, last_use)
    ref = jwf._color_ring_slots(n, last_use)
    assert (got == ref).all()


def test_pack_queries_matches():
    rng = random.Random(4)
    reads = [_mutate(rng, "ACGT" * 40, 0.1).encode() for _ in range(9)]
    reads.append(b"")
    jq, jl = jwf.pack_queries(reads)
    tq, tl = twf.pack_queries(reads, device="cpu")
    assert tq.dtype == tl.dtype == torch.int32
    assert (np.asarray(jq) == tq.numpy()).all()
    assert (np.asarray(jl) == tl.numpy()).all()


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_device_graph_from_reference_round_trips(name):
    flat = GRAPHS[name].flatten()
    jdg = jwf.DeviceGraph.build(flat)
    arrays = {k: _as_np(getattr(jdg, k)) for k in REFERENCE_KEYS}
    arrays["window"] = jdg.window
    arrays["end_rank_i"] = jdg.end_rank_i
    tdg = device_graph_from_reference(arrays, device="cpu")
    _assert_same_graph(jdg, tdg)
    _assert_same_graph(twf.DeviceGraph.build(flat, device="cpu"), tdg)


def test_device_graph_from_reference_rejects_bad_meta():
    jdg = jwf.DeviceGraph.build(GRAPHS["fused-3"].flatten())
    arrays = {k: _as_np(getattr(jdg, k)) for k in REFERENCE_KEYS}
    arrays["window"] = jdg.window
    arrays["end_rank_i"] = jdg.end_rank_i + 1
    with pytest.raises(ValueError):
        device_graph_from_reference(arrays, device="cpu")
    del arrays["meta"]
    with pytest.raises(KeyError):
        device_graph_from_reference(arrays, device="cpu")
