"""The port's mesh (``poasta_tpu_torch/utils/mesh.py``,
``parallel/mapper.py``) on the CPU, against ``poasta_tpu``'s on its 8
virtual CPU devices (tests/conftest.py) and against the port's own
one-device outputs, with tolerance 0.

Eight CPU entries of one ``torch.device`` stand in for the reference's
eight virtual devices: every (dp, sp) layout runs the real split, per-shard
fills and gather, and with sp > 1 the demonstrator's halo, gathered
prefix-min and min over slabs.  Inputs are drawn from seeds.  Also pinned:
the reference's swallowed shard failures that the port does not copy
(ROADMAP C13), ``place_on_device=False`` keeping host tensors without a
device call, and the mesh helpers' rules.
"""

import random

import jax
import numpy as np
import pytest
import torch

from poasta_tpu.aligner import (
    GapAffine,
    GapAffine2Piece,
    Global,
    PoastaAligner,
)
from poasta_tpu.aligner.banded import BandedScorer as JaxScorer
from poasta_tpu.aligner.costs import UNBOUNDED, EndsFree, included
from poasta_tpu.aligner.wavefront import DeviceGraph as JaxDeviceGraph
from poasta_tpu.aligner.wavefront import dp_fill_scores as jax_fill
from poasta_tpu.aligner.wavefront import pack_queries as jax_pack
from poasta_tpu.graphs import POAGraph
from poasta_tpu.native import NativeAligner as JaxNative
from poasta_tpu.parallel import BatchMapper as JaxMapper
from poasta_tpu.parallel import make_mesh as jax_make_mesh
from poasta_tpu.parallel import make_sharded_score_fn as jax_sharded
from poasta_tpu_torch import BandedScorer, BatchMapper, DeviceGraph
from poasta_tpu_torch import EndsFree as PortEndsFree
from poasta_tpu_torch import GapAffine as PortGapAffine
from poasta_tpu_torch import UNBOUNDED as PORT_UNBOUNDED
from poasta_tpu_torch import included as port_included
from poasta_tpu_torch import pack_queries
from poasta_tpu_torch.aligner import wavefront as wf
from poasta_tpu_torch.aligner import banded as banded_mod
from poasta_tpu_torch.parallel import make_mesh, make_sharded_score_fn
from poasta_tpu_torch.parallel import mapper as mapper_mod
from poasta_tpu_torch.parallel.mapper import _sp_scan_rows, parse_mesh_spec
from poasta_tpu_torch.utils.device import NoDeviceError
from poasta_tpu_torch.utils.errors import PoastaError
from poasta_tpu_torch.utils.mesh import Mesh, check_mesh, dp_shards

torch.set_num_threads(1)

COSTS = GapAffine(4, 2, 6)
COSTS_2P = GapAffine2Piece(4, 2, 8, 1, 24)
SEMI = EndsFree(UNBOUNDED, included(0), UNBOUNDED, UNBOUNDED)
PORT_SEMI = PortEndsFree(PORT_UNBOUNDED, port_included(0), PORT_UNBOUNDED,
                         PORT_UNBOUNDED)
CPU8 = ["cpu"] * 8


def _jax_mesh(dp, sp):
    if jax.device_count() < dp * sp:
        pytest.skip("needs 8 virtual devices")
    return jax_make_mesh(devices=jax.devices()[: dp * sp], dp=dp, sp=sp)


def _mutate(rng, s, d):
    out = []
    for ch in s:
        r = rng.random()
        if r < d:
            continue
        out.append(rng.choice("ACGT") if r < 2 * d else ch)
        if rng.random() < d * 2 / 3:
            out.append(rng.choice("ACGT"))
    return "".join(out) or "A"


def _case(seed=11, nseq=3, length=40, nq=8):
    """tests/test_parallel.py's workload: a small fused graph and reads
    drawn from its base at ~6%."""
    rng = random.Random(seed)
    base = "".join(rng.choice("ACGT") for _ in range(length))
    g = POAGraph()
    aligner = PoastaAligner(COSTS, Global(), heuristic="mingap")
    g.add_alignment_with_weights("s0", base.encode(), None, [1] * length)
    for i in range(1, nseq):
        s = _mutate(rng, base, 0.06).encode()
        g.add_alignment_with_weights(f"s{i}", s, aligner.align(g, s).alignment,
                                     [1] * len(s))
    return g, [_mutate(rng, base, 0.06).encode() for _ in range(nq)]


@pytest.fixture(scope="module")
def long_read_case():
    """Reads long enough that the band is narrower than the row, so the
    banded scorer's sharded fills run (seed 41, 700 bases)."""
    rng = random.Random(41)
    length = 700
    base = "".join(rng.choice("ACGT") for _ in range(length))
    g = POAGraph()
    g.add_alignment_with_weights("s0", base.encode(), None, [1] * length)
    for i in range(1, 3):
        s = _mutate(rng, base, 0.03).encode()
        _, aln, _ = JaxNative(g).align(s, COSTS)
        g.add_alignment_with_weights(f"s{i}", s, aln, [1] * len(s))
    queries = [_mutate(rng, base, 0.03).encode() for _ in range(8)]
    na = JaxNative(g)
    return g, queries, [na.align(q, COSTS)[0] for q in queries]


def _port(g, queries, pad_to=None):
    dg = DeviceGraph.build(g.flatten(), device="cpu")
    return (dg,) + pack_queries(queries, pad_to=pad_to, device="cpu")


# ---- make_sharded_score_fn --------------------------------------------------

@pytest.mark.parametrize("dp,sp", [(8, 1), (4, 2), (2, 4), (1, 8)])
def test_sharded_scores_match_reference(dp, sp):
    g, queries = _case()
    jdg = JaxDeviceGraph.build(g.flatten())
    jq, jl = jax_pack(queries, pad_to=255)
    want = np.asarray(jax_sharded(jdg, COSTS, _jax_mesh(dp, sp))(jq, jl))
    dg, q, ln = _port(g, queries, pad_to=255)
    got = make_sharded_score_fn(dg, COSTS, make_mesh(CPU8, dp=dp, sp=sp))(
        q, ln)
    assert got.tolist() == want.tolist()
    assert got.tolist() == wf.dp_fill_scores(dg, q, ln, COSTS).tolist()


@pytest.mark.parametrize("dp,sp", [(8, 1), (4, 2)])
@pytest.mark.parametrize("fs,fe", [(True, True), (False, True),
                                   (True, False)])
def test_sharded_free_ends_match_reference(dp, sp, fs, fe):
    """Free graph ends: B2f's plain version on each dp shard (sp 1), the
    demonstrator with its free-start seeds and free-end min (sp 2)."""
    g, queries = _case(seed=61)
    jdg = JaxDeviceGraph.build(g.flatten())
    jq, jl = jax_pack(queries, pad_to=255)
    want = np.asarray(jax_sharded(jdg, COSTS, _jax_mesh(dp, sp),
                                  free_start=fs, free_end=fe)(jq, jl))
    dg, q, ln = _port(g, queries, pad_to=255)
    fn = make_sharded_score_fn(dg, COSTS, make_mesh(CPU8, dp=dp, sp=sp),
                               free_start=fs, free_end=fe)
    got = fn(q, ln)
    assert got.tolist() == want.tolist()
    assert got.tolist() == wf.dp_fill_scores(dg, q, ln, COSTS, fs,
                                             fe).tolist()


def test_sharded_two_piece_scores():
    """Two-piece costs shard over dp (B12's plain version on each shard)
    and equal the reference's one-device fill; with sp > 1 they raise, as
    the reference's do."""
    g, queries = _case(seed=53, length=60)
    jdg = JaxDeviceGraph.build(g.flatten())
    want = np.asarray(jax_fill(jdg, *jax_pack(queries), COSTS_2P))
    dg, q, ln = _port(g, queries)
    got = make_sharded_score_fn(dg, COSTS_2P, make_mesh(CPU8, dp=8))(q, ln)
    assert got.tolist() == want.tolist()
    with pytest.raises(NotImplementedError, match="dp-only mesh"):
        make_sharded_score_fn(dg, COSTS_2P, make_mesh(CPU8, dp=4, sp=2))
    with pytest.raises(NotImplementedError):
        jax_sharded(jdg, COSTS_2P, _jax_mesh(4, 2))


@pytest.mark.parametrize("sp,lengths", [
    (2, [127, 128, 255, 1, 64, 200]),
    (4, [63, 64, 127, 128, 191, 192, 255, 0]),
])
def test_sp_scan_rows_read_ends_on_slab_boundaries(sp, lengths):
    """Reads ending on the last column of a slab, the first of the next,
    and in the last slab: the min over slabs picks each read's value where
    it lives.  Held to the one-device fill, the reference's demonstrator
    and the native engine."""
    rng = random.Random(7)
    base = "".join(rng.choice("ACGT") for _ in range(200))
    g = POAGraph()
    g.add_alignment_with_weights("s0", base.encode(), None, [1] * 200)
    s = _mutate(rng, base, 0.05).encode()
    _, aln, _ = JaxNative(g).align(s, COSTS)
    g.add_alignment_with_weights("s1", s, aln, [1] * len(s))
    queries = [_mutate(rng, base, 0.04)[:n].encode().ljust(n, b"A")
               for n in lengths]
    assert [len(q) for q in queries] == lengths
    dg, q, ln = _port(g, queries, pad_to=255)
    assert q.shape[1] == 256
    got = _sp_scan_rows(dg, q, ln, [torch.device("cpu")] * sp,
                        PortGapAffine(4, 2, 6), False, False)
    assert got.tolist() == wf.dp_fill_scores(dg, q, ln, COSTS).tolist()
    jdg = JaxDeviceGraph.build(g.flatten())
    want = jax_sharded(jdg, COSTS, _jax_mesh(1, sp))(
        *jax_pack(queries, pad_to=255))
    assert got.tolist() == np.asarray(want).tolist()
    na = JaxNative(g)
    assert got.tolist()[:3] == [na.align(x, COSTS)[0] for x in queries[:3]]


# ---- BandedScorer(mesh=) ----------------------------------------------------

@pytest.mark.parametrize("dp,sp", [(8, 1), (4, 2)])
def test_sharded_banded_scorer_matches_reference(dp, sp, long_read_case):
    g, queries, oracle = long_read_case
    flat = g.flatten()
    want = JaxScorer(flat, COSTS, mesh=_jax_mesh(dp, sp)).scores(
        *jax_pack(queries))
    scorer = BandedScorer(flat, COSTS, mesh=make_mesh(CPU8, dp=dp, sp=sp),
                          device="cpu")
    calls = []
    real = banded_mod.banded_scores

    def spy(dg, q, *args, **kwargs):
        calls.append(int(q.shape[0]))
        return real(dg, q, *args, **kwargs)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(banded_mod, "banded_scores", spy)
        got = scorer.scores(*pack_queries(queries, device="cpu"))
    assert not any(isinstance(k, tuple) and k and k[0] == "fullfill"
                   for k in scorer._prep_cache), "the band did not engage"
    # every tier refills the whole batch, one shard of 8 // dp reads a
    # mesh row
    assert calls and all(n == 8 // dp for n in calls)
    assert len(calls) % dp == 0
    assert got.tolist() == np.asarray(want).tolist() == oracle


def test_banded_scorer_mesh_refuses_ends_free_spans():
    g, _ = _case()
    with pytest.raises(NotImplementedError, match="does not shard"):
        BandedScorer(g.flatten(), COSTS, mesh=make_mesh(CPU8, dp=8),
                     aln_type=PORT_SEMI, device="cpu")
    with pytest.raises(NotImplementedError, match="does not shard"):
        JaxScorer(g.flatten(), COSTS, mesh=_jax_mesh(8, 1), aln_type=SEMI)


# ---- BatchMapper(mesh=) -----------------------------------------------------

def _pairs(out):
    return [(s, [(p.rpos, p.qpos) for p in a]) for s, a in out]


@pytest.mark.parametrize("span,costs", [
    ("global", COSTS), ("semi-global", COSTS), ("global", COSTS_2P),
    ("semi-global", COSTS_2P)],
    ids=["global", "semi-global", "global-2p", "semi-global-2p"])
def test_batch_mapper_mesh_matches_reference(span, costs):
    """score_batch and align_batch over a (4, 2) mesh equal the reference
    mapper's over its (4, 2) mesh and the port's own one-device mapper."""
    g, queries = _case(seed=37, nq=8, length=60)
    semi = span == "semi-global"
    jm = JaxMapper(g, costs, mesh=_jax_mesh(4, 2),
                   aln_type=SEMI if semi else None)
    aln_type = PORT_SEMI if semi else None
    port_mesh = BatchMapper(g, costs, make_mesh(CPU8, dp=4, sp=2),
                            aln_type=aln_type)
    port_one = BatchMapper(g, costs, aln_type=aln_type, device="cpu")
    assert port_mesh.dg.device.type == "cpu"
    want = np.asarray(jm.score_batch(queries)).tolist()
    assert port_mesh.score_batch(queries).tolist() == want
    assert port_one.score_batch(queries).tolist() == want
    want = _pairs(jm.align_batch(queries))
    assert _pairs(port_mesh.align_batch(queries)) == want
    assert _pairs(port_one.align_batch(queries)) == want
    if span == "global":
        assert port_mesh.takes_banded_path(queries)
        assert port_mesh.last_banded_stats["device_traced"] \
            + port_mesh.last_banded_stats["host_backtraced"] == len(queries)


def test_batch_mapper_mesh_routes_as_the_reference():
    """Under a mesh: the banded route at every size for a global span.  An
    ends-free span over a dp-only mesh keeps a replica a mesh row, each a
    one-card mapper on its row's device that seeds its block; over sp > 1,
    or under two-piece costs, the reference's route: no capped ladder, no
    seeding, the trace on the mesh's first device."""
    g, queries = _case(seed=39)
    mesh = make_mesh(CPU8, dp=8)
    mapper = BatchMapper(g, COSTS, mesh)
    one = BatchMapper(g, COSTS, device="cpu")
    assert mapper.takes_banded_path(queries)
    assert not one.takes_banded_path(queries)
    assert mapper.dg.device == mesh.first
    assert mapper.replicas is None and mapper.scorer.mesh is mesh
    semi = BatchMapper(g, COSTS, mesh, aln_type=PORT_SEMI)
    assert semi.scorer.mesh is None and len(semi.replicas) == 8
    assert [r.dg.device for r in semi.replicas] == list(mesh.devices[:, 0])
    assert all(r.mesh is None and r.replicas is None for r in semi.replicas)
    # as one card's mapper: the capped ladder where the card is
    assert [r._ef_cap_enabled() for r in semi.replicas] == \
        [one._ef_cap_enabled()] * 8
    others = [BatchMapper(g, COSTS, make_mesh(CPU8, dp=4, sp=2),
                          aln_type=PORT_SEMI),
              BatchMapper(g, COSTS_2P, mesh, aln_type=PORT_SEMI)]
    calls = []

    def spy(m, key):
        real = m._fill_ends_free_seeded

        def seeded(*args, **kwargs):
            calls.append(key)
            return real(*args, **kwargs)
        return seeded

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("POASTA_SEED", "all")
        for card, rep in enumerate(semi.replicas):
            mp.setattr(rep, "_fill_ends_free_seeded", spy(rep, card))
        for m in [semi] + others:
            mp.setattr(m, "_fill_ends_free_seeded", spy(m, "top"))
        for m in [semi] + others:
            want = _pairs(BatchMapper(g, m.costs, device="cpu",
                                      aln_type=PORT_SEMI).align_batch(queries))
            assert _pairs(m.align_batch(queries)) == want
            assert _pairs(m.align_batch(queries)) == want
    # each replica seeds its one read, twice; no other mapper seeds
    assert sorted(calls) == sorted(list(range(8)) * 2)
    for m in others:
        assert m.replicas is None and not m._ef_cap_enabled()


# ---- ROADMAP C13: a shard's failure reaches the caller ----------------------

class ShardFailure(RuntimeError):
    pass


def _fail_on_second_shard(real):
    seen = []

    def fill(*args, **kwargs):
        seen.append(1)
        if len(seen) == 2:
            raise ShardFailure("shard 1 failed")
        return real(*args, **kwargs)
    return fill


def test_sharded_score_fn_shard_failure_propagates(monkeypatch):
    """poasta_tpu/parallel/mapper.py:245-253 remembers a failed shape and
    takes its XLA body; the port's shard error reaches the caller."""
    g, queries = _case()
    dg, q, ln = _port(g, queries)
    monkeypatch.setattr(mapper_mod, "dp_fill_scores",
                        _fail_on_second_shard(mapper_mod.dp_fill_scores))
    fn = make_sharded_score_fn(dg, COSTS, make_mesh(CPU8, dp=8))
    with pytest.raises(ShardFailure):
        fn(q, ln)


def test_sharded_banded_fill_failure_propagates(monkeypatch, long_read_case):
    """poasta_tpu/aligner/banded.py:1573-1574 passes over any exception of
    its sharded banded kernel; the port's reaches the caller."""
    g, queries, _ = long_read_case
    monkeypatch.setattr(banded_mod, "banded_scores",
                        _fail_on_second_shard(banded_mod.banded_scores))
    scorer = BandedScorer(g.flatten(), COSTS, mesh=make_mesh(CPU8[:4], dp=4),
                          device="cpu")
    with pytest.raises(ShardFailure):
        scorer.scores(*pack_queries(queries, device="cpu"))


@pytest.mark.parametrize("fill,wrapper", [
    ("dp_fill_ends_free_with_ends", "bounded_with_ends"),
    ("dp_fill_scores_ends_free", "bounded_scores")],
    ids=["with-ends", "scores"])
def test_sharded_ends_free_fill_failure_propagates(fill, wrapper,
                                                   monkeypatch):
    """poasta_tpu/aligner/wavefront.py:823-826 and :924-925 take the XLA
    shard body after a kernel exception; the port's reaches the caller."""
    g, queries = _case()
    dg, q, ln = _port(g, queries)
    monkeypatch.setattr(wf, wrapper, _fail_on_second_shard(
        getattr(wf, wrapper)))
    with pytest.raises(ShardFailure):
        getattr(wf, fill)(dg, g.flatten(), q, ln, COSTS, PORT_SEMI,
                          mesh=make_mesh(CPU8, dp=8))


def test_sharded_ends_free_fills_match_one_device():
    g, queries = _case(seed=43)
    dg, q, ln = _port(g, queries)
    mesh = make_mesh(CPU8, dp=8)
    for fill in (wf.dp_fill_scores_ends_free, wf.dp_fill_ends_free_with_ends):
        got = fill(dg, g.flatten(), q, ln, COSTS, PORT_SEMI, mesh=mesh)
        want = fill(dg, g.flatten(), q, ln, COSTS, PORT_SEMI)
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        assert [t.tolist() for t in got] == [t.tolist() for t in want]


# ---- place_on_device=False --------------------------------------------------

def test_host_arrays_without_a_device_call(monkeypatch):
    """``place_on_device=False`` keeps host tensors and makes no device
    call; a fill moves them to the device asked for at build (the CPU here,
    the card by default, which raises at the fill without one)."""
    g, queries = _case(seed=47)
    flat = g.flatten()
    real = (torch.cuda.is_available, torch.cuda.device_count)

    def no_device_call():
        raise AssertionError("a device call")

    monkeypatch.setattr(torch.cuda, "is_available", no_device_call)
    monkeypatch.setattr(torch.cuda, "device_count", no_device_call)
    host = DeviceGraph.build(flat, 64, False)
    q, ln = pack_queries(queries, None, False)
    on_cpu = DeviceGraph.build(flat, 64, False, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", real[0])
    monkeypatch.setattr(torch.cuda, "device_count", real[1])
    assert host.on_host and host.device.type == "cpu"
    assert q.device.type == ln.device.type == "cpu"
    jdg = JaxDeviceGraph.build(flat, place_on_device=False)
    assert np.array_equal(host.symbols.numpy(), jdg.symbols)
    assert np.array_equal(host.pred_slots.numpy(), jdg.pred_slots)
    want = np.asarray(jax_fill(jdg, *jax_pack(queries, place_on_device=False),
                               COSTS)).tolist()
    assert wf.dp_fill_scores(on_cpu, q, ln, COSTS).tolist() == want
    if not torch.cuda.is_available():
        with pytest.raises(NoDeviceError):
            wf.dp_fill_scores(host, q, ln, COSTS)


# ---- the mesh helpers -------------------------------------------------------

def test_make_mesh_and_parse_mesh_spec_rules():
    mesh = make_mesh(CPU8, dp=4, sp=2)
    assert isinstance(mesh, Mesh)
    assert mesh.shape == {"dp": 4, "sp": 2}
    assert mesh.axis_names == ("dp", "sp")
    assert mesh.devices.shape == (4, 2)
    assert all(d == torch.device("cpu") for d in mesh.devices.flat)
    assert make_mesh(CPU8[:6], sp=2).shape == {"dp": 3, "sp": 2}
    with pytest.raises(ValueError, match="must equal device count"):
        make_mesh(CPU8, dp=3, sp=2)
    if not torch.cuda.is_available():
        with pytest.raises(NoDeviceError):
            make_mesh()
    for spec in ("off", "1", "none", " OFF ", "1,1"):
        assert parse_mesh_spec(spec, device="cpu") is None
    assert parse_mesh_spec("auto", device="cpu") is None
    assert parse_mesh_spec("4,2", device="cpu").shape == {"dp": 4, "sp": 2}
    assert parse_mesh_spec("3", device="cpu").shape == {"dp": 3, "sp": 1}
    for bad in ("x", "2,y", "0", "2,0"):
        with pytest.raises(ValueError, match="bad --mesh spec"):
            parse_mesh_spec(bad, device="cpu")
    if torch.cuda.device_count() == 0:
        assert parse_mesh_spec("auto") is None
        with pytest.raises(ValueError,
                           match="dp\\*sp = 2 but 0 devices are visible"):
            parse_mesh_spec("2")


def test_dp_shards_split_and_check_mesh():
    mesh = make_mesh(CPU8[:3], dp=3)
    assert [(r.start, r.stop) for _, r in dp_shards(mesh, 8, None)] == \
        [(0, 3), (3, 6), (6, 8)]
    assert [(r.start, r.stop) for _, r in dp_shards(mesh, 2, None)] == \
        [(0, 1), (1, 2)]
    assert [(r.start, r.stop) for _, r in dp_shards(mesh, 0, None)] == \
        [(0, 0)]
    assert dp_shards(None, 5, "cpu") == [("cpu", slice(0, 5))]
    check_mesh(None)
    check_mesh(mesh)
    with pytest.raises(PoastaError, match="not a poasta_tpu_torch mesh"):
        check_mesh(_jax_mesh(8, 1))


# ---- the CLI's mesh ----------------------------------------------------------

@pytest.mark.parametrize("spec", ["4,2", "8"])
def test_cli_mesh_gaf_byte_equal(spec, tmp_path):
    """``lasagna align --mesh DP[,SP] --device cpu`` (DP*SP CPU entries)
    writes GAF byte-equal to ``--mesh off`` and to the reference CLI's
    under the same spec on its 8 virtual devices."""
    from poasta_tpu.cli.lasagna import main as jax_lasagna
    from poasta_tpu.io.gfa import graph_to_gfa
    from poasta_tpu_torch.cli.lasagna import main as port_lasagna

    _jax_mesh(8, 1)
    g, queries = _case(seed=29, nq=12, length=80)
    gfa, fa = tmp_path / "g.gfa", tmp_path / "r.fa"
    with open(gfa, "w") as fh:
        graph_to_gfa(g, fh)
    fa.write_text("".join(f">r{i}\n{q.decode()}\n"
                          for i, q in enumerate(queries)))
    outs = {}
    for name, main, argv in (
            ("jax", jax_lasagna, ["--mesh", spec]),
            ("off", port_lasagna, ["--mesh", "off", "--device", "cpu"]),
            ("mesh", port_lasagna, ["--mesh", spec, "--device", "cpu"])):
        out = tmp_path / f"{name}.gaf"
        assert main(["align", str(gfa), str(fa), "-o", str(out),
                     *argv]) in (0, None)
        outs[name] = out.read_text()
    assert len(outs["mesh"].splitlines()) == len(queries)
    assert outs["mesh"] == outs["off"] == outs["jax"]
