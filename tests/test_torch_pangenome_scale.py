"""The mapping path that ``chip_smoke.py``'s phase 13 drives at the
reference's 200k-node probe (``scripts/pangenome_200k.py``) with 512-read
batches (``scripts/pangenome_bigbatch.py``), here at a small size on the
CPU: phase 13's own workload function at 2,400 nodes (an edge v -> v+3
every 500 nodes) and 24 reads of 800 bases at 1.5%.

The graph is under ``BatchMapper.SEED_MIN_NODES``, so ``POASTA_SEED=all``
seeds it.  The JAX package runs as ``tests/test_torch_anchored.py`` runs
it (Pallas interpret mode, ``POASTA_SEED=all POASTA_SEED_DEBUG=1``); the
port runs its kernels' plain versions (``device="cpu"``, ``--device
cpu``).  Every comparison is exact (tolerance 0).  Last, a pin of the
sizing phase 13 asserts on the card at the full 200,002 nodes.
"""

import pytest
import torch

import chip_smoke
from poasta_tpu.aligner import GapAffine
from poasta_tpu.aligner import costs as jcosts
from poasta_tpu.cli.lasagna import main as jax_lasagna
from poasta_tpu.ops.pallas_fill import set_interpret_mode
from poasta_tpu.parallel import BatchMapper as JaxMapper
from poasta_tpu_torch import BatchMapper, DeviceGraph
from poasta_tpu_torch.aligner import costs as tcosts
from poasta_tpu_torch.aligner import wavefront as twf
from poasta_tpu_torch.aligner.seeds import k_for_graph
from poasta_tpu_torch.cli.lasagna import main as port_lasagna
from poasta_tpu_torch.ops import trace as tr

torch.set_num_threads(1)

COSTS = GapAffine(4, 2, 6)
N_NODES, N_READS, READ_LEN, BATCH = 2400, 24, 800, 8


def _semi(mod):
    return mod.EndsFree(qry_free_end=("included", 0))


def _alignments(out):
    return [(int(s), [(p.rpos, p.qpos) for p in a]) for s, a in out]


@pytest.fixture(scope="module")
def seeded_env():
    """The seeded path at this graph size, and the JAX package's kernels in
    interpret mode, for the module's fixtures and tests."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("POASTA_SEED", "all")
        mp.setenv("POASTA_SEED_DEBUG", "1")
        set_interpret_mode(True)
        try:
            yield
        finally:
            set_interpret_mode(False)


@pytest.fixture(scope="module")
def workload():
    return chip_smoke.pangenome_200k_workload(N_NODES, N_READS, READ_LEN)


@pytest.fixture(scope="module")
def batches(workload):
    _, reads = workload
    return [reads[i:i + BATCH] for i in range(0, N_READS, BATCH)]


@pytest.fixture(scope="module")
def reference(seeded_env, workload, batches):
    """``poasta_tpu``'s ``align_batch`` on the batches in turn (the first
    learns the seed rates, the others seed)."""
    graph, _ = workload
    jm = JaxMapper(graph, COSTS, aln_type=_semi(jcosts))
    return [_alignments(jm.align_batch(b)) for b in batches]


@pytest.mark.parametrize("route", ["batched", "pipelined"])
def test_align_batch_equals_the_reference(seeded_env, workload, batches,
                                          reference, route):
    """The port's ``align_batch`` on batches of 8, one after the other or
    through the prescore pipeline (the next batch prescored before this one
    aligns, as ``lasagna``'s worker does): scores and alignments equal
    ``poasta_tpu``'s, the later batches seed, and every alignment costs its
    score."""
    graph, _ = workload
    tm = BatchMapper(graph, COSTS, device="cpu", aln_type=_semi(tcosts))
    got, seeded = [], []
    if route == "batched":
        for b in batches:
            got.append(tm.align_batch(b))
            seeded.append(tm.last_seed_stats)
    else:
        token = tm.prescore(batches[0])
        seeded.append(tm.last_seed_stats)
        for k, b in enumerate(batches):
            nxt = None
            if k + 1 < len(batches):
                nxt = tm.prescore(batches[k + 1])
                seeded.append(tm.last_seed_stats)
            got.append(tm.align_batch(b, prescored=token))
            token = nxt
    assert [_alignments(out) for out in got] == reference
    assert seeded[0] is None
    assert all(st["seeded"] >= BATCH // 2 for st in seeded[1:]), seeded
    assert tm.last_ends_free_stats["device_traced"] == BATCH
    for b, out in zip(batches, got):
        for read, (score, aln) in zip(b, out):
            assert twf.alignment_cost(graph, read, aln, COSTS) == score


@pytest.fixture(scope="module")
def cli_inputs(seeded_env, workload, tmp_path_factory):
    """The GFA and FASTA phase 13 writes, and the reference CLI's GAF."""
    graph, reads = workload
    tmp = tmp_path_factory.mktemp("pangenome_scale")
    gfa, fa = chip_smoke.write_inputs(graph, reads, str(tmp))
    out = tmp / "jax.gaf"
    assert jax_lasagna(["align", gfa, fa, "--mesh", "off", "-o", str(out),
                        "-m", "semi-global", "-j", str(BATCH)]) in (0, None)
    return gfa, fa, out.read_text()


@pytest.mark.parametrize("batch,seed_mode", [(N_READS, "all"), (BATCH, "all"),
                                             (N_READS, "0")],
                         ids=["one-batch", "pipelined", "unseeded"])
def test_cli_gaf_equals_the_reference(cli_inputs, tmp_path, monkeypatch,
                                      batch, seed_mode):
    """``lasagna align -m semi-global --device cpu`` at the batch of all the
    reads, at batches of 8 (pipelined, seeded after the first) and at all
    the reads with ``POASTA_SEED=0``: GAF byte-equal to the reference
    CLI's, as phase 13 holds its three runs byte-equal on the card."""
    gfa, fa, want = cli_inputs
    monkeypatch.setenv("POASTA_SEED", seed_mode)
    out = tmp_path / "port.gaf"
    assert port_lasagna(["align", gfa, fa, "-o", str(out), "--device", "cpu",
                         "-m", "semi-global", "-j", str(batch)]) == 0
    text = out.read_text()
    assert len(text.splitlines()) == N_READS
    assert text == want


def test_anchored_trace_split_by_free_memory_equals_unsplit(
        seeded_env, workload, batches, monkeypatch):
    """The anchored route (``free_start``, each read's end state as its
    anchor) with free memory for 3 reads' buffers at Wb 256: the batch runs
    in sub-batches of at most 3, and every alignment equals the unsplit
    call's."""
    graph, _ = workload
    tm = BatchMapper(graph, COSTS, device="cpu", aln_type=_semi(tcosts))
    tm.prescore(batches[0])  # learns the seed rates: the next call seeds
    _, (sc, er, ej), q, ln = tm.prescore(batches[1])
    dg, flat = tm.dg, tm.flat

    def traced():
        out = tr.trace_align(dg, flat, q, ln, COSTS, sc, anchor_r=er,
                             anchor_j=ej, free_start=True)
        return [None if a is None else list(a) for a in out]

    want = traced()
    assert all(a is not None for a in want)
    calls = []
    real_fill = tr.trace_fill

    def counting_fill(g, qpad, *args, **kwargs):
        calls.append((int(qpad.shape[0]), kwargs["Wb"]))
        return real_fill(g, qpad, *args, **kwargs)

    per_read = tr.tier_bytes_per_read(dg, 256)
    monkeypatch.setattr(tr, "trace_fill", counting_fill)
    monkeypatch.setattr(tr, "free_bytes", lambda dev: 2 * 3 * per_read)
    assert traced() == want
    at256 = [b for b, wb in calls if wb == 256]
    assert at256 == [3, 3, 2]


def test_phase_13_sizing():
    """At phase 13's 200,002 nodes (Np 200,064) and Wb 256, the planes of a
    64-read trace call pass 2^31 int32 elements and fit one sub-batch of a
    card with 79 GB free; 512 reads split into 3; rank 131,072, the first
    whose rows lie wholly past element 2^31, is inside the graph; the seed
    index takes k 11 (k 10 at the 50,002 nodes of phase 8)."""
    graph, _ = chip_smoke.pangenome_200k_workload(n_reads=0)
    dg = DeviceGraph.build(graph.flatten(), device="cpu")
    assert (dg.n_nodes, dg.n_nodes_padded, dg.window) == (200_002, 200_064, 3)
    assert dg.n_nodes_padded * 64 * 256 > 2 ** 31
    per_read = tr.tier_bytes_per_read(dg, 256)
    assert per_read == 4 * (200_064 * 257 + 2 * 3 * 256 + 32 + 4)
    free = 79 * 10 ** 9
    assert tr.sub_batch_count(64, per_read, free) == 1
    assert tr.sub_batch_count(chip_smoke.P200_READS, per_read, free) == 3
    assert tr.sub_batch_count(1, per_read, 2 * per_read - 1) == 0
    assert 2 ** 31 // (64 * 256) == 131_072 < dg.n_nodes
    assert k_for_graph(dg.n_nodes) == 11 and k_for_graph(50_002) == 10
