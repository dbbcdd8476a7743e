"""The port's ``BatchMapper.align_batch`` and ``lasagna`` CLI on the CPU,
against ``poasta_tpu``'s: scores and alignments equal, GAF byte-equal, on
the dense route, the banded route (device traceback plus native host
backtrace), the pipelined multi-batch path, ``--engine exact``, shard
part files, and ``-m semi-global|ends-free`` (seeded and not, pipelined
and not; the JAX side then runs its Pallas kernels in interpret mode).
Options the port does not carry yet exit 1.  The port runs on the CPU here
because every call names it (``device="cpu"``, ``--device cpu``); without
that it takes the card or fails.
"""

import os
import random
import subprocess
import sys

import numpy as np
import pytest
import torch

from poasta_tpu.aligner import GapAffine, Global, PoastaAligner
from poasta_tpu.cli.lasagna import main as jax_lasagna
from poasta_tpu.graphs import POAGraph
from poasta_tpu.io.gfa import graph_to_gfa
from poasta_tpu.ops.pallas_fill import set_interpret_mode
from poasta_tpu.parallel import BatchMapper as JaxMapper
from poasta_tpu_torch import BatchMapper
from poasta_tpu_torch.cli.lasagna import main as port_lasagna

torch.set_num_threads(1)

COSTS = GapAffine(4, 2, 6)


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


def _workload(seed=23, glen=180, n_reads=10):
    rng = random.Random(seed)
    base = "".join(rng.choice("ACGT") for _ in range(glen))
    g = POAGraph()
    al = PoastaAligner(COSTS, Global(), heuristic="mingap")
    g.add_alignment_with_weights("s0", base.encode(), None, [1] * glen)
    for i in range(1, 3):
        s = _mutate(rng, base, 0.06).encode()
        g.add_alignment_with_weights(f"s{i}", s, al.align(g, s).alignment,
                                     [1] * len(s))
    reads = [_mutate(rng, base, rng.choice([0.02, 0.06, 0.12])).encode()
             for _ in range(n_reads - 2)]
    reads.append((base[:50] + base[140:]).encode())  # tier-retry read
    reads.append(base[:30].encode())  # short read: long deletion
    return g, reads


def _pairs(aln):
    return [(p.rpos, p.qpos) for p in aln]


@pytest.mark.parametrize("route", ["dense", "banded"])
def test_align_batch_matches_jax(route, monkeypatch):
    g, reads = _workload()
    if route == "banded":
        monkeypatch.setattr(BatchMapper, "DENSE_TABLE_BUDGET", 0)
        monkeypatch.setattr(JaxMapper, "DENSE_TABLE_BUDGET", 0)
    port = BatchMapper(g, COSTS, device="cpu")
    ref = JaxMapper(g, COSTS).align_batch(reads)
    got = port.align_batch(reads)
    assert port.takes_banded_path(reads) == (route == "banded")
    assert len(got) == len(ref)
    for (ps, pa), (js, ja) in zip(got, ref):
        assert ps == js
        assert _pairs(pa) == _pairs(ja)
    if route == "banded":
        assert port.last_banded_stats["device_traced"] == len(reads)


def _write_inputs(tmp_path, g, reads):
    gfa = tmp_path / "graph.gfa"
    with open(gfa, "w") as fh:
        graph_to_gfa(g, fh)
    fa = tmp_path / "reads.fa"
    with open(fa, "w") as fh:
        for i, r in enumerate(reads):
            fh.write(f">read{i}\n{r.decode()}\n")
        fh.write(">empty\n\n")
    return str(gfa), str(fa)


@pytest.mark.parametrize("mode", ["dense", "banded", "pipelined", "exact"])
def test_cli_gaf_byte_equal(mode, tmp_path, monkeypatch):
    g, reads = _workload(seed=31)
    gfa, fa = _write_inputs(tmp_path, g, reads)
    extra = []
    if mode in ("banded", "pipelined"):
        monkeypatch.setattr(BatchMapper, "DENSE_TABLE_BUDGET", 0)
        monkeypatch.setattr(JaxMapper, "DENSE_TABLE_BUDGET", 0)
    if mode == "pipelined":
        extra = ["-j", "2"]
    if mode == "exact":
        extra = ["--engine", "exact"]
    out_j, out_p = tmp_path / "jax.gaf", tmp_path / "port.gaf"
    assert jax_lasagna(["align", gfa, fa, "--mesh", "off", "-o", str(out_j),
                        *extra]) in (0, None)
    assert port_lasagna(["align", gfa, fa, "-o", str(out_p), "--device",
                         "cpu", *extra]) == 0
    text = out_p.read_text()
    assert len(text.splitlines()) == len(reads)
    assert text == out_j.read_text()


def test_cli_shard_parts_byte_equal(tmp_path):
    g, reads = _workload(seed=37, n_reads=7)
    gfa, fa = _write_inputs(tmp_path, g, reads)
    for k in range(3):
        args = ["--shard-index", str(k), "--shard-count", "3"]
        jax_lasagna(["align", gfa, fa, "-o", str(tmp_path / "j.gaf"), *args])
        assert port_lasagna(["align", gfa, fa, "-o", str(tmp_path / "p.gaf"),
                             "--device", "cpu", *args]) == 0
        part = (tmp_path / f"p.gaf.part{k}").read_text()
        assert part and part == (tmp_path / f"j.gaf.part{k}").read_text()
    assert port_lasagna(["align", gfa, fa, "--device", "cpu",
                         "--shard-index", "3", "--shard-count", "3"]) == 1


def _mapping_workload(seed=47, n=900, n_reads=8, read_len=300):
    """A linear graph with skip edges (the pangenome configuration's shape)
    and reads cut from it at 2%, one of them random."""
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
        reads.append(_mutate(rng, base[a:a + read_len - rng.randrange(40)],
                             0.02).encode())
    reads[2] = "".join(rng.choice("ACGT") for _ in range(200)).encode()
    return g, reads


@pytest.fixture
def interpret_mode():
    set_interpret_mode(True)
    try:
        yield
    finally:
        set_interpret_mode(False)


@pytest.mark.parametrize("pipelined", [False, True],
                         ids=["serial", "pipelined"])
@pytest.mark.parametrize("seed_mode", ["all", "0"])
@pytest.mark.parametrize("span", ["semi-global", "ends-free"])
def test_cli_span_gaf_byte_equal(span, seed_mode, pipelined, tmp_path,
                                 monkeypatch, interpret_mode, capsys):
    """``-m semi-global`` and ``-m ends-free`` on two batches (the second
    seeds under POASTA_SEED=all where the span can), with the scoring of a
    batch overlapped with the alignment of the one before or not: GAF
    byte-equal to the JAX package's CLI."""
    from poasta_tpu_torch.parallel import mapper as tmapper

    monkeypatch.setenv("POASTA_SEED", seed_mode)
    monkeypatch.setenv("POASTA_SEED_DEBUG", "1")
    if not pipelined:
        # the pipeline gate of an ends-free span is a second core
        monkeypatch.setattr(os, "cpu_count", lambda: 1)
    g, reads = _mapping_workload()
    gfa, fa = _write_inputs(tmp_path, g, reads)
    seeded = []
    real = tmapper.BatchMapper._ends_free_scores

    def rec(self, *args):
        out = real(self, *args)
        seeded.append(self.last_seed_stats)
        return out

    monkeypatch.setattr(tmapper.BatchMapper, "_ends_free_scores", rec)
    out_j, out_p = tmp_path / "jax.gaf", tmp_path / "port.gaf"
    extra = ["-m", span, "-j", "4"]
    assert jax_lasagna(["align", gfa, fa, "--mesh", "off", "-o", str(out_j),
                        *extra]) in (0, None)
    assert port_lasagna(["align", gfa, fa, "-o", str(out_p), "--device",
                         "cpu", "-v", *extra]) == 0
    text = out_p.read_text()
    assert len(text.splitlines()) == len(reads)
    assert text == out_j.read_text()
    err = capsys.readouterr().err
    assert "[anchored path: device" in err and "exact-fallback 0]" in err
    assert len(seeded) == 2
    if span == "semi-global" and seed_mode == "all":
        assert seeded[0] is None and seeded[1]["seeded"] >= 3
        assert "[seeded corridors: " in err
    else:
        assert seeded == [None, None] and "[seeded corridors" not in err


def test_cli_exact_engine_runs_dijkstra_under_free_ends(tmp_path):
    """``--engine exact -m semi-global``: the reference's CLI runs the A*
    engine under its minimum-gap-cost heuristic, which is not admissible
    when ends are free, and reports 158 for a read whose optimum is 132.
    The port's runs Dijkstra there, and agrees with its wavefront engine."""
    rng = random.Random(0)
    base = "".join(rng.choice("ACGT") for _ in range(160))
    g = POAGraph()
    g.add_alignment_with_weights("s0", base.encode(), None, [1] * 160)
    read = _mutate(rng, base[30:110], 0.15).encode()
    gfa, fa = _write_inputs(tmp_path, g, [read])

    def score_of(main, *argv):
        out = tmp_path / "out.gaf"
        assert main(["align", gfa, fa, "-o", str(out), "-m", "semi-global",
                     *argv]) in (0, None)
        (tag,) = [f for f in out.read_text().split() if f.startswith("AS:i:")]
        return int(tag[5:])

    assert score_of(jax_lasagna, "--engine", "exact") == 158
    assert score_of(port_lasagna, "--engine", "exact") == 132
    assert score_of(port_lasagna, "--device", "cpu") == 132
    # the global span keeps the reference's heuristic
    out_j, out_p = tmp_path / "j.gaf", tmp_path / "p.gaf"
    jax_lasagna(["align", gfa, fa, "-o", str(out_j), "--engine", "exact"])
    assert port_lasagna(["align", gfa, fa, "-o", str(out_p), "--engine",
                         "exact"]) == 0
    assert out_p.read_text() == out_j.read_text()


@pytest.mark.parametrize("argv", [
    ["--distributed"],
    ["--mesh", "2"],
    ["--mesh", "2,1"],
])
def test_cli_unported_options_exit_1(argv, tmp_path, capsys):
    g, reads = _workload(n_reads=2)
    gfa, fa = _write_inputs(tmp_path, g, reads)
    out = tmp_path / "out.gaf"
    assert port_lasagna(["align", gfa, fa, "-o", str(out), "--device", "cpu",
                         *argv]) == 1
    assert "not ported yet" in capsys.readouterr().err
    assert not out.exists()


def test_cli_without_a_card_exits_1(tmp_path, capsys):
    """The default device is the card: with none, the CLI says so and
    exits 1 instead of carrying on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    g, reads = _workload(n_reads=2)
    gfa, fa = _write_inputs(tmp_path, g, reads)
    out = tmp_path / "out.gaf"
    assert port_lasagna(["align", gfa, fa, "-o", str(out)]) == 1
    assert "no CUDA device" in capsys.readouterr().err
    assert not out.exists()


def test_cli_run_imports_no_jax(tmp_path):
    """A whole run of the port's CLI (banded route: scoring, trace,
    decode, GAF) in a fresh process loads no jax."""
    g, reads = _workload(seed=43, n_reads=3)
    gfa, fa = _write_inputs(tmp_path, g, reads)
    out = tmp_path / "out.gaf"
    argv = ["align", gfa, fa, "-o", str(out), "--device", "cpu"]
    code = ("import sys\n"
            "from poasta_tpu_torch.parallel.mapper import BatchMapper\n"
            "from poasta_tpu_torch.cli.lasagna import main\n"
            "BatchMapper.DENSE_TABLE_BUDGET = 0\n"
            f"assert main({argv!r}) == 0\n"
            "assert not [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'poasta_tpu')]\n")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo)
    res = subprocess.run([sys.executable, "-c", code], cwd=repo, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert len(out.read_text().splitlines()) == len(reads)


def test_lasagna_gaf_golden(tmp_path, reference_tests_dir):
    """The port's GAF on the reference test data equals the golden that
    pins ``poasta_tpu``'s."""
    out_path = tmp_path / "out.gaf"
    rc = port_lasagna(["align", f"{reference_tests_dir}/test.gfa",
                       f"{reference_tests_dir}/small_test.query.fa",
                       "-o", str(out_path), "--device", "cpu"])
    assert rc == 0
    golden = os.path.join(os.path.dirname(__file__), "goldens",
                          "lasagna_small_query.gaf")
    with open(golden) as fh:
        assert out_path.read_text() == fh.read()


def test_batch_mapper_rejects_unported_spans():
    """An ends-free span scores and aligns, under one- and two-piece costs
    (two-piece: a read must end at its last base, as the two-piece engines
    rule, and scores equal poasta_tpu's); a span object of another package
    is refused by name, not guessed at."""
    from poasta_tpu_torch import UNBOUNDED, EndsFree
    from poasta_tpu_torch import Global as PortGlobal

    g, _ = _workload(n_reads=2)
    semi = BatchMapper(g, COSTS, device="cpu",
                       aln_type=EndsFree(UNBOUNDED, UNBOUNDED, UNBOUNDED,
                                         UNBOUNDED))
    assert np.all(semi.score_batch([b"ACGT"]) == 0)
    assert [s for s, _ in semi.align_batch([b"ACGT"])] == [0]
    from poasta_tpu_torch.aligner import GapAffine2Piece

    from poasta_tpu.aligner import GapAffine2Piece as JaxGapAffine2Piece
    from poasta_tpu.aligner.costs import UNBOUNDED as JAX_UNBOUNDED
    from poasta_tpu.aligner.costs import EndsFree as JaxEndsFree

    two_piece = GapAffine2Piece(4, 2, 6, 1, 20)
    reads = [b"ACGT", b"TTTTTTGGGGGG"]
    semi_2p = BatchMapper(g, two_piece, device="cpu",
                          aln_type=EndsFree(UNBOUNDED, UNBOUNDED, UNBOUNDED,
                                            UNBOUNDED))
    want = JaxMapper(g, JaxGapAffine2Piece(4, 2, 6, 1, 20),
                     aln_type=JaxEndsFree(*[JAX_UNBOUNDED] * 4)).align_batch(
                         reads)
    assert list(semi_2p.score_batch(reads)) == [s for s, _ in want]
    got = semi_2p.align_batch(reads)
    assert [(s, list(a)) for s, a in got] == [(s, list(a)) for s, a in want]
    assert got[1][0] > 0
    assert np.all(BatchMapper(g, two_piece, device="cpu").score_batch(
        [b"ACGT"]) > 0)
    with pytest.raises(TypeError):
        BatchMapper(g, COSTS, device="cpu", aln_type=Global())
    assert np.all(BatchMapper(g, COSTS, device="cpu", aln_type=PortGlobal()
                              ).score_batch([b"ACGT"]) > 0)
