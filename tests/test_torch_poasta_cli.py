"""The port's ``poasta`` CLI (MSA) on the CPU against ``poasta_tpu``'s, and
its device assist.

Both CLIs run in process on a seeded FASTA of a few 1-2 kb sequences; the
port's with ``--device cpu`` (the kernels' plain PyTorch versions).  Output
files must be byte-equal.  The assist's background scoring keeps its
errors and hands them to the caller (ROADMAP C9).
"""

import contextlib
import io
import random
import time

import pytest
import torch

from poasta_tpu.cli.poasta import main as jax_main
from poasta_tpu_torch import NativeAligner, POAGraph
from poasta_tpu_torch.aligner import GapAffine2Piece
from poasta_tpu_torch.aligner import banded as tbd
from poasta_tpu_torch.aligner.fusion_assist import DeviceSeedPrefetcher
from poasta_tpu_torch.cli.poasta import main as port_main

torch.set_num_threads(1)

TWO_PIECE = ["-n", "4", "-g", "8,24", "-e", "2,1"]


def _mutate(rng, s, d):
    out = []
    for ch in s:
        r = rng.random()
        if r < d:
            continue
        out.append(rng.choice("ACGT") if r < 2 * d else ch)
        if rng.random() < d:
            out.append(rng.choice("ACGT"))
    return "".join(out)


def _write_fasta(path, n_bases, cut):
    """Five sequences of about ``n_bases`` at 3% from one base (seed 23),
    every other one with the bases ``cut`` (a slice) deleted."""
    rng = random.Random(23)
    base = "".join(rng.choice("ACGT") for _ in range(n_bases))
    with open(path, "w") as fh:
        for i in range(5):
            s = _mutate(rng, base, 0.03)
            if i % 2:
                s = s[:cut.start] + s[cut.stop:]
            fh.write(f">s{i}\n{s}\n")
    return str(path)


@pytest.fixture(scope="module")
def fasta(tmp_path_factory):
    """1.5 kb sequences with a 200-base deletion in every other one."""
    return _write_fasta(tmp_path_factory.mktemp("msa") / "seqs.fa", 1500,
                        slice(300, 500))


@pytest.fixture(scope="module")
def short_fasta(tmp_path_factory):
    """400-base sequences for the exact A* engine, whose two-piece search
    takes tens of seconds on the 1.5 kb ones."""
    return _write_fasta(tmp_path_factory.mktemp("msa") / "short.fa", 400,
                        slice(100, 160))


def _run(main, argv):
    with contextlib.redirect_stdout(io.StringIO()), \
            contextlib.redirect_stderr(io.StringIO()) as err:
        rc = main(argv)
    return rc, err.getvalue()


@pytest.mark.parametrize("engine,costs,out_type", [
    (["--engine", "banded", "--device-assist", "on"], TWO_PIECE, "fasta"),
    (["--engine", "banded", "--device-assist", "on"], TWO_PIECE, "gfa"),
    (["--engine", "banded", "--device-assist", "off"], TWO_PIECE, "fasta"),
    (["--engine", "exact"], TWO_PIECE, "fasta"),
    (["--engine", "banded", "--device-assist", "on"], [], "fasta"),
    (["--engine", "exact"], [], "gfa"),
], ids=["banded-assist-2p", "banded-assist-2p-gfa", "banded-2p",
        "exact-2p", "banded-assist-1p", "exact-1p-gfa"])
def test_align_output_byte_equal(fasta, short_fasta, tmp_path, engine, costs,
                                 out_type):
    """The port's ``poasta align`` writes what ``poasta_tpu``'s writes."""
    if "exact" in engine:
        fasta = short_fasta
    mine, ref = tmp_path / "port.out", tmp_path / "jax.out"
    argv = ["align", "-O", out_type, *engine, *costs]
    rc, err = _run(port_main, argv + ["--device", "cpu", "-o", str(mine),
                                      fasta])
    assert rc == 0, err
    assert _run(jax_main, argv + ["-o", str(ref), fasta])[0] in (0, None)
    assert mine.read_bytes() == ref.read_bytes()
    assert mine.stat().st_size > 0


def test_view_and_stats_match(fasta, tmp_path):
    """``view`` and ``stats`` on a graph the port's ``align`` wrote."""
    g = tmp_path / "g.poasta"
    assert _run(port_main, ["align", "-O", "poasta", "-o", str(g),
                            fasta])[0] == 0
    for fmt in ("gfa", "gfav1", "fasta", "dot"):
        mine, ref = tmp_path / f"p.{fmt}", tmp_path / f"j.{fmt}"
        assert _run(port_main, ["view", "-O", fmt, "-o", str(mine),
                                str(g)])[0] == 0
        assert _run(jax_main, ["view", "-O", fmt, "-o", str(ref),
                               str(g)])[0] in (0, None)
        assert mine.read_bytes() == ref.read_bytes(), fmt
    assert _run(port_main, ["stats", str(g)])[1] == \
        _run(jax_main, ["stats", str(g)])[1]


def test_assist_needs_the_named_device(fasta, tmp_path):
    """Without a card the default ``--device cuda`` exits 1 wherever the
    assist may run; the assist off or the exact engine need no device."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    out = str(tmp_path / "o.fa")
    for assist in ("auto", "on"):
        rc, err = _run(port_main, ["align", "--engine", "banded",
                                   "--device-assist", assist, "-o", out,
                                   fasta])
        assert rc == 1 and "no CUDA device" in err
    for argv in (["--engine", "banded", "--device-assist", "off"],
                 ["--engine", "exact"]):
        assert _run(port_main, ["align", *argv, "-o", out, fasta])[0] == 0


def test_banded_engine_stays_global(fasta):
    with pytest.raises(SystemExit, match="supports global alignment"):
        _run(port_main, ["align", "--engine", "banded", "-m", "semi-global",
                         "--device", "cpu", fasta])


def _graph_and_next(path):
    from poasta_tpu_torch.io import read_fasta

    recs = list(read_fasta(path))
    g = POAGraph()
    g.add_alignment_with_weights(recs[0][0], recs[0][1], None,
                                 [1] * len(recs[0][1]))
    return g, recs[1][1], recs[2][1]


def test_prefetcher_hands_over_exact_scores(fasta):
    """A taken score is the exact score of that sequence against the graph
    it was computed on; a result for another sequence is discarded; the
    counters say what happened."""
    costs = GapAffine2Piece(4, 2, 8, 1, 24)
    g, seq, other = _graph_and_next(fasta)
    want = NativeAligner(g).align_banded(seq, costs)[0]
    p = DeviceSeedPrefetcher(costs, device="cpu")
    try:
        assert p.prefetch(g, seq)
        got, deadline = None, time.monotonic() + 120
        while got is None and time.monotonic() < deadline:
            got = p.take(seq)
            time.sleep(0.01)
        assert got == want
        assert p.prefetch(g, seq)
        p._future.result(timeout=120)
        assert p.take(other) is None  # computed for another sequence
        assert p.stats == {"started": 2, "finished": 2, "taken": 1}
    finally:
        p.close()


def test_prefetcher_error_reaches_the_caller(fasta, monkeypatch):
    """An error in the background scoring is kept and re-raised by take()
    and close(), and through the CLI (C9: the reference swallowed it)."""
    def boom(*args, **kwargs):
        raise RuntimeError("device scoring failed")

    monkeypatch.setattr(tbd.BandedScorer, "scores", boom)
    costs = GapAffine2Piece(4, 2, 8, 1, 24)
    g, seq, _ = _graph_and_next(fasta)
    p = DeviceSeedPrefetcher(costs, device="cpu")
    p.prefetch(g, seq)
    with pytest.raises(RuntimeError, match="device scoring failed"):
        p.close()
    p = DeviceSeedPrefetcher(costs, device="cpu")
    p.prefetch(g, seq)
    deadline = time.monotonic() + 60
    with pytest.raises(RuntimeError, match="device scoring failed"):
        while time.monotonic() < deadline:
            p.take(seq)
            time.sleep(0.01)
    p.close()
    with pytest.raises(RuntimeError, match="device scoring failed"):
        _run(port_main, ["align", "--engine", "banded", "--device-assist",
                         "on", "--device", "cpu", *TWO_PIECE, fasta])
