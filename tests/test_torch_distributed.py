"""The port's multi-process serving path, ``lasagna align --distributed``:
the twin of ``tests/test_distributed.py``.

Every process joins a ``torch.distributed`` process group (gloo; no
collective runs inside a fill), aligns the round-robin slice of the read
stream its rank selects, and writes ``<output>.part<rank>``.  Covered:

* an in-process simulation (``torch.distributed``'s rank and world size
  patched) pinning the slicing, the part names, that the shared output
  path is never truncated, and that an explicit mesh spec is refused;
* a real two-process gloo rendezvous over localhost with ``--device cpu``
  driving the port's CLI end to end: the parts, merged in round-robin
  order, equal the single-process GAF and the reference CLI's;
* the recovery of a part lost to a failed process with
  ``--shard-index/--shard-count``, and the guard rails.

Every subprocess has its own timeout and binds a free port, so parallel
test workers do not collide.
"""

import os
import socket
import subprocess
import sys

import pytest
import torch

from poasta_tpu.cli.lasagna import main as jax_lasagna
from poasta_tpu_torch.cli.lasagna import main as port_lasagna

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 120


def _diamond_gfa_and_reads(tmp_path, n_reads=8, seed=11):
    """tests/test_distributed.py's diamond graph and reads."""
    import random

    gfa = tmp_path / "diamond.gfa"
    gfa.write_text(
        "H\tVN:Z:1.1\n"
        "S\ts1\tACGTACGTGGCATTGAC\n"
        "S\ts2\tTTACGGA\n"
        "S\ts3\tTCACGTT\n"
        "S\ts4\tGGATCGATCGTTAACC\n"
        "L\ts1\t+\ts2\t+\t0M\n"
        "L\ts1\t+\ts3\t+\t0M\n"
        "L\ts2\t+\ts4\t+\t0M\n"
        "L\ts3\t+\ts4\t+\t0M\n"
    )
    rng = random.Random(seed)
    paths = ["ACGTACGTGGCATTGAC" + mid + "GGATCGATCGTTAACC"
             for mid in ("TTACGGA", "TCACGTT")]
    reads = tmp_path / "reads.fa"
    with open(reads, "w") as fh:
        for i in range(n_reads):
            s = list(rng.choice(paths))
            for _ in range(rng.randrange(3)):
                p = rng.randrange(len(s))
                s[p] = rng.choice("ACGT")
            fh.write(f">r{i}\n{''.join(s)}\n")
    return gfa, reads


def _merge_round_robin(parts):
    """Reassemble the input order from per-process round-robin parts."""
    lines = [p.read_text().splitlines() for p in parts]
    out = []
    i = 0
    while any(lines):
        pid = i % len(lines)
        if lines[pid]:
            out.append(lines[pid].pop(0))
        i += 1
    return "\n".join(out) + "\n" if out else ""


def _single(tmp_path, gfa, reads):
    """The single-process GAF of the port (checked against the reference
    CLI's)."""
    out = tmp_path / "single.gaf"
    assert port_lasagna(["align", str(gfa), str(reads), "--mesh", "off",
                         "--device", "cpu", "-o", str(out)]) == 0
    ref = tmp_path / "ref.gaf"
    assert jax_lasagna(["align", str(gfa), str(reads), "--mesh", "off",
                        "-o", str(ref)]) in (0, None)
    assert out.read_text() == ref.read_text()
    return out.read_text()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_group(argvs):
    """Start one CLI process per argv, wait for all (each within
    TIMEOUT_S), and return [(returncode, stderr)]."""
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "poasta_tpu_torch.cli.lasagna", *argv],
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for argv in argvs]
    outs = []
    try:
        for p in procs:
            outs.append((p.communicate(timeout=TIMEOUT_S)[1], p.returncode))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [(rc, err) for err, rc in outs]


def _group_argv(gfa, reads, out, port, pid, n=2, mesh="auto"):
    return ["align", str(gfa), str(reads), "--mesh", mesh, "-o", str(out),
            "--device", "cpu", "--distributed", "--coordinator-address",
            f"127.0.0.1:{port}", "--num-processes", str(n), "--process-id",
            str(pid)]


def test_multi_process_slicing_and_parts(tmp_path, monkeypatch):
    """Simulated two-process run: each rank writes the .part<rank> of its
    round-robin slice, the merged parts equal the single-process GAF, and
    a file at the shared path is left alone.  The read count is odd, so
    the parts are unequal (5 and 4)."""
    import torch.distributed as dist

    gfa, reads = _diamond_gfa_and_reads(tmp_path, n_reads=9)
    single = _single(tmp_path, gfa, reads)
    out_multi = tmp_path / "multi.gaf"
    out_multi.write_text("sentinel\n")
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda: 2)
    for pid in range(2):
        monkeypatch.setattr(dist, "get_rank", lambda pid=pid: pid)
        assert port_lasagna(["align", str(gfa), str(reads), "--mesh", "off",
                             "--device", "cpu", "-o", str(out_multi)]) == 0
    assert out_multi.read_text() == "sentinel\n"
    parts = [tmp_path / "multi.gaf.part0", tmp_path / "multi.gaf.part1"]
    assert [len(p.read_text().splitlines()) for p in parts] == [5, 4]
    assert _merge_round_robin(parts) == single

    # an explicit mesh spec cannot be honoured per process: refused before
    # any file is opened
    for spec in ("2", "4,2"):
        out = tmp_path / f"spec{spec}.gaf"
        assert port_lasagna(["align", str(gfa), str(reads), "--mesh", spec,
                             "--device", "cpu", "-o", str(out)]) == 1
        assert not (tmp_path / f"spec{spec}.gaf.part1").exists()


def test_distributed_two_process_lasagna(tmp_path):
    """A real gloo rendezvous of two processes over localhost: the parts
    merged in round-robin order equal the single-process GAF and the
    reference CLI's."""
    gfa, reads = _diamond_gfa_and_reads(tmp_path)
    single = _single(tmp_path, gfa, reads)
    out = tmp_path / "dist.gaf"
    port = _free_port()
    res = _run_group([_group_argv(gfa, reads, out, port, pid)
                      for pid in range(2)])
    for rc, err in res:
        assert rc == 0, err[-2000:]
    parts = [tmp_path / "dist.gaf.part0", tmp_path / "dist.gaf.part1"]
    assert [len(p.read_text().splitlines()) for p in parts] == [4, 4]
    assert _merge_round_robin(parts) == single
    assert not out.exists()


def test_shard_failure_recovery(tmp_path):
    """Process 1 dies after the rendezvous (its reads file is missing);
    process 0 completes a valid part on its own (dp has no collective in a
    fill).  Re-running only the lost index with --shard-index/--shard-count
    (no process group) regenerates its part, and the merge equals the
    single-process GAF."""
    gfa, reads = _diamond_gfa_and_reads(tmp_path, n_reads=9)
    single = _single(tmp_path, gfa, reads)
    out = tmp_path / "dist.gaf"
    port = _free_port()
    read_paths = [reads, tmp_path / "missing_reads.fa"]
    res = _run_group([_group_argv(gfa, read_paths[pid], out, port, pid)
                      for pid in range(2)])
    assert res[0][0] == 0, res[0][1][-2000:]
    assert res[1][0] != 0  # the simulated failure
    part0, part1 = tmp_path / "dist.gaf.part0", tmp_path / "dist.gaf.part1"
    assert len(part0.read_text().splitlines()) == 5
    assert not part1.exists() or part1.read_text() == ""

    assert port_lasagna(["align", str(gfa), str(reads), "--mesh", "off",
                         "--device", "cpu", "-o", str(out),
                         "--shard-index", "1", "--shard-count", "2"]) == 0
    assert len(part1.read_text().splitlines()) == 4
    assert _merge_round_robin([part0, part1]) == single

    # guard rails: an out-of-range index, and mixing with --distributed
    # (refused before any rendezvous)
    assert port_lasagna(["align", str(gfa), str(reads), "--device", "cpu",
                         "--shard-index", "2", "--shard-count", "2",
                         "-o", str(out)]) == 1
    assert port_lasagna(["align", str(gfa), str(reads), "--device", "cpu",
                         "--shard-index", "0", "--shard-count", "2",
                         "--distributed", "-o", str(out)]) == 1


@pytest.mark.parametrize("spec", ["2", "1,2"])
def test_distributed_rejects_an_explicit_mesh_spec(spec, tmp_path):
    """Under a real process group an explicit spec exits 1 with the
    reference's message, and no part is written."""
    gfa, reads = _diamond_gfa_and_reads(tmp_path, n_reads=4)
    out = tmp_path / "dist.gaf"
    port = _free_port()
    res = _run_group([_group_argv(gfa, reads, out, port, pid, mesh=spec)
                      for pid in range(2)])
    for rc, err in res:
        assert rc == 1
        assert "cannot be honored per-host under --distributed" in err
    assert not list(tmp_path.glob("dist.gaf*"))
