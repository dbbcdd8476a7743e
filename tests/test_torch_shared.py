"""What the port keeps of the JAX package's jax-free modules, and how it
picks its device.

The port imports nothing of ``poasta_tpu``: it carries its own copies of
the graph, cost-model, exact-engine and I/O modules and of the native
engine's source.  Each copy must stay byte-equal to its original (the
native binding is the one adapted file: it builds into ``build/`` and
raises when it cannot).  Entry points run on the card unless the caller
names the CPU, so on a host without a card they raise.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from poasta_tpu.graphs import POAGraph as JaxPOAGraph
from poasta_tpu.native import NativeAligner as JaxNative
from poasta_tpu_torch import (
    BandedScorer,
    BatchMapper,
    DeviceGraph,
    GapAffine,
    NativeAligner,
    POAGraph,
    convert,
    pack_queries,
)
from poasta_tpu_torch import native as port_native
from poasta_tpu_torch.ops import trace as tr
from poasta_tpu_torch.utils.device import NoDeviceError, resolve_device

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COPIED = [
    "aligner/__init__.py", "aligner/alignment.py", "aligner/costs.py",
    "aligner/engine.py", "aligner/heuristic.py", "aligner/path_index.py",
    "graphs/__init__.py", "graphs/flat.py", "graphs/poa.py",
    "graphs/tools.py",
    "io/__init__.py", "io/bincode.py", "io/fasta.py", "io/gaf.py",
    "io/gfa.py", "io/graph_io.py",
    "bubbles/__init__.py", "bubbles/finder.py", "bubbles/index.py",
    "utils/errors.py", "native/engine.cpp",
]
COSTS = GapAffine(4, 2, 6)


@pytest.mark.parametrize("rel", COPIED)
def test_copy_is_byte_equal(rel):
    with open(os.path.join(REPO, "poasta_tpu", rel), "rb") as fh:
        original = fh.read()
    with open(os.path.join(REPO, "poasta_tpu_torch", rel), "rb") as fh:
        assert fh.read() == original, rel


def test_port_imports_nothing_of_the_jax_package():
    """Importing the port and its CLI loads neither jax nor poasta_tpu, and
    no source line of the port or of its ``chip_*.py`` scripts imports
    them."""
    code = ("import sys, poasta_tpu_torch, poasta_tpu_torch.cli.lasagna, "
            "poasta_tpu_torch.convert, poasta_tpu_torch.ops.trace, "
            "poasta_tpu_torch.utils.build; "
            "bad = [m for m in sys.modules if m == 'jax' or m == 'poasta_tpu'"
            " or m.startswith(('jax.', 'poasta_tpu.'))]; assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    sources = [os.path.join(REPO, name) for name in (
        "chip_smoke.py", "chip_profile.py", "chip_kernel_times.py")]
    for root, _, files in os.walk(os.path.join(REPO, "poasta_tpu_torch")):
        sources += [os.path.join(root, f) for f in files if f.endswith(".py")]
    for path in sources:
        with open(path) as fh:
            for line in fh:
                words = line.split()
                if words[:1] in (["import"], ["from"]):
                    assert not words[1].startswith(("jax", "poasta_tpu.")) \
                        and words[1] != "poasta_tpu", (path, line)


def _small_graph(cls=POAGraph):
    g = cls()
    g.add_alignment_with_weights("s0", b"ACGTACGTTGCA", None, [1] * 12)
    return g


@pytest.mark.parametrize("entry", [
    lambda g: BatchMapper(g, COSTS),
    lambda g: BandedScorer(g.flatten(), COSTS),
    lambda g: DeviceGraph.build(g.flatten()),
    lambda g: pack_queries([b"ACGT"]),
    lambda g: convert.ends_free_params_from_reference(True, [1], [0]),
    lambda g: tr.build_trace_schedule(g.flatten(), np.array([4]),
                                      np.array([2]), 256, 64),
    lambda g: resolve_device(),
], ids=["BatchMapper", "BandedScorer", "DeviceGraph.build", "pack_queries",
        "ends_free_params_from_reference", "build_trace_schedule",
        "resolve_device"])
def test_no_device_named_means_the_card(entry):
    """With no card here the default raises; it never becomes the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(NoDeviceError, match="no CUDA device"):
        entry(_small_graph())


def test_naming_the_cpu_runs_there():
    g = _small_graph()
    mapper = BatchMapper(g, COSTS, device="cpu")
    assert mapper.dg.device.type == "cpu"
    assert resolve_device("cpu") == torch.device("cpu")
    assert mapper.score_batch([b"ACGTACGTTGCA", b"ACGTTGCA"]).tolist() == \
        [0, 14]


def test_native_engine_builds_into_build_dir():
    """The port's native engine is compiled from its own ``engine.cpp``
    into the git-ignored build tree, and scores like the original."""
    path = port_native._lib_path()
    assert path.startswith(os.path.join(REPO, "build", "poasta_tpu_torch",
                                        "native-"))
    g = _small_graph()
    score, aln, _ = NativeAligner(g).align(b"ACGTTTGCA", COSTS)
    assert os.path.exists(path)
    ref_score, ref_aln, _ = JaxNative(_small_graph(JaxPOAGraph)).align(
        b"ACGTTTGCA", COSTS)
    assert score == ref_score
    assert [(p.rpos, p.qpos) for p in aln] == \
        [(p.rpos, p.qpos) for p in ref_aln]
    assert not [f for f in os.listdir(os.path.dirname(port_native.__file__))
                if f.endswith(".so")]


def test_native_engine_raises_when_it_cannot_build(tmp_path, monkeypatch):
    """No compiler, no engine: the binding raises and keeps nothing
    behind."""
    monkeypatch.setattr(port_native, "_lib", None)
    monkeypatch.setattr(port_native, "_BUILD_ROOT", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        NativeAligner(_small_graph())
    assert port_native._lib is None
