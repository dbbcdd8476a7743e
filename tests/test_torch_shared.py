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
from poasta_tpu_torch.aligner.fusion_assist import DeviceSeedPrefetcher
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
    "utils/errors.py", "utils/debug.py", "native/engine.cpp",
    "tools/__init__.py", "tools/graphviz_region.py", "tools/plot_dp.py",
]
COSTS = GapAffine(4, 2, 6)


@pytest.mark.parametrize("rel", COPIED)
def test_copy_is_byte_equal(rel):
    with open(os.path.join(REPO, "poasta_tpu", rel), "rb") as fh:
        original = fh.read()
    with open(os.path.join(REPO, "poasta_tpu_torch", rel), "rb") as fh:
        assert fh.read() == original, rel


def test_seeds_copy_differs_in_one_docstring_line():
    """``aligner/seeds.py`` (numpy, no JAX) is the original but for the
    line of its docstring that points at the upstream A* source."""
    def lines(pkg):
        with open(os.path.join(REPO, pkg, "aligner", "seeds.py"), "rb") as fh:
            return fh.read().split(b"\n")

    original, copy = lines("poasta_tpu"), lines("poasta_tpu_torch")
    assert len(original) == len(copy)
    differ = [(a, b) for a, b in zip(original, copy) if a != b]
    assert len(differ) == 1
    assert all(b"src/aligner/astar.rs" in line for line in differ[0])
    assert original.index(differ[0][0]) < 20  # inside the module docstring


def test_port_imports_nothing_of_the_jax_package():
    """Importing the port and its CLI loads neither jax nor poasta_tpu, and
    no source line of the port or of its ``chip_*.py`` scripts imports
    them."""
    code = ("import sys, poasta_tpu_torch, poasta_tpu_torch.cli.lasagna, "
            "poasta_tpu_torch.cli.poasta, poasta_tpu_torch.convert, "
            "poasta_tpu_torch.ops.trace, poasta_tpu_torch.ops.seed, "
            "poasta_tpu_torch.ops.dp_rows_2p, poasta_tpu_torch.utils.debug, "
            "poasta_tpu_torch.aligner.seeds, "
            "poasta_tpu_torch.aligner.fusion_assist, "
            "poasta_tpu_torch.utils.build, poasta_tpu_torch.utils.mesh, "
            "poasta_tpu_torch.entry, poasta_tpu_torch.tools.graphviz_region, "
            "poasta_tpu_torch.tools.plot_dp, poasta_tpu_torch.bench; "
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


def test_gpu_runner_and_port_sweep_import_nothing_of_the_jax_package():
    """``run_gpu_tests.py`` and ``tests/test_torch_consistency.py`` run on
    the card's machine, which has no JAX: importing them loads neither jax
    nor poasta_tpu, and no source line of theirs imports either."""
    code = ("import sys; sys.path[:0] = ['.', 'tests']; "
            "import run_gpu_tests, test_torch_consistency; "
            "bad = [m for m in sys.modules if m == 'jax' or m == 'poasta_tpu'"
            " or m.startswith(('jax.', 'poasta_tpu.'))]; assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    for name in ("run_gpu_tests.py", "tests/test_torch_consistency.py",
                 "tests/test_torch_cuda.py"):
        with open(os.path.join(REPO, name)) as fh:
            for line in fh:
                words = line.split()
                if words[:1] in (["import"], ["from"]):
                    assert not words[1].startswith(("jax", "poasta_tpu.")) \
                        and words[1] != "poasta_tpu", (name, line)


def test_gpu_runner_without_a_card_exits_1_with_a_message():
    """No card visible: the runner says so and exits 1, with no traceback
    and no test run on the CPU."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run([sys.executable, "run_gpu_tests.py"], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 1
    assert res.stdout.startswith("ERROR: no card:"), res.stdout
    assert "Traceback" not in res.stderr, res.stderr
    assert "card tests" not in res.stdout


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
    lambda g: DeviceSeedPrefetcher(COSTS),
], ids=["BatchMapper", "BandedScorer", "DeviceGraph.build", "pack_queries",
        "ends_free_params_from_reference", "build_trace_schedule",
        "resolve_device", "DeviceSeedPrefetcher"])
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


def test_parallel_package_exports_batch_mapper():
    """``from poasta_tpu_torch.parallel import BatchMapper``, the import
    every caller of the reference's mapper writes, gives the port's, and
    the package exports what the reference's does (the mesh helpers
    too)."""
    from poasta_tpu import parallel as jax_parallel
    from poasta_tpu.parallel import BatchMapper as JaxMapper
    from poasta_tpu_torch import parallel

    assert parallel.BatchMapper is BatchMapper
    assert parallel.__all__ == jax_parallel.__all__ == [
        "BatchMapper", "make_mesh", "make_sharded_score_fn",
        "parse_mesh_spec"]
    for name in parallel.__all__:
        assert getattr(parallel, name).__module__.startswith(
            "poasta_tpu_torch.")
    assert JaxMapper is not BatchMapper


@pytest.mark.parametrize("cli", ["poasta", "lasagna"])
def test_port_clis_have_main_entry(cli, monkeypatch, capsys):
    """Each port CLI has the console-script entry point the reference's
    has: ``main()``'s return code becomes the exit status."""
    import importlib

    mod = importlib.import_module(f"poasta_tpu_torch.cli.{cli}")
    monkeypatch.setattr(sys, "argv", [f"{cli}-torch"])
    with pytest.raises(SystemExit) as exc:
        mod.main_entry()
    assert exc.value.code == 1
    assert "No subcommand given." in capsys.readouterr().err


def test_pyproject_names_the_port_scripts():
    """``pyproject.toml`` installs the port's CLIs under their own names
    beside the reference's, and names PyTorch as an optional extra."""
    import tomllib

    with open(os.path.join(REPO, "pyproject.toml"), "rb") as fh:
        project = tomllib.load(fh)["project"]
    assert project["scripts"] == {
        "poasta": "poasta_tpu.cli.poasta:main_entry",
        "lasagna": "poasta_tpu.cli.lasagna:main_entry",
        "poasta-torch": "poasta_tpu_torch.cli.poasta:main_entry",
        "lasagna-torch": "poasta_tpu_torch.cli.lasagna:main_entry",
    }
    assert project["optional-dependencies"]["torch"] == ["torch"]
    assert project["dependencies"] == ["jax", "numpy"]


# The reference's public callables in the modules the port mirrors, the
# mesh helpers included.
SIGNATURE_MODULES = ("aligner.wavefront", "aligner.banded", "parallel.mapper")


def _public_callables():
    import importlib

    out = []
    for mod in SIGNATURE_MODULES:
        ref = importlib.import_module(f"poasta_tpu.{mod}")
        for name, obj in vars(ref).items():
            if name.startswith("_") or not callable(obj) \
                    or getattr(obj, "__module__", None) != ref.__name__:
                continue
            out.append((mod, name))
            if name == "DeviceGraph":
                out.append((mod, "DeviceGraph.build"))
    return out


def _resolve(mod, dotted):
    import importlib
    import inspect

    obj = importlib.import_module(mod)
    for part in dotted.split("."):
        obj = getattr(obj, part)
    return list(inspect.signature(obj).parameters.values())


def test_signature_walk_covers_the_library_api():
    """The walk below reaches every entry point the library API names."""
    names = {name for _, name in _public_callables()}
    assert {"pack_queries", "DeviceGraph.build", "BandedScorer",
            "BatchMapper", "dp_fill_scores", "dp_fill_scores_ends_free",
            "dp_fill_ends_free_with_ends",
            "ends_free_device_params", "make_mesh", "parse_mesh_spec",
            "make_sharded_score_fn"} <= names


@pytest.mark.parametrize("mod,name", _public_callables())
def test_port_takes_the_reference_keywords_in_place(mod, name):
    """Each parameter of the reference's public signature is the port's
    parameter at the same position, of the same kind and default; what
    the port adds (``device``) is keyword-only."""
    import inspect

    ref = _resolve(f"poasta_tpu.{mod}", name)
    port = _resolve(f"poasta_tpu_torch.{mod}", name)
    assert [p.name for p in port[:len(ref)]] == [p.name for p in ref]
    for r, p in zip(ref, port):
        assert p.kind == r.kind, r.name
        assert p.default == r.default, r.name
    assert all(p.kind == inspect.Parameter.KEYWORD_ONLY
               for p in port[len(ref):]), [p.name for p in port[len(ref):]]


def test_pack_queries_pad_to_matches_the_reference():
    from poasta_tpu.aligner.wavefront import pack_queries as jax_pack

    reads = [b"ACGT" * 10, b"TTGCA"]
    want_q, want_l = jax_pack(reads, pad_to=4096, place_on_device=False)
    got_q, got_l = pack_queries(reads, pad_to=4096, device="cpu")
    assert tuple(got_q.shape) == want_q.shape == (2, 4224)
    assert np.array_equal(got_q.numpy(), want_q)
    assert np.array_equal(got_l.numpy(), want_l)
    # a pad_to under the longest read changes nothing
    assert tuple(pack_queries(reads, 8, device="cpu")[0].shape) == (2, 128)


def test_node_bucket_matches_the_reference():
    """``node_bucket=128`` pads the rank rows as the reference does, and
    the banded scorer's scores stay the reference's."""
    from poasta_tpu.aligner.banded import BandedScorer as JaxScorer
    from poasta_tpu.aligner.wavefront import DeviceGraph as JaxDeviceGraph
    from poasta_tpu.aligner.wavefront import pack_queries as jax_pack

    rng = np.random.default_rng(5)
    base = bytes(rng.choice(list(b"ACGT"), 150).tolist())  # 152 ranks
    reads = [base, base[:70] + base[100:], base[10:] + b"ACGT"]
    flats = []
    for cls in (POAGraph, JaxPOAGraph):
        g = cls()
        g.add_alignment_with_weights("s0", base, None, [1] * len(base))
        flats.append(g.flatten())
    flat, jflat = flats
    dg = DeviceGraph.build(flat, node_bucket=128, device="cpu")
    assert dg.n_nodes_padded == \
        JaxDeviceGraph.build(jflat, node_bucket=128).n_nodes_padded == 256
    assert DeviceGraph.build(flat, device="cpu").n_nodes_padded == 192
    q, ln = pack_queries(reads, device="cpu")
    got = BandedScorer(flat, COSTS, 128, device="cpu")
    assert got.dg.n_nodes_padded == 256
    want = JaxScorer(jflat, COSTS, node_bucket=128).scores(*jax_pack(reads))
    assert np.asarray(got.scores(q, ln)).tolist() == \
        np.asarray(want).tolist()


def test_keywords_the_port_cannot_serve_raise_by_name():
    """``engine`` other than auto/pallas, and a mesh object that is not a
    port mesh, raise a PoastaError that names the value; host placement
    (``place_on_device=False``) keeps host tensors whatever the device,
    and the fills move them to the device asked for."""
    from poasta_tpu_torch.aligner import wavefront as wf
    from poasta_tpu_torch.parallel import make_mesh
    from poasta_tpu_torch.utils.errors import PoastaError

    g = _small_graph()
    flat = g.flatten()
    dg = DeviceGraph.build(flat, device="cpu")
    q, ln = pack_queries([b"ACGTACGTTGCA"], device="cpu")
    assert wf.dp_fill_scores(dg, q, ln, COSTS, engine="pallas").tolist() == \
        [0]
    with pytest.raises(PoastaError, match="engine='xla'"):
        wf.dp_fill_scores(dg, q, ln, COSTS, engine="xla")
    from poasta_tpu_torch import UNBOUNDED, EndsFree

    span = EndsFree(UNBOUNDED, UNBOUNDED, UNBOUNDED, UNBOUNDED)
    mesh = make_mesh(["cpu"] * 2, dp=2)
    for fill in (wf.dp_fill_scores_ends_free, wf.dp_fill_ends_free_with_ends):
        with pytest.raises(PoastaError, match="engine='xla'"):
            fill(dg, flat, q, ln, COSTS, span, engine="xla")
        with pytest.raises(PoastaError, match="not a poasta_tpu_torch mesh"):
            fill(dg, flat, q, ln, COSTS, span, "auto", object())
        one = fill(dg, flat, q, ln, COSTS, span)
        two = fill(dg, flat, q, ln, COSTS, span, "auto", mesh)
        assert [t.tolist() for t in (one if isinstance(one, tuple)
                                     else (one,))] == \
            [t.tolist() for t in (two if isinstance(two, tuple) else (two,))]
    for make in (lambda m: BatchMapper(g, COSTS, m, device="cpu"),
                 lambda m: BandedScorer(flat, COSTS, 64, m, device="cpu")):
        with pytest.raises(PoastaError,
                           match="mesh=<object.*not a poasta_tpu_torch mesh"):
            make(object())
        assert make(mesh).mesh is mesh
    # host arrays, whatever the device named: the fill runs where the
    # graph was built for (the CPU here; the card by default)
    for dev in (None, "cuda", "cpu"):
        host = DeviceGraph.build(flat, 64, False, device=dev)
        assert host.on_host and host.device.type == "cpu"
        hq, hl = pack_queries([b"ACGT"], None, False, device=dev)
        assert hq.device.type == hl.device.type == "cpu"
    assert wf.dp_fill_scores(host, hq, hl, COSTS).tolist() == \
        wf.dp_fill_scores(dg, hq, hl, COSTS).tolist()
    fs, end_ok, jlo = wf.ends_free_device_params(flat, span, ln, 64,
                                                 with_jlo=False)
    assert jlo is None and fs and int(end_ok.sum()) == flat.n_nodes
