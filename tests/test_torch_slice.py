"""The PyTorch port's scoring path end to end on the CPU, against the JAX
package's ``BandedScorer`` on its accelerator route and against the native
exact engine.

The JAX side runs under an accelerator simulation (Pallas interpret mode
plus a non-"cpu" backend name), so its ladder lays windows out as on a
chip, which is the layout the port always uses.  Scores, attempt counts
and learned ub hints must agree exactly (tolerance 0).
"""

import os
import random
import subprocess
import sys
from contextlib import contextmanager
from unittest import mock

import jax
import numpy as np
import pytest
import torch

from poasta_tpu.aligner import GapAffine
from poasta_tpu.aligner import banded as jbd
from poasta_tpu.aligner import wavefront as jwf
from poasta_tpu.graphs import POAGraph
from poasta_tpu.native import NativeAligner
from poasta_tpu.ops.pallas_fill import set_interpret_mode
from poasta_tpu_torch import BandedScorer, BatchMapper, pack_queries
from poasta_tpu_torch.ops import cuda_fill as tcf

torch.set_num_threads(1)

COSTS = GapAffine(4, 2, 6)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "poasta_tpu_torch")
LADDER_STATS = ("fills", "tiers", "fullfill_fallbacks")


@contextmanager
def accel_sim():
    set_interpret_mode(True)
    try:
        with mock.patch.object(jax, "default_backend",
                               lambda: "interpret-sim"):
            yield
    finally:
        set_interpret_mode(False)


def _mutate(rng, s, d):
    out = []
    for ch in s:
        r = rng.random()
        if r < d:
            continue
        out.append(rng.choice("ACGT") if r < 2.5 * d else ch)
        if rng.random() < d:
            out.append(rng.choice("ACGT"))
    return "".join(out) or "A"


def _graph(rng, glen, divs):
    base = "".join(rng.choice("ACGT") for _ in range(glen))
    g = POAGraph()
    g.add_alignment_with_weights("s0", base.encode(), None, [1] * glen)
    for i, d in enumerate(divs, start=1):
        s = _mutate(rng, base, d).encode()
        _, aln, _ = NativeAligner(g).align(s, COSTS)
        g.add_alignment_with_weights(f"s{i}", s, aln, [1] * len(s))
    return g, base


def _exact(g, reads):
    na = NativeAligner(g)
    return np.array([na.align(q, COSTS)[0] for q in reads])


def _run_both(g, reads, calls):
    """Run the JAX scorer (accelerator route) and the port's scorer through
    the same sequence of ``scores`` calls; return per-call results."""
    flat = g.flatten()
    jq, jl = jwf.pack_queries(reads)
    tq, tl = pack_queries(reads, device="cpu")
    port = BandedScorer(flat, COSTS, device="cpu")
    out = []
    with accel_sim():
        ref = jbd.BandedScorer(flat, COSTS)
        for kw in calls:
            j = np.asarray(ref.scores(jq, jl, **kw))
            p = port.scores(tq, tl, **kw)
            out.append((j, p, ref, port))
            assert port.last_attempts == ref.last_attempts, kw
            assert port._ub_hint == ref._ub_hint, kw
            for k in LADDER_STATS:
                assert port.stats[k] == ref.stats[k], (kw, k)
    return out


def test_uniform_batch_matches_jax_and_native():
    rng = random.Random(7)
    g, base = _graph(rng, 400, [0.03, 0.03, 0.03])
    reads = [_mutate(rng, base, 0.03).encode() for _ in range(64)]
    exact = _exact(g, reads)
    for j, p, _, _ in _run_both(g, reads, [{}, {}]):
        assert p.dtype == np.int32
        assert (p == j).all()
        assert (p == exact).all()
    # the library entry point: same scores, fresh mapper
    mapper = BatchMapper(g, COSTS, device="cpu")
    assert (mapper.score_batch(reads) == exact).all()
    assert mapper.scorer.stats["fullfill_fallbacks"] == 0


def test_mixed_divergence_batch_retries_and_tail_fill():
    """95% of reads at 2% divergence, 5% at 15%: a low first tier resolves
    part of the bulk, the second the rest, and the 15% tail takes the
    full-width fill; the next call starts at the learned tier."""
    rng = random.Random(11)
    g, base = _graph(rng, 800, [0.02])
    reads = [_mutate(rng, base, 0.15 if i % 20 == 0 else 0.02).encode()
             for i in range(64)]
    exact = _exact(g, reads)
    runs = _run_both(g, reads, [{"ub": 150, "max_retries": 2}, {}])
    for j, p, _, _ in runs:
        assert (p == j).all()
        assert (p == exact).all()
    port = runs[-1][3]
    assert port.stats["fullfill_fallbacks"] == 1
    assert port.stats["tiers"] == 4


def test_forced_full_fill_fallback():
    """No read verifies at ub 8: with one attempt the whole batch goes to
    the full-width fill."""
    rng = random.Random(5)
    g, base = _graph(rng, 300, [0.04, 0.04])
    reads = [_mutate(rng, base, 0.04).encode() for _ in range(64)]
    exact = _exact(g, reads)
    launches = tcf.fill_end_rows.launches
    runs = _run_both(g, reads, [{"ub": 8, "max_retries": 1}])
    j, p, _, port = runs[0]
    assert (p == j).all() and (p == exact).all()
    assert port.stats["fullfill_fallbacks"] == 1
    assert tcf.fill_end_rows.launches == launches  # CPU: plain version


def test_clamped_tier_fills_uncapped():
    """ROADMAP fault C1.  At ub 300 the band of this batch is as wide as
    the row, so the ladder takes the clamped full-width tier, which
    accepts every score without the <= ub check.  poasta_tpu still caps
    the insertion scan there (ins_run_cap(ub=300) = 256 lanes), so the
    read carrying a 300-base insertion comes back over-estimated and is
    accepted: it scores 612 where the exact optimum is 606.  The port
    fills that tier uncapped and must equal the exact engine; the
    reference's divergence is pinned here, not matched."""
    rng = random.Random(3)
    g, base = _graph(rng, 200, [0.02])
    reads = [_mutate(rng, base, 0.02).encode() for _ in range(63)]
    insert = "".join(rng.choice("ACGT") for _ in range(300))
    reads.append((base[:100] + insert + base[100:]).encode())
    exact = _exact(g, reads)
    j, p, ref, port = _run_both(g, reads, [{"ub": 300, "max_retries": 1}])[0]
    assert port._last_fill_exact and ref._last_fill_exact
    assert (p == exact).all()
    assert (j[:63] == p[:63]).all()
    assert (int(j[63]), int(exact[63])) == (612, 606)


def test_port_imports_no_jax():
    code = ("import sys, poasta_tpu_torch, poasta_tpu_torch.convert, "
            "poasta_tpu_torch.utils.device, poasta_tpu_torch.utils.build, "
            "poasta_tpu_torch.ops.trace, poasta_tpu_torch.cli.lasagna; "
            "assert 'jax' not in sys.modules, sorted(sys.modules)")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    for root, _, files in os.walk(PORT):
        for name in files:
            if name.endswith(".py"):
                with open(os.path.join(root, name)) as fh:
                    src = fh.read()
                assert "import jax" not in src, name
                assert "from jax" not in src, name


def test_fills_refuse_other_devices():
    """Only a CPU tensor takes the plain version; any other device must
    launch a kernel or raise."""
    g, base = _graph(random.Random(1), 60, [])
    scorer = BandedScorer(g.flatten(), COSTS, device="cpu")
    q, _ = pack_queries([base.encode()], device="cpu")
    q = q.to("meta")
    with pytest.raises(ValueError):
        tcf.fill_end_rows(scorer.dg, q, COSTS)
    with pytest.raises(ValueError):
        tcf.banded_end_rows(scorer.dg, q, COSTS, prep={})
