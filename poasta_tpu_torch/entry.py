"""Entry points of the port: the one-device fill and a dry run over
a device mesh.  Counterpart of the JAX package's ``__graft_entry__.py``.

    from poasta_tpu_torch.entry import entry, dryrun_multichip
    fn, args = entry()            # host tensors; fn(*args) fills on the card
    dryrun_multichip(8)           # a 4 x 2 mesh, checked against one device
"""

from __future__ import annotations

import os
import random

import numpy as np
import torch


def _toy_graph_and_reads(n_reads=8, read_len=120):
    """Small POA graph + mutated reads, deterministic (seed 7)."""
    from .aligner import GapAffine, Global, PoastaAligner
    from .graphs import POAGraph

    rng = random.Random(7)
    base = "".join(rng.choice("ACGT") for _ in range(read_len))

    def mutate(s):
        out = []
        for ch in s:
            r = rng.random()
            if r < 0.04:
                continue
            out.append(rng.choice("ACGT") if r < 0.10 else ch)
            if rng.random() < 0.03:
                out.append(rng.choice("ACGT"))
        return "".join(out) or "A"

    graph = POAGraph()
    aligner = PoastaAligner(GapAffine(4, 2, 6), Global(), heuristic="mingap")
    graph.add_alignment_with_weights("s0", base.encode(), None,
                                     [1] * len(base))
    for i in range(1, 3):
        s = mutate(base).encode()
        res = aligner.align(graph, s)
        graph.add_alignment_with_weights(f"s{i}", s, res.alignment,
                                         [1] * len(s))
    reads = [mutate(base).encode() for _ in range(n_reads)]
    return graph, reads


def entry(*, device=None):
    """(fn, example_args): the batched gap-affine scoring step.

    ``fn(dg, qshift, lengths)`` is the full-width global fill
    (``dp_fill_scores``: the fill kernel B2 on the card).  The arguments
    are host tensors (``place_on_device=False``): building them makes no
    device call, and ``fn`` moves them to ``device`` (None: the card) at
    the call, so a missing card shows there, not here.
    """
    from .aligner import GapAffine
    from .aligner.wavefront import DeviceGraph, dp_fill_scores, pack_queries

    costs = GapAffine(4, 2, 6)
    graph, reads = _toy_graph_and_reads()
    dg = DeviceGraph.build(graph.flatten(), place_on_device=False,
                           device=device)
    qshift, lengths = pack_queries(reads, place_on_device=False)

    def fn(dg, qshift, lengths):
        return dp_fill_scores(dg, qshift, lengths, costs)

    return fn, (dg, qshift, lengths)


def _mesh_devices(n_devices: int):
    """n mesh entries: the visible cards, repeated where there are fewer
    than n, or n CPU entries without a card."""
    cards = torch.cuda.device_count()
    if cards == 0:
        print(f"dryrun_multichip: no card, {n_devices} CPU entries")
        return [torch.device("cpu")] * n_devices, "cpu"
    print(f"dryrun_multichip: {cards} card(s) visible, {n_devices} entries")
    return [torch.device("cuda", i % cards) for i in range(n_devices)], None


def dryrun_multichip(n_devices: int) -> None:
    """Run the sharded scoring step over an n-entry mesh and check it.

    Mesh axes: dp (reads) x sp (query offsets; 2 where n is even).  The
    sharded scores (``make_sharded_score_fn``: the sp demonstrator's halo,
    gathered prefix-min and min over slabs) must equal the one-device
    fill's; ``BandedScorer(mesh=)`` must give the same scores; and the
    ``lasagna`` CLI's meshed GAF must be byte-equal to ``--mesh off``.
    Any failure raises.
    """
    import tempfile

    from .aligner import GapAffine
    from .aligner.banded import BandedScorer
    from .aligner.wavefront import DeviceGraph, dp_fill_scores, pack_queries
    from .cli.lasagna import main as lasagna_main
    from .parallel import make_mesh, make_sharded_score_fn

    devices, cli_device = _mesh_devices(n_devices)
    sp = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    dp = n_devices // sp
    mesh = make_mesh(devices=devices, dp=dp, sp=sp)

    costs = GapAffine(4, 2, 6)
    graph, reads = _toy_graph_and_reads(n_reads=max(dp * 2, 4), read_len=60)
    dg = DeviceGraph.build(graph.flatten(), device=mesh.first)
    while len(reads) % dp:
        reads.append(reads[0])
    qshift, lengths = pack_queries(reads, pad_to=2 * 128 - 1,
                                   device=mesh.first)

    scores = make_sharded_score_fn(dg, costs, mesh)(qshift,
                                                    lengths).cpu().numpy()
    assert scores.shape == (len(reads),)
    assert (scores >= 0).all() and (scores < 1 << 28).all()
    ref = dp_fill_scores(dg, qshift, lengths, costs).cpu().numpy()
    assert (scores == ref).all(), (scores, ref)

    banded = BandedScorer(graph.flatten(), costs, mesh=mesh).scores(
        qshift, lengths)
    assert (banded == ref).all(), (banded, ref)

    # the serving path: the CLI with a meshed batch against one device
    rng = random.Random(5)
    paths = ["ACGTACGTGGCATTGAC" + mid + "GGATCGATCGTTAACC"
             for mid in ("TTACGGA", "TCACGTT")]
    with tempfile.TemporaryDirectory() as td:
        gfa = os.path.join(td, "g.gfa")
        with open(gfa, "w") as fh:
            fh.write(
                "H\tVN:Z:1.1\n"
                "S\ts1\tACGTACGTGGCATTGAC\nS\ts2\tTTACGGA\n"
                "S\ts3\tTCACGTT\nS\ts4\tGGATCGATCGTTAACC\n"
                "L\ts1\t+\ts2\t+\t0M\nL\ts1\t+\ts3\t+\t0M\n"
                "L\ts2\t+\ts4\t+\t0M\nL\ts3\t+\ts4\t+\t0M\n")
        reads_fa = os.path.join(td, "reads.fa")
        with open(reads_fa, "w") as fh:
            for i in range(2 * n_devices):
                s = list(rng.choice(paths))
                for _ in range(rng.randrange(3)):
                    s[rng.randrange(len(s))] = rng.choice("ACGT")
                fh.write(f">r{i}\n{''.join(s)}\n")
        single, meshed = (os.path.join(td, n) for n in ("s.gaf", "m.gaf"))
        dev_flag = ["--device", "cpu"] if cli_device == "cpu" else []
        # on the CPU the spec names the mesh; on cards, auto spans them all
        spec = f"{dp},{sp}" if cli_device == "cpu" else "auto"
        assert lasagna_main(["align", gfa, reads_fa, "--mesh", "off", "-o",
                             single, *dev_flag]) == 0
        assert lasagna_main(["align", gfa, reads_fa, "--mesh", spec, "-o",
                             meshed, *dev_flag]) == 0
        with open(meshed) as fh:
            got = fh.read()
        with open(single) as fh:
            assert got and got == fh.read(), "mesh GAF diverged"
    print(f"dryrun_multichip: dp={dp} sp={sp}: sharded, banded and CLI "
          f"outputs equal one device's ({len(reads)} reads, scores "
          f"{np.asarray(scores).tolist()[:4]}...)")
