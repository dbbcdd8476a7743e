"""The port's copies of the offline viz tools (``poasta_tpu_torch/tools``):
DP heatmaps and region extraction from debug dumps, the cases of
``tests/test_tools.py``.  The reference's cases build their dump from
``small_test.fa`` of the upstream test data, absent here; these build it
from sequences drawn in the test (seed 7) with the port's aligner and
debug writer, so they run.  The copies themselves are held byte-equal to
the originals by ``tests/test_torch_shared.py``.
"""

import random

import numpy as np
import pytest
import torch

from poasta_tpu_torch.aligner import GapAffine, Global, PoastaAligner
from poasta_tpu_torch.graphs import POAGraph
from poasta_tpu_torch.io import format_as_dot, graph_to_dot
from poasta_tpu_torch.utils.debug import DebugOutputWriter

torch.set_num_threads(1)

COSTS = GapAffine(4, 2, 6)


def _sequences(length=40, seed=7):
    """seq0 (random bases) and three copies of it: seq1 with substitutions
    at 10 and 25, seq2 with one at 18 and a deletion at 30, seq3 with an
    insertion at 20."""
    rng = random.Random(seed)
    base = [rng.choice("ACGT") for _ in range(length)]

    def sub(s, i):
        s = list(s)
        s[i] = "ACGT"[("ACGT".index(s[i]) + 1) % 4]
        return s

    seq1 = sub(sub(base, 10), 25)
    seq2 = sub(base, 18)
    del seq2[30]
    seq3 = base[:20] + ["T"] + base[20:]
    return [(f"seq{i}", "".join(s).encode())
            for i, s in enumerate((base, seq1, seq2, seq3))]


def _msa(sink=None):
    g = POAGraph()
    a = PoastaAligner(COSTS, Global(), heuristic="mingap", debug_sink=sink)
    for name, seq in _sequences():
        w = [1] * len(seq)
        if g.is_empty():
            g.add_alignment_with_weights(name, seq, None, w)
        else:
            if sink is not None:
                sink.new_sequence(name, seq, g)
            r = a.align(g, seq)
            g.add_alignment_with_weights(name, seq, r.alignment, w)
    return g


@pytest.fixture
def debug_dump(tmp_path):
    sink = DebugOutputWriter(str(tmp_path / "dbg"))
    g = _msa(sink)
    sink.close()
    with open(tmp_path / "annot.dot", "w") as fh:
        graph_to_dot(g, fh)
    return tmp_path


def test_plot_dp_writes_heatmaps(debug_dump):
    from poasta_tpu_torch.tools.plot_dp import main

    out = debug_dump / "viz"
    main([str(debug_dump / "dbg" / "graph_for_seq3.dot"),
          str(debug_dump / "dbg" / "astar_iterations" / "seq3.iter0.tsv"),
          "-o", str(out)])
    pngs = sorted(p.name for p in out.glob("*.png"))
    assert pngs == ["seq3.iter0.deletion.png", "seq3.iter0.insertion.png",
                    "seq3.iter0.match.png"]
    assert all((out / p).stat().st_size > 1000 for p in pngs)


def test_graphviz_region_extracts_subgraph(debug_dump, capsys):
    """Beside the reference's checks, the copy's output equals the
    original tool's on the same dump."""
    from poasta_tpu.tools.graphviz_region import main as ref_main
    from poasta_tpu_torch.tools.graphviz_region import main

    argv = [str(debug_dump / "annot.dot"), "seq1:2-35", "-H", "seq2:red"]
    main(argv)
    out = capsys.readouterr().out
    assert out.startswith("digraph {")
    assert "rank=same" in out
    assert 'color="red"' in out
    assert '[label="' in out
    ref_main(argv)
    assert capsys.readouterr().out == out


def test_graphviz_region_stop_inclusive(debug_dump, capsys):
    """Region coordinates are 1-based with an inclusive stop: a
    one-position region keeps that node."""
    from poasta_tpu_torch.tools.graphviz_region import (
        main,
        parse_annotated_dot,
        sequence_path,
    )

    dot = str(debug_dump / "annot.dot")
    sequences, nodes, edges, aligned = parse_annotated_dot(dot)
    name = next(iter(sequences))
    path = sequence_path(sequences, edges, name)
    main([dot, f"{name}:3-3"])
    out = capsys.readouterr().out
    assert f"{path[2]} [label=" in out


def test_plot_dp_two_piece_matrices(tmp_path):
    """Two-piece dumps name the first gap layers insertion1/deletion1; the
    copy renders those too."""
    from poasta_tpu_torch.tools.plot_dp import main

    dot = tmp_path / "g.dot"
    dot.write_text(
        "digraph {\n"
        '0 [label="\'#\' (0)"]\n'
        '1 [label="\'A\' (1)"]\n'
        '2 [label="\'$\' (2)"]\n'
        "0 -> 1\n"
        "1 -> 2\n"
        "}\n"
    )
    tsv = tmp_path / "x.iter0.tsv"
    tsv.write_text(
        "node_id\toffset\tmatrix\tscore\n"
        "1\t0\tmatch\t0\n"
        "1\t1\tinsertion1\t8\n"
        "1\t1\tdeletion1\t8\n"
        "1\t1\tinsertion2\t9\n"
    )
    out = tmp_path / "viz"
    main([str(dot), str(tsv), "-o", str(out)])
    names = sorted(p.name for p in out.glob("*.png"))
    assert names == ["x.iter0.deletion1.png", "x.iter0.insertion1.png",
                     "x.iter0.insertion2.png", "x.iter0.match.png"]


def test_graphviz_region_unknown_sequence(debug_dump):
    from poasta_tpu_torch.tools.graphviz_region import main

    with pytest.raises(SystemExit):
        main([str(debug_dump / "annot.dot"), "nope:1-5"])


def test_wavefront_dump_renders(tmp_path):
    """The port's dense tables (``dp_fill_full`` on the CPU), dumped with
    ``dump_wavefront_tsv``, render with the same tooling as the exact
    engine's dumps."""
    from poasta_tpu_torch.aligner.wavefront import (
        DeviceGraph,
        dp_fill_full,
        pack_queries,
    )
    from poasta_tpu_torch.tools.plot_dp import main as plot_main
    from poasta_tpu_torch.utils.debug import dump_wavefront_tsv

    g = _msa()
    flat = g.flatten()
    dg = DeviceGraph.build(flat, device="cpu")
    qshift, lengths = pack_queries([_sequences()[2][1][:30]], device="cpu")
    _, M, I, D = dp_fill_full(dg, qshift, lengths, COSTS)
    tsv = tmp_path / "wave.iter0.tsv"
    dump_wavefront_tsv(flat, np.asarray(M)[:, 0, :], np.asarray(I)[:, 0, :],
                       np.asarray(D)[:, 0, :], tsv)
    import io as _io

    dot = tmp_path / "g.dot"
    buf = _io.StringIO()
    format_as_dot(g, buf)
    dot.write_text(buf.getvalue())
    out = tmp_path / "viz"
    plot_main([str(dot), str(tsv), "-o", str(out)])
    assert len(list(out.glob("*.png"))) == 3
