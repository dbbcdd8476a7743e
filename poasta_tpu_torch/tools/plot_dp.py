"""Plot aligner DP state as per-matrix heatmaps.

Our implementation of the capability of the reference's
``contrib/poasta_tools/poasta_plot.py`` (reference behavior at
``poasta_plot.py:118-258``): given the debug DOT graph and one or more
A*-iteration TSV dumps (``node_id\toffset\tmatrix\tscore``), render one
heatmap per matrix (match / insertion / deletion, plus the two-piece
layers when present), with rows ordered by graph topological rank,
y-tick labels showing node symbols, and horizontal rules at branch
points of the POA graph.

Usage:
    python -m poasta_tpu.tools.plot_dp GRAPH_DOT TSV [TSV ...] -o OUTDIR
"""

from __future__ import annotations

import argparse
import csv
import re
import sys
from pathlib import Path

NODE_LABEL = re.compile(r"'(.|#|\$)' \((\d+)\)")
EDGE = re.compile(r"^\s*(\d+)\s*->\s*(\d+)")
NODE = re.compile(r"^\s*(\d+)\s*\[\s*label\s*=")

# two-piece dumps name the first gap layer "deletion1"/"insertion1"
# (debug.py mirrors the reference TSV schema), so both spellings render
MATRICES = ("match", "deletion", "insertion", "deletion1", "insertion1",
            "deletion2", "insertion2")


def load_dot(path):
    """Parse node symbols + edges from a library-style DOT file.

    Returns (symbols: {node_ix: char}, succs: {node_ix: [node_ix]}).
    """
    symbols = {}
    succs = {}
    with open(path) as fh:
        for line in fh:
            if (m := EDGE.match(line)) is not None:
                u, v = int(m.group(1)), int(m.group(2))
                succs.setdefault(u, []).append(v)
                succs.setdefault(v, [])
            elif NODE.match(line) is not None:
                lm = NODE_LABEL.search(line)
                if lm is None:
                    print("Could not parse node label:", line.strip(),
                          file=sys.stderr)
                    continue
                ix = int(lm.group(2))
                symbols[ix] = lm.group(1)
                succs.setdefault(ix, [])
    return symbols, succs


def topo_ranks(symbols, succs):
    """DFS reverse-postorder ranks from the source node ('#' if present)."""
    indeg = {n: 0 for n in succs}
    for u, vs in succs.items():
        for v in vs:
            indeg[v] = indeg.get(v, 0) + 1
    roots = [n for n, d in indeg.items() if d == 0] or [min(succs)]
    post = []
    seen = set()
    for root in roots:
        stack = [(root, iter(succs.get(root, ())))]
        seen.add(root)
        while stack:
            node, it = stack[-1]
            adv = False
            for v in it:
                if v not in seen:
                    seen.add(v)
                    stack.append((v, iter(succs.get(v, ()))))
                    adv = True
                    break
            if not adv:
                post.append(node)
                stack.pop()
    order = list(reversed(post))
    return {n: r for r, n in enumerate(order)}


def branch_rules(succs, ranks):
    """Ranks where the matrix should show a horizontal rule: rows whose
    node starts a new branch (successor of an out-branching node) or
    merges one (in-degree > 1)."""
    indeg = {}
    for u, vs in succs.items():
        for v in vs:
            indeg[v] = indeg.get(v, 0) + 1
    rules = set()
    for u, vs in succs.items():
        if len(vs) > 1:
            for v in vs:
                rules.add(ranks[v])
        elif indeg.get(u, 0) > 1 and vs:
            rules.add(ranks[u])
    return sorted(rules)


def load_tsv(path):
    """TSV rows -> {matrix: {(node_id, offset): score}} + max offset."""
    per_matrix = {}
    max_off = 0
    with open(path) as fh:
        # dumps open with a `# seq_name: ...` comment line (debug.rs:103)
        lines = (ln for ln in fh if not ln.startswith("#"))
        rd = csv.DictReader(lines, delimiter="\t")
        for row in rd:
            score = row["score"]
            if score in ("", "none", "None"):
                continue
            m = per_matrix.setdefault(row["matrix"], {})
            key = (int(row["node_id"]), int(row["offset"]))
            val = int(score)
            if key not in m or val < m[key]:
                m[key] = val
            max_off = max(max_off, key[1])
    return per_matrix, max_off


def plot_file(dot_path, tsv_path, outdir, fig_width=None):
    import numpy as np
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    symbols, succs = load_dot(dot_path)
    ranks = topo_ranks(symbols, succs)
    rules = branch_rules(succs, ranks)
    per_matrix, max_off = load_tsv(tsv_path)

    n_rows = len(ranks)
    n_cols = max_off + 1
    present = [m for m in MATRICES if m in per_matrix]
    if not present:
        print(f"{tsv_path}: no matrix data", file=sys.stderr)
        return []

    ylabels = [""] * n_rows
    for node, r in ranks.items():
        ylabels[r] = f"{symbols.get(node, '?')} ({node})"

    width = fig_width or max(6, min(0.14 * n_cols + 2, 60))
    height = max(4, min(0.14 * n_rows + 2, 60))
    written = []
    for mat in present:
        grid = np.full((n_rows, n_cols), np.nan)
        for (node, off), score in per_matrix[mat].items():
            if node in ranks and 0 <= off < n_cols:
                grid[ranks[node], off] = score
        fig, ax = plt.subplots(figsize=(width, height))
        im = ax.imshow(grid, aspect="auto", interpolation="nearest",
                       cmap="viridis")
        fig.colorbar(im, ax=ax, label="score")
        for r in rules:
            ax.axhline(r - 0.5, color="white", linewidth=0.6)
        if n_rows <= 120:
            ax.set_yticks(range(n_rows))
            ax.set_yticklabels(ylabels, fontsize=5)
        ax.set_xlabel("query offset")
        ax.set_ylabel("graph node (topological rank)")
        ax.set_title(f"{Path(tsv_path).stem} — {mat}")
        out = Path(outdir) / f"{Path(tsv_path).stem}.{mat}.png"
        fig.savefig(out, dpi=120, bbox_inches="tight")
        plt.close(fig)
        written.append(out)
    return written


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Plot aligner DP computation state as heatmaps")
    parser.add_argument("graph", type=Path,
                        help="graph DOT file (debug dump)")
    parser.add_argument("astar_data_tsvs", type=Path, metavar="ASTAR_TSV",
                        nargs="+", help="A*-iteration TSV dump(s)")
    parser.add_argument("-o", "--output", type=Path, required=True,
                        help="output directory for the PNGs")
    parser.add_argument("-w", "--fig-width", default=None, type=int)
    args = parser.parse_args(argv)

    args.output.mkdir(parents=True, exist_ok=True)
    for tsv in args.astar_data_tsvs:
        for out in plot_file(args.graph, tsv, args.output, args.fig_width):
            print(out)


if __name__ == "__main__":
    main()
