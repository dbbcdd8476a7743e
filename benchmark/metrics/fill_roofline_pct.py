"""The least time the card could take for the cells the fills were handed
(``BandedScorer.stats["cells_filled"]``, ``yardstick.fill_bound_s``) over
the profiler's device time of the fill kernels (``banded_*``,
``full_fill_*``), %.  The work the ladder chose, well or not."""

import re

from benchmark.yardstick import fill_bound_s

FILL = re.compile(r"\b(banded|full_fill)_\w*kernel")


def read(run):
    cells = run.counters.get("cells_filled")
    busy = sum(e - s for name, s, e in run.device if FILL.search(name))
    if not cells or busy <= 0:
        return None
    g = run.ctx.ref_graph
    extra = sum(max(len(p) - 1, 0) for p in g.seg_preds)
    return 100.0 * fill_bound_s(cells, extra, g.n_nodes) / busy
