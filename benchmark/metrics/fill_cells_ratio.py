"""Cells the fills were handed (``BandedScorer.stats["cells_filled"]``)
over the effective cells of the window's calls: ranks x padded read length
x reads of each call's batch."""

from benchmark.yardstick import padded_len


def read(run):
    calls = run.counters.get("batch_of_call")
    if not calls:
        return None
    n = run.ctx.ref_graph.n_nodes
    batches = run.ctx.batches
    effective = sum(n * padded_len(max(map(len, batches[k]))) * len(batches[k])
                    for k in calls)
    return run.counters["cells_filled"] / effective
