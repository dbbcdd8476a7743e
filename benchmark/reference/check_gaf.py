"""The check of a mapping cell, on the GAF file the window wrote.

* ``records_missing``: reads handed in whose record is not in the file.
* ``gaf_faults``: records that are not a valid alignment of their read
  along a path of the graph, with the cost they state: the path's
  segments linked in the GFA, the CIGAR (``cg:Z``) walked from the path
  start and from the read offset where it has to begin, with each ``=`` a
  match and each ``X`` a mismatch, ending at the stated path and query
  ends, the counts of matches and columns as stated, and ``AS:i`` equal
  to the walk's gap-affine cost with the end gaps outside the CIGAR; and
  records out of order, repeated or of no read handed in.
* ``score_mismatches``: ``AS:i`` against the reference's optimal score,
  on a sample drawn from the seed with the highest ``AS:i`` of the window
  added.

Exact: each limit is 0.
"""

from __future__ import annotations

import re
import sys

import numpy as np

from ..graphgen import STREAM_SAMPLE, rng_for
from .dp import best_scores

_CIGAR = re.compile(r"(?:\d+[=XDI])+")
_DIGITS, _LETTERS = re.compile(r"\d+"), re.compile(r"[=XDI]")
_KIND = np.zeros(256, dtype=np.int64)
_KIND[np.frombuffer(b"=XDI", dtype=np.uint8)] = np.arange(4)
# faulty records printed to standard error, and how much of each
REPORTED, REPORT_CHARS = 3, 2000


def record_fault(fields, read: bytes, graph, seg_ix, costs):
    """None where one GAF record is a valid alignment of ``read`` with the
    cost its ``AS:i`` states, else what is wrong with it."""
    try:
        (_, qlen, qs, qe, strand, path, plen, ps, pe, nm, blk,
         _) = fields[:12]
        tags = {t.split(":", 2)[0]: t.split(":", 2)[2] for t in fields[12:]}
        qlen, qs, qe, plen, ps, pe, nm, blk = map(
            int, (qlen, qs, qe, plen, ps, pe, nm, blk))
        score, cigar = int(tags["AS"]), tags["cg"]
    except (ValueError, KeyError):
        return "unparsable fields"
    if not _CIGAR.fullmatch(cigar):
        return "CIGAR syntax"
    segs = path.split(">")
    if strand != "+" or qlen != len(read) or segs[0] != "" or len(segs) < 2:
        return "strand, query length or path syntax"
    segs = segs[1:]
    if any(s not in seg_ix for s in segs) or any(
            (a, b) not in graph.links for a, b in zip(segs, segs[1:])):
        return "unknown segment or unlinked step"
    seq = "".join(graph.seg_seqs[seg_ix[s]] for s in segs).encode()
    if len(seq) != plen:
        return "path length"
    letters = np.frombuffer(_DIGITS.sub("", cigar).encode(), dtype=np.uint8)
    kinds = _KIND[letters]  # 0 = 1 X 2 D 3 I
    lens = np.asarray(_LETTERS.split(cigar)[:-1], dtype=np.int64)
    if kinds[0] > 1 or kinds[-1] > 1:
        return "CIGAR starts or ends with a gap"
    # upstream's GAF (gaf.rs) counts the leading graph-only columns in the
    # query start and writes no column before the first aligned pair, so
    # the read's leading insertions show only as the query bases the CIGAR
    # does not reach: it starts at qe + 1 less the bases it consumes
    col = np.repeat(kinds, lens)  # a column each
    on_g, on_q = col <= 2, col != 2
    q0 = qe + 1 - int(on_q.sum())
    g_end, q_end = ps + int(on_g.sum()), q0 + int(on_q.sum())
    if q0 < 0 or g_end > len(seq) or q_end > len(read):
        return "CIGAR runs past the path or read"
    aligned = col <= 1
    gpos = (ps + np.cumsum(on_g) - on_g)[aligned]
    qpos = (q0 + np.cumsum(on_q) - on_q)[aligned]
    same = np.frombuffer(seq, dtype=np.uint8)[gpos] \
        == np.frombuffer(read, dtype=np.uint8)[qpos]
    if not np.array_equal(same, col[aligned] == 0):
        return "an = or X column that does not hold"
    gaps = lens[kinds >= 2]
    # the leading graph-only run (the query start), the leading and the
    # trailing read-only runs: end gaps outside the CIGAR
    ends = [k for k in (qs, q0, qlen - 1 - qe) if k > 0]
    cost = (costs["mismatch"] * int((col == 1).sum())
            + costs["gap_open"] * (gaps.shape[0] + len(ends))
            + costs["gap_extend"] * (int(gaps.sum()) + sum(ends)))
    last = len(graph.seg_seqs[seg_ix[segs[-1]]])
    if not (g_end - 1 == pe and plen - last <= pe < plen):
        return f"path end {g_end - 1} vs {pe}"
    if int((col == 0).sum()) != nm or col.shape[0] != blk:
        return "counts of matches or columns"
    if cost != score:
        return f"cost {cost} of the CIGAR vs AS:i {score}"
    return None


def check(outputs, ctx):
    costs = ctx.config["costs"]
    graph = ctx.ref_graph
    seg_ix = graph.seg_index()
    reads = {name: ctx.batches[k][i] for name, k, i in outputs["reads"]}
    expected = [name for name, _, _ in outputs["reads"]]
    with open(outputs["path"]) as fh:
        records = [line.rstrip("\n").split("\t") for line in fh]
    names = [f[0] for f in records]
    seen = set(names)
    missing = sum(name not in seen for name in expected)
    faults = len(names) - len(seen & set(expected))
    if names != [n for n in expected if n in seen]:
        faults += 1
    scores, ok, bad = [], [], []
    for f in records:
        why = "no read of that name" if f[0] not in reads else record_fault(
            f, reads[f[0]], graph, seg_ix, costs)
        if why is None:
            scores.append(int(f[12 + [t[:2] for t in f[12:]].index("AS")]
                              .split(":")[2]))
            ok.append(f[0])
        else:
            faults += 1
            if len(bad) < REPORTED and f[0] in reads:
                bad.append((f[0], why, "\t".join(f)))
    mismatches = 0
    if ok:
        rng = rng_for(ctx.seed, STREAM_SAMPLE)
        size = min(int(ctx.cell["check_sample"]), len(ok))
        pick = set(rng.choice(len(ok), size=size, replace=False).tolist())
        pick.add(int(np.argmax(scores)))
        pick = sorted(pick)
        names = [ok[i] for i in pick] + [name for name, _, _ in bad]
        want = best_scores(graph, [reads[n] for n in names], costs,
                           ctx.config["span"] != "global", device=ctx.device)
        mismatches = int((np.asarray([scores[i] for i in pick])
                          != want[:len(pick)]).sum())
        for (name, why, line), best in zip(bad, want[len(pick):]):
            print(f"gaf fault: {why}; the reference's score {best}: "
                  f"{line[:REPORT_CHARS]}", file=sys.stderr)
    return [("score_mismatches", mismatches, 0), ("gaf_faults", faults, 0),
            ("records_missing", missing, 0)]
