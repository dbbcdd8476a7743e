"""Run the card-only validation suite of the PyTorch/CUDA port on one
NVIDIA card: the counterpart of ``run_tpu_tests.py``.

    python run_gpu_tests.py [--soak N]

The tier-1 suite runs on the CPU, where every ``cuda``-marked test skips;
this runner probes the card, runs those tests there, then runs the sections
of ``run_tpu_tests.py`` that the port serves, each named by the reference
line it mirrors and printing ``OK`` or raising.  Two of those sections, the
consistency sweep (``:66-77``) and the traceback kernels (``:422-452``),
are the card tests' own (``test_torch_consistency.py``'s ``cuda`` twins,
``test_torch_cuda.py``'s trace tests), so the pytest step holds them.  ``--soak N`` runs the
cross-engine sweep (``tests/test_torch_consistency.py``) with N more seeds
on the card.  The first failure ends the run with a non-zero exit code;
nothing is caught to carry on.  It ends with ``all GPU validations
passed``.

Left out, and said so when it runs: chain-skip (``:200-205``; an opt-in
branch of the TPU kernels that the port does not carry).

Imports the port, numpy, torch and pytest only: the card's machine has no
JAX.
"""

import os
import random
import subprocess
import sys

REPO = os.path.dirname(os.path.abspath(__file__))
CARD_TESTS = ["tests/test_torch_cuda.py", "tests/test_torch_consistency.py"]


def _mutate(rng, s, d, mismatch=2.0):
    out = []
    for ch in s:
        r = rng.random()
        if r < d:
            continue
        out.append(rng.choice("ACGT") if r < mismatch * d else ch)
        if rng.random() < d:
            out.append(rng.choice("ACGT"))
    return "".join(out) or "A"


def _step(name):
    print(f"  {name} ...", end=" ", flush=True)


def _launched(counter, before, what):
    if counter.launches <= before:
        raise AssertionError(f"{what} never launched")


def _banded_sections(card, rng):
    """run_tpu_tests.py:79-222: randomized costs on the banded route,
    drifting windows (one- and two-piece) and the big banded kernel's
    windows; returns the graphs the later sections reuse."""
    import torch

    from poasta_tpu_torch import (
        BandedScorer,
        DeviceGraph,
        GapAffine,
        NativeAligner,
        POAGraph,
        pack_queries,
    )
    from poasta_tpu_torch.aligner import GapAffine2Piece
    from poasta_tpu_torch.aligner.banded import band_windows
    from poasta_tpu_torch.aligner.wavefront import dp_fill_scores
    from poasta_tpu_torch.ops import cuda_fill as cf

    costs = GapAffine(4, 2, 6)
    base = "".join(rng.choice("ACGT") for _ in range(500))
    g = POAGraph()
    g.add_alignment_with_weights("s0", base.encode(), None, [1] * 500)
    for i in range(1, 3):
        s = _mutate(rng, base, 0.05).encode()
        _, aln, _ = NativeAligner(g).align(s, costs)
        g.add_alignment_with_weights(f"s{i}", s, aln, [1] * len(s))
    flat = g.flatten()
    dg = DeviceGraph.build(flat, device=card)
    queries = [_mutate(rng, base, 0.05).encode() for _ in range(64)]
    qshift, lengths = pack_queries(queries, device=card)
    print("single-device mesh (run_tpu_tests.py:79-130):")
    from poasta_tpu_torch.parallel import make_mesh, make_sharded_score_fn

    full = dp_fill_scores(dg, qshift, lengths, costs).cpu().numpy()
    for dp in (1, 2):
        # the reference's 1 x 1 mesh of its one chip, and the card twice
        # (dp 2: the split, a launch a shard and the gather)
        mesh = make_mesh(devices=[card] * dp, dp=dp)
        _step(f"dp={dp} mesh full fill")
        before = cf.fill_end_rows.launches
        got = make_sharded_score_fn(dg, costs, mesh)(qshift, lengths)
        launched = cf.fill_end_rows.launches - before
        if launched != dp:
            raise AssertionError(f"B2 launched {launched} times, not {dp}")
        assert (got.cpu().numpy() == full).all()
        print("OK")
        _step(f"dp={dp} mesh banded fill")
        before = cf.banded_end_rows.launches
        bs = BandedScorer(flat, costs, mesh=mesh)
        assert (bs.scores(qshift, lengths) == full).all()
        _launched(cf.banded_end_rows, before, "B1")
        print("OK")

    print("randomized costs on the banded route (run_tpu_tests.py:132-147):")
    for seed in (41, 43):
        rr = random.Random(seed)
        rcosts = GapAffine(rr.randrange(1, 9), rr.randrange(1, 5),
                           rr.randrange(0, 12))
        _step(f"banded, {rcosts}")
        oracle = dp_fill_scores(dg, qshift, lengths, rcosts).cpu().numpy()
        before = cf.banded_end_rows.launches
        got = BandedScorer(flat, rcosts, dg=dg).scores(qshift, lengths)
        _launched(cf.banded_end_rows, before, "B1")
        assert (got == oracle).all(), (got[:6], oracle[:6])
        print("OK")

    print("drifting windows, mixed-length SV batch "
          "(run_tpu_tests.py:149-174):")
    base2 = "".join(rng.choice("ACGT") for _ in range(2200))
    variant2 = base2[:300] + base2[1900:]  # 1.6 kb deletion allele
    g2 = POAGraph()
    g2.add_alignment_with_weights("s0", base2.encode(), None,
                                  [1] * len(base2))
    _, aln2, _ = NativeAligner(g2).align(variant2.encode(), costs)
    g2.add_alignment_with_weights("s1", variant2.encode(), aln2,
                                  [1] * len(variant2))
    flat2 = g2.flatten()
    dg2 = DeviceGraph.build(flat2, device=card)
    reads2 = [_mutate(rng, base2 if i % 2 else variant2, 0.015).encode()
              for i in range(64)]
    q2, l2 = pack_queries(reads2, device=card)
    oracle2 = dp_fill_scores(dg2, q2, l2, costs).cpu().numpy()
    _step("drift scores == full fill")
    before = cf.drift_end_rows.launches
    got2 = BandedScorer(flat2, costs, dg=dg2).scores(q2, l2)
    _launched(cf.drift_end_rows, before, "the drift fill B3")
    assert (got2 == oracle2).all(), (got2[:6], oracle2[:6])
    print("OK")

    print("the big banded kernel on identical windows "
          "(run_tpu_tests.py:176-198; B11's work is B1's):")
    ln2 = l2.cpu().numpy()
    ws, wd, _, _ = band_windows(flat2, int(ln2.min()), int(ln2.max()),
                                costs, 800)
    prep = cf.prepare_banded(dg2, costs, (ws // 128) * 128, wd + 128,
                             int(q2.shape[1]))
    _step("B1 == its plain version on the same windows, covered reads == "
          "full fill")
    assert torch.equal(cf.banded_end_rows(dg2, q2, costs, prep),
                       cf.banded_end_rows_plain(dg2, q2, costs, prep))
    a_std = cf.banded_scores(dg2, q2, l2, costs, prep).cpu().numpy()
    covered = a_std <= 800
    assert covered.any() and (a_std[covered] == oracle2[covered]).all()
    print("OK")
    import test_torch_cuda as tc

    gb, big_reads = tc._bubble_case(47, 12000, 3, 1000, 64)
    flatb = gb.flatten()
    dgb = DeviceGraph.build(flatb, device=card)
    qb, lb = pack_queries(big_reads, device=card)
    _step(f"B1 past the reference's gate ({flatb.n_nodes} ranks, P "
          f"{int(dgb.pred_slots.shape[1])}, 64 reads of 12 kb) == full "
          f"fill; rows == plain on 2 reads")
    oracle_b = dp_fill_scores(dgb, qb, lb, costs).cpu().numpy()
    lnb = lb.cpu().numpy()
    ub = int(oracle_b.max()) * 5 // 4
    ws, wd, _, _ = band_windows(flatb, int(lnb.min()), int(lnb.max()),
                                costs, ub)
    prep = cf.prepare_banded(dgb, costs, (ws // 128) * 128, wd + 128,
                             int(qb.shape[1]))
    got_b = cf.banded_scores(dgb, qb, lb, costs, prep).cpu().numpy()
    assert (got_b == oracle_b).all(), (got_b[:6], oracle_b[:6])
    q2b = qb[:2].contiguous()
    assert torch.equal(cf.banded_end_rows(dgb, q2b, costs, prep),
                       cf.banded_end_rows_plain(dgb, q2b, costs, prep))
    print("OK")
    print("chain-skip (run_tpu_tests.py:200-205): left out, an opt-in "
          "branch of the TPU kernels that the port does not carry")

    print("drifting windows, two-piece (run_tpu_tests.py:207-222):")
    _step("2p drift scores == full fill")
    c2p = GapAffine2Piece(4, 2, 6, 1, 24)
    oracle2p = dp_fill_scores(dg2, q2, l2, c2p).cpu().numpy()
    before = cf.drift_end_rows_2p.launches
    got2p = BandedScorer(flat2, c2p, dg=dg2).scores(q2, l2)
    _launched(cf.drift_end_rows_2p, before, "the two-piece drift fill B17")
    assert (got2p == oracle2p).all(), (got2p[:6], oracle2p[:6])
    print("OK")
    return (g, flat, dg, base), (flat2, dg2, q2, l2)


def _ends_free_sections(card, rng, small, sv):
    """run_tpu_tests.py:223-299: bounded ends-free fills."""
    import numpy as np
    import torch

    from poasta_tpu_torch import (
        UNBOUNDED,
        BandedScorer,
        EndsFree,
        GapAffine,
        excluded,
        included,
        pack_queries,
    )
    from poasta_tpu_torch.aligner import GapAffine2Piece
    from poasta_tpu_torch.aligner.wavefront import (
        dp_fill_full,
        dp_fill_scores_ends_free,
        ends_free_device_params,
    )
    from poasta_tpu_torch.ops import cuda_fill as cf

    costs = GapAffine(4, 2, 6)
    _, flat, dg, base = small
    flat2, dg2, q2, l2 = sv
    print("bounded ends-free fills (run_tpu_tests.py:223-299):")
    ef_reads = []
    for _ in range(64):
        a = rng.randrange(0, 150)
        b = rng.randrange(a + 60, 500)
        ef_reads.append(_mutate(rng, base[a:b], 0.03).encode())
    qe, le = pack_queries(ef_reads, device=card)
    le_np = le.cpu().numpy()
    for cfg in (EndsFree(UNBOUNDED, UNBOUNDED, UNBOUNDED, UNBOUNDED),
                EndsFree(UNBOUNDED, included(25), UNBOUNDED, included(30)),
                EndsFree(UNBOUNDED, excluded(20), included(3),
                         excluded(40))):
        _step(f"bounded fill {cfg.qry_free_end}/{cfg.graph_free_end} == "
              "the dense tables' min")
        fs, end_ok, jlo = ends_free_device_params(flat, cfg, le,
                                                  dg.n_nodes_padded)
        before = cf.bounded_best_rows.launches
        got = dp_fill_scores_ends_free(dg, flat, qe, le, costs,
                                       cfg).cpu().numpy()
        _launched(cf.bounded_best_rows, before, "B4")
        Mt = dp_fill_full(dg, qe, le, costs, free_start=fs)[1].cpu().numpy()
        eo = end_ok.cpu().numpy().astype(bool)
        jlo_np = jlo.cpu().numpy()
        for b in range(len(ef_reads)):
            n, lo = int(le_np[b]), int(jlo_np[b])
            sub = Mt[eo, b, lo:n + 1] if lo <= n else np.empty(0)
            want = int(sub.min()) if sub.size else cf.INF
            assert int(got[b]) == want, (b, int(got[b]), want)
        print("OK")

    _step("bounded 2p fill == its plain version")
    costs2p = GapAffine2Piece(4, 2, 6, 1, 24)
    cfg2 = EndsFree(UNBOUNDED, included(25), UNBOUNDED, included(30))
    fs, end_ok, jlo = ends_free_device_params(flat, cfg2, le,
                                              dg.n_nodes_padded, True)
    before = cf.bounded_best_rows_2p.launches
    got2 = dp_fill_scores_ends_free(dg, flat, qe, le, costs2p, cfg2)
    _launched(cf.bounded_best_rows_2p, before, "B13")
    assert torch.equal(got2, cf.bounded_scores_2p_plain(
        dg, qe, le, costs2p, fs, end_ok, jlo))
    print("OK")

    _step("banded ends-free == full fill")
    cfg = EndsFree(UNBOUNDED, included(40), UNBOUNDED, included(40))
    oracle = dp_fill_scores_ends_free(dg, flat, qe, le, costs,
                                      cfg).cpu().numpy()
    before = cf.ef_best_rows.launches
    got = BandedScorer(flat, costs, dg=dg, aln_type=cfg).scores(qe, le)
    _launched(cf.ef_best_rows, before, "B5")
    assert (got == oracle).all(), (got[:6], oracle[:6])
    print("OK")

    _step("drift x bounded ends-free == full fill")
    cfg_de = EndsFree(UNBOUNDED, included(40), included(0), included(40))
    oracle = dp_fill_scores_ends_free(dg2, flat2, q2, l2, costs,
                                      cfg_de).cpu().numpy()
    bs = BandedScorer(flat2, costs, dg=dg2, aln_type=cfg_de)
    before = cf.drift_ef_best_rows.launches
    got = bs.scores(q2, l2)
    _launched(cf.drift_ef_best_rows, before, "B6")
    assert (got == oracle).all(), (got[:6], oracle[:6])
    assert bs.stats["fills"] and not bs.stats["fullfill_fallbacks"]
    print("OK")

    print("  (run_tpu_tests.py:412's standard 2p with-ends check follows "
          "the 60k block)")
    return cfg, qe, le


def _big_graph_sections(card, rng, small, ef):
    """run_tpu_tests.py:301-420: the 60k-node block, past the reference's
    gate, where it ran its streamed kernels (B9, B10, B15)."""
    import torch

    from poasta_tpu_torch import (
        UNBOUNDED,
        BatchMapper,
        DeviceGraph,
        EndsFree,
        GapAffine,
        NativeAligner,
        POAGraph,
        included,
        pack_queries,
    )
    from poasta_tpu_torch.aligner import GapAffine2Piece
    from poasta_tpu_torch.aligner.wavefront import (
        alignment_cost,
        dp_fill_ends_free_with_ends,
        dp_fill_scores,
        dp_fill_scores_ends_free,
        ends_free_device_params,
    )
    from poasta_tpu_torch.ops import cuda_fill as cf

    costs = GapAffine(4, 2, 6)
    print("the 60k-node block (run_tpu_tests.py:301-420):")
    big_base = "".join(rng.choice("ACGT") for _ in range(60000))
    gb = POAGraph()
    gb.add_alignment_with_weights("s0", big_base.encode(), None,
                                  [1] * len(big_base))
    for v in range(0, 60000 - 3, 997):
        gb.add_edge(v, v + 3, 0, 1)
    gb.post_process()
    flatb = gb.flatten()
    dgb = DeviceGraph.build(flatb, device=card)
    big_reads = [_mutate(rng, big_base[i * 400:i * 400 + 1500],
                         0.02).encode() for i in range(64)]
    qb, lb = pack_queries(big_reads, device=card)
    q2, l2 = qb[:2].contiguous(), lb[:2].contiguous()
    cfgb = EndsFree(UNBOUNDED, included(0), UNBOUNDED, UNBOUNDED)
    fs, end_ok, jlo = ends_free_device_params(flatb, cfgb, lb,
                                              dgb.n_nodes_padded)

    _step(f"semi-global and global scores on {flatb.n_nodes} ranks (B4, B2) "
          "== their plain versions on 2 reads; semi-global <= global")
    before = cf.bounded_best_rows.launches
    got_b = dp_fill_scores_ends_free(dgb, flatb, qb, lb, costs, cfgb)
    _launched(cf.bounded_best_rows, before, "B4")
    before = cf.fill_end_rows.launches
    got_g = dp_fill_scores(dgb, qb, lb, costs)
    _launched(cf.fill_end_rows, before, "B2")
    assert torch.equal(got_b[:2], cf.bounded_scores_plain(
        dgb, q2, l2, costs, fs, end_ok, jlo[:2].contiguous()))
    assert torch.equal(got_g[:2], cf.fill_scores_plain(dgb, q2, l2, costs))
    got_b, got_g = got_b.cpu().numpy(), got_g.cpu().numpy()
    assert (got_b <= got_g).all()
    print("OK")

    _step("end anchors (B7) + the native corridor on reads 0, 17, 63")
    sc_b, er_b, ej_b = (t.cpu().numpy() for t in dp_fill_ends_free_with_ends(
        dgb, flatb, qb, lb, costs, cfgb))
    assert (sc_b == got_b).all()
    nab = NativeAligner(gb)
    for b in (0, 17, 63):
        score, aln = nab.align_anchored(
            big_reads[b], costs, int(flatb.node_of_rank[er_b[b]]),
            int(ej_b[b]), int(sc_b[b]))
        assert score == sc_b[b]
        assert alignment_cost(gb, big_reads[b], aln, costs) == score
    print("OK")

    _step("the capped ladder at max_run 64 only raises scores; the "
          "mapper's ladder is exact")
    scap, ercap, ejcap = (t.cpu().numpy() for t in
                          dp_fill_ends_free_with_ends(
                              dgb, flatb, qb, lb, costs, cfgb, max_run=64))
    assert (scap >= sc_b).all()
    same = scap == sc_b
    assert same.any()
    assert (ercap[same] == er_b[same]).all()
    assert (ejcap[same] == ej_b[same]).all()
    bm = BatchMapper(gb, costs, device=card, aln_type=cfgb)
    sl, el_, jl_ = bm._fill_ends_free_capped(qb, lb, lb.cpu().numpy())
    assert (sl == sc_b).all() and (el_ == er_b).all() \
        and (jl_ == ej_b).all()
    print("OK")

    _step("two-piece end anchors (B14 at 60k ranks) + the 2p native "
          "corridor")
    costs2p = GapAffine2Piece(4, 2, 8, 1, 24)
    before = cf.bounded_end_rows_2p.launches
    sc2, er2, ej2 = (t.cpu().numpy() for t in dp_fill_ends_free_with_ends(
        dgb, flatb, qb, lb, costs2p, cfgb))
    _launched(cf.bounded_end_rows_2p, before, "B14")
    ref2 = dp_fill_scores_ends_free(dgb, flatb, qb, lb, costs2p,
                                    cfgb).cpu().numpy()
    assert (sc2 == ref2).all(), (sc2[:8], ref2[:8])
    for b in (3, 29, 55):
        score, aln = nab.align_anchored(
            big_reads[b], costs2p, int(flatb.node_of_rank[er2[b]]),
            int(ej2[b]), int(sc2[b]))
        assert score == sc2[b]
        assert alignment_cost(gb, big_reads[b], aln, costs2p) == score
    scap2, ercap2, ejcap2 = (t.cpu().numpy() for t in
                             dp_fill_ends_free_with_ends(
                                 dgb, flatb, qb, lb, costs2p, cfgb,
                                 max_run=256))
    assert (scap2 >= sc2).all()
    same2 = scap2 == sc2
    assert same2.any()
    assert (ercap2[same2] == er2[same2]).all()
    assert (ejcap2[same2] == ej2[same2]).all()
    print("OK")

    _step("two-piece anchors, the standard shape (run_tpu_tests.py:412): "
          "B14 == its plain version")
    _, flat, dg, _ = small
    cfg, qe, le = ef
    fs, end_ok, jlo = ends_free_device_params(flat, cfg, le,
                                              dg.n_nodes_padded, True)
    got = cf.bounded_with_ends_2p(dg, qe, le, costs2p, fs, end_ok, jlo)
    want = cf.bounded_with_ends_2p_plain(dg, qe, le, costs2p, fs, end_ok,
                                         jlo)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    print("OK")


def _clamp_and_seed_sections(card):
    """run_tpu_tests.py:454-540: the full-width clamp and the seeded
    corridors."""
    import numpy as np

    from poasta_tpu_torch import (
        UNBOUNDED,
        BandedScorer,
        BatchMapper,
        DeviceGraph,
        EndsFree,
        GapAffine,
        POAGraph,
        included,
        pack_queries,
    )
    from poasta_tpu_torch.aligner.wavefront import dp_fill_scores

    costs = GapAffine(4, 2, 6)
    print("full-width band clamp (run_tpu_tests.py:454-478):")
    _step("the ladder's clamped full-width tier == full fill (uncapped, "
          "ROADMAP C1)")
    rngc = random.Random(83)
    basec = "".join(rngc.choice("ACGT") for _ in range(700))
    gc = POAGraph()
    gc.add_alignment_with_weights("s0", basec.encode(), None, [1] * 700)
    creads = []
    for i in range(64):
        if i % 8 == 7:
            creads.append("".join(rngc.choice("ACGT")
                                  for _ in range(700)).encode())
        else:
            creads.append(_mutate(rngc, basec, 0.05).encode())
    flatc = gc.flatten()
    qc, lc = pack_queries(creads, device=card)
    bsc = BandedScorer(flatc, costs, device=card)
    gotc = bsc.scores(qc, lc, ub=120)
    dgc = DeviceGraph.build(flatc, device=card)
    refc = dp_fill_scores(dgc, qc, lc, costs).cpu().numpy()
    assert (gotc == refc).all(), (gotc[:8], refc[:8])
    assert (bsc.scores(qc, lc) == refc).all()
    print("OK")

    print("seeded corridor fills (run_tpu_tests.py:480-540, POASTA_SEED=all):")
    os.environ["POASTA_SEED"] = "all"
    try:
        rng = random.Random(23)
        n = 3000
        base = "".join(rng.choice("ACGT") for _ in range(n))
        gsd = POAGraph()
        gsd.add_alignment_with_weights("s0", base.encode(), None, [1] * n)
        for v in range(0, n - 3, 97):
            gsd.add_edge(v, v + 3, 0, 1)
        gsd.post_process()
        cfgs = EndsFree(UNBOUNDED, included(0), UNBOUNDED, UNBOUNDED)
        for costs_s, div in ((GapAffine(4, 2, 6), 0.015),
                             (GapAffine(3, 1, 9), 0.005)):
            _step(f"seeded == full fill, {costs_s} d={div}")
            reads = []
            for _ in range(64):
                a = rng.randrange(0, n - 1200)
                reads.append(_mutate(rng, base[a:a + 1200], div,
                                     mismatch=2.5).encode())
            reads[11] = "".join(rng.choice("ACGT")
                                for _ in range(1200)).encode()  # garbage
            msd = BatchMapper(gsd, costs_s, device=card, aln_type=cfgs)
            qsd, lsd = pack_queries(reads, device=card)
            msd._ends_free_scores(reads, qsd, lsd)  # learn the rates
            got = msd._ends_free_scores(reads, qsd, lsd)
            st = msd.last_seed_stats
            assert st["seeded"] >= 48 and st["seed_tail"] >= 1, st
            refs = msd._fill_ends_free_capped(qsd, lsd, lsd.cpu().numpy())
            for a, b in zip(got, refs):
                assert (np.asarray(a) == np.asarray(b)).all()
            print(f"OK (seeded {st['seeded']}/64, k={st['seed_k']})")
    finally:
        os.environ.pop("POASTA_SEED", None)


def main(argv) -> int:
    soak = None
    if "--soak" in argv:
        at = argv.index("--soak")
        if at + 1 >= len(argv) or not argv[at + 1].isdigit():
            print("usage: run_gpu_tests.py [--soak N]")
            return 2
        soak = int(argv[at + 1])

    sys.path.insert(0, REPO)
    from poasta_tpu_torch.utils.device import (
        NoDeviceError,
        card_info,
        cuda_device,
    )

    try:
        card = cuda_device()
    except NoDeviceError as exc:
        print(f"ERROR: no card: {exc}")
        return 1
    import torch

    print(f"card: {card_info()}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.device_count()} device(s)",
          flush=True)

    print("card tests:", flush=True)
    rc = subprocess.call([sys.executable, "-m", "pytest", "--noconftest",
                          "-q", "-p", "no:cacheprovider", "--durations=10",
                          "-m", "cuda",
                          *CARD_TESTS], cwd=REPO)
    if rc != 0:
        print(f"card tests failed (pytest exit code {rc})")
        return rc

    print("cross-engine consistency sweep (run_tpu_tests.py:66-77) and "
          "device traceback kernels (:422-452, the forced big-kernel trace "
          "at :431 included): held by the card tests above "
          "(test_torch_consistency.py's cuda twins; test_torch_cuda.py's "
          "trace tests)", flush=True)
    sys.path.insert(0, os.path.join(REPO, "tests"))
    import test_torch_consistency as tcons

    rng = random.Random(41)
    small, sv = _banded_sections(card, rng)
    ef = _ends_free_sections(card, rng, small, sv)
    _big_graph_sections(card, rng, small, ef)
    _clamp_and_seed_sections(card)

    if soak is not None:
        print(f"soak: {soak} more consistency seeds on the card:")
        for k in range(soak):
            seed = 900 + k
            _step(f"seed {seed}")
            if k % 4 == 3:
                tcons.check_two_piece(seed, card)
            else:
                tcons.check_one_piece(seed, card)
            print("OK")

    print("all GPU validations passed")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
