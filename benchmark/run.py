"""Run one cell of the port's benchmark once.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout that holds ``BENCHMARK.json``, ``benchmark/``
and ``poasta_tpu_torch``.  The run makes its graph and reads from
``--seed`` (``graphgen``, ``readgen``), starts the cell's adapter (to
one entry of the port, ``benchmark/adapters/``), warms it up,
then calls it in a closed loop until ``--seconds`` have passed and the
call in flight has returned: that is the window.  Set-up is process start
to the window's first call.  After the window each card's peak device
memory is read, the program's state freed, and its outputs compared with
the plain reference (``benchmark/reference/``).  With ``--trace 1`` the
harness's spans and ``torch.profiler`` record the window, and the line
carries the cell's per-layer metrics instead of its end-to-end ones.

The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared with its limit);
the last lines of standard error repeat the checks.  No card, fewer cards
than the cell asks for, or ``jax``, ``jaxlib``, ``flax`` or ``poasta_tpu``
among the loaded modules after the window: an error on standard error, no
result, a non-zero exit; so does a run that used fewer cards than its cell
asks for, or cards of two kinds.  A card counts as used where the run
allocated device memory on it, and in a traced run also ran device work
in the window.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import functools  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402

from .graphgen import build_graph  # noqa: E402
from .readgen import make_batches  # noqa: E402
from .registry import Registry  # noqa: E402
from .tracing import DeviceTrace, Spans  # noqa: E402
from .yardstick import busy_per_card, idle_gaps, mean_busy  # noqa: E402

# top-level module names that may not be loaded when the window closes:
# the JAX package and JAX itself (compared by whole top-level name, since
# the port's name begins with the JAX package's)
BANNED = ("jax", "jaxlib", "flax", "poasta_tpu")
BREAKDOWN_TOP = 10


@dataclass
class Context:
    """A run's inputs, as an adapter and a check see them."""

    seed: int
    device: str  # the current card: where a one-card adapter works
    devices: list  # the cell's cards, cuda:0 .. cuda:<chips-1> (CPU: cpu)
    cell: dict
    config: dict
    mix: dict
    tmpdir: str
    gfa_text: str
    gfa_path: str
    batches: list
    warm: list
    spans: Spans

    @functools.cached_property
    def ref_graph(self):
        """The reference's own parse of the GFA text (after the window)."""
        from .reference.gfa import parse_gfa

        return parse_gfa(self.gfa_text)


@dataclass
class RunRecord:
    """What a metric's reader reads: the window's calls (host start, end,
    reads completed), the adapter's counters, the spans, the cards the run
    used (``cards``, indices), and with ``--trace 1`` the device trace:
    each card's rows (``device_by_card``), and all of them as ``device``."""

    ctx: Context
    setup_s: float
    calls: list
    window_s: float
    counters: dict
    spans: dict
    device_by_card: dict = field(default_factory=dict)
    cards: list = field(default_factory=list)
    host_spans: list = field(default_factory=list)
    trace_window: tuple = None

    def add_trace(self, traced) -> None:
        """Take :meth:`tracing.DeviceTrace.read`'s result, each card's
        rows in their order."""
        rows, self.host_spans, self.trace_window = traced
        for n, s, e, card in rows:
            self.device_by_card.setdefault(card, []).append((n, s, e))

    @property
    def device(self) -> list:
        """Every card's device rows (name, start, end), card by card."""
        return [row for rows in self.device_by_card.values() for row in rows]

    @property
    def reads(self) -> int:
        return sum(n for _, _, n in self.calls)


def loaded_banned() -> list:
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops.intersection(BANNED))


def _pin_caches(root: str) -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    base = os.path.join(root, "build", "benchmark")
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = os.path.join(base, sub)


def _peaks() -> list:
    """Each visible card's peak of allocated device memory, bytes.  Reads
    the caching allocator's counts: no CUDA context is made on a card the
    run never touched."""
    import torch

    return [torch.cuda.max_memory_allocated(i)
            for i in range(torch.cuda.device_count())]


def _sync(device: str) -> None:
    """Wait for every visible card the run has put work on (a card with
    no allocation holds no work, and synchronising it would make a
    context there)."""
    if device.startswith("cuda"):
        import torch

        for i, peak in enumerate(_peaks()):
            if peak > 0:
                torch.cuda.synchronize(i)


def _cards(on_card: bool, traced_by_card):
    """(each visible card's peak bytes, the cards the run used, their
    kind).  Used: memory allocated there, and with a trace, device rows in
    the window.  Raises where the used cards differ in kind."""
    if not on_card:
        return [0], [0], "cpu"
    import torch

    peaks = _peaks()
    used = [i for i, peak in enumerate(peaks) if peak > 0
            and (traced_by_card is None or traced_by_card.get(i))]
    kinds = sorted({torch.cuda.get_device_name(i) for i in used})
    if len(kinds) > 1:
        raise RuntimeError(f"the cards the run used differ in kind: "
                           f"{', '.join(kinds)}")
    return peaks, used, kinds[0] if kinds else "none"


def _breakdown(run):
    """The device operations that took most time (every card's), and the
    idle time of the window summed over the cards the run used, by the
    harness spans open at each gap's midpoint."""
    per_op = {}
    for name, s, e in run.device:
        per_op[name] = per_op.get(name, 0.0) + (e - s)
    idle = {}
    for card in run.cards:
        rows = run.device_by_card.get(card, [])
        for a, b in idle_gaps([(s, e) for _, s, e in rows],
                              *run.trace_window):
            mid = (a + b) / 2
            label = "+".join(sorted({n for n, s, e in run.host_spans
                                     if s <= mid <= e})) or "outside any span"
            idle[label] = idle.get(label, 0.0) + (b - a)

    def top(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
                [:BREAKDOWN_TOP]]
    return {"device_ops": top(per_op), "idle_gaps": top(idle)}


def run_cell(reg: Registry, name: str, seed: int, seconds: float,
             trace: bool, device: str = "cuda", t_start: float = None):
    """One run of cell ``name``: (the result line as a dict, the checks as
    [(name, value, limit)])."""
    t_start = T_START if t_start is None else t_start
    on_card = device.startswith("cuda")
    cell = reg.cell(name)
    config, mix = reg.config(cell["config"]), reg.mix(cell["traffic"])
    gfa, haps, backbone = build_graph(config["graph"], seed)
    batches, warm, _ = make_batches(mix, haps, backbone, seed)
    with tempfile.TemporaryDirectory(prefix="bench-") as tmp:
        gfa_path = os.path.join(tmp, "graph.gfa")
        with open(gfa_path, "w") as fh:
            fh.write(gfa)
        spans = Spans(trace)
        devices = ([f"cuda:{i}" for i in range(cell["chips"])] if on_card
                   else [device] * cell["chips"])
        ctx = Context(seed=seed, device=device, devices=devices, cell=cell,
                      config=config, mix=mix, tmpdir=tmp, gfa_text=gfa,
                      gfa_path=gfa_path, batches=batches, warm=warm,
                      spans=spans)
        caller = reg.adapter(cell["adapter"]).start(ctx)
        caller.warm_up()
        _sync(device)
        setup_s = time.perf_counter() - t_start
        calls = []
        with DeviceTrace(trace) as dtrace:
            _sync(device)
            with dtrace.window():
                w0 = time.perf_counter()
                while True:
                    t0 = time.perf_counter()
                    n = caller.step()
                    t1 = time.perf_counter()
                    calls.append((t0, t1, n))
                    if t1 - w0 >= seconds:
                        break
        window_s = calls[-1][1] - w0
        walls = sorted(t1 - t0 for t0, t1, _ in calls)
        print(f"window: {len(calls)} calls in {window_s:.3f} s, a call "
              f"{walls[0]:.3f} / {walls[len(walls) // 2]:.3f} / "
              f"{walls[-1]:.3f} s (least / median / most)", file=sys.stderr)
        run = RunRecord(ctx=ctx, setup_s=setup_s, calls=calls,
                        window_s=window_s, counters={}, spans={})
        traced = dtrace.read()
        if traced is not None:
            run.add_trace(traced)
        peaks, run.cards, kind = _cards(
            on_card, None if traced is None else run.device_by_card)
        run.counters = caller.counters()
        outputs = caller.outputs()
        caller.close()
        del caller
        gc.collect()
        if on_card:
            import torch

            # the caching allocator releases the cache of every card
            torch.cuda.empty_cache()
        t_check = time.perf_counter()
        checks = reg.check(outputs["kind"]).check(outputs, ctx)
        print(f"reference check: {time.perf_counter() - t_check:.1f} s",
              file=sys.stderr)
        run.spans = dict(spans.durations)
        metrics = {}
        for m in reg.metrics(name, trace):
            value = reg.metric(m["name"]).read(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    missing = sum(v for k, v, _ in checks if k.endswith("_missing"))
    dev = {"platform": "gpu" if on_card else "cpu", "kind": kind,
           "count": len(run.cards), "memory_peak_bytes": int(max(peaks)),
           "memory_peak_bytes_per_card": [int(p) for p in peaks]}
    line = {"correct": all(v <= lim for _, v, lim in checks),
            "attempted": run.reads, "failed": int(missing),
            "metrics": metrics, "device": dev}
    if traced is not None:
        lo, hi = run.trace_window
        busy = busy_per_card(run.device_by_card, run.trace_window)
        dev["busy_s"] = mean_busy(run.device_by_card, run.cards,
                                  run.trace_window)
        dev["busy_s_per_card"] = [busy.get(i, 0.0) for i in range(len(peaks))]
        dev["window_s"] = hi - lo
        line["breakdown"] = _breakdown(run)
    line["checks"] = {k: {"value": v, "limit": lim} for k, v, lim in checks}
    return line, checks


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m benchmark.run",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    reg = Registry()
    chips = reg.cell(args.workload)["chips"]
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"error: cell {args.workload} needs {chips} CUDA card(s); "
              f"torch sees {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    _pin_caches(reg.root)
    line, checks = run_cell(reg, args.workload, args.seed, args.seconds,
                            bool(args.trace))
    used = line["device"]["count"]
    if used < chips:
        print(f"error: cell {args.workload} needs {chips} card(s); the run "
              f"used {used}", file=sys.stderr)
        return 4
    banned = loaded_banned()
    if banned:
        print(f"error: loaded after the window: {', '.join(banned)}",
              file=sys.stderr)
        return 3
    for k, v, lim in checks:
        print(f"check {k} {v} limit {lim}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
