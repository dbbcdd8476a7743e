"""The port's spans and counters: one recorder, in memory.

``span(name, **attrs)`` times a block on the host clock
(``time.perf_counter_ns``) and records its name, its thread, its parent
(the span open on the same thread, or the one :func:`attach` hands across
threads) and its attributes: the request identifiers, such as the chunk id
and batch index of ``lasagna``'s loop, which a span also takes from its
parent.  ``count(name, n)`` adds ``n`` to a counter.

Both record only while a ``torch.profiler`` session is active or inside
:func:`recording`.  Otherwise they return after one check, make no record
and call nothing: no ``record_function``, no NVTX range, nothing that the
profiler would turn into a row of its trace, whose device rows then hold
device work alone.  :func:`drain` hands back what was recorded and clears
it; nothing is written anywhere.

The finest grain is a batch, a tier or a sub-batch: no span and no count a
read.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from dataclasses import dataclass, field

from torch.autograd import profiler as _profiler

__all__ = ["Span", "active", "attach", "count", "current", "drain",
           "recording", "span"]


@dataclass(slots=True)
class Span:
    """One recorded span: times in ``perf_counter_ns``; ``parent`` is the
    parent's ``id`` (None at a root); ``thread`` the ``threading.get_ident``
    of the thread that ran it."""

    name: str
    id: int
    parent: int | None
    thread: int
    attrs: dict = field(default_factory=dict)
    start_ns: int = 0
    end_ns: int = 0


_lock = threading.Lock()
_local = threading.local()
_ids = itertools.count(1)
_spans: list = []
_counts: dict = {}
_forced = 0  # open recording() blocks


def active() -> bool:
    """Whether spans and counts record now."""
    return bool(_forced) or _profiler._is_profiler_enabled


class _Off:
    """What :func:`span` and :func:`attach` return while nothing records."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Open:
    __slots__ = ("span", "stack")

    def __init__(self, span: Span, stack: list):
        self.span, self.stack = span, stack

    def __enter__(self) -> Span:
        self.stack.append(self.span)
        self.span.start_ns = time.perf_counter_ns()
        return self.span

    def __exit__(self, *exc):
        self.span.end_ns = time.perf_counter_ns()
        self.stack.pop()
        _spans.append(self.span)
        return False


def span(name: str, **attrs):
    """A context manager that records the block as span ``name``; it
    yields the :class:`Span` (None while nothing records)."""
    if not (_forced or _profiler._is_profiler_enabled):
        return _OFF
    stack = _stack()
    parent = stack[-1] if stack else None
    if parent is not None and parent.attrs:
        attrs = {**parent.attrs, **attrs}
    return _Open(Span(name, next(_ids),
                      None if parent is None else parent.id,
                      threading.get_ident(), attrs), stack)


@contextlib.contextmanager
def _attached(parent: Span, attrs: dict):
    stack = _stack()
    # a stand-in, never recorded: spans opened under it take the parent's
    # id and its attributes with ``attrs`` added
    stack.append(Span(parent.name, parent.id, parent.parent, parent.thread,
                      {**parent.attrs, **attrs}, parent.start_ns))
    try:
        yield parent
    finally:
        stack.pop()


def current() -> Span | None:
    """The span open innermost on this thread (or the one :func:`attach`
    hands it), to attach another thread's spans to; None while nothing
    records or no span is open."""
    if not (_forced or _profiler._is_profiler_enabled):
        return None
    stack = _stack()
    return stack[-1] if stack else None


def attach(parent: Span | None, **attrs):
    """Make ``parent`` (a span of another thread, or None) the parent of
    the spans this thread opens inside the block, with ``attrs`` added to
    what they inherit."""
    if parent is None or not (_forced or _profiler._is_profiler_enabled):
        return _OFF
    return _attached(parent, attrs)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name``."""
    if not (_forced or _profiler._is_profiler_enabled):
        return
    with _lock:
        _counts[name] = _counts.get(name, 0) + int(n)


@contextlib.contextmanager
def recording():
    """Record inside the block, in every thread, profiler or not."""
    global _forced
    with _lock:
        _forced += 1
    try:
        yield
    finally:
        with _lock:
            _forced -= 1


def drain() -> dict:
    """``{"spans": [Span, ...], "counts": {name: n}}``: everything recorded
    since the last drain, in the order the spans closed; clears both."""
    global _spans, _counts
    with _lock:
        spans, counts = _spans, _counts
        _spans, _counts = [], {}
    return {"spans": spans, "counts": counts}
