"""What a traced run (``--trace 1``) records: host spans the harness puts
around its calls into the port, and the profiler's device activity over
the measured window.  An untraced run wraps nothing and starts no
profiler.
"""

from __future__ import annotations

import time
from collections import defaultdict

SPAN = "bench."  # the profiler's name of a harness span
WINDOW = SPAN + "window"


class Spans:
    """Host wall of each call of the wrapped callables, by span name."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.durations = defaultdict(list)

    def wrap(self, fn, name: str):
        """``fn`` unchanged when disabled, else timed and named in the
        profiler's trace."""
        if not self.enabled:
            return fn
        from torch.profiler import record_function

        durations = self.durations[name]

        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                with record_function(SPAN + name):
                    return fn(*args, **kwargs)
            finally:
                durations.append(time.perf_counter() - t0)
        return timed


class DeviceTrace:
    """``torch.profiler`` over the window (CPU and CUDA activity), or
    nothing when disabled.  Use ``with trace: ... with trace.window(): ...``
    and then :meth:`read`."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self._prof = None

    def __enter__(self):
        if self.enabled:
            from torch.profiler import ProfilerActivity, profile

            self._prof = profile(activities=[ProfilerActivity.CPU,
                                             ProfilerActivity.CUDA])
            self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self._prof is not None:
            self._prof.__exit__(*exc)
        return False

    def window(self):
        if not self.enabled:
            import contextlib

            return contextlib.nullcontext()
        from torch.profiler import record_function

        return record_function(WINDOW)

    def read(self):
        """(device activities [(name, start, end, card)] clipped to the
        window, harness spans [(name, start, end)], (window start, window
        end)), in seconds on the profiler's clock, ``card`` the index of the
        card the activity ran on; None when disabled."""
        if self._prof is None:
            return None
        from torch.autograd import DeviceType

        device, spans, window = [], [], None
        for ev in self._prof.events():
            start, end = ev.time_range.start / 1e6, ev.time_range.end / 1e6
            if ev.device_type == DeviceType.CUDA:
                # the device rows also carry the harness's own spans (user
                # annotations), which are no device work
                if "Activity Buffer" not in ev.name \
                        and not ev.name.startswith(SPAN):
                    device.append((ev.name, start, end, ev.device_index))
            elif ev.name == WINDOW:
                window = (start, end)
            elif ev.name.startswith(SPAN):
                spans.append((ev.name[len(SPAN):], start, end))
        if window is None:
            raise RuntimeError("the profiler recorded no window span")
        lo, hi = window
        device = [(n, max(s, lo), min(e, hi), card)
                  for n, s, e, card in device if e > lo and s < hi]
        return device, spans, window
