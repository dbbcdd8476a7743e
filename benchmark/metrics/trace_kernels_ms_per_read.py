"""The profiler's device time of the trace fill and the decode
(``trace_fill_kernel``, ``decode_warp_kernel``) per read of the window,
ms."""

import re

TRACE = re.compile(r"\b(trace_fill_kernel|decode_warp_kernel)\b")


def read(run):
    busy = sum(e - s for name, s, e in run.device if TRACE.search(name))
    return busy * 1e3 / run.reads if busy > 0 else None
