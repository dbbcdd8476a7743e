"""The 95th percentile of the host wall of the window's
``BatchMapper.align_batch`` calls, ms (the harness's span)."""

from benchmark.yardstick import percentile


def read(run):
    spans = run.spans.get("align_batch")
    return percentile(spans, 95) * 1e3 if spans else None
