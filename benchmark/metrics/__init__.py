"""One reader a metric, found by the metric's name in ``BENCHMARK.json``:
``read(run)`` takes a ``run.RunRecord`` and returns the metric's value, or
None where the run holds nothing to read (the harness then leaves the
metric out of the line)."""
