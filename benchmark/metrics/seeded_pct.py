"""Reads the seeded corridors resolved (``last_seed_stats["seeded"]``
after each call that scored a batch) over the reads scored, %."""


def read(run):
    scored = run.counters.get("scored")
    return 100.0 * run.counters["seeded"] / scored if scored else None
