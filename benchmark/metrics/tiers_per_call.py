"""The ladder's tiers (``BandedScorer.stats["tiers"]``) per call."""


def read(run):
    calls = run.counters.get("calls")
    return run.counters["tiers"] / calls if calls else None
