"""Finds what ``BENCHMARK.json`` names: a configuration by its ``file``, a
traffic mix at ``benchmark/mixes/<traffic>.json``, a cell's parameters at
``benchmark/workloads/<cell>.json``, an adapter at
``benchmark/adapters/<adapter>.py``, a metric's reader at
``benchmark/metrics/<metric>.py`` and a check at
``benchmark/reference/check_<kind>.py``.  Adding one is adding files and
entries; nothing here names any of them.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class Registry:
    def __init__(self, root: str = REPO):
        self.root = root
        self.bench = os.path.join(root, "benchmark")
        with open(os.path.join(root, "BENCHMARK.json")) as fh:
            self.spec = json.load(fh)

    def _entry(self, kind: str, name: str) -> dict:
        for entry in self.spec[kind]:
            if entry["name"] == name:
                return entry
        raise KeyError(f"BENCHMARK.json has no {kind} entry {name!r}")

    def _json(self, *parts) -> dict:
        with open(os.path.join(self.bench, *parts)) as fh:
            return json.load(fh)

    def cell(self, name: str) -> dict:
        """The ``workloads`` entry and its parameters file, merged."""
        entry = self._entry("workloads", name)
        return {**self._json("workloads", f"{name}.json"), **entry}

    def config(self, name: str) -> dict:
        with open(os.path.join(self.root,
                               self._entry("configs", name)["file"])) as fh:
            return json.load(fh)

    def mix(self, name: str) -> dict:
        return self._json("mixes", f"{name}.json")

    def _module(self, kind: str, name: str):
        qual = f"benchmark.{kind}.{name.replace('.', '_')}"
        path = os.path.join(self.bench, kind, f"{name}.py")
        if not os.path.exists(path):
            raise KeyError(f"no {kind} module {name!r} at {path}")
        spec = importlib.util.spec_from_file_location(qual, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[qual] = mod
        spec.loader.exec_module(mod)
        return mod

    def adapter(self, name: str):
        return self._module("adapters", name)

    def metric(self, name: str):
        return self._module("metrics", name)

    def check(self, kind: str):
        return self._module("reference", f"check_{kind}")

    def metrics(self, cell: str, trace: bool) -> list:
        """The cell's end-to-end metrics (untraced) or per-layer metrics
        (traced): those whose ``workloads`` name it, or that have none."""
        kind = "per_layer" if trace else "end_to_end"
        return [m for m in self.spec[kind]
                if cell in m.get("workloads", [cell])]
