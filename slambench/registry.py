"""Everything the harness runs, found by name from ``BENCHMARK.json``.

* a configuration ``<name>``: its ``file`` (``slambench/configs/<name>.json``);
* a traffic mix ``<name>``: ``slambench/traffic/<name>.json``;
* a per-layer metric ``<name>``: ``slambench/metrics/<name>.py``, a module with
  ``NEEDS`` (what the traced run has to collect for it, of
  :data:`COLLECTORS`) and ``read(run) -> float | None`` (None: nothing to
  read in this run, and the metric is left out of the line);
* the limits of a cell's correctness check: ``slambench/limits/<cell>.json``.

A later cell, mix, configuration or metric is a new file and a new entry in
``BENCHMARK.json``: no file here needs an edit.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

#: what a ``--trace 1`` run can collect for its metrics: the runner's stats of
#: every timed sequence and the frames' stamps come with every run; ``syncs``
#: counts host syncs over the window, ``profile`` traces a part of it with the
#: host's events, ``idle`` traces a longer part on the device alone, and
#: ``stages`` profiles eager steps after it
COLLECTORS = ("syncs", "profile", "idle", "stages")


class Benchmark:
    """``BENCHMARK.json`` with its files."""

    def __init__(self, root: Path = ROOT):
        self.root = Path(root)
        with open(self.root / "BENCHMARK.json") as f:
            self.spec = json.load(f)

    def _named(self, key: str, name: str) -> dict:
        found = [e for e in self.spec[key] if e["name"] == name]
        if len(found) != 1:
            known = ", ".join(e["name"] for e in self.spec[key])
            raise KeyError(f"no {key} entry named {name!r}; known: {known}")
        return found[0]

    def workload(self, name: str) -> dict:
        return self._named("workloads", name)

    def config(self, name: str) -> dict:
        entry = self._named("configs", name)
        with open(self.root / entry["file"]) as f:
            return json.load(f)

    def traffic(self, name: str) -> dict:
        with open(self.root / "slambench" / "traffic" / f"{name}.json") as f:
            return json.load(f)

    def limits(self, workload: str) -> dict:
        """{number: {"limit", "lower", "upper"}} of the cell's check, and
        ``leaves``: {leaf of the state or the outputs: the limit of its gap};
        empty when the cell has no limits file (then no number can pass)."""
        path = self.root / "slambench" / "limits" / f"{workload}.json"
        if not path.exists():
            return {}
        with open(path) as f:
            return json.load(f)

    def end_to_end(self, workload: str) -> list[dict]:
        return [m for m in self.spec["end_to_end"]
                if workload in m.get("workloads", [workload])]

    def per_layer(self, workload: str) -> list[dict]:
        return [m for m in self.spec["per_layer"]
                if workload in m.get("workloads", [workload])]

    def readers(self, workload: str) -> dict:
        """{metric name: its reader module} of the cell's per-layer metrics."""
        return {m["name"]: load_reader(self.root, m["name"])
                for m in self.per_layer(workload)}


def load_reader(root: Path, name: str):
    """The module ``slambench/metrics/<name>.py``, loaded from its file (a
    metric's name may hold dots)."""
    path = Path(root) / "slambench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"slambench_metric_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    unknown = set(module.NEEDS) - set(COLLECTORS)
    if unknown:
        raise ValueError(f"metric {name} needs {sorted(unknown)}, which no collector makes")
    return module
