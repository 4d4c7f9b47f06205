"""Find a cell's files by the names in ``BENCHMARK.json``.

Everything that belongs to one configuration, traffic mix, cell or
per-layer metric sits in a file of its own, found by name:

- ``portbench/configs/<config>.json``: a configuration as it is run;
- ``portbench/workloads/<cell>.json``: a cell's traffic parameters and
  the limits of its correctness checks;
- ``portbench/mixes/<mix>.py``: the generator and the loop of one kind of
  traffic, named by the cell file's ``mix``;
- ``portbench/metrics/<metric>.py``: the reader of one per-layer metric;
- ``portbench/reference/<config's arch>.py``: the plain reference.

Adding any of these is adding a file; no file here names a cell.
"""
from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from typing import Any, Dict, List

PORTBENCH = Path(__file__).resolve().parent.parent
ROOT = PORTBENCH.parent


def read_json(path: Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> Dict[str, Any]:
    return read_json(root / "BENCHMARK.json")


def load_module(path: Path, prefix: str):
    """Import the Python file ``path`` under a module name of its own
    (file names may hold ``.`` and ``-``, as metric names do)."""
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    name = f"portbench_{prefix}_" + re.sub(r"\W", "_", path.stem)
    mod_spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


class Cell:
    """One cell: its ``BENCHMARK.json`` entry, its workload file, its
    configuration file, and the metrics that it reports."""

    def __init__(self, name: str, bench: Dict[str, Any],
                 base: Path = PORTBENCH):
        entries = {w["name"]: w for w in bench["workloads"]}
        if name not in entries:
            raise KeyError(f"no cell {name!r} in BENCHMARK.json "
                           f"({sorted(entries)})")
        self.name = name
        self.base = base
        self.entry = entries[name]
        self.work = read_json(base / "workloads" / f"{name}.json")
        for key in ("config", "traffic", "chips"):
            if self.work[key] != self.entry[key]:
                raise ValueError(
                    f"{name}: workloads/{name}.json has {key}="
                    f"{self.work[key]!r}, BENCHMARK.json {self.entry[key]!r}")
        self.conf = read_json(base / "configs"
                              / f"{self.entry['config']}.json")
        self.mix_name = self.work["mix"]
        self.params = self.work["params"]
        self.limits: Dict[str, float] = self.work["limits"]
        self.end_to_end = [m for m in bench["end_to_end"] if self._has(m)]
        reported = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in bench["per_layer"]
                          if self._has(m) if m["moves"] in reported]

    def _has(self, metric: Dict[str, Any]) -> bool:
        cells = metric.get("workloads")
        return cells is None or self.name in cells

    def mix(self):
        return load_module(self.base / "mixes" / f"{self.mix_name}.py", "mix")

    def reader(self, metric: str):
        return load_module(self.base / "metrics" / f"{metric}.py", "metric")

    def reference(self):
        return load_module(self.base / "reference"
                           / f"{self.conf['arch']}.py", "reference")


def cells_of(bench: Dict[str, Any]) -> List[str]:
    return [w["name"] for w in bench["workloads"]]

