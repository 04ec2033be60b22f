"""What the benchmark reads from its files, found by the names in
`BENCHMARK.json`.

* a configuration: the file that its entry names (`perfbench/configs/
  <config>.json`), and its plain reference, `perfbench/reference/
  <config>.py`;
* a traffic mix: `perfbench/traffic/<traffic>.json`, parameters that its
  runner reads; the runner is `perfbench/runners/<task>_<kind>.py`, by
  the configuration's `task` and the traffic's `kind`;
* an end-to-end metric: `perfbench/end_to_end/<metric>.py`, and a
  per-layer metric: `perfbench/metrics/<metric>.py`, each with a
  `read(ctx)` that returns the value (a per-layer reader None where it
  finds nothing to read);
* a cell's correctness limits: `perfbench/limits/<workload>.json`.

A configuration, a cell or a per-layer metric is added by adding such
files and entries; no file here changes.
"""

from __future__ import annotations

import importlib.util
import json
import re
import sys
from dataclasses import dataclass
from pathlib import Path

PACKAGE = Path(__file__).resolve().parent
ROOT = PACKAGE.parent


def _module_name(kind, name):
    return f"perfbench.{kind}.{re.sub(r'[^0-9A-Za-z_]', '_', name)}"


def load_module(path, module_name):
    """Import the file at `path` as `module_name` (once per process)."""
    if module_name in sys.modules:
        return sys.modules[module_name]
    spec = importlib.util.spec_from_file_location(module_name, path)
    if spec is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[module_name] = module
    try:
        spec.loader.exec_module(module)
    except BaseException:
        del sys.modules[module_name]
        raise
    return module


def _read_json(path):
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    """One workload of `BENCHMARK.json` with everything it reads."""

    name: str
    chips: int
    config_entry: dict
    config: dict          # the configuration file's content
    traffic: dict         # the traffic mix's parameters
    limits: dict          # {number: limit} of the correctness check
    end_to_end: list      # the metric entries this cell reports
    per_layer: list
    root: Path

    @property
    def reference(self):
        """The configuration's plain reference module."""
        name = self.config_entry["name"]
        import perfbench.reference  # noqa: F401  (the package first)
        return load_module(
            self.root / "perfbench" / "reference" / f"{name}.py",
            _module_name("reference", name))

    def _found(self, kind, name):
        return load_module(self.root / "perfbench" / kind / f"{name}.py",
                           _module_name(kind, name))

    @property
    def runner(self):
        """The class that drives this cell's traffic."""
        return self._found(
            "runners", f"{self.config['task']}_{self.traffic['kind']}").Runner

    def end_to_end_reader(self, name):
        return self._found("end_to_end", name)

    def metric_reader(self, name):
        return self._found("metrics", name)


def _reports(metric, workload):
    return "workloads" not in metric or workload in metric["workloads"]


def load_cell(workload, root=ROOT):
    """The cell `workload` of the `BENCHMARK.json` under `root`."""
    root = Path(root)
    bench = _read_json(root / "BENCHMARK.json")
    entries = {w["name"]: w for w in bench["workloads"]}
    if workload not in entries:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; it "
                       f"has {sorted(entries)}")
    w = entries[workload]
    config_entry = next(c for c in bench["configs"]
                        if c["name"] == w["config"])
    limits_path = root / "perfbench" / "limits" / f"{workload}.json"
    return Cell(
        name=workload,
        chips=int(w["chips"]),
        config_entry=config_entry,
        config=_read_json(root / config_entry["file"]),
        traffic=_read_json(root / "perfbench" / "traffic"
                           / f"{w['traffic']}.json"),
        limits=_read_json(limits_path) if limits_path.exists() else {},
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, workload)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, workload)],
        root=root,
    )
