"""Finds every part of the benchmark by the name ``BENCHMARK.json`` gives it.

- a cell ``workloads[i]`` names a configuration and a traffic mix;
- ``configs/<config>.json`` is the configuration as it is run (the port's
  ``PipelineConfig`` under ``"pipeline"``, the scene under ``"scene"``);
- ``traffic/<mix>.json`` is the mix's parameters; its ``"driver"`` names
  ``drivers/<driver>.py``, its scene maker ``scenes/<kind>.py`` is named by
  the configuration's ``scene.kind``;
- ``end_to_end/<metric>.py`` and ``layer_metrics/<metric>.py`` each hold a
  ``read(record)`` for one metric;
- ``limits/<cell>.json`` holds the limits of the numbers that decide
  ``correct`` in that cell.

A later change adds a configuration, a mix, a driver or a metric by adding
its file and its entry; no file here changes.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_benchmark(root: Path = ROOT) -> Dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def read_json(path: Path) -> Dict:
    return json.loads(path.read_text())


def module(path: Path) -> ModuleType:
    """The Python file at ``path`` as a module (names with dots allowed)."""
    if not path.is_file():
        raise FileNotFoundError(f"no file {path}")
    name = "portbench_" + "_".join(path.relative_to(HERE).with_suffix(
        "").parts).replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One entry of ``workloads`` with everything it names, resolved."""

    def __init__(self, name: str, bench: Dict, here: Path = HERE):
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                           f"(have {sorted(cells)})")
        self.name = name
        self.entry = cells[name]
        configs = {c["name"]: c for c in bench["configs"]}
        self.config_entry = configs[self.entry["config"]]
        self.config = read_json(ROOT / self.config_entry["file"])
        self.mix = read_json(here / "traffic" / f"{self.entry['traffic']}.json")
        self.driver = module(here / "drivers" / f"{self.mix['driver']}.py")
        self.scene = module(here / "scenes"
                            / f"{self.config['scene']['kind']}.py")
        self.limits = read_json(here / "limits" / f"{name}.json")
        self.chips = int(self.entry["chips"])
        self.end_to_end = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        self.per_layer = [m for m in bench["per_layer"] if reports(m, self)]

    def readers(self, kind: str, metrics: List[Dict]) -> Dict[str, ModuleType]:
        return {m["name"]: module(HERE / kind / f"{m['name']}.py")
                for m in metrics}


def reports(metric: Dict, cell: Cell) -> bool:
    """Whether ``cell`` reports a per-layer metric: listed in its
    ``workloads``, or, without that key, in every cell that reports the
    end-to-end metric it moves."""
    if "workloads" in metric:
        return cell.name in metric["workloads"]
    return any(m["name"] == metric["moves"] for m in cell.end_to_end)
