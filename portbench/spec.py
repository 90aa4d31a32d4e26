"""Resolve a cell of ``BENCHMARK.json`` to its files, by name only.

- the configuration: the ``file`` that ``configs`` gives for its name;
- the traffic mix: ``portbench/mixes/<traffic>.json``;
- the configuration's ``model``: ``portbench/models/<model>.py``, its
  plain reference, weights and work (no import of the program), and
  ``portbench/systems/<model>.py``, the program's adapter (``System``);
- the mix's ``kind``: ``portbench/kinds/<kind>.py`` (``data``, ``run``,
  ``check``, ``control``);
- each per-layer metric: ``portbench/metrics/<base>.py``, where <base>
  is the metric's name before its first dot (``spmm_ms.serve`` ->
  ``spmm_ms.py``), a module with ``read(reading) -> float | None``.

A cell whose model or kind has no file is refused. So a later
configuration, model, mix, kind or metric is new files and new entries,
and no edit of a file that is already there.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Callable, List

ROOT = Path(__file__).resolve().parents[1]
HOME = "portbench"


def _module(folder: str, name: str, root: Path = ROOT) -> ModuleType:
    """``portbench/<folder>/<name>.py``, loaded from its file; LookupError
    where there is none."""
    path = Path(root) / HOME / folder / f"{name}.py"
    if not path.is_file():
        raise LookupError(f"no {HOME}/{folder}/{name}.py")
    spec = importlib.util.spec_from_file_location(f"portbench_{folder}_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    root = Path(root)
    doc = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in doc["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r}; have {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in doc["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    mix = json.loads((root / HOME / "mixes" / f"{w['traffic']}.json").read_text())
    for folder, part in (("models", config["model"]), ("systems", config["model"]),
                         ("kinds", mix["kind"])):
        if not (root / HOME / folder / f"{part}.py").is_file():
            raise LookupError(f"cell {name!r}: no {HOME}/{folder}/{part}.py")
    return Cell(
        name=name,
        chips=int(w["chips"]),
        config=config,
        mix=mix,
        end_to_end=[m for m in doc["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in doc["per_layer"] if _applies(m, name)],
    )


def model(name: str, root: Path = ROOT) -> ModuleType:
    """The model's plain reference, weights and work (``models/<name>.py``)."""
    return _module("models", name, root)


def system(name: str, root: Path = ROOT) -> ModuleType:
    """The program's adapter for the model (``systems/<name>.py``)."""
    return _module("systems", name, root)


def kind(name: str, root: Path = ROOT) -> ModuleType:
    """The traffic kind's run, check and control (``kinds/<name>.py``)."""
    return _module("kinds", name, root)


def reader(metric: str, root: Path = ROOT) -> Callable:
    """The read() of the metric's own module."""
    return _module("metrics", metric.split(".")[0], root).read
