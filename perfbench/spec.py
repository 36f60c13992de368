"""What a cell is made of, found by name from ``BENCHMARK.json``.

Every part of a cell is a file of its own under ``perfbench/``:

- the configuration: the JSON file that ``BENCHMARK.json`` names for it;
- the traffic mix: ``traffic/<traffic>.json``, whose ``pass`` names the
  window's pass, ``passes/<pass>.py``;
- each per-layer metric: its reader, ``metrics/<name>.py``;
- each host span the traced passes record inside the program:
  ``spans/<span>.json``;
- the limits of the numbers that decide ``correct``: ``limits.json``.

A later cell or metric is new files and new entries, and no edit.
"""

from __future__ import annotations

import dataclasses
import glob
import importlib.util
import json
import os
from typing import Dict, List

__all__ = ["Cell", "ROOT", "load_benchmark", "load_cell", "load_module", "load_spans",
           "load_limits", "BLOCKED_MODULES"]

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = "perfbench"
#: top-level module names that no process of the benchmark may load
BLOCKED_MODULES = ("jax", "jaxlib", "flax", "tissue_analysis_tpu")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    root: str


def _read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_benchmark(root: str = ROOT) -> dict:
    return _read_json(os.path.join(root, "BENCHMARK.json"))


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: str = ROOT) -> Cell:
    """The cell ``name`` of the ``BENCHMARK.json`` under ``root``."""
    bench = load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; it has {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _read_json(os.path.join(root, configs[w["config"]]["file"]))
    traffic = _read_json(os.path.join(root, HERE, "traffic", w["traffic"] + ".json"))
    return Cell(
        name=name, chips=int(w["chips"]),
        config=config, traffic=traffic,
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)],
        root=root,
    )


def load_module(kind: str, name: str, root: str = ROOT):
    """``perfbench/<kind>/<name>.py`` under ``root``, loaded as a module."""
    path = os.path.join(root, HERE, kind, name + ".py")
    if not os.path.exists(path):
        raise FileNotFoundError(f"{kind} {name!r} has no file {path}")
    spec = importlib.util.spec_from_file_location(f"perfbench_{kind}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_spans(root: str = ROOT) -> Dict[str, str]:
    """{span name: "module:attribute"} of every ``spans/<span>.json``."""
    out = {}
    for path in sorted(glob.glob(os.path.join(root, HERE, "spans", "*.json"))):
        out[os.path.basename(path)[:-5]] = _read_json(path)["target"]
    return out


def load_limits(root: str = ROOT) -> Dict[str, float]:
    """The limit of each number compared (``limits.json``)."""
    return {k: v["limit"] for k, v in _read_json(os.path.join(root, HERE, "limits.json")).items()}
