"""Finding a cell's parts by name: its entry in ``BENCHMARK.json``, its
configuration file, its traffic mix (``benchmark/traffic/<mix>.json``),
the frame kind the mix names (``benchmark/frames/<kind>.py``), its
per-layer metric readers (``benchmark/metrics/<metric>.py``) and its
comparison limits (``benchmark/limits/<cell>.json``). Adding a cell adds
files and entries; no file here changes.

Data (``BENCHMARK.json``, configurations, mixes, limits) is read under a
root, the checkout by default; code (frame kinds, metric readers) always
comes from this benchmark's own folder."""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
from types import ModuleType
from typing import Callable, Dict, List

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
BENCH_NAME = os.path.basename(BENCH_DIR)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict
    limits: Dict[str, float]
    end_to_end: List[dict]
    per_layer: List[dict]


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def _json(path: str):
    with open(path) as f:
        return json.load(f)


def load(workload: str, root: str = ROOT) -> Cell:
    bench = _json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"unknown workload {workload!r}; have {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    data = os.path.join(root, BENCH_NAME)
    limits = _json(os.path.join(data, "limits", f"{workload}.json"))["limits"]
    return Cell(name=workload, chips=int(w["chips"]),
                config=_json(os.path.join(root, configs[w["config"]]["file"])),
                mix=_json(os.path.join(data, "traffic", f"{w['traffic']}.json")),
                limits={k: float(v) for k, v in limits.items()},
                end_to_end=[m for m in bench["end_to_end"] if _applies(m, workload)],
                per_layer=[m for m in bench["per_layer"] if _applies(m, workload)])


def _module(folder: str, name: str) -> ModuleType:
    path = os.path.join(BENCH_DIR, folder, f"{name}.py")
    if not os.path.exists(path):
        raise KeyError(f"no {folder} module {name!r} at {path}")
    spec = importlib.util.spec_from_file_location(f"bench_{folder}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def frames(kind: str) -> ModuleType:
    """``benchmark/frames/<kind>.py``: the frame kind a mix names."""
    return _module("frames", kind)


def reader(metric: str) -> Callable[[dict], object]:
    """The ``read(record)`` function of ``benchmark/metrics/<metric>.py``."""
    return _module("metrics", metric).read
