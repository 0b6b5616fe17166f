"""``BENCHMARK.json`` and the files its names lead to.

A cell names a configuration (``configs/<config>.json``, by the file the
manifest gives it) and a traffic mix (``traffic/<mix>.json``).  Each
metric of a cell is one of the manifest's end-to-end metrics or one of
its per-layer metrics, whose reader is ``metrics/<metric>.py``.  A new
configuration, mix or metric is a new file and a new entry; no file here
changes.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import List

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


@dataclasses.dataclass
class Cell:
    name: str
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    chips: int
    end_to_end: List[dict]
    per_layer: List[dict]


def load_manifest(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _reports(metric: dict, cell: str, e2e_names) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    # a per-layer metric without a list goes wherever what it moves goes
    return metric.get("moves", metric["name"]) in e2e_names


def cell(name: str, manifest: dict, root: Path = ROOT) -> Cell:
    work = {w["name"]: w for w in manifest["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r}; the manifest has "
                       f"{sorted(work)}")
    w = work[name]
    cfg = {c["name"]: c for c in manifest["configs"]}[w["config"]]
    e2e = [m for m in manifest["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    names = {m["name"] for m in e2e}
    return Cell(
        name=name, config_name=w["config"],
        config=json.loads((root / cfg["file"]).read_text()),
        traffic_name=w["traffic"],
        traffic=json.loads(
            (BENCH / "traffic" / f"{w['traffic']}.json").read_text()),
        chips=int(w["chips"]), end_to_end=e2e,
        per_layer=[m for m in manifest["per_layer"]
                   if _reports(m, name, names)])


def reader(metric: dict):
    """The module that reads a per-layer metric; its ``UNIT``, ``LAYER``
    and ``MOVES`` must be the manifest's."""
    name = metric["name"]
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for attr, key in (("UNIT", "unit"), ("LAYER", "layer"),
                      ("MOVES", "moves")):
        if getattr(mod, attr) != metric[key]:
            raise ValueError(f"{path.name}: {attr} {getattr(mod, attr)!r} "
                             f"is not the manifest's {metric[key]!r}")
    return mod
