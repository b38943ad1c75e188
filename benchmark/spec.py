"""BENCHMARK.json and the files it names, resolved for one cell.

A cell ("workloads" entry) names a configuration ("configs" entry, whose
"file" is benchmark/configs/<name>.json) and a traffic mix
(benchmark/traffic/<traffic>.json: the rows' law, and under "protocol"
how the program is fed: the Config fields of the run, such as online or
resident, passed through as they stand); its limits for `correct` are
benchmark/limits/<cell>.json.  A metric applies to the cells its
"workloads" key lists, or to every cell without one.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    limits: dict
    end_to_end: list
    per_layer: list


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, name: str) -> bool:
    return "workloads" not in metric or name in metric["workloads"]


def traffic(name: str, root: str = ROOT) -> dict:
    """benchmark/traffic/<name>.json."""
    return _json(os.path.join(root, "benchmark", "traffic", name + ".json"))


def cell(name: str, root: str = ROOT) -> Cell:
    bench = _json(os.path.join(root, "BENCHMARK.json"))
    (w,) = [w for w in bench["workloads"] if w["name"] == name]
    (c,) = [c for c in bench["configs"] if c["name"] == w["config"]]
    here = os.path.join(root, "benchmark")
    return Cell(
        name=name,
        config=_json(os.path.join(root, c["file"])),
        traffic=traffic(w["traffic"], root),
        chips=w["chips"],
        limits=_json(os.path.join(here, "limits", name + ".json")),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)],
    )
