"""Find a cell and everything it names, by name.

A cell (an entry of ``BENCHMARK.json``'s ``workloads``) names a
configuration (``configs[].file``, a JSON file), a traffic mix
(``traffic/<mix>.json``), and, through ``per_layer``, the metrics it
reports (``metrics/<metric>.py``, each a reader with a ``read(run)``
function).  Its limits are ``limits/<cell>.json``.  A later cell adds files
and entries; nothing here names a cell.
"""

from __future__ import annotations

import importlib.util
import json
import os
from typing import NamedTuple

class Cell(NamedTuple):
    name: str
    bench_dir: str        # the benchmark's folder: metrics/, traffic/, limits/
    chips: int
    config: dict          # the configuration file's contents
    traffic: dict         # the traffic mix's parameters
    limits: dict          # {number: limit} of the comparison that decides correct
    end_to_end: list      # BENCHMARK.json's metric entries this cell reports
    per_layer: list


def load_manifest(root: str) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _reports(metric: dict, cell: str, reported: set | None = None) -> bool:
    """Whether ``cell`` reports ``metric``: listed in its ``workloads``, or,
    without that key, reported wherever its end-to-end metric is."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return reported is None or metric.get("moves") in reported


def read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def find_cell(manifest: dict, name: str, root: str) -> Cell:
    """The cell ``name`` of the manifest with its files read; KeyError if
    the manifest has no such cell."""
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: {sorted(cells)}")
    w = cells[name]
    bench_dir = os.path.join(root, manifest["paths"][0])
    configs = {c["name"]: c for c in manifest["configs"]}
    config = read_json(os.path.join(root, configs[w["config"]]["file"]))
    traffic = read_json(os.path.join(bench_dir, "traffic", f"{w['traffic']}.json"))
    limits = read_json(os.path.join(bench_dir, "limits", f"{name}.json"))
    e2e = [m for m in manifest["end_to_end"] if _reports(m, name)]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in manifest["per_layer"] if _reports(m, name, reported)]
    return Cell(name, bench_dir, int(w["chips"]), config, traffic, limits, e2e, per_layer)


def reader(bench_dir: str, metric: str):
    """The ``read`` function of ``metrics/<metric>.py``."""
    path = os.path.join(bench_dir, "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(f"metric_{metric.replace('.', '_')}",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
