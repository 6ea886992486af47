"""BENCHMARK.json and every file its cells name, found by name; a cell
added by files and entries alone."""

import json
import os
import re
import shutil

from conftest import BENCH, ROOT

from harness import manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_every_cell_finds_its_files(cells):
    m = manifest.load_manifest(ROOT)
    assert [w["name"] for w in m["workloads"]] == ["fast_default.random",
                                                    "ppo_multimap.train"]
    for name, cell in cells.items():
        assert cell.traffic["runner"] in ("sim", "train")
        assert cell.limits, name
        assert any(e["name"] == "setup_s" for e in cell.end_to_end)
        assert len(cell.end_to_end) >= 2 and cell.per_layer, name
        for metric in cell.per_layer:
            assert callable(manifest.reader(cell.bench_dir, metric["name"]))


def test_manifest_keeps_the_contract():
    m = manifest.load_manifest(ROOT)
    assert set(m) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in m[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in m["configs"]:
        path = os.path.join(ROOT, c["file"])
        assert os.path.exists(path) and c["file"].startswith(m["paths"][0] + "/")
        reduced = json.load(open(path)).get("reduced", {})
        assert sorted(reduced) == sorted(c["reduced"])
    for e in m["end_to_end"] + m["per_layer"]:
        assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
    layers = {e["layer"] for e in m["per_layer"]}
    assert all("\n" not in x and len(x) <= 200 for x in layers)
    bounds = {e["name"]: e["bound"] for e in m["end_to_end"]}
    assert bounds["setup_s"] <= 0.25 and all(0.01 <= b <= 0.25 for b in bounds.values())
    moves = {e["name"] for e in m["end_to_end"]}
    assert all(e["moves"] in moves for e in m["per_layer"])


def test_a_cell_is_added_by_files_and_entries(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    m = manifest.load_manifest(ROOT)
    bench = root / "benchmark"
    cfg = json.load(open(bench / "configs" / "fast_default.json"))
    cfg["envs"] = 1024
    json.dump(cfg, open(bench / "configs" / "fast_small.json", "w"))
    json.dump({"runner": "sim", "policy": {"steer": 0.2, "speed": [1.0, 4.0]},
               "warmup_steps": 5, "trace_steps": 50,
               "check": {"steps": 1, "first": 5, "last": 40}},
              open(bench / "traffic" / "calm.json", "w"))
    json.dump({"scan_p99_m": 1e-3}, open(bench / "limits" / "fast_small.calm.json", "w"))
    (bench / "metrics" / "steps.calm.py").write_text(
        "def read(run):\n    return float(run.counters['steps'])\n")
    m["configs"].append({"name": "fast_small", "source": "https://example.org/x",
                         "file": "benchmark/configs/fast_small.json", "reduced": [],
                         "why": "w"})
    m["workloads"].append({"name": "fast_small.calm", "config": "fast_small",
                           "traffic": "calm", "chips": 1, "why": "w"})
    m["end_to_end"][0]["workloads"].append("fast_small.calm")
    m["per_layer"].append({"name": "steps.calm", "unit": "steps", "better": "higher",
                           "source": "program_counter", "layer": "rollout",
                           "moves": "env_steps_per_s", "workloads": ["fast_small.calm"]})
    json.dump(m, open(root / "BENCHMARK.json", "w"))
    cell = manifest.find_cell(manifest.load_manifest(str(root)), "fast_small.calm",
                              str(root))
    assert cell.config["envs"] == 1024 and cell.traffic["policy"]["steer"] == 0.2
    assert cell.limits == {"scan_p99_m": 1e-3}
    assert [e["name"] for e in cell.per_layer] == ["steps.calm"]
    assert sorted(e["name"] for e in cell.end_to_end) == ["env_steps_per_s", "setup_s"]
    read = manifest.reader(cell.bench_dir, "steps.calm")
    assert read(type("R", (), {"counters": {"steps": 7}})()) == 7.0
