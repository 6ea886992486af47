"""The benchmark's tests: the harness's folder, the reference's and the
repository root on the path, a tiny form of each cell for the CPU, and the
card fixture of the tests marked ``cuda``."""

import copy
import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for _p in (ROOT, os.path.join(BENCH, "reference"), BENCH):
    if _p not in sys.path:
        sys.path.insert(0, _p)


def tiny(cell):
    """The cell at a size the CPU runs in seconds: 6 envs, 60 beams, a
    coarse texture, two maps for a multi-map cell (its env steps held on
    one, drawn from the seed), rollouts of 8, a short warm-up."""
    cfg = copy.deepcopy(cell.config)
    cfg["envs"] = 6
    cfg["sim"].update({"num_beams": 60, "rt_pose_stride": 16})
    traffic = copy.deepcopy(cell.traffic)
    if "warmup_steps" in traffic:
        traffic["warmup_steps"] = 10
        traffic["check"] = {"steps": 2, "first": 1, "last": 10}
    if "ppo" in cfg:
        cfg["maps"] = ["track_0019", "track_0042"]
        cfg["ppo"]["rollout_len"] = 8
        traffic["check"] = {"steps": 2, "first": 0, "last": 8 * traffic["checked_iters"],
                            "maps": 1}
    return cell._replace(config=cfg, traffic=traffic)


@pytest.fixture
def cells():
    from harness import manifest

    m = manifest.load_manifest(ROOT)
    return {w["name"]: manifest.find_cell(m, w["name"], ROOT) for w in m["workloads"]}


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card: python -m pytest benchmark/tests -m cuda)")
    return torch.device("cuda", 0)
