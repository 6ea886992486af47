"""The inputs a run makes from its configuration and its seed: the maps'
files, the cars' start poses, the simulator's settings, and the policy's
first weights.  Both the program and the reference are handed these."""

from __future__ import annotations

import glob
import math
import os

import numpy as np

MAP_DIR = os.path.join("red_gym_tpu", "assets", "data")   # raw files, read by path


def map_paths(config: dict, root: str) -> list[str]:
    """The map yamls of a configuration: ``maps`` is a list of map names,
    or a glob of names (``"track_*"``), under the packaged map folder."""
    paths = []
    for name in config["maps"]:
        found = sorted(glob.glob(os.path.join(root, MAP_DIR, f"{name}.yaml")))
        if not found:
            raise FileNotFoundError(f"no map {name!r} under {MAP_DIR}")
        paths += found
    return paths


def start_poses(yaml_path: str, num_agents: int, rows_apart: int) -> np.ndarray:
    """(A, 3) start poses on a track's waypoints: agent i on waypoint row
    ``rows_apart * i``, all facing along the first waypoint segment."""
    w = np.loadtxt(yaml_path[: -len(".yaml")] + "_waypoints.csv", delimiter=";",
                   comments="#")
    th = np.arctan2(w[1, 2] - w[0, 2], w[1, 1] - w[0, 1])
    return np.array([[w[rows_apart * i, 1], w[rows_apart * i, 2], th]
                     for i in range(num_agents)])


def sim_settings(config: dict, config_cls, integrator_cls):
    """The simulator's configuration object of either side (the program's or
    the reference's ``SimConfig``) from the configuration file's ``sim``."""
    kw = dict(config["sim"])
    kw["integrator"] = getattr(integrator_cls, kw["integrator"])
    return config_cls(**kw)


def policy_weights(shapes: dict, seed: int, device) -> dict:
    """The policy's first weights, drawn on the device from the seed in one
    call: each matrix (out, in) N(0, 1/in), biases 0, ``log_std`` -0.5."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    mats = {k: s for k, s in shapes.items() if len(s) == 2}
    draw = torch.randn(sum(math.prod(s) for s in mats.values()), generator=gen,
                       device=device)
    out, off = {}, 0
    for name, shape in shapes.items():
        if name in mats:
            n = math.prod(shape)
            out[name] = draw[off:off + n].view(shape) / math.sqrt(shape[1])
            off += n
        elif name.endswith("log_std"):
            out[name] = torch.full(shape, -0.5, device=device)
        else:
            out[name] = torch.zeros(shape, device=device)
    return out
