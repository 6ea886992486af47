"""Asset paths for maps and waypoints, and start poses from waypoints.

The packaged tracks live in ``red_gym_tpu/assets/data/``.  They are found
by file path, never by importing ``red_gym_tpu``: that package imports JAX.
"""

from __future__ import annotations

import glob
import os

import numpy as np

DATA_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "red_gym_tpu", "assets", "data")


def packaged_tracks() -> list[str]:
    """The sorted paths of the packaged ``track_*.yaml`` maps: the stack of
    ``examples/train_ppo.py --multi-map``."""
    paths = sorted(glob.glob(os.path.join(DATA_DIR, "track_*.yaml")))
    if not paths:
        raise FileNotFoundError(f"no packaged track_*.yaml under {DATA_DIR}")
    return paths


def named_map_yaml(name: str) -> str:
    """Path of a packaged map's yaml, e.g. ``named_map_yaml("track_0019")``."""
    path = os.path.join(DATA_DIR, f"{name}.yaml")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no packaged map {name!r} at {path}")
    return path


def waypoints_csv(track: str) -> str:
    """Waypoint CSV of a track given by name or by its map yaml path."""
    if track.endswith(".yaml"):
        path = track[: -len(".yaml")] + "_waypoints.csv"
    else:
        path = os.path.join(DATA_DIR, f"{track}_waypoints.csv")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no waypoint file {path}")
    return path


def waypoint_start_poses(track: str, num_agents: int) -> np.ndarray:
    """(A, 3) start poses on a track's centre line: agent i sits on waypoint
    row 8*i, all facing along the first waypoint segment.  For two agents
    this is the recipe of ``examples/train_ppo.py`` (rows 0 and 8), which
    puts both cars in free space on every packaged track."""
    w = np.loadtxt(waypoints_csv(track), delimiter=";", comments="#")
    if 8 * (num_agents - 1) >= w.shape[0]:
        raise ValueError(f"{num_agents} agents need {8 * (num_agents - 1) + 1} "
                         f"waypoints, the track has {w.shape[0]}")
    th = np.arctan2(w[1, 2] - w[0, 2], w[1, 1] - w[0, 1])
    return np.array([[w[8 * i, 1], w[8 * i, 2], th] for i in range(num_agents)])


def start_pose_table(tracks, num_agents: int) -> np.ndarray:
    """(M, A, 3) start poses of M tracks (names or map yaml paths), each
    track's :func:`waypoint_start_poses`: the ``randomize_starts`` table of
    a multi-map rollout, and env e's start on its map m = ``table[m]``."""
    return np.stack([waypoint_start_poses(t, num_agents) for t in tracks])
