"""Simulation-state sanitizers and failure recovery for batched runs.

PyTorch counterpart of ``red_gym_tpu/utils/debug.py``.  What is worth
guarding in long batched runs: numerical blow-ups (NaN/Inf from extreme
params or dt), states escaping the map, and constraint violations.
``check_state`` returns violation counts as tensors on the state's device
(no host sync); ``explain`` turns its report into findings on the host;
``quarantine_reset`` restarts the envs that went bad, in place.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from red_gym_tpu_torch.config import SimConfig
from red_gym_tpu_torch.env import EnvParams, EnvState, Observation
from red_gym_tpu_torch.rollout import _env_maps, reset_done


def check_state(cfg: SimConfig, params: EnvParams, state: EnvState
                ) -> Dict[str, torch.Tensor]:
    """Violation counts over a batched EnvState; every entry is an integer
    count (0 == healthy).

    The map extents come from the params' one map; from a map stack, each
    env's map through ``state.map_idx``; or, when the maps carry a leading
    env axis (``rollout`` under ``map_axis=0``, ``map_idx`` None), env e's
    from map e."""
    x = state.x
    p = params.vehicle
    nonfinite = torch.sum(~torch.isfinite(x))

    # pose inside the map rectangle (world frame, per true map extents)
    t = params.tmap
    if t.dt.dim() == 3:
        if state.map_idx is not None:
            sel = lambda leaf: leaf[state.map_idx.long()][:, None]  # noqa: E731
        else:
            sel = lambda leaf: leaf[:, None]  # noqa: E731
        t = t._replace(**{f: sel(getattr(t, f)) for f in
                          ("orig_x", "orig_y", "orig_c", "orig_s", "resolution",
                           "height", "width")})
    xt = x[..., 0] - t.orig_x
    yt = x[..., 1] - t.orig_y
    xr = xt * t.orig_c + yt * t.orig_s
    yr = -xt * t.orig_s + yt * t.orig_c
    w_m = t.width.to(xr.dtype) * t.resolution
    h_m = t.height.to(yr.dtype) * t.resolution
    off_map = torch.sum((xr < 0) | (xr > w_m) | (yr < 0) | (yr > h_m))

    eps = 1e-4
    over_speed = torch.sum((x[..., 3] > p.v_max + eps) | (x[..., 3] < p.v_min - eps))
    over_steer = torch.sum((x[..., 2] > p.s_max + eps) | (x[..., 2] < p.s_min - eps))
    bad_yaw = torch.sum((x[..., 4] < -2 * math.pi) | (x[..., 4] > 4 * math.pi))
    bad_clock = torch.sum(state.current_time < 0) + torch.sum(state.lap_times < 0)
    return {"nonfinite": nonfinite, "off_map": off_map,
            "over_speed": over_speed, "over_steer": over_steer,
            "bad_yaw": bad_yaw, "bad_clock": bad_clock}


def explain(report: Dict[str, torch.Tensor]) -> list[str]:
    """Host-side: the nonzero findings of a check_state report."""
    return [f"{k}: {int(v)} violations" for k, v in report.items() if int(v) > 0]


def env_health_mask(state: EnvState, max_abs_x: float = 1e4) -> torch.Tensor:
    """Per-env health (E,) bool of a batched EnvState: an env is unhealthy
    iff any of its floating-point state fields carries a non-finite value,
    or its dynamic state ``x`` exceeds ``max_abs_x`` in magnitude.  The
    stiff single-track yaw/slip feedback passes through a huge but finite
    stage (|yaw_rate| ~1e35) for several steps before the first NaN, and
    rewards and observations are already poisoned there.  The bound applies
    to ``x`` only: clocks and lap times grow without bound in long runs."""
    e_n = state.x.shape[0]
    bad = torch.zeros(e_n, dtype=torch.bool, device=state.x.device)
    for leaf in state:
        if leaf is None or not leaf.is_floating_point() or leaf.dim() == 0:
            continue
        bad |= ~torch.isfinite(leaf.reshape(e_n, -1)).all(dim=1)
    bad |= (state.x.abs() > max_abs_x).reshape(e_n, -1).any(dim=1)
    return ~bad


def quarantine_reset(cfg: SimConfig, params: EnvParams, state: EnvState,
                     obs: Observation, gen: torch.Generator, map_axis=None):
    """Restart every unhealthy env (``env_health_mask``) from its start pose,
    in place; healthy envs are untouched.  -> (state', obs', healthy (E,)).

    A start pose that is itself non-finite restarts at the origin (the env
    stays flagged in the mask).  ``map_axis=0`` as in ``rollout``: env e is
    on map e of the params.  Only the unhealthy envs are stepped, as
    ``rollout.reset_done`` restarts done envs; it reads the mask on the
    host."""
    healthy = env_health_mask(state)
    maps = _env_maps(params, map_axis, state.x.shape[0], state.x.device)
    safe = torch.where(torch.isfinite(state.start_pose), state.start_pose,
                       torch.zeros_like(state.start_pose))
    work = state._replace(start_pose=safe)
    if maps is not None:
        work = work._replace(map_idx=maps)
    fixed, obs, _ = reset_done(cfg, params, work, obs, ~healthy, gen)
    # a healthy env's start pose is finite, so ``safe`` kept it as it was
    return fixed._replace(map_idx=state.map_idx), obs, healthy


def assert_healthy(cfg: SimConfig, params: EnvParams, state: EnvState):
    """Host-side hard assert (it syncs the host: use it at episode
    boundaries, not in the hot loop)."""
    findings = explain(check_state(cfg, params, state))
    if findings:
        raise AssertionError("unhealthy sim state: " + "; ".join(findings))
