"""High-level path-planning environment: the SACF110Env equivalent.

PyTorch counterpart of ``red_gym_tpu/agents/planning_env.py``.  The RL
action is a 16-D vector decoded into 8 angle-clamped unit path segments,
tracked by a low-level MPC, with bitmap-derived rewards (reference:
src/SAL.py:30-269).  The pipeline (action decode, spline/QP MPC, env step,
rasterization, rewards) runs over a batch of E envs: ``reset(poses (E, A,
3), gen)`` and ``step(ps, raw_action (E, 16), gen)``, where the JAX package
writes one env and vmaps it.  On the card each planning step launches the
exact scan's march kernel once (``env.step``) and the rasterizer's fill and
segment kernels once each (the FILL bitmap of every env).  Its sections
are spans (``utils/profiling.span``): ``plan/mpc`` (decode, path, MPC),
``plan/env_step``, ``plan/bitmap`` and ``plan/reward``.

Faithful semantic notes (as in the JAX package):
  * the reference's MPC_controller simulates 10 internal steps but only
    u[0] is applied (SAL.py:183-217); u[0] depends only on the first QP
    solve, so the MPC solves with total_steps=1;
  * path replan fires when the path index reaches the end of the 8-point
    path or at the first step (SAL.py:108-110);
  * rewards: progress*10, bitmap-collision -100, centerline*2, lap bonus
    (SAL.py:219-250), summed in float64 and cast to float32 last, as the
    JAX package's sum comes out with 64-bit types enabled.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from red_gym_tpu_torch import env as envlib, rollout
from red_gym_tpu_torch.agents import mpc
from red_gym_tpu_torch.config import SimConfig, resolve_device
from red_gym_tpu_torch.env import EnvParams, EnvState, Observation
from red_gym_tpu_torch.ops import bitmap_rewards as br
from red_gym_tpu_torch.ops.rasterize import lidar_to_bitmap
from red_gym_tpu_torch.utils.profiling import span

NUM_SEGMENTS = 8
ACTION_DIM = 16           # reshaped (8, 2) like the reference decode
PATH_LEN = NUM_SEGMENTS   # decoded path points


class PlanConfig(NamedTuple):
    car_length: torch.Tensor          # 0.3 (SAL.py:56)
    vector_length: torch.Tensor       # 0.5
    dist_threshold: torch.Tensor      # 0.2 waypoint reach radius
    max_angle_diff_deg: torch.Tensor  # 10.0
    map_scale: torch.Tensor           # 10 px/m (SAL.py:66)
    bitmap_dims: tuple = (256, 256)


def default_plan_config(dtype=torch.float32) -> PlanConfig:
    """The SAL planning constants, 0-d tensors on the CPU; ``PlanningEnv``
    moves them to its env's device."""
    t = lambda v: torch.as_tensor(v, dtype=dtype)  # noqa: E731
    return PlanConfig(car_length=t(0.3), vector_length=t(0.5), dist_threshold=t(0.2),
                      max_angle_diff_deg=t(10.0), map_scale=t(10.0))


class PlanState(NamedTuple):
    """The planning state of E envs."""

    env_state: EnvState
    obs: Observation
    bitmap: torch.Tensor      # (E, H, W) uint8 FILL bitmap of the last scan
    path: torch.Tensor        # (E, PATH_LEN, 2) world-frame waypoints
    sub_index: torch.Tensor   # (E,) int32 current waypoint pointer
    prev_pos: torch.Tensor    # (E, 2) position at the last step


def decode_action(raw_action, pcfg: PlanConfig):
    """16-D actions (E, 16) -> 8 angle-clamped unit vectors (E, 8, 2)
    (reference compute_vectors_with_angle_clamp, SAL.py:585-608): each
    segment's angle within max_angle_diff_deg of the one before, the first
    (1, 0)."""
    e_n = raw_action.shape[0]
    v = raw_action.reshape(e_n, NUM_SEGMENTS, 2)
    v = v / (torch.linalg.vector_norm(v, dim=-1, keepdim=True) + 1e-8)
    max_diff = pcfg.max_angle_diff_deg * (math.pi / 180)      # jnp.deg2rad
    prev = torch.zeros((e_n,), dtype=v.dtype, device=v.device)
    out = [torch.tensor([1.0, 0.0], dtype=v.dtype, device=v.device).expand(e_n, 2)]
    for i in range(1, NUM_SEGMENTS):
        desired = torch.atan2(v[:, i, 1], v[:, i, 0])
        diff = torch.remainder(desired - prev + math.pi, 2 * math.pi) - math.pi
        prev = prev + torch.clamp(diff, -max_diff, max_diff)
        out.append(torch.stack([torch.cos(prev), torch.sin(prev)], dim=-1))
    return torch.stack(out, dim=1)


def build_path(increments, car_pose, pcfg: PlanConfig):
    """Local increments (E, 8, 2) -> global paths (E, 8, 2) starting at each
    car's nose, car_pose (E, 3) (reference _calculate_global_path,
    SAL.py:157-181).  The nose and the rotated steps fuse one product into
    their sums (``addcmul``), as XLA's CPU code does, so paths equal the
    JAX package's bit for bit."""
    x, y, th = car_pose[:, 0], car_pose[:, 1], car_pose[:, 2]
    c, s = torch.cos(th), torch.sin(th)
    front = torch.stack([torch.addcmul(x, pcfg.car_length, c),
                         torch.addcmul(y, pcfg.car_length, s)], dim=-1)
    d = increments * pcfg.vector_length
    c, s = c[:, None], s[:, None]
    gdx = torch.addcmul(-(d[..., 1] * s), d[..., 0], c)
    gdy = torch.addcmul(d[..., 1] * c, d[..., 0], s)
    steps = torch.stack([gdx, gdy], dim=-1)
    return front[:, None, :] + torch.cumsum(steps, dim=1)


def _world_to_pixel(x, y, pcfg: PlanConfig):
    px = torch.clamp((128 + x * pcfg.map_scale).to(torch.int32), 0, 255)
    py = torch.clamp((128 + y * pcfg.map_scale).to(torch.int32), 0, 255)
    return px, py


def _on(nt: NamedTuple, device) -> NamedTuple:
    return type(nt)(*(v.to(device) if isinstance(v, torch.Tensor) else v for v in nt))


class PlanningEnv:
    """Batched SACF110Env: ``step(ps, raw_action, gen) -> (ps', bitmap, reward,
    done, info)`` for E envs at once."""

    def __init__(self, cfg: SimConfig, env_params: EnvParams,
                 pcfg: PlanConfig | None = None,
                 mcfg: mpc.MPCConfig | None = None,
                 reward_mode: str = "sal", device="cuda"):
        """``reward_mode``:

        * "sal"   — reference-faithful (default): collision/centering are
          probed at _world_to_pixel of the ABSOLUTE pose, reproducing the
          reference's world-coord-as-pixel quirk (SAL.py:229-243) — the
          probe leaves the bitmap's black center square as soon as the car
          is ~0.2 m from the world origin, after which the -100 collision
          penalty fires almost every step.
        * "fixed" — the same reward terms with physically-meaningful
          probes: collision = the env's actual collision flag (iTTC/body),
          centering evaluated at the car's true position in its own lidar
          bitmap (the center).  Use for training that needs a sane signal.

        ``device`` (the card unless the caller passes "cpu") must be the
        device of ``env_params``.  The condensed QP of the MPC and its
        Cholesky factor are built here, once."""
        if reward_mode not in ("sal", "fixed"):
            raise ValueError(f"reward_mode must be 'sal'|'fixed', got "
                             f"{reward_mode!r}")
        device = resolve_device(device)
        params_dev = env_params.tables.beam_cosines.device
        if params_dev.type != device.type or (
                device.index is not None and params_dev.index != device.index):
            raise ValueError(f"env_params are on {params_dev}, the env on {device}")
        self.cfg = cfg
        self.env_params = env_params
        self.device = params_dev
        self.pcfg = _on(pcfg or default_plan_config(cfg.tdtype), params_dev)
        self.mcfg = _on(mcfg or mpc.default_mpc_config(cfg.tdtype), params_dev)
        self.reward_mode = reward_mode
        m = self.mcfg
        self.qp = mpc.condensed_qp(m.timestep, m.Q, m.R, m.Qf, m.horizon)

    def _bitmap(self, scan):
        return lidar_to_bitmap(scan, bg_color="black", draw_mode="FILL",
                               output_image_dims=self.pcfg.bitmap_dims)

    def _initial(self, env_state: EnvState, obs: Observation) -> PlanState:
        """The plan state right after a reset step: the first bitmap, no
        path yet (sub_index at its end forces a replan)."""
        ego, e_n = self.cfg.ego_idx, obs.scans.shape[0]
        dev = obs.scans.device
        return PlanState(
            env_state=env_state, obs=obs, bitmap=self._bitmap(obs.scans[:, ego]),
            path=torch.zeros((e_n, PATH_LEN, 2), dtype=self.cfg.tdtype, device=dev),
            sub_index=torch.full((e_n,), PATH_LEN, dtype=torch.int32, device=dev),
            prev_pos=torch.stack([obs.poses_x[:, ego], obs.poses_y[:, ego]], dim=-1))

    def reset(self, poses, gen) -> PlanState:
        """Reset E envs at poses (E, A, 3) (reference default pose,
        SAL.py:69-89)."""
        env_state, obs, *_ = envlib.reset(self.cfg, self.env_params, poses, gen)
        return self._initial(env_state, obs)

    def reset_done(self, ps: PlanState, done, gen):
        """Restart the envs with ``done`` from their start poses -> (ps,
        reset_any): only those envs are reset (one zero-action env step and
        one bitmap), as ``rollout.reset_done`` restarts env states; the
        others keep ``ps``.  The JAX trainer resets every env and keeps the
        done ones; the results agree up to the scan-noise draws.  Reads
        ``done`` on the host."""
        idx = torch.nonzero(done).squeeze(1)
        if not idx.numel():
            return ps, False
        st = ps.env_state
        r_state, r_obs, *_ = envlib.reset_unchecked(
            self.cfg, self.env_params, st.start_pose[idx], gen,
            None if st.map_idx is None else st.map_idx[idx])
        return rollout._select(self._initial(r_state, r_obs), ps, idx), True

    def step(self, ps: PlanState, raw_action, gen):
        """One planning step of every env: replan where the path is used
        up, one MPC control, one env step, the new bitmap and the reward on
        the previous one -> (ps', bitmap, reward (E,) float32, done (E,),
        info)."""
        cfg, pcfg, mcfg = self.cfg, self.pcfg, self.mcfg
        ego, obs = cfg.ego_idx, ps.obs
        e_n = obs.scans.shape[0]
        car_pose = torch.stack([obs.poses_x[:, ego], obs.poses_y[:, ego],
                                obs.poses_theta[:, ego]], dim=-1)

        with span("plan/mpc"):
            # replan when the path is exhausted (SAL.py:108-110)
            need = ps.sub_index >= PATH_LEN
            new_path = build_path(decode_action(raw_action.to(cfg.tdtype), pcfg), car_pose,
                                  pcfg)
            path = torch.where(need[:, None, None], new_path, ps.path)
            sub_index = torch.where(need, torch.zeros_like(ps.sub_index), ps.sub_index)

            # low-level MPC on the current path (u[0] only; see module note)
            vx, vy = obs.linear_vels_x[:, ego], obs.linear_vels_y[:, ego]
            u = mpc.mpc_controller(path, mcfg.desired_velocity, mcfg.timestep, mcfg.Q, mcfg.R,
                                   mcfg.Qf, total_steps=1, horizon=mcfg.horizon,
                                   current_vel_x=vx, current_vel_y=vy, qp=self.qp)[:, 0]
            ctrl = mpc.mpc_converter(u[:, 0], u[:, 1], torch.hypot(vx, vy), 0.0,
                                     0.4189, 3.0, 8.0, -4.0)
            actions = torch.zeros((e_n, cfg.num_agents, 2), dtype=cfg.tdtype,
                                  device=self.device)
            actions[:, ego] = ctrl.to(cfg.tdtype)
        with span("plan/env_step"):
            env_state, obs2, _, done, info = envlib.step(cfg, self.env_params, ps.env_state,
                                                         actions, gen)
        with span("plan/bitmap"):
            bitmap = self._bitmap(obs2.scans[:, ego])
        with span("plan/reward"):

            # divergence quarantine: the CommonRoad ST model is stiff near the
            # kinematic-switch speed, and an adversarial planner CAN excite the
            # yaw/slip feedback into overflow at the reference's own dt=0.015;
            # batched training flags the env done (the trainer's auto-reset
            # restarts it) BEFORE a huge/NaN reward poisons the replay buffer.
            xs = env_state.x.reshape(e_n, -1)
            diverged = (~torch.isfinite(xs).all(dim=-1)) | (xs.abs().amax(dim=-1) > 1e4)
            done = done | diverged

            # rewards (SAL.py:219-250) — computed on the PREVIOUS bitmap
            px_w, py_w = obs2.poses_x[:, ego], obs2.poses_y[:, ego]
            new_pos = torch.stack([px_w, py_w], dim=-1)
            progress = torch.linalg.vector_norm(new_pos - ps.prev_pos, dim=-1) * 10.0
            if self.reward_mode == "sal":
                px, py = _world_to_pixel(px_w, py_w, pcfg)
                collided = br.detect_collision(ps.bitmap, px, py)
                centering = br.centerline_reward(ps.bitmap, px_w.to(torch.int32),
                                                 py_w.to(torch.int32)) * 2.0
            else:  # "fixed": env-true collision, car-frame centering probe
                collided = obs2.collisions[:, ego] > 0
                h, w = pcfg.bitmap_dims
                # probe one row above the drawn +-2px black car marker (the
                # marker itself breaks the white run at the exact center)
                full = lambda v: torch.full((e_n,), v, dtype=torch.int32,  # noqa: E731
                                            device=self.device)
                centering = br.centerline_reward(ps.bitmap, full(w // 2), full(h // 2 - 3)) * 2.0
            lap_bonus = torch.where(obs2.lap_counts[:, ego] > obs.lap_counts[:, ego],
                                    500.0 - 10.0 * obs2.lap_times[:, ego],
                                    torch.zeros_like(obs2.lap_times[:, ego]))
            reward = (progress.to(torch.float64) + centering + lap_bonus.to(torch.float64)
                      + torch.where(collided, -100.0, 0.0).to(torch.float64))
            # a diverged step's reward is crash-valued, never the (huge/NaN)
            # computed one
            reward = torch.where(diverged, torch.full_like(reward, -100.0), reward)

            # waypoint index advance (SAL.py:252-259)
            target = path[torch.arange(e_n, device=self.device),
                          torch.clamp(sub_index, 0, PATH_LEN - 1).long()]
            reached = torch.linalg.vector_norm(new_pos - target, dim=-1) < pcfg.dist_threshold
            sub_index = sub_index + reached.to(torch.int32)

        new_ps = PlanState(env_state=env_state, obs=obs2, bitmap=bitmap, path=path,
                           sub_index=sub_index, prev_pos=new_pos)
        return new_ps, bitmap, reward.to(torch.float32), done, info
