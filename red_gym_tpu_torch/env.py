"""The F1TENTH environment as functions over batched tensors.

PyTorch counterpart of ``red_gym_tpu/env.py``.  The JAX package writes one
env and vmaps it; here every tensor carries the env axis E first (and the
agent axis A second), so one call steps every car of every env:

    ``step(cfg, params, state, actions, gen) -> (state', obs, reward, done, info)``

Step order matches Simulator.step + F110Env.step (base_classes.py:546-605,
f110_env.py:261-302): pose update -> scans (with the per-agent wall iTTC)
-> pairwise body collision -> frozen dynamic state on iTTC -> opponent ray
casting -> time/lap/done.  Randomness comes only from the
``torch.Generator`` passed in: one noise row per env per step, shared by
the env's agents (the reference's identical-seed-per-car quirk,
base_classes.py:117,202).

The step runs on hand-written kernels where the config is in their scope:
the pre-scan state kernel (``cfg.state_kernel``, ``ops/state_kernels.py``)
and the scan megakernel (``cfg.scan_megakernel``) with the opponent ray
cast in it (``cfg.fuse_scan_opp``) and, under ``noise_mode="pool_rot"``,
its resident noise pool (``ops/scan_kernels.py``); without the megakernel,
the epilogue kernels of the unfused scan (``ops/blend_kernels.py``), the
edge render with the noise add and iTTC (``cfg.fuse_scan_ttc``) and the
opponent cast (``cfg.fuse_scan_opp``) in it, the edge render alone, or the
plain 3-tap blend.  "auto" resolves by scope alone: an in-scope config runs
the kernels on a CUDA device and their plain PyTorch twins on the CPU; out
of scope, "auto" takes the eager code and "on" raises ValueError.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from red_gym_tpu_torch.config import Integrator, SimConfig, VehicleParams
from red_gym_tpu_torch.maps.loader import TrackMap, load_map
from red_gym_tpu_torch.ops import agent_scan, collision as col
from red_gym_tpu_torch.ops import scan as scan_ops, scan_fast, state_kernels

_NOISE_POOL_SEED = 0x5EED


class EnvParams(NamedTuple):
    """Everything the step reads but does not write."""

    vehicle: VehicleParams
    tables: scan_ops.ScanTables
    tmap: TrackMap
    rtex: Optional[scan_fast.RangeTexture] = None
    noise_pool: Optional[torch.Tensor] = None  # (rows, B): noise_mode "pool"/"pool_rot"
    # (32,) vehicle + geometry scalars of the state kernel
    # (state_kernels.pack_params); rebuild it after replacing vehicle/tmap/rtex
    state_pack: Optional[torch.Tensor] = None


class EnvState(NamedTuple):
    """Simulation state of E envs with A agents each."""

    x: torch.Tensor            # (E, A, 7) [x, y, steer, vel, yaw, yaw_rate, slip]
    steer_buf: torch.Tensor    # (E, A, D) steering delay line, newest first
    steer_cnt: torch.Tensor    # (E, A) int32 fills of the delay line
    collisions: torch.Tensor   # (E, A) collision flags from the last step
    near_starts: torch.Tensor  # (E, A) bool finish-line proximity latch
    toggle_list: torch.Tensor  # (E, A) int32 finish-line crossing toggles
    lap_times: torch.Tensor    # (E, A)
    lap_counts: torch.Tensor   # (E, A) int32
    current_time: torch.Tensor  # (E,)
    start_pose: torch.Tensor   # (E, A, 3) reset poses
    start_rot: torch.Tensor    # (E, 2, 2) rotation into the ego start frame
    step_idx: torch.Tensor     # (E,) int32


class Observation(NamedTuple):
    """Fixed-shape observation (reference obs dict fields,
    base_classes.py:587-605 + f110_env.py:277-278), batched (E, A, ...)."""

    scans: torch.Tensor          # (E, A, B)
    poses_x: torch.Tensor        # (E, A)
    poses_y: torch.Tensor
    poses_theta: torch.Tensor
    linear_vels_x: torch.Tensor
    linear_vels_y: torch.Tensor  # always zero (reference base_classes.py:602)
    ang_vels_z: torch.Tensor
    collisions: torch.Tensor
    lap_times: torch.Tensor
    lap_counts: torch.Tensor


def make_params(cfg: SimConfig, map_yaml_path: str, map_ext: str = ".png",
                vehicle: Optional[VehicleParams] = None,
                tmap: Optional[TrackMap] = None, device="cpu") -> EnvParams:
    """Load the map, build the lidar tables, the range texture (marched on
    ``device``) and the noise pool."""
    scan_fast.check_supported(cfg)
    device = torch.device(device)
    vehicle = vehicle if vehicle is not None else VehicleParams.default(
        cfg.tdtype, device)
    if tmap is None:
        tmap = load_map(map_yaml_path, map_ext, dtype=cfg.tdtype, device=device)
    # the car-edge table uses width/2 and (lf+lr)/2 (base_classes.py:127-128)
    tables = scan_ops.build_tables(
        cfg, width=float(vehicle.width.reshape(-1)[0]),
        length=float(vehicle.lf.reshape(-1)[0] + vehicle.lr.reshape(-1)[0]),
        dtype=cfg.tdtype, device=device)
    rtex = scan_fast.build_range_texture(tmap, cfg)
    return EnvParams(vehicle=vehicle, tables=tables, tmap=tmap, rtex=rtex,
                     noise_pool=_make_noise_pool(cfg, device),
                     state_pack=state_kernels.pack_params(vehicle, tmap, rtex))


def _make_noise_pool(cfg: SimConfig, device):
    """Pregenerated N(0, sigma) beam rows for noise_mode "pool" and
    "pool_rot", drawn from a fixed-seed generator (a run's randomness is
    the row pick).  Stored in bfloat16 in float32 runs: a bf16 ulp of a
    1 cm perturbation is ~0.02 mm; compute upcasts on read."""
    if cfg.noise_mode not in ("pool", "pool_rot") or cfg.scan_noise_std <= 0:
        return None
    gen = torch.Generator(device=device).manual_seed(_NOISE_POOL_SEED)
    pool = cfg.scan_noise_std * torch.randn(
        (cfg.noise_pool_rows, cfg.num_beams), generator=gen,
        dtype=cfg.tdtype, device=device)
    return pool.to(torch.bfloat16) if cfg.tdtype == torch.float32 else pool


def init_state(cfg: SimConfig, poses) -> EnvState:
    """Fresh state at poses (E, A, 3) (reference RaceCar.reset + F110Env.reset
    counters, base_classes.py:181-202, f110_env.py:317-329)."""
    poses = torch.as_tensor(poses, dtype=cfg.tdtype)
    e_n, a_n = poses.shape[:2]
    dev, dt = poses.device, poses.dtype
    x = torch.zeros((e_n, a_n, 7), dtype=dt, device=dev)
    x[..., 0:2] = poses[..., 0:2]
    x[..., 4] = poses[..., 2]
    theta_e = poses[:, cfg.ego_idx, 2]
    c, s = torch.cos(-theta_e), torch.sin(-theta_e)
    start_rot = torch.stack([torch.stack([c, -s], -1), torch.stack([s, c], -1)], -2)

    def zeros(dtype, *shape):
        return torch.zeros((e_n, *shape), dtype=dtype, device=dev)

    return EnvState(
        x=x, steer_buf=zeros(dt, a_n, cfg.steer_delay),
        steer_cnt=zeros(torch.int32, a_n), collisions=zeros(dt, a_n),
        near_starts=torch.ones((e_n, a_n), dtype=torch.bool, device=dev),
        toggle_list=zeros(torch.int32, a_n), lap_times=zeros(dt, a_n),
        lap_counts=zeros(torch.int32, a_n), current_time=zeros(dt),
        start_pose=poses.clone(), start_rot=start_rot,
        step_idx=zeros(torch.int32))


def use_state_kernel(cfg: SimConfig, params: EnvParams) -> bool:
    """Resolution of cfg.state_kernel: "off" never, "auto" iff the config
    and params are in the kernel's scope (state_kernels.supported), "on"
    always, raising ValueError out of scope."""
    if cfg.state_kernel == "off":
        return False
    if state_kernels.supported(cfg, params):
        return True
    if cfg.state_kernel == "on":
        raise ValueError(
            "state_kernel='on' needs the kernel's scope: scan_mode='fast', "
            "rt_spatial='nearest1', dtype='float32', steer_delay=2, the "
            "default PID, the megakernel resolving on and scalar vehicle "
            "params (state_kernels.supported)")
    return False


def _noise_rows(cfg: SimConfig, params: EnvParams, e_n: int, gen):
    """This step's scan noise -> (noise, pool_off): one row per env (E, B),
    a row of the pool (bfloat16 storage, read by the kernels as is) or a
    fresh draw, with pool_off None.  Under "pool_rot" with the megakernel
    resolving on: the whole (rows, B) pool and one draw pool_off (1,) int32
    on the device, env g reading pool row (g + (pool_off & ~15)) % rows
    (scan_kernels.pool_rot_rows), the counterpart of the JAX package's
    env-0 draw; without the megakernel, "pool_rot" picks one pool row per
    env as "pool" does, as the JAX package does."""
    device = params.tables.beam_cosines.device
    if cfg.scan_noise_std <= 0:
        return torch.zeros((e_n, cfg.num_beams), dtype=cfg.tdtype,
                           device=device), None
    if cfg.noise_mode == "pool_rot" and scan_fast.use_megakernel(cfg):
        off = torch.randint(0, cfg.noise_pool_rows, (1,), generator=gen,
                            device=device, dtype=torch.int32)
        return params.noise_pool, off
    if cfg.noise_mode in ("pool", "pool_rot"):
        r = torch.randint(0, cfg.noise_pool_rows, (e_n,), generator=gen,
                          device=device)
        return params.noise_pool[r], None
    return cfg.scan_noise_std * torch.randn(
        (e_n, cfg.num_beams), generator=gen, dtype=cfg.tdtype, device=device), None


def sim_step(cfg: SimConfig, params: EnvParams, state: EnvState, actions, gen):
    """One Simulator.step (base_classes.py:546-605) for every agent of every
    env.  actions (E, A, 2) = [desired steer, desired speed]."""
    p = params.vehicle
    actions = torch.as_tensor(actions, dtype=cfg.tdtype)

    pregeo = None
    if use_state_kernel(cfg, params):
        # one launch for steer delay, PID, integration, yaw wrap and the
        # megakernel's per-row operands
        x, steer_buf, steer_cnt, rows, scal = state_kernels.prestep(
            cfg, params, state.x, state.steer_buf, state.steer_cnt, actions)
        pregeo = (rows, scal)
    else:
        x, steer_buf, steer_cnt = state_kernels.dynamics_chain(
            cfg, p, state.x, state.steer_buf, state.steer_cnt, actions)
    poses = x[..., [0, 1, 4]]
    vel = x[..., 3]

    # lidar: the noisy scan and the wall iTTC (pre-opponent scan), from the
    # megakernel or a fused edge epilogue (with the opponent ray cast where
    # it rides the kernel), or from the clean scan plus the eager noise add
    # and iTTC check, as the JAX package orders them
    noise, pool_off = _noise_rows(cfg, params, x.shape[0], gen)
    verts = col.get_vertices(poses, p.length, p.width)
    mega = scan_fast.use_megakernel(cfg)
    opp = None
    if scan_fast.use_fused_opp_mega(cfg) if mega else scan_fast.use_fused_opp(cfg):
        opp = agent_scan.opponent_slab_scalars(poses, verts, params.tables)
    if mega or scan_fast.use_fused_ttc(cfg):
        scans, hit01 = scan_fast.trace_fast_mxu(
            poses, params.tables, params.tmap, params.rtex, cfg,
            fused_ttc=(noise, vel), opp=opp, pool_off=pool_off, pregeo=pregeo)
        ttc_hit = (hit01 > 0) & (vel != 0.0)
    else:
        scans = scan_fast.trace_fast_mxu(poses, params.tables, params.tmap,
                                         params.rtex, cfg)
        if cfg.scan_noise_std > 0:
            scans = scans + noise.to(scans.dtype)[:, None, :]
        ttc_hit = agent_scan.check_ttc(scans, vel, params.tables, cfg.ttc_thresh)

    # pairwise body collision (base_classes.py:529-543)
    body_hits = col.pairwise_hits_from_poses(poses, p.length, p.width).to(x.dtype)

    # iTTC against walls freezes the dynamic state (base_classes.py:227-252)
    freeze = ttc_hit[..., None] & (torch.arange(7, device=x.device) >= 3)
    x = torch.where(freeze, torch.zeros_like(x), x)

    # opponent ray casting on the noisy scans (base_classes.py:204-225),
    # unless the megakernel already did it
    if opp is None:
        scans = agent_scan.ray_cast_all_opponents(poses, scans, verts, params.tables)

    collisions = torch.maximum(body_hits, ttc_hit.to(body_hits.dtype))
    new_state = state._replace(x=x, steer_buf=steer_buf, steer_cnt=steer_cnt,
                               collisions=collisions,
                               step_idx=state.step_idx + 1)
    return new_state, scans


def _lap_done_update(cfg: SimConfig, state: EnvState):
    """Finish-line toggle / lap counting / done (f110_env.py:202-244)."""
    left_t = right_t = cfg.finish_band_halfwidth
    dxy = state.x[..., 0:2] - state.start_pose[..., 0:2]          # (E, A, 2)
    delta = state.start_rot @ dxy.transpose(-1, -2)               # (E, 2, A)
    temp_y = delta[:, 1]
    over = temp_y > left_t
    under = temp_y < -right_t
    temp_y = torch.where(over, temp_y - left_t,
                         torch.where(under, -right_t - temp_y,
                                     torch.zeros_like(temp_y)))
    dist2 = delta[:, 0] ** 2 + temp_y ** 2
    closes = dist2 <= cfg.finish_dist2

    crossed = closes != state.near_starts
    toggle_list = state.toggle_list + crossed.to(torch.int32)
    near_starts = torch.where(crossed, closes, state.near_starts)
    lap_counts = toggle_list // 2
    lap_times = torch.where(toggle_list < cfg.laps_to_finish_toggles,
                            state.current_time[:, None], state.lap_times)
    finished = toggle_list >= cfg.laps_to_finish_toggles
    done = (state.collisions[:, cfg.ego_idx] > 0) | torch.all(finished, dim=-1)
    new_state = state._replace(near_starts=near_starts, toggle_list=toggle_list,
                               lap_counts=lap_counts, lap_times=lap_times)
    return new_state, done, finished


def _build_obs(state: EnvState, scans) -> Observation:
    x = state.x
    return Observation(
        scans=scans, poses_x=x[..., 0], poses_y=x[..., 1],
        poses_theta=x[..., 4], linear_vels_x=x[..., 3],
        linear_vels_y=torch.zeros_like(x[..., 3]), ang_vels_z=x[..., 5],
        collisions=state.collisions, lap_times=state.lap_times,
        lap_counts=state.lap_counts.to(state.lap_times.dtype))


def step(cfg: SimConfig, params: EnvParams, state: EnvState, actions, gen):
    """Full env step (f110_env.py:261-302) -> (state', obs, reward (E,),
    done (E,), info) with the per-agent ``checkpoint_done`` flags in info."""
    state, scans = sim_step(cfg, params, state, actions, gen)
    state = state._replace(current_time=state.current_time + cfg.timestep)
    state, done, finished = _lap_done_update(cfg, state)
    reward = torch.full(done.shape, cfg.timestep, dtype=cfg.tdtype,
                        device=done.device)
    return state, _build_obs(state, scans), reward, done, {"checkpoint_done": finished}


def reset(cfg: SimConfig, params: EnvParams, poses, gen):
    """Reset to poses (E, A, 3) and make the first observation by stepping
    once with zero actions, as the reference does (f110_env.py:304-347)."""
    state = init_state(cfg, poses)
    actions = torch.zeros(state.x.shape[:2] + (2,), dtype=cfg.tdtype,
                          device=state.x.device)
    return step(cfg, params, state, actions, gen)


class F110Env:
    """Stateful wrapper with the reference's gym-style API for one env:
    ``reset(poses (A, 3))`` and ``step(action (A, 2))`` return the classic
    4-tuple with the reference's obs dict keys (f110_env.py:53-99).
    ``scan_mode`` defaults to "fast", the only scan mode ported; rendering
    is not ported."""

    def __init__(self, map: str, map_ext: str = ".png",
                 params: dict | VehicleParams | None = None,
                 num_agents: int = 2, timestep: float = 0.01, ego_idx: int = 0,
                 integrator: Integrator = Integrator.RK4,
                 fov: float = 2.0 * np.pi, seed: int = 12345,
                 num_beams: int = 1080, dtype: str = "float32",
                 device="cpu", **kwargs):
        fields = {k: v for k, v in kwargs.items()
                  if k in SimConfig.__dataclass_fields__}
        fields.setdefault("scan_mode", "fast")
        self.cfg = SimConfig(num_agents=num_agents, num_beams=num_beams,
                             fov=fov, timestep=timestep, ego_idx=ego_idx,
                             integrator=integrator, dtype=dtype, **fields)
        self.device = torch.device(device)
        if isinstance(params, dict):
            vehicle = VehicleParams.from_dict(params, self.cfg.tdtype, self.device)
        elif isinstance(params, VehicleParams):
            vehicle = params
        else:
            vehicle = VehicleParams.default(self.cfg.tdtype, self.device)
        map_yaml = map if map.endswith(".yaml") else f"{map}.yaml"
        self.params = make_params(self.cfg, map_yaml, map_ext, vehicle,
                                  device=self.device)
        self.seed = seed
        self.gen = torch.Generator(device=self.device)
        self.state: EnvState | None = None

    def reset(self, poses):
        self.gen.manual_seed(self.seed)
        poses = torch.as_tensor(np.asarray(poses), dtype=self.cfg.tdtype,
                                device=self.device)[None]
        self.state, obs, reward, done, info = reset(
            self.cfg, self.params, poses, self.gen)
        return self._legacy(obs), float(reward[0]), bool(done[0]), self._info(info)

    def step(self, action):
        action = torch.as_tensor(np.asarray(action), dtype=self.cfg.tdtype,
                                 device=self.device)[None]
        self.state, obs, reward, done, info = step(
            self.cfg, self.params, self.state, action, self.gen)
        return self._legacy(obs), float(reward[0]), bool(done[0]), self._info(info)

    def _legacy(self, obs: Observation) -> dict:
        d = {k: getattr(obs, k)[0].cpu().numpy() for k in obs._fields}
        d["ego_idx"] = self.cfg.ego_idx
        return d

    @staticmethod
    def _info(info) -> dict:
        return {"checkpoint_done": info["checkpoint_done"][0].cpu().numpy()}
