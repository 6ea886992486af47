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

The exact scan (``scan_mode="exact"``, SimConfig's default) marches every
beam on the map's distance transform with the march kernel
(``ops/march_kernels.py``), after the eager pre-scan chain, and adds the
noise, iTTC check and opponent pass eagerly.  The fast scan runs on
hand-written kernels where the config is in their scope: the pre-scan
state kernel (``cfg.state_kernel``, ``ops/state_kernels.py``)
and the scan megakernel (``cfg.scan_megakernel``) with the opponent ray
cast in it (``cfg.fuse_scan_opp``) and, under ``noise_mode="pool_rot"``,
its resident noise pool (``ops/scan_kernels.py``); without the megakernel,
the epilogue kernels of the unfused scan (``ops/blend_kernels.py``), the
edge render with the noise add and iTTC (``cfg.fuse_scan_ttc``) and the
opponent cast (``cfg.fuse_scan_opp``) in it, the edge render alone, or the
plain 3-tap blend; under ``scan_interp="spectral"``, the spectral render
with the noise add and iTTC in it (``ops/spectral_kernels.py``; the
opponent pass stays eager).  "auto" resolves by scope alone: an in-scope
config runs the kernels on a CUDA device and their plain PyTorch twins on
the CPU; out of scope, "auto" takes the eager code and "on" raises
ValueError.  Every function here that takes ``device`` defaults to the
card ("cuda") and raises without one; pass ``device="cpu"`` for the CPU.

Multi-map batches (``make_multimap_params``): the params hold M maps, and
in fast mode their textures, stacked on a leading map axis and padded to
one shape; each env picks its map with ``EnvState.map_idx`` (E,) int32,
which ``reset`` checks once against M.  Every scan branch takes it: the
megakernel, the unfused epilogues and the spectral render read the flat
(M * N, C*T) texture at rows offset by map, and the exact march reads each
car's map of the (M, H, W) distance transforms.  The pre-scan state kernel
covers one map, so under ``map_idx`` the eager chain runs, as in JAX.

A step's stages are spans (``utils/profiling.span``, profiler ranges
while a session records): ``env/dynamics`` (the state kernel or the eager
chain), ``env/noise``, ``env/scan`` (the cars' vertices, the opponent
slab and the scan, whatever kernels implement it), ``env/scan_tail`` (the
eager noise add, iTTC check and opponent cast, where no kernel fused
them), ``env/collision`` and ``env/laps``.  ``make_params`` and
``make_multimap_params`` are the set-up span ``setup/params``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from red_gym_tpu_torch.config import (Integrator, SimConfig, VehicleParams,
                                      resolve_device)
from red_gym_tpu_torch.maps.loader import TrackMap, load_map, pad_map, stack_maps
from red_gym_tpu_torch.ops import agent_scan, collision as col
from red_gym_tpu_torch.ops import scan as scan_ops, scan_fast, scan_kernels, state_kernels
from red_gym_tpu_torch.parallel import draws
from red_gym_tpu_torch.utils.profiling import setup_span, span

_NOISE_POOL_SEED = 0x5EED


class EnvParams(NamedTuple):
    """Everything the step reads but does not write."""

    vehicle: VehicleParams
    tables: scan_ops.ScanTables
    tmap: TrackMap
    rtex: Optional[scan_fast.RangeTexture] = None
    noise_pool: Optional[torch.Tensor] = None  # (rows, B): noise_mode "pool"/"pool_rot"


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
    # (E,) int32 map of each env in map-stacked params; None with one map
    map_idx: Optional[torch.Tensor] = None


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

    def to_legacy_dict(self, ego_idx: int = 0) -> dict:
        """The reference's obs dict (f110_env.py:53-99) of env 0: each
        field's (A, ...) row as a numpy array on the host, and ``ego_idx``."""
        d = {k: getattr(self, k)[0].cpu().numpy() for k in self._fields}
        d["ego_idx"] = ego_idx
        return d


@setup_span("setup/params")
def make_params(cfg: SimConfig, map_yaml_path: str, map_ext: str = ".png",
                vehicle: Optional[VehicleParams] = None,
                tmap: Optional[TrackMap] = None, device="cuda") -> EnvParams:
    """Load the map, build the lidar tables, the range texture of the fast
    scan (marched on ``device``, the card unless the caller passes "cpu";
    the exact scan has none) and the noise pool."""
    device = resolve_device(device)
    scan_fast.check_supported(cfg)
    vehicle, tables = _vehicle_and_tables(cfg, vehicle, device)
    if tmap is None:
        tmap = load_map(map_yaml_path, map_ext, dtype=cfg.tdtype, device=device)
    rtex = None
    if cfg.scan_mode == "fast":
        rtex = scan_fast.build_range_texture(tmap, cfg)
    return EnvParams(vehicle=vehicle, tables=tables, tmap=tmap, rtex=rtex,
                     noise_pool=_make_noise_pool(cfg, device))


@setup_span("setup/params")
def make_multimap_params(cfg: SimConfig, map_yaml_paths, map_ext: str = ".png",
                         vehicle: Optional[VehicleParams] = None,
                         device="cuda") -> EnvParams:
    """EnvParams with M maps stacked on a leading map axis (JAX
    env.make_multimap_params): every map padded to the largest extents
    (``maps.loader.pad_map``, after its EDT) and, in fast mode, every
    texture built on its raw map, so that its disk-cache entry is the one
    ``make_params`` writes, then grown to the padded cell grid
    (``ceil(pad / rt_pose_stride)``) and stacked.  Each map is loaded once.
    Envs pick their map with ``EnvState.map_idx`` (``reset(...,
    map_idx=...)``).  On ``device``, the card unless the caller passes
    "cpu"."""
    device = resolve_device(device)
    scan_fast.check_supported(cfg)
    vehicle, tables = _vehicle_and_tables(cfg, vehicle, device)
    raw = [load_map(p, map_ext, dtype=cfg.tdtype, device=device)
           for p in map_yaml_paths]
    pad = (max(int(m.height) for m in raw), max(int(m.width) for m in raw))
    tmap = stack_maps([pad_map(m, pad) for m in raw])
    rtex = None
    if cfg.scan_mode == "fast":
        s = cfg.rt_pose_stride
        hc_pad, wc_pad = (pad[0] + s - 1) // s, (pad[1] + s - 1) // s
        rtex = scan_fast.stack_textures(
            [scan_fast.pad_texture(scan_fast.build_range_texture(m, cfg),
                                   hc_pad, wc_pad) for m in raw])
    return EnvParams(vehicle=vehicle, tables=tables, tmap=tmap, rtex=rtex,
                     noise_pool=_make_noise_pool(cfg, device))


def _vehicle_and_tables(cfg: SimConfig, vehicle, device):
    """The vehicle (the default one if None) and the lidar tables of it."""
    vehicle = vehicle if vehicle is not None else VehicleParams.default(
        cfg.tdtype, device)
    # the car-edge table uses width/2 and (lf+lr)/2 (base_classes.py:127-128)
    tables = scan_ops.build_tables(
        cfg, width=float(vehicle.width.reshape(-1)[0]),
        length=float(vehicle.lf.reshape(-1)[0] + vehicle.lr.reshape(-1)[0]),
        dtype=cfg.tdtype, device=device)
    return vehicle, tables


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


def init_state(cfg: SimConfig, poses, map_idx=None) -> EnvState:
    """Fresh state at poses (E, A, 3) (reference RaceCar.reset + F110Env.reset
    counters, base_classes.py:181-202, f110_env.py:317-329); ``map_idx``
    (E,) is each env's map of map-stacked params, kept as int32."""
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
        step_idx=zeros(torch.int32),
        map_idx=None if map_idx is None else torch.as_tensor(
            map_idx, device=dev).to(torch.int32))


def check_map_idx(params: EnvParams, map_idx) -> None:
    """Raise ValueError unless ``map_idx`` fits ``params``: None for one
    map, an index in [0, M) per env for M stacked maps.  Reads the indices
    on the host, so ``reset`` runs it once and the step never does."""
    stacked = params.tmap.dt.dim() == 3
    if map_idx is None:
        if stacked:
            raise ValueError("these params hold a stack of maps: pass map_idx, "
                             "each env's map")
        return
    if not stacked:
        raise ValueError("map_idx needs map-stacked params "
                         "(env.make_multimap_params)")
    m_n = params.tmap.dt.shape[0]
    idx = torch.as_tensor(map_idx)
    if idx.dtype.is_floating_point or idx.dim() != 1:
        raise ValueError(f"map_idx must be (E,) integers, got {idx.dtype} "
                         f"{tuple(idx.shape)}")
    if idx.numel() and (int(idx.min()) < 0 or int(idx.max()) >= m_n):
        raise ValueError(f"map_idx must lie in [0, {m_n}), got "
                         f"[{int(idx.min())}, {int(idx.max())}]")


def state_kernel_pack(cfg: SimConfig, params: EnvParams, midx=None):
    """Resolution of cfg.state_kernel for a step: the state kernel's scalar
    pack (state_kernels.step_pack, cached while the params do not change)
    where the kernel runs, None where the eager chain runs.  "off" never,
    "auto" iff the config and params are in the kernel's scope
    (state_kernels.supported) and the step has one map (``midx`` None, as
    JAX's _use_state_kernel), "on" always, raising ValueError out of
    scope."""
    if cfg.state_kernel == "off":
        return None
    pack = None if midx is not None else state_kernels.step_pack(cfg, params)
    if pack is None and cfg.state_kernel == "on":
        raise ValueError(
            "state_kernel='on' needs the kernel's scope: scan_mode='fast', "
            "rt_spatial='nearest1', dtype='float32', steer_delay=2, the "
            "default PID, the megakernel resolving on, one map (no map_idx) "
            "and scalar vehicle params (state_kernels.supported)")
    return pack


def _noise_rows(cfg: SimConfig, params: EnvParams, e_n: int, gen):
    """This step's scan noise -> (noise, pool_off): one row per env (E, B)
    that the env's agents share, with pool_off None.  Under "pool" (and
    "pool_rot" without the megakernel, as in the JAX package) the row is a
    pool row uniform on [0, rows), in the pool's storage dtype (bfloat16
    in float32 runs, read by the kernels as is); under "fresh" a draw of
    N(0, scan_noise_std).  Under "pool_rot" with the megakernel resolving
    on: the whole (rows, B) pool and one draw pool_off (1,) int32 on the
    device, uniform on [0, rows), the counterpart of the JAX package's
    env-0 draw; env g reads pool row (g + (pool_off & ~15)) % rows
    (scan_kernels.pool_rot_rows), uniform over the rows / 16 rows of its
    class g mod 16, and the rows of one call are distinct for E <= rows.
    Inside ``parallel.draws.row_draws`` every draw is made for all ranks'
    envs and this rank keeps its rows; "pool_rot" then hands the megakernel
    its rows of the pool as a slab (the plain variant)."""
    device = params.tables.beam_cosines.device
    if cfg.scan_noise_std <= 0:
        return torch.zeros((e_n, cfg.num_beams), dtype=cfg.tdtype,
                           device=device), None
    if cfg.noise_mode == "pool_rot" and scan_fast.use_megakernel(cfg):
        off = torch.randint(0, cfg.noise_pool_rows, (1,), generator=gen,
                            device=device, dtype=torch.int32)
        if draws.current() is None:
            return params.noise_pool, off
        # a rank's rows of the rotation counted over every rank's envs: the
        # pool rows themselves, for the plain variant
        return draws.draw_rows(e_n, lambda n: params.noise_pool[
            scan_kernels.pool_rot_rows(n, cfg.noise_pool_rows, off)]), None
    if cfg.noise_mode in ("pool", "pool_rot"):
        r = draws.draw_rows(e_n, lambda n: torch.randint(
            0, cfg.noise_pool_rows, (n,), generator=gen, device=device))
        return params.noise_pool[r], None
    return draws.draw_rows(e_n, lambda n: cfg.scan_noise_std * torch.randn(
        (n, cfg.num_beams), generator=gen, dtype=cfg.tdtype, device=device)), None


def skip_step_draws(cfg: SimConfig, params: EnvParams, gen) -> None:
    """Advance ``gen`` past the draws of a step of no env of this process:
    inside ``parallel.draws.row_draws``, a step of other ranks' envs only."""
    _noise_rows(cfg, params, 0, gen)


def sim_step(cfg: SimConfig, params: EnvParams, state: EnvState, actions, gen):
    """One Simulator.step (base_classes.py:546-605) for every agent of every
    env.  actions (E, A, 2) = [desired steer, desired speed]."""
    p = params.vehicle
    actions = torch.as_tensor(actions, dtype=cfg.tdtype)
    # each car's map of map-stacked params, (E, 1) against the (E, A) cars
    midx = None if state.map_idx is None else state.map_idx[:, None]

    pregeo = None
    with span("env/dynamics"):
        pack = state_kernel_pack(cfg, params, midx)
        if pack is not None:
            # one launch for steer delay, PID, integration, yaw wrap and the
            # megakernel's per-row operands; its scalar pack is that of these
            # params, rebuilt whenever one of them changed (JAX:
            # pallas_state.pack_rows in sim_step)
            x, steer_buf, steer_cnt, rows, scal = state_kernels.prestep(
                cfg, params, state.x, state.steer_buf, state.steer_cnt, actions, pack)
            pregeo = (rows, scal)
        else:
            x, steer_buf, steer_cnt = state_kernels.dynamics_chain(
                cfg, p, state.x, state.steer_buf, state.steer_cnt, actions)
    poses = x[..., [0, 1, 4]]
    vel = x[..., 3]

    # lidar: the noisy scan and the wall iTTC (pre-opponent scan), from the
    # megakernel or a fused edge epilogue (with the opponent ray cast where
    # it rides the kernel), or from the clean scan (the exact march or an
    # unfused fast scan) plus the eager noise add and iTTC check, as the JAX
    # package orders them
    with span("env/noise"):
        noise, pool_off = _noise_rows(cfg, params, x.shape[0], gen)
    mega = scan_fast.use_megakernel(cfg)
    fused = mega or scan_fast.use_fused_ttc(cfg)
    with span("env/scan"):
        # the cars' vertices are the opponents' polygons of the ray cast
        verts = col.get_vertices(poses, p.length, p.width)
        opp = None
        if scan_fast.use_fused_opp_mega(cfg) if mega else scan_fast.use_fused_opp(cfg):
            opp = agent_scan.opponent_slab_scalars(poses, verts, params.tables)
        if fused:
            scans, hit01 = scan_fast.trace_fast_mxu(
                poses, params.tables, params.tmap, params.rtex, cfg,
                fused_ttc=(noise, vel), opp=opp, pool_off=pool_off, pregeo=pregeo,
                midx=midx)
            ttc_hit = (hit01 > 0) & (vel != 0.0)
        elif cfg.scan_mode == "exact":
            scans = scan_ops.trace(poses, params.tables, params.tmap, cfg, midx)
        else:
            scans = scan_fast.trace_fast_mxu(poses, params.tables, params.tmap,
                                             params.rtex, cfg, midx=midx)
    if not fused or opp is None:
        with span("env/scan_tail"):
            if not fused:
                if cfg.scan_noise_std > 0:
                    scans = scans + noise.to(scans.dtype)[:, None, :]
                ttc_hit = agent_scan.check_ttc(scans, vel, params.tables, cfg.ttc_thresh)
            # opponent ray casting on the noisy scans (base_classes.py:204-225),
            # unless a kernel already did it; it reads the poses, not the
            # state the collision below freezes
            if opp is None:
                scans = agent_scan.ray_cast_all_opponents(poses, scans, verts,
                                                          params.tables)

    with span("env/collision"):
        # pairwise body collision (base_classes.py:529-543)
        body_hits = col.pairwise_hits_from_poses(poses, p.length, p.width).to(x.dtype)
        # iTTC against walls freezes the dynamic state (base_classes.py:227-252)
        freeze = ttc_hit[..., None] & (torch.arange(7, device=x.device) >= 3)
        x = torch.where(freeze, torch.zeros_like(x), x)
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
    with span("env/laps"):
        state = state._replace(current_time=state.current_time + cfg.timestep)
        state, done, finished = _lap_done_update(cfg, state)
        reward = torch.full(done.shape, cfg.timestep, dtype=cfg.tdtype,
                            device=done.device)
        obs = _build_obs(state, scans)
    return state, obs, reward, done, {"checkpoint_done": finished}


def staggered_start_poses(num_agents: int) -> np.ndarray:
    """Default (A, 3) grid spawn: agents staggered in 0.6 m ranks behind the
    reference's example start pose (examples/config_example_map.yaml sx, sy,
    stheta).  The default of the gymnasium facades."""
    return np.array([[0.7 - 0.6 * (i // 2), -1.0 * (i % 2), 1.37079632679]
                     for i in range(num_agents)])


def action_bounds(vehicle: VehicleParams) -> tuple[np.ndarray, np.ndarray]:
    """(low, high) of one agent's [steer, speed] action, float32 numpy, from
    the vehicle limits (the widest over per-agent fields)."""
    lo = np.array([float(vehicle.s_min.min()), float(vehicle.v_min.min())], np.float32)
    hi = np.array([float(vehicle.s_max.max()), float(vehicle.v_max.max())], np.float32)
    return lo, hi


def reset(cfg: SimConfig, params: EnvParams, poses, gen, map_idx=None):
    """Reset to poses (E, A, 3) and make the first observation by stepping
    once with zero actions, as the reference does (f110_env.py:304-347).
    ``map_idx`` (E,) puts each env on its map of map-stacked params; it is
    checked here (``check_map_idx``), once."""
    check_map_idx(params, map_idx)
    return reset_unchecked(cfg, params, poses, gen, map_idx)


def reset_unchecked(cfg: SimConfig, params: EnvParams, poses, gen, map_idx=None):
    """``reset`` without the host-side check of ``map_idx``: for callers
    whose indices are known to be in range (a rollout's auto-reset)."""
    state = init_state(cfg, poses, map_idx)
    actions = torch.zeros(state.x.shape[:2] + (2,), dtype=cfg.tdtype,
                          device=state.x.device)
    return step(cfg, params, state, actions, gen)


class F110Env:
    """Stateful wrapper with the reference's gym-style API for one env:
    ``reset(poses (A, 3))`` and ``step(action (A, 2))`` return the classic
    4-tuple with the reference's obs dict keys (f110_env.py:53-99).  Its
    config is built as the JAX package's ``F110Env`` builds it, so with no
    ``scan_mode`` given it runs the exact scan, SimConfig's default.
    ``tmap`` takes an already loaded map in place of ``map``.  ``render``
    draws the env on the host with matplotlib (``render/viewer.py``).  It
    runs on the card unless ``device="cpu"``."""

    metadata = {"render.modes": ["human", "human_fast"]}

    def __init__(self, map: str | None = None, map_ext: str = ".png",
                 params: dict | VehicleParams | None = None,
                 num_agents: int = 2, timestep: float = 0.01, ego_idx: int = 0,
                 integrator: Integrator = Integrator.RK4,
                 fov: float = 2.0 * np.pi, seed: int = 12345,
                 num_beams: int = 1080, dtype: str = "float32",
                 tmap: TrackMap | None = None, device="cuda", **kwargs):
        self.cfg = SimConfig(num_agents=num_agents, num_beams=num_beams,
                             fov=fov, timestep=timestep, ego_idx=ego_idx,
                             integrator=integrator, dtype=dtype,
                             **{k: v for k, v in kwargs.items()
                                if k in SimConfig.__dataclass_fields__})
        self.device = resolve_device(device)
        if isinstance(params, dict):
            vehicle = VehicleParams.from_dict(params, self.cfg.tdtype, self.device)
        elif isinstance(params, VehicleParams):
            vehicle = params
        else:
            vehicle = VehicleParams.default(self.cfg.tdtype, self.device)
        map_yaml = f"{map}.yaml" if map and not map.endswith(".yaml") else map
        self.params = make_params(self.cfg, map_yaml, map_ext, vehicle, tmap=tmap,
                                  device=self.device)
        self.seed = seed
        self.gen = torch.Generator(device=self.device)
        self.state: EnvState | None = None
        self.render_callbacks = []
        self._renderer = None

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

    def update_params(self, params: dict, index: int = -1):
        """Replace the vehicle parameters (reference f110_env.py:362-373).
        ``index < 0``: every agent gets ``params`` over the defaults.
        ``index >= 0``: each field becomes per-agent (A,), and agent
        ``index`` takes the values in ``params``; per-agent fields take the
        step out of the state kernel's scope, to the eager chain."""
        vehicle = self.params.vehicle
        if index < 0:
            vehicle = VehicleParams.from_dict(params, self.cfg.tdtype, self.device)
        else:
            a_n = self.cfg.num_agents
            fields = {}
            for name in VehicleParams._fields:
                cur = torch.broadcast_to(getattr(vehicle, name), (a_n,)).clone()
                if name in params:
                    cur[index] = params[name]
                fields[name] = cur
            vehicle = VehicleParams(**fields)
        self.params = self.params._replace(vehicle=vehicle)

    def update_map(self, map_path: str, map_ext: str = ".png"):
        """Load another map (the map yaml's path); in fast mode the range
        texture is rebuilt for it, never kept stale."""
        tmap = load_map(map_path, map_ext, dtype=self.cfg.tdtype, device=self.device)
        rtex = self.params.rtex
        if self.cfg.scan_mode == "fast":
            rtex = scan_fast.build_range_texture(tmap, self.cfg)
        self.params = self.params._replace(tmap=tmap, rtex=rtex)
        self._renderer = None  # the map raster changed

    def add_render_callback(self, fn):
        """``fn(viewer)`` runs before each frame (the viewer's draw_* API)."""
        self.render_callbacks.append(fn)

    def render(self, mode: str = "human"):
        """Draw env 0 of the current state with the host viewer (the
        reference's EnvRenderer, rendering.py:50-335); "human" and
        "human_fast" draw alike, as in JAX."""
        from red_gym_tpu_torch.render.viewer import Viewer

        if self._renderer is None:
            self._renderer = Viewer(self.params, self.cfg)
        self._renderer.update(self.state)
        for cb in self.render_callbacks:
            cb(self._renderer)
        self._renderer.draw(block=False)

    def _legacy(self, obs: Observation) -> dict:
        return obs.to_legacy_dict(self.cfg.ego_idx)

    @staticmethod
    def _info(info) -> dict:
        return {"checkpoint_done": info["checkpoint_done"][0].cpu().numpy()}


def make(map: str, **kwargs) -> F110Env:
    """Construct an env (the reference's gym.make('f110_gym:f110-v0', ...))."""
    return F110Env(map=map, **kwargs)
