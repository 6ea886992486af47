"""Configuration: vehicle parameters and the static simulation config.

PyTorch counterpart of ``red_gym_tpu/config.py``.  Field names, defaults and
validation are the same, so a config written for the JAX package means the
same thing here.  The JAX-only knobs (``scan_backend``, ``fuse_scan_ttc``,
``fuse_scan_opp``, ``scan_megakernel``, ``state_kernel``) keep their values
and checks, but nothing here resolves "auto" from a capability record: on a
CUDA device an in-scope config always runs the hand-written kernels, on a
CPU device always their plain PyTorch twins (see ``env.py``,
``ops/scan_fast.py``).  So the default config runs the state kernel and the
megakernel with the opponent cast; ``state_kernel="off"`` and
``fuse_scan_opp="off"`` select the eager pre-scan chain and the separate
opponent pass; ``scan_megakernel="off"`` or a config outside the
megakernel's scope (``rt_spatial``, ``rt_occlusion``, ``rt_grad``) runs the
unfused scan, whose epilogue takes the noise, iTTC and opponent cast as
``fuse_scan_ttc`` and ``fuse_scan_opp`` say.  ``scan_interp="spectral"``
runs the spectral render, with the noise add and iTTC in its kernel where
``fuse_scan_ttc`` resolves on.  The kernels take float32: in float64, and
under ``scan_backend="xla"``, every kernel knob's "auto" resolves off and
its "on" raises ValueError, and the fast scan runs JAX's XLA branches
eagerly (``ops/scan_fast.xla_tail``).  In float32, ``scan_backend="xla"``
is an explicit eager reference mode, the counterpart of JAX's XLA branch
for parity runs: it takes no kernel on any device, and no path that wants
the card's speed should set it (the default "auto" runs the kernels).
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import Callable, NamedTuple, Optional

import torch


def resolve_device(device) -> torch.device:
    """The torch.device of an entry point's ``device`` argument.

    Every function of the port that takes ``device`` defaults to "cuda":
    the port runs on the card unless the caller asks for the CPU.  Without
    a usable CUDA device a "cuda" device raises RuntimeError; nothing falls
    back to the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} (the default) needs a CUDA device, and "
            "torch.cuda.is_available() is false: pass device='cpu' to run "
            "on the CPU")
    return device


class Integrator(enum.Enum):
    """Time integrator for the vehicle ODE (reference: base_classes.py:40-42)."""

    RK4 = 1
    EULER = 2


class VehicleParams(NamedTuple):
    """Vehicle physical parameters (reference: f110_env.py:67-128).

    Every field is a tensor: a scalar, or per-agent / per-env with leading
    batch axes that broadcast against the state's (E, A) axes."""

    mu: torch.Tensor        # surface friction coefficient
    C_Sf: torch.Tensor      # front cornering stiffness coefficient
    C_Sr: torch.Tensor      # rear cornering stiffness coefficient
    lf: torch.Tensor        # CoG -> front axle distance [m]
    lr: torch.Tensor        # CoG -> rear axle distance [m]
    h: torch.Tensor         # CoG height [m]
    m: torch.Tensor         # mass [kg]
    I: torch.Tensor         # yaw moment of inertia [kg m^2]
    s_min: torch.Tensor     # min steering angle [rad]
    s_max: torch.Tensor     # max steering angle [rad]
    sv_min: torch.Tensor    # min steering velocity [rad/s]
    sv_max: torch.Tensor    # max steering velocity [rad/s]
    v_switch: torch.Tensor  # wheel-spin switching velocity [m/s]
    a_max: torch.Tensor     # max acceleration [m/s^2]
    v_min: torch.Tensor     # min longitudinal velocity [m/s]
    v_max: torch.Tensor     # max longitudinal velocity [m/s]
    width: torch.Tensor     # car body width [m]
    length: torch.Tensor    # car body length [m]

    @classmethod
    def default(cls, dtype=torch.float32, device="cuda") -> "VehicleParams":
        """Default F1TENTH car (reference: f110_env.py:128)."""
        return cls.from_dict({}, dtype=dtype, device=device)

    @classmethod
    def from_dict(cls, d: dict, dtype=torch.float32,
                  device="cuda") -> "VehicleParams":
        unknown = set(d) - set(cls._fields)
        if unknown:
            raise KeyError(f"unknown vehicle params: {sorted(unknown)}")
        device = resolve_device(device)
        merged = dict(DEFAULT_PARAMS_DICT)
        merged.update(d)
        return cls(**{k: torch.as_tensor(merged[k], dtype=dtype, device=device)
                      for k in cls._fields})

    def replace(self, **kw) -> "VehicleParams":
        return self._replace(**{
            k: torch.as_tensor(v, dtype=self.mu.dtype, device=self.mu.device)
            for k, v in kw.items()})


DEFAULT_PARAMS_DICT = {
    "mu": 1.0489,
    "C_Sf": 4.718,
    "C_Sr": 5.4562,
    "lf": 0.15875,
    "lr": 0.17145,
    "h": 0.074,
    "m": 3.74,
    "I": 0.04712,
    "s_min": -0.4189,
    "s_max": 0.4189,
    "sv_min": -3.2,
    "sv_max": 3.2,
    "v_switch": 7.319,
    "a_max": 9.51,
    "v_min": -5.0,
    "v_max": 20.0,
    "width": 0.31,
    "length": 0.58,
}

_TORCH_DTYPES = {"float32": torch.float32, "float64": torch.float64,
                 "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Static simulation configuration (reference: f110_env.py:100-157).

    The meaning of every field is documented at its namesake in
    ``red_gym_tpu/config.py``."""

    num_agents: int = 2
    num_beams: int = 1080
    fov: float = 2.0 * math.pi
    timestep: float = 0.01
    ego_idx: int = 0
    integrator: Integrator = Integrator.RK4
    # lidar
    theta_dis: int = 2000
    max_range: float = 30.0
    eps: float = 0.0001
    scan_noise_std: float = 0.01
    ttc_thresh: float = 0.005
    # "pool": one row of a pregenerated N(0, sigma) pool per env per step;
    # "fresh": one fresh draw per env per step; "pool_rot": the same pool,
    # env g of a step call reading row (g + off) % rows for one drawn
    # offset, read by the megakernel from the resident pool
    noise_mode: str = "pool"
    noise_pool_rows: int = 1024
    steer_delay: int = 2
    finish_band_halfwidth: float = 2.0
    finish_dist2: float = 0.1
    laps_to_finish_toggles: int = 4
    dtype: str = "float32"
    march_iters: int = 0
    scan_mode: str = "exact"
    rt_theta_bins: int = 128
    rt_pose_stride: int = 2
    scan_backend: str = "auto"        # "xla": the eager reference mode, no kernel
    scan_interp: str = "linear"
    rt_dtype: str = "auto"
    rt_spatial: str = "nearest1"
    rt_occlusion: str = "edge"
    rt_occlusion_cells: float = 2.0
    rt_edge_iters: int = 6
    rt_grad: bool = True
    # e/w channel-tap dtype.  "auto": bfloat16 on a CUDA device, the scan
    # dtype on the CPU (ops/scan_fast.resolve_ew_dtype); explicit values win
    rt_ew_dtype: str = "auto"
    fuse_scan_ttc: str = "auto"
    fuse_scan_opp: str = "auto"
    scan_megakernel: str = "auto"
    state_kernel: str = "auto"
    # low-level controller (speed_cmd, steer_cmd, v, steer, sv_max, a_max,
    # v_max, v_min) -> (accl, steer_vel) on tensors; None -> ops.dynamics.pid
    speed_controller: Optional[Callable] = None

    def __post_init__(self):
        if self.scan_mode not in ("exact", "fast"):
            raise ValueError(f"scan_mode must be 'exact' or 'fast', got "
                             f"{self.scan_mode!r}")
        if self.scan_backend not in ("auto", "xla", "pallas"):
            raise ValueError(f"scan_backend must be 'auto'|'xla'|'pallas', "
                             f"got {self.scan_backend!r}")
        if self.scan_interp not in ("linear", "spectral"):
            raise ValueError(f"scan_interp must be 'linear'|'spectral', got "
                             f"{self.scan_interp!r}")
        if self.rt_spatial not in ("bilinear", "nearest", "nearest1"):
            raise ValueError(f"rt_spatial must be 'bilinear'|'nearest'|"
                             f"'nearest1', got {self.rt_spatial!r}")
        if self.rt_dtype not in ("auto", "float32", "bfloat16"):
            raise ValueError(f"rt_dtype must be 'auto'|'float32'|'bfloat16', "
                             f"got {self.rt_dtype!r}")
        if self.rt_ew_dtype not in ("auto", "float32", "bfloat16"):
            raise ValueError(f"rt_ew_dtype must be 'auto'|'float32'|"
                             f"'bfloat16', got {self.rt_ew_dtype!r}")
        if self.fuse_scan_ttc not in ("auto", "on", "off"):
            raise ValueError(f"fuse_scan_ttc must be 'auto'|'on'|'off', got "
                             f"{self.fuse_scan_ttc!r}")
        if self.fuse_scan_opp not in ("auto", "on", "off"):
            raise ValueError(f"fuse_scan_opp must be 'auto'|'on'|'off', got "
                             f"{self.fuse_scan_opp!r}")
        if self.scan_megakernel not in ("auto", "on", "off"):
            raise ValueError(f"scan_megakernel must be 'auto'|'on'|'off', "
                             f"got {self.scan_megakernel!r}")
        if self.state_kernel not in ("auto", "on", "off"):
            raise ValueError(f"state_kernel must be 'auto'|'on'|'off', "
                             f"got {self.state_kernel!r}")
        if self.noise_mode not in ("fresh", "pool", "pool_rot"):
            raise ValueError(f"noise_mode must be 'fresh'|'pool'|"
                             f"'pool_rot', got {self.noise_mode!r}")
        if self.rt_occlusion not in ("off", "snap", "edge"):
            raise ValueError(f"rt_occlusion must be 'off'|'snap'|'edge', got "
                             f"{self.rt_occlusion!r}")
        if self.scan_backend == "pallas" and self.rt_eff_occlusion == "snap":
            raise ValueError(
                "scan_backend='pallas' supports rt_occlusion 'off' and "
                "'edge' (or scan_interp='spectral'); the fused epilogue "
                "kernel has no snap path")
        if self.num_agents < 1 or self.num_beams < 2:
            raise ValueError("need num_agents >= 1 and num_beams >= 2")
        if self.ego_idx < 0 or self.ego_idx >= self.num_agents:
            raise ValueError(f"ego_idx {self.ego_idx} out of range for "
                             f"{self.num_agents} agents")
        if self.speed_controller is not None and not callable(self.speed_controller):
            raise ValueError("speed_controller must be callable (or None for "
                             "the reference PID)")

    @property
    def tdtype(self) -> torch.dtype:
        """Scan/state dtype as a torch dtype."""
        return _TORCH_DTYPES[self.dtype]

    @property
    def rt_tdtype(self) -> torch.dtype:
        """Range-texture storage dtype: bfloat16 in float32 runs ("auto")."""
        if self.rt_dtype == "auto":
            return torch.bfloat16 if self.tdtype == torch.float32 else self.tdtype
        return _TORCH_DTYPES[self.rt_dtype]

    @property
    def angle_increment(self) -> float:
        return self.fov / (self.num_beams - 1)

    @property
    def rt_eff_occlusion(self) -> str:
        """Occlusion mode in effect: spectral interpolation ignores it."""
        return self.rt_occlusion if self.scan_interp == "linear" else "off"

    @property
    def rt_channels(self) -> int:
        """Texture channels per theta bin: [R | e w (edge) | gx gy (grad)]."""
        return (1 + (2 if self.rt_eff_occlusion == "edge" else 0)
                + (2 if self.rt_grad else 0))
