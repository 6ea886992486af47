"""The pre-scan state kernel: steer delay, PID, vehicle step and scan geometry.

Replaces the TPU kernel ``red_gym_tpu/ops/pallas_state.py::prestep``
(``_kernel``).  The CUDA C++ source is ``red_gym_tpu_torch/csrc/prestep.cu``.

Per row (one car), from its state x = [x, y, steer, vel, yaw, yaw_rate,
slip], its depth-2 steering delay line and fill count, and its action
[desired steer, desired speed]:

1. the steering delay line (the first two steps see zero steer);
2. the reference PID: (accl, steering velocity);
3. one RK4 or Euler step of the dynamic single-track model, yaw wrap;
4. the nearest1 texture cell of the new pose (row, in-bounds flag and the
   offset dx, dy from the cell centre) and the theta decomposition
   s = yaw * T / 2pi = i_f + f_s.

It returns the new state and the megakernel's per-row operands: the texture
row (int32) and the packed scalars [dx, dy, f_s, i_f, inb, vel, 0, 0] that
``scan_kernels.mega_edge_ttc`` reads as ``scal``.

The plain version, :func:`prestep_reference`, is the eager chain that
``env.sim_step`` runs with the state kernel off (:func:`dynamics_chain`
then ``scan_fast.row_scalars``), so the two paths share one formula.

What bounds it on an H100: at K = 32768 rows it reads and writes about
100 bytes per row (3.3 MB) and does a few hundred float operations per row,
a few microseconds of work.  The eager chain it replaces issues one small
kernel per tensor operation, well over a hundred per step, each a launch
and a full pass over (E, A) tensors, so the kernel's gain is launches and
host time, not device bandwidth.  Its design: one thread per row, with no
fields-on-sublanes transpose (that layout exists for the TPU's lanes).  The vehicle and geometry scalars come
from one small float32 device buffer (:func:`pack_params`) built once with
the params, so no step waits on the host.  The source is compiled without
FMA contraction, and every operation is written in the order and rounding
of the PyTorch chain (IEEE division where PyTorch divides tensor by tensor,
``x * x`` for ``** 2``, round-half-even cells), so the kernel and its plain
version agree bit for bit on the card.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from red_gym_tpu_torch.config import Integrator, SimConfig, VehicleParams
from red_gym_tpu_torch.ops import _build, dynamics as dyn, integrate, scan_fast

PACK_LEN = 32   # floats in the pack_params buffer
_GEO_FIELDS = ("orig_x", "orig_y", "orig_c", "orig_s")


def steer_delay(depth: int, steer_buf, steer_cnt, raw_steer):
    """Steering delay line (base_classes.py:268-276): the first ``depth``
    steps see zero steer, afterwards the oldest value.
    -> (steer, steer_buf', steer_cnt')."""
    filled = steer_cnt >= depth
    steer = torch.where(filled, steer_buf[..., depth - 1],
                        torch.zeros_like(raw_steer))
    new_buf = torch.cat([raw_steer[..., None], steer_buf[..., : depth - 1]], dim=-1)
    new_cnt = torch.clamp(steer_cnt + 1, max=depth)
    return steer, new_buf, new_cnt


def dynamics_chain(cfg: SimConfig, p: VehicleParams, x, steer_buf, steer_cnt,
                   actions):
    """Steer delay -> speed controller -> integrator -> yaw wrap, eager.
    x (..., 7), actions (..., 2) -> (x', steer_buf', steer_cnt')."""
    raw_steer, vel_cmd = actions[..., 0], actions[..., 1]
    steer, steer_buf, steer_cnt = steer_delay(cfg.steer_delay, steer_buf,
                                              steer_cnt, raw_steer)
    controller = cfg.speed_controller or dyn.pid
    accl, sv = controller(vel_cmd, steer, x[..., 3], x[..., 2],
                          p.sv_max, p.a_max, p.v_max, p.v_min)
    xt = tuple(x[..., i] for i in range(7))
    xt = integrate.integrate_t(cfg.integrator, dyn.vehicle_dynamics_st_t,
                               xt, sv, accl, cfg.timestep, p)
    xt = xt[:4] + (integrate.wrap_yaw(xt[4]),) + xt[5:]
    return torch.stack(xt, dim=-1), steer_buf, steer_cnt


def supported(cfg: SimConfig, params) -> bool:
    """True iff the state kernel covers this config and these params
    (pallas_state.supported): fast scan, nearest1, float32, steer delay 2,
    the default PID, the megakernel resolving on (it alone reads the
    kernel's per-row operands), one map, and a scalar for every vehicle
    parameter."""
    return (cfg.scan_mode == "fast" and cfg.rt_spatial == "nearest1"
            and cfg.dtype == "float32" and cfg.steer_delay == 2
            and cfg.speed_controller is None and scan_fast.use_megakernel(cfg)
            and params.rtex is not None
            and params.rtex.rt.dim() == 2
            and all(getattr(params.vehicle, f).dim() == 0
                    for f in VehicleParams._fields))


def pack_params(vehicle: VehicleParams, tmap, rtex):
    """The kernel's (32,) float32 scalar buffer (pallas_state.pack_rows):
    the 18 vehicle fields in VehicleParams order, then orig_x, orig_y,
    orig_c, orig_s, cell, hc, wc.  None when a vehicle field is not a
    scalar (the kernel's scope).  Build it again after replacing the
    vehicle, map or texture of the params."""
    if rtex is None or any(getattr(vehicle, f).dim() != 0
                           for f in VehicleParams._fields):
        return None
    vals = ([getattr(vehicle, f) for f in VehicleParams._fields]
            + [getattr(tmap, f) for f in _GEO_FIELDS]
            + [rtex.cell, rtex.hc, rtex.wc])
    vals = [v.to(torch.float32) for v in vals]
    pack = torch.zeros((PACK_LEN,), dtype=torch.float32, device=rtex.rt.device)
    pack[:len(vals)] = torch.stack(vals)
    return pack


def prestep_reference(cfg: SimConfig, params, x, steer_buf, steer_cnt, actions):
    """Plain PyTorch version of the state kernel (same signature as
    :func:`prestep`): the eager chain of ``env.sim_step``.
    -> (x' (..., 7), steer_buf' (..., 2), steer_cnt' (...) int32,
    rows (...) int32, scal (..., 8))."""
    x, steer_buf, steer_cnt = dynamics_chain(cfg, params.vehicle, x, steer_buf,
                                             steer_cnt, actions)
    rows, scal = scan_fast.row_scalars(x[..., [0, 1, 4]], params.tmap,
                                       params.rtex, cfg, x[..., 3])
    return x, steer_buf, steer_cnt, rows, scal


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("prestep")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.prestep_launch.argtypes = [p, p, p, p, p, p, p, p, p, p, i, f, f, f,
                                   i, i, p]
    lib.prestep_launch.restype = ctypes.c_int
    return lib


def prestep(cfg: SimConfig, params, x, steer_buf, steer_cnt, actions):
    """The state kernel on a CUDA device, its plain twin on the CPU.

    x (..., 7), steer_buf (..., 2), steer_cnt (...) int32, actions (..., 2);
    ``params`` is an ``env.EnvParams`` with ``state_pack`` (pack_params).
    On CUDA tensors it launches the kernel or raises, never a fallback;
    callers check :func:`supported` first.  ``prestep.launches`` counts
    kernel launches."""
    lead = tuple(x.shape[:-1])
    if (x.shape[-1] != 7 or steer_buf.shape != lead + (2,)
            or steer_cnt.shape != lead or actions.shape != lead + (2,)):
        raise ValueError(f"prestep needs x (..., 7), steer_buf (..., 2), "
                         f"steer_cnt (...) and actions (..., 2), got "
                         f"{tuple(x.shape)}, {tuple(steer_buf.shape)}, "
                         f"{tuple(steer_cnt.shape)}, {tuple(actions.shape)}")
    device = x.device
    devices = {t.device for t in (x, steer_buf, steer_cnt, actions, params.rtex.rt)}
    if len(devices) != 1:
        raise ValueError(f"all operands must be on one device, got {devices}")
    if device.type == "cpu":
        return prestep_reference(cfg, params, x, steer_buf, steer_cnt, actions)
    if device.type != "cuda":
        raise ValueError(f"prestep runs on cuda or cpu, not {device}")
    if cfg.steer_delay != 2:
        raise ValueError(f"the CUDA kernel takes steer_delay=2, got {cfg.steer_delay}")
    for name, v in (("x", x), ("steer_buf", steer_buf), ("actions", actions)):
        if v.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 on CUDA, got {v.dtype}")
    if steer_cnt.dtype != torch.int32:
        raise ValueError(f"steer_cnt must be int32, got {steer_cnt.dtype}")
    pack = params.state_pack
    if pack is None or pack.shape != (PACK_LEN,) or pack.device != device:
        raise ValueError("params.state_pack must be state_kernels.pack_params "
                         "of these params, on the same device")
    if cfg.integrator not in (Integrator.RK4, Integrator.EULER):
        raise ValueError(f"unknown integrator {cfg.integrator}")

    k_n = math.prod(lead)
    x, steer_buf, steer_cnt, actions = (
        v.contiguous() for v in (x, steer_buf, steer_cnt, actions))
    x_out = torch.empty_like(x)
    buf_out = torch.empty_like(steer_buf)
    cnt_out = torch.empty_like(steer_cnt)
    rows = torch.empty(lead, dtype=torch.int32, device=device)
    scal = torch.empty(lead + (8,), dtype=torch.float32, device=device)
    if k_n == 0:
        return x_out, buf_out, cnt_out, rows, scal
    dt = cfg.timestep
    err = _lib().prestep_launch(
        x.data_ptr(), steer_buf.data_ptr(), steer_cnt.data_ptr(),
        actions.data_ptr(), pack.data_ptr(), x_out.data_ptr(),
        buf_out.data_ptr(), cnt_out.data_ptr(), rows.data_ptr(),
        scal.data_ptr(), k_n, dt / 2, dt, dt * (1.0 / 6.0),
        int(cfg.integrator is Integrator.RK4), cfg.rt_theta_bins,
        torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"prestep kernel launch failed: CUDA error {err}")
    prestep.launches += 1
    return x_out, buf_out, cnt_out, rows, scal


prestep.launches = 0
