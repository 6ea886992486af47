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
100 bytes per row (3.3 MB), a microsecond at the memory rate, but each row
is a serial chain of four right-hand sides of accurate transcendentals and
IEEE divisions, so one thread a row leaves too few warps to hide its
latency.  The kernel splits each right-hand side into tasks that two warps
share (``csrc/prestep.cu``).  The eager chain it replaces launches one small
kernel per tensor operation, well over a hundred per step, so on a path
the gain is launches and host time as much as device time; on the host,
the wrapper is what a step pays for it.  The vehicle and geometry scalars
come from one small float32 device buffer (:func:`pack_params`), built
from the params of the step as the JAX package's ``pack_rows`` is;
:func:`step_pack` builds it again only when one of those params changed,
so a step on unchanged params launches no device op and waits on nothing
for it.  The source is compiled without FMA contraction, and every
operation is written in the order and rounding of the PyTorch chain (IEEE
division where PyTorch divides tensor by tensor, ``x * x`` for ``** 2``,
round-half-even cells), so the kernel and its plain version agree bit for
bit on the card.
"""

from __future__ import annotations


import torch

from refsim.config import SimConfig, VehicleParams
from refsim.ops import dynamics as dyn, integrate, scan_fast

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
    orig_c, orig_s, cell, hc, wc, zeros.  None when a vehicle field is not
    a scalar (the kernel's scope).  Reads the tensors as they are now, on
    the device: a few small device ops and no host wait.  A step takes it
    through :func:`step_pack`, which builds it again when they change."""
    if rtex is None or any(getattr(vehicle, f).dim() != 0
                           for f in VehicleParams._fields):
        return None
    vals = ([getattr(vehicle, f) for f in VehicleParams._fields]
            + [getattr(tmap, f) for f in _GEO_FIELDS]
            + [rtex.cell, rtex.hc, rtex.wc])
    vals = [v.to(torch.float32) for v in vals]
    zero = vals[0].new_zeros(())
    return torch.stack(vals + [zero] * (PACK_LEN - len(vals)))


def prestep_reference(cfg: SimConfig, params, x, steer_buf, steer_cnt, actions):
    """Plain PyTorch version of the state kernel (the arguments of
    :func:`prestep` but the pack): the eager chain of ``env.sim_step``.
    -> (x' (..., 7), steer_buf' (..., 2), steer_cnt' (...) int32,
    rows (...) int32, scal (..., 8))."""
    x, steer_buf, steer_cnt = dynamics_chain(cfg, params.vehicle, x, steer_buf,
                                             steer_cnt, actions)
    rows, scal = scan_fast.row_scalars(x[..., [0, 1, 4]], params.tmap,
                                       params.rtex, cfg, x[..., 3])
    return x, steer_buf, steer_cnt, rows, scal


def _sources(params) -> tuple:
    """The 25 tensors :func:`pack_params` reads, in its order."""
    tmap, rtex = params.tmap, params.rtex
    return (*params.vehicle, *(getattr(tmap, f) for f in _GEO_FIELDS),
            rtex.cell, rtex.hc, rtex.wc)


# step_pack's one entry, replaced whole and read once: the cfg, the source
# tensors the pack was computed from (held, so that no id is reused), their
# versions, and the pack
_STEP_PACK = (None, (), (), None)


def step_pack(cfg: SimConfig, params):
    """The pack of a step of ``cfg`` on ``params``: ``pack_params`` of the
    params as they are now where :func:`supported` holds, else None.

    A one-entry cache computes both again only when ``cfg``, one of the 25
    tensors the pack reads (:func:`_sources`) or one's ``_version``
    changed: a replaced field is another tensor, an in-place edit bumps
    the version.  So a step whose params did not change launches no device
    op and reads no vehicle field's shape for it, and a step whose params
    did change gets their pack (fault C1).  Inference tensors keep no
    version counter, so params made under ``torch.inference_mode()`` get
    their pack built at every step and are not cached."""
    global _STEP_PACK
    rtex = params.rtex
    if rtex is None or rtex.rt.dim() != 2:
        return None
    sources = _sources(params)
    try:
        versions = tuple(t._version for t in sources)
    except RuntimeError:  # an inference tensor
        return (pack_params(params.vehicle, params.tmap, rtex)
                if supported(cfg, params) else None)
    c_cfg, c_sources, c_versions, c_pack = _STEP_PACK
    if (cfg is c_cfg and versions == c_versions
            and all(a is b for a, b in zip(sources, c_sources))):
        return c_pack
    pack = (pack_params(params.vehicle, params.tmap, rtex)
            if supported(cfg, params) else None)
    _STEP_PACK = (cfg, sources, versions, pack)
    return pack


def prestep(cfg: SimConfig, params, x, steer_buf, steer_cnt, actions, pack):
    """The state kernel's plain twin (:func:`prestep_reference`) on every
    device; ``pack`` is not read."""
    return prestep_reference(cfg, params, x, steer_buf, steer_cnt, actions)
