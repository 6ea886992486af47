"""Carry the JAX package's params and state across as the port's tensors.

Both packages can then compute on the identical texture, noise pool and
state.  Inputs are numpy arrays (the caller does ``np.asarray`` on the JAX
leaves, e.g. ``{k: np.asarray(v) for k, v in nt._asdict().items()}``);
nothing here imports JAX.  bfloat16 arrays (numpy dtype named "bfloat16")
keep their bits.
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

from red_gym_tpu_torch.config import SimConfig, VehicleParams
from red_gym_tpu_torch.env import EnvParams, EnvState
from red_gym_tpu_torch.maps.loader import TrackMap
from red_gym_tpu_torch.ops import scan as scan_ops, scan_fast, state_kernels


def to_tensor(a, device="cpu") -> torch.Tensor:
    """numpy array (incl. ml_dtypes bfloat16) -> tensor with the same values."""
    a = np.array(a, order="C")   # a C-ordered copy that keeps 0-d arrays 0-d
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def params_from_numpy(cfg: SimConfig, vehicle: Mapping, tables: Mapping,
                      tmap: Mapping, rtex: Mapping,
                      noise_pool: Optional[np.ndarray] = None,
                      device="cpu") -> EnvParams:
    """EnvParams from the numpy leaves of JAX ``EnvParams`` fields.

    ``rtex`` needs rt, valid, hc, wc, cell, fmat, gmat and smat; the port's
    per-step constants (fmat_sw, shift1, c_frac) and the state kernel's
    scalar pack are derived here.  ``noise_pool`` serves noise_mode "pool"
    and "pool_rot" alike.  ``tables.noise_pool_ext``, the JAX package's
    wrap-extended pool for "pool_rot", is left out: the port's megakernel
    indexes the pool modulo its row count and needs no extended copy."""
    t = lambda a: to_tensor(a, device)  # noqa: E731
    rt = {k: t(rtex[k]) for k in ("rt", "valid", "hc", "wc", "cell", "fmat",
                                  "gmat", "smat")}
    consts = scan_fast.texture_constants(cfg, rt["fmat"].dtype, device)
    rt.update({k: consts[k] for k in ("fmat_sw", "shift1", "c_frac")})
    veh = VehicleParams(**{k: t(vehicle[k]) for k in VehicleParams._fields})
    tm = TrackMap(**{k: t(tmap[k]) for k in TrackMap._fields})
    rtex_t = scan_fast.RangeTexture(**rt)
    return EnvParams(
        vehicle=veh,
        tables=scan_ops.ScanTables(**{k: t(tables[k]) for k in
                                      scan_ops.ScanTables._fields
                                      if k != "noise_pool_ext"}),
        tmap=tm, rtex=rtex_t,
        noise_pool=None if noise_pool is None else t(noise_pool),
        state_pack=state_kernels.pack_params(veh, tm, rtex_t))


def state_from_numpy(state: Mapping, device="cpu") -> EnvState:
    """EnvState from the numpy leaves of a batched JAX ``EnvState`` (leading
    env axis); the JAX PRNG key and map index are not carried over."""
    return EnvState(**{k: to_tensor(state[k], device) for k in EnvState._fields})
