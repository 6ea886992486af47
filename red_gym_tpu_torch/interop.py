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

from red_gym_tpu_torch.agents.pure_pursuit import PurePursuitParams
from red_gym_tpu_torch.config import SimConfig, VehicleParams, resolve_device
from red_gym_tpu_torch.env import EnvParams, EnvState
from red_gym_tpu_torch.maps.loader import TrackMap
from red_gym_tpu_torch.ops import scan as scan_ops, scan_fast


def to_tensor(a, device="cuda") -> torch.Tensor:
    """numpy array (incl. ml_dtypes bfloat16) -> tensor with the same values
    on ``device`` (the card unless the caller passes "cpu")."""
    device = resolve_device(device)
    a = np.array(a, order="C")   # a C-ordered copy that keeps 0-d arrays 0-d
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def params_from_numpy(cfg: SimConfig, vehicle: Mapping, tables: Mapping,
                      tmap: Mapping, rtex: Optional[Mapping],
                      noise_pool: Optional[np.ndarray] = None,
                      device="cuda") -> EnvParams:
    """EnvParams from the numpy leaves of JAX ``EnvParams`` fields.

    ``rtex`` needs rt, valid, hc, wc, cell, fmat, gmat and smat; the port's
    per-step constants (fmat_sw, shift1, c_frac) are derived here.  It is
    None for the exact scan, whose JAX params carry no texture.  Map-stacked
    params (JAX ``make_multimap_params``) come across as they are: ``tmap``
    leaves with a leading map axis, and a stacked ``rtex`` (rt (M, N, C*T),
    valid (M, N), hc, wc, cell (M,)).
    ``noise_pool`` serves noise_mode "pool" and "pool_rot" alike.  ``tables.noise_pool_ext``, the JAX package's
    wrap-extended pool for "pool_rot", is left out: the port's megakernel
    indexes the pool modulo its row count and needs no extended copy."""
    device = resolve_device(device)
    t = lambda a: to_tensor(a, device)  # noqa: E731
    rtex_t = None if rtex is None else texture_from_numpy(cfg, rtex, device)
    veh = VehicleParams(**{k: t(vehicle[k]) for k in VehicleParams._fields})
    tm = TrackMap(**{k: t(tmap[k]) for k in TrackMap._fields})
    return EnvParams(
        vehicle=veh,
        tables=scan_ops.ScanTables(**{k: t(tables[k]) for k in
                                      scan_ops.ScanTables._fields
                                      if k != "noise_pool_ext"}),
        tmap=tm, rtex=rtex_t,
        noise_pool=None if noise_pool is None else t(noise_pool))


def texture_from_numpy(cfg: SimConfig, rtex: Mapping,
                       device="cuda") -> scan_fast.RangeTexture:
    """RangeTexture from the numpy leaves of a JAX ``RangeTexture`` (one
    map's or a stack's): rt, valid, hc, wc, cell, fmat, gmat and smat, plus
    the port's per-step constants fmat_sw, shift1 and c_frac, derived
    here."""
    device = resolve_device(device)
    rt = {k: to_tensor(rtex[k], device) for k in ("rt", "valid", "hc", "wc", "cell",
                                                  "fmat", "gmat", "smat")}
    consts = scan_fast.texture_constants(cfg, rt["fmat"].dtype, device)
    rt.update({k: consts[k] for k in ("fmat_sw", "shift1", "c_frac")})
    return scan_fast.RangeTexture(**rt)


def state_from_numpy(state: Mapping, device="cuda") -> EnvState:
    """EnvState from the numpy leaves of a batched JAX ``EnvState`` (leading
    env axis), ``map_idx`` (as int32) when it is there; the JAX PRNG key is
    not carried over."""
    device = resolve_device(device)
    fields = {k: to_tensor(state[k], device) for k in EnvState._fields
              if state.get(k) is not None}
    if "map_idx" in fields:
        fields["map_idx"] = fields["map_idx"].to(torch.int32)
    return EnvState(**fields)


def policy_from_numpy(flax_params: Mapping) -> dict:
    """The port's ``ScanPolicy`` state_dict from the numpy leaves of a flax
    ``ScanPolicy`` param tree (with or without its outer "params" key):
    ``Dense_i`` ``kernel`` (in, out) transposed to ``Linear.weight`` (out,
    in), ``bias`` and ``log_std`` as they are.  ``Dense_0`` and ``Dense_1``
    are the hidden layers, ``Dense_2`` the mean head and ``Dense_3`` the
    value head, in call order.  Tensors on the CPU;
    ``policy.load_state_dict`` copies them onto the policy's device and
    dtype."""
    p = flax_params.get("params", flax_params)
    out = {}
    for i, name in enumerate(("hidden_0", "hidden_1", "mean", "value")):
        dense = p[f"Dense_{i}"]
        out[f"{name}.weight"] = torch.from_numpy(np.array(dense["kernel"]).T.copy())
        out[f"{name}.bias"] = torch.from_numpy(np.array(dense["bias"]))
    out["log_std"] = torch.from_numpy(np.array(p["log_std"]))
    return out


# flax submodule names, in call order, of each SAC network -> the port's
# module names (agents/sac.py)
_SAC_LAYERS = {
    "actor": {"Dense_0": "dense_0", "Dense_1": "mean", "Dense_2": "log_std"},
    "critic": {"Dense_0": "dense_0", "Dense_1": "out"},
    "scan_actor": {"Dense_0": "mean", "Dense_1": "log_std"},
    "scan_critic": {"Dense_0": "dense_0", "Dense_1": "out"},
}


def sac_from_numpy(flax_params: Mapping, kind: str) -> dict:
    """The state_dict of the port's ``Actor``, ``Critic``, ``ScanActor`` or
    ``ScanCritic`` (``kind`` "actor", "critic", "scan_actor",
    "scan_critic") from the numpy leaves of the flax module's param tree
    (with or without its outer "params" key).  ``ConvTrunk_0/Conv_i``
    kernels (kh, kw, in, out) become ``Conv2d.weight`` (out, in, kh, kw);
    ``ScanTrunk_0/Dense_i`` and the ``Dense_i`` of the head (in call order)
    have their (in, out) kernels transposed to ``Linear.weight``.  Tensors
    on the CPU; ``load_state_dict`` copies them onto the module's device
    and dtype."""
    if kind not in _SAC_LAYERS:
        raise ValueError(f"kind must be one of {sorted(_SAC_LAYERS)}, got {kind!r}")
    p = flax_params.get("params", flax_params)
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    out = {}

    def dense(layer, name):
        out[f"{name}.weight"] = t(np.array(layer["kernel"]).T.copy())
        out[f"{name}.bias"] = t(layer["bias"])

    if kind in ("actor", "critic"):
        for i in range(3):
            conv = p["ConvTrunk_0"][f"Conv_{i}"]
            out[f"trunk.conv_{i}.weight"] = t(
                np.ascontiguousarray(np.array(conv["kernel"]).transpose(3, 2, 0, 1)))
            out[f"trunk.conv_{i}.bias"] = t(conv["bias"])
    else:
        for i in range(2):
            dense(p["ScanTrunk_0"][f"Dense_{i}"], f"trunk.dense_{i}")
    for flax_name, name in _SAC_LAYERS[kind].items():
        dense(p[flax_name], name)
    return out


def pure_pursuit_from_numpy(ppp: Mapping, device="cuda"):
    """``agents.pure_pursuit.PurePursuitParams`` from the numpy leaves of
    the JAX package's (one map's or a stack's)."""
    device = resolve_device(device)
    return PurePursuitParams(**{k: to_tensor(ppp[k], device)
                                for k in PurePursuitParams._fields})
