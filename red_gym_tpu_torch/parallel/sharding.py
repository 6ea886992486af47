"""Env rows sharded over the ranks of a process group, learner replicated.

PyTorch counterpart of ``red_gym_tpu/parallel/sharding.py``.  JAX shards
every leading env axis over a 1-D ``env`` mesh and lets XLA insert the
gradient psum; here a rank keeps its rows of every env tree
(``shard_envs``), every rank holds the shared params (``shard_params``)
and the same trainer state (``replicate``), and ``agents.ppo.PPO`` with a
mesh of several ranks reduces gradients and statistics itself.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

from red_gym_tpu_torch.env import EnvParams
from red_gym_tpu_torch.maps.loader import TrackMap
from red_gym_tpu_torch.parallel import distributed, draws


class EnvMesh(NamedTuple):
    """The 1-D env mesh of a process group: P ranks, this one's rank and
    device, and the group (None: the default group, or no group)."""

    world_size: int
    rank: int
    device: torch.device
    group: object = None


def make_env_mesh(n: Optional[int] = None, device: str = "cuda") -> EnvMesh:
    """The mesh of every rank of the process group (one rank without a
    group), on ``distributed.local_device(device)``.  ``n``, where given,
    must be the world size: a mesh spans the whole group."""
    world = distributed.world_size()
    if n is not None and n != world:
        raise ValueError(f"a mesh of {n} ranks in a group of {world}: the mesh "
                         f"spans the whole group")
    return EnvMesh(world, distributed.rank(), distributed.local_device(device))


def rows(mesh: EnvMesh, n_global: int) -> slice:
    """The env rows of this rank of ``mesh``."""
    return distributed.process_env_slice(n_global, mesh.world_size, mesh.rank)


def shard_envs(mesh: EnvMesh, tree, n_global: Optional[int] = None):
    """This rank's rows of every leaf of a global env tree (leading env
    axis; 0-d leaves whole), on the mesh's device.  ``n_global`` defaults
    to the rows of the tree's first leaf with any."""
    if n_global is None:
        n_global = _first_rows(tree)
    return distributed.local_rows(tree, n_global, mesh.device, mesh.world_size, mesh.rank)


def _first_rows(tree) -> int:
    found = []
    distributed.map_tree(lambda x: found.append(x) if x.dim() else None, tree)
    if not found:
        raise ValueError("the tree has no leaf with an env axis")
    return found[0].shape[0]


@contextlib.contextmanager
def env_draws(mesh: Optional[EnvMesh], n_local: int):
    """Random draws of this rank's ``n_local`` env rows made for all ranks'
    rows (``parallel.draws.row_draws``); a no-op without a mesh or on one
    rank."""
    if mesh is None or mesh.world_size == 1:
        yield
        return
    with draws.row_draws(n_local * mesh.world_size, n_local * mesh.rank, mesh.group):
        yield


def _broadcast_tensor(mesh: EnvMesh, t: torch.Tensor) -> None:
    dev = draws.collective_device(mesh.group)
    buf = t.detach().to(dev).clone()
    dist.broadcast(buf, src=0, group=mesh.group)
    with torch.no_grad():
        t.copy_(buf.to(t.device))


def replicate(mesh: EnvMesh, obj):
    """Make ``obj`` rank 0's on every rank, in place where it can be, and
    return it: a tensor, an ``nn.Module`` (parameters and buffers), an
    optimizer (its state tensors; created first where a rank has none), a
    generator (its state), or a tuple, list or dict of them.  A no-op on
    a one-rank mesh."""
    if mesh.world_size == 1:
        return obj
    if isinstance(obj, torch.Tensor):
        _broadcast_tensor(mesh, obj)
        return obj
    if isinstance(obj, torch.nn.Module):
        for t in list(obj.parameters()) + list(obj.buffers()):
            _broadcast_tensor(mesh, t)
        return obj
    if isinstance(obj, torch.optim.Optimizer):
        for group in obj.param_groups:
            for p in group["params"]:
                st = obj.state[p]
                for k in sorted(st):
                    if isinstance(st[k], torch.Tensor):
                        _broadcast_tensor(mesh, st[k])
        return obj
    if isinstance(obj, torch.Generator):
        state = obj.get_state()
        _broadcast_tensor(mesh, state)
        obj.set_state(state)
        return obj
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(replicate(mesh, v) for v in obj))
    if isinstance(obj, dict):
        return {k: replicate(mesh, v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(replicate(mesh, v) for v in obj)
    return obj


def shard_params(mesh: EnvMesh, params: EnvParams, map_axis: Optional[int] = None
                 ) -> EnvParams:
    """The env params of this rank (JAX ``shard_params``): the vehicle, the
    lidar tables, the map, the texture and the noise pool whole on the
    mesh's device (every rank builds them from the same files); under
    ``map_axis=0`` (one map a env along the leading axis of the map's and
    the texture's fields) this rank's envs' maps."""
    dev = mesh.device

    def to(x):
        return None if x is None else distributed.map_tree(lambda t: t.to(dev), x)

    tmap, rtex = to(params.tmap), to(params.rtex)
    if map_axis is not None:
        if map_axis != 0:
            raise ValueError(f"map_axis must be 0 or None, got {map_axis}")
        n_global = tmap.dt.shape[0]
        sl = rows(mesh, n_global)
        tmap = TrackMap(*(f[sl].clone() for f in tmap))
        if rtex is not None:
            per_env = ("rt", "valid", "hc", "wc", "cell")
            rtex = rtex._replace(**{f: getattr(rtex, f)[sl].clone() for f in per_env})
    return EnvParams(vehicle=to(params.vehicle), tables=to(params.tables), tmap=tmap,
                     rtex=rtex, noise_pool=to(params.noise_pool))
