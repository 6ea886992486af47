"""Checkpoint/resume for env and trainer state with ``torch.save``.

PyTorch counterpart of ``red_gym_tpu/utils/checkpoint.py`` (orbax).  A tree
is saved as plain nested dicts of tensors and Python scalars, which
``torch.load(weights_only=True)`` reads back: a NamedTuple (``EnvState``,
``Observation``, ``PPOState``) as a dict of its fields, a module or an
optimizer as its ``state_dict()``, a generator as its ``get_state()``.
``restore(like=...)`` rebuilds the types of ``like`` on ``like``'s devices.

A process group's ranks checkpoint into a directory (``save_shards``):
each rank writes its own shard file of step k under ``step-k/``, and after
a barrier rank 0 writes ``STEP`` (k) atomically, so ``STEP`` names a step
whose shards are all on disk.  ``restore_shards`` reads STEP's shards back
with the same world size.  The process group itself is never saved.
"""

from __future__ import annotations

import os
import shutil
from typing import Any

import torch

from red_gym_tpu_torch.parallel import distributed


def _plain(tree: Any) -> Any:
    if isinstance(tree, torch.Tensor):
        return tree.detach()
    if isinstance(tree, (torch.nn.Module, torch.optim.Optimizer)):
        return tree.state_dict()
    if isinstance(tree, torch.Generator):
        return tree.get_state()
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return {f: _plain(v) for f, v in zip(tree._fields, tree)}
    if isinstance(tree, dict):
        return {k: _plain(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_plain(v) for v in tree]
    if tree is None or isinstance(tree, (bool, int, float, str)):
        return tree
    raise TypeError(f"cannot checkpoint a {type(tree).__name__}")


def _rebuild(like: Any, plain: Any) -> Any:
    if isinstance(like, torch.Tensor):
        if plain.shape != like.shape or plain.dtype != like.dtype:
            raise ValueError(f"checkpoint holds {plain.dtype} {tuple(plain.shape)} "
                             f"where the template has {like.dtype} {tuple(like.shape)}")
        return plain.to(like.device)
    if isinstance(like, (torch.nn.Module, torch.optim.Optimizer)):
        like.load_state_dict(plain)
        return like
    if isinstance(like, torch.Generator):
        like.set_state(plain)
        return like
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_rebuild(v, plain[f]) for f, v in zip(like._fields, like)))
    if isinstance(like, dict):
        return {k: _rebuild(v, plain[k]) for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(a, b) for a, b in zip(like, plain))
    return plain


def save(path: str, tree: Any, step: int = 0, overwrite: bool = True) -> str:
    """Save a tree (EnvState batch, PPOState, dicts of them, ...) to the
    file ``path`` -> its absolute path.  Written to a temporary file and
    renamed, so a reader never sees half a checkpoint."""
    path = os.path.abspath(path)
    if not overwrite and os.path.exists(path):
        raise FileExistsError(path)
    tmp = f"{path}.tmp"
    torch.save({"step": step, "tree": _plain(tree)}, tmp)
    os.replace(tmp, path)
    return path


def restore(path: str, like: Any = None) -> Any:
    """Restore a tree.  Without ``like``: the plain dicts, tensors on the
    CPU.  With ``like`` (a template of the saved tree): its NamedTuples and
    containers rebuilt, tensors on the template's devices, and its modules,
    optimizers and generators loaded in place (``load_state_dict``,
    ``set_state``) and returned."""
    plain = torch.load(os.path.abspath(path), map_location="cpu",
                       weights_only=True)["tree"]
    return plain if like is None else _rebuild(like, plain)


def _shard_file(directory: str, step: int, rank: int, world: int) -> str:
    return os.path.join(directory, f"step-{step}", f"shard-{rank:05d}-of-{world:05d}.pt")


def read_step(directory: str) -> int:
    """The step of the last complete sharded checkpoint in ``directory``."""
    with open(os.path.join(directory, "STEP")) as f:
        return int(f.read())


def save_shards(directory: str, tree: Any, step: int, mesh=None) -> str:
    """Save this rank's ``tree`` (its env rows, the replicated trainer
    state) as shard ``rank`` of ``mesh.world_size`` of ``step``; after a
    barrier rank 0 writes ``STEP`` atomically and removes older steps.
    Every rank of ``mesh`` (a ``parallel.sharding.EnvMesh``; None: one
    process) calls it -> the shard's path."""
    rank, world = (0, 1) if mesh is None else (mesh.rank, mesh.world_size)
    path = _shard_file(os.path.abspath(directory), step, rank, world)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    save(path, tree, step)
    distributed.barrier(None if mesh is None else mesh.group)
    if rank == 0:
        tmp = os.path.join(directory, "STEP.tmp")
        with open(tmp, "w") as f:
            f.write(str(step))
        os.replace(tmp, os.path.join(directory, "STEP"))
        for name in os.listdir(directory):
            if name.startswith("step-") and name != f"step-{step}":
                shutil.rmtree(os.path.join(directory, name), ignore_errors=True)
    return path


def restore_shards(directory: str, like: Any = None, mesh=None) -> tuple[Any, int]:
    """This rank's shard of the step in ``STEP`` -> (tree, step), rebuilt
    as ``restore`` does.  Raises ValueError when the checkpoint was written
    by another number of ranks."""
    rank, world = (0, 1) if mesh is None else (mesh.rank, mesh.world_size)
    step = read_step(directory)
    path = _shard_file(os.path.abspath(directory), step, rank, world)
    if not os.path.exists(path):
        saved = sorted(os.listdir(os.path.dirname(path)))
        raise ValueError(f"no shard {rank} of {world} ranks for step {step} in "
                         f"{directory}: it holds {saved}; restore with the world "
                         f"size that saved it")
    return restore(path, like), step
