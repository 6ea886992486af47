"""Checkpoint/resume for env and trainer state with ``torch.save``.

PyTorch counterpart of ``red_gym_tpu/utils/checkpoint.py`` (orbax).  A tree
is saved as plain nested dicts of tensors and Python scalars, which
``torch.load(weights_only=True)`` reads back: a NamedTuple (``EnvState``,
``Observation``, ``PPOState``) as a dict of its fields, a module or an
optimizer as its ``state_dict()``, a generator as its ``get_state()``.
``restore(like=...)`` rebuilds the types of ``like`` on ``like``'s devices.
"""

from __future__ import annotations

import os
from typing import Any

import torch


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
