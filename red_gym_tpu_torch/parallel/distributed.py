"""Multi-process execution: the ``torch.distributed`` process group and the
split of env rows between its ranks.

PyTorch counterpart of ``red_gym_tpu/parallel/distributed.py``.  The JAX
package assembles every process's chips into one global mesh and runs one
sharded program; here each rank is a process with its envs' rows on its
device, and the learner's collectives are explicit (``agents/ppo.py``).
Rank r of P holds env rows [r E/P, (r+1) E/P), as JAX's process r does.

Launch under torchrun, which sets ``MASTER_ADDR``, ``MASTER_PORT``,
``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK`` and ``LOCAL_WORLD_SIZE``::

    torchrun --nproc-per-node=N -m red_gym_tpu_torch.examples.train_ppo ...

or pass ``init_method`` (``tcp://host:port``), ``world_size`` and ``rank``
to ``initialize`` yourself.  The backend is NCCL when every rank of a host
has a card of its own, gloo on the CPU or when ranks share a card; the
choice is printed, and a failing NCCL initialisation raises.
"""

from __future__ import annotations

import datetime
import os
import socket
from typing import Optional

import torch
import torch.distributed as dist

from red_gym_tpu_torch.parallel import draws

DEFAULT_TIMEOUT = datetime.timedelta(seconds=30)


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v else None


def local_rank() -> int:
    """This process's rank on its host: ``LOCAL_RANK`` (torchrun), else
    its global rank (every rank on one host)."""
    lr = _env_int("LOCAL_RANK")
    if lr is not None:
        return lr
    return dist.get_rank() if is_initialized() else 0


def local_world_size(world_size: int) -> int:
    """Ranks on this host: ``LOCAL_WORLD_SIZE`` (torchrun), else all."""
    return _env_int("LOCAL_WORLD_SIZE") or world_size


def choose_backend(device: str = "cuda", world_size: int = 1) -> str:
    """"nccl" when each rank of this host gets a card of its own, "gloo" on
    the CPU or when ranks share a card."""
    if torch.device(device).type == "cpu":
        return "gloo"
    if not torch.cuda.is_available():
        raise RuntimeError("device='cuda' needs a GPU; pass device='cpu' for the "
                           "CPU (gloo)")
    if torch.cuda.device_count() >= local_world_size(world_size):
        return "nccl"
    return "gloo"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def initialize(init_method: Optional[str] = None, world_size: Optional[int] = None,
               rank: Optional[int] = None, backend: Optional[str] = None,
               timeout: datetime.timedelta = DEFAULT_TIMEOUT,
               device: str = "cuda") -> None:
    """Join the process group (JAX ``initialize``).

    Arguments left None come from torchrun's environment (``WORLD_SIZE``,
    ``RANK``, and ``MASTER_ADDR``/``MASTER_PORT`` through ``env://``).
    With neither, a group of one process on a free local port.  ``backend``
    None picks by ``choose_backend(device, world_size)``.  Under NCCL each
    rank's current card is ``cuda:LOCAL_RANK``.  A second call is a no-op.
    ``timeout`` bounds every collective, so that a dead peer raises."""
    if is_initialized():
        return
    world_size = world_size if world_size is not None else _env_int("WORLD_SIZE")
    rank = rank if rank is not None else _env_int("RANK")
    if init_method is None:
        if os.environ.get("MASTER_ADDR") and os.environ.get("MASTER_PORT"):
            init_method = "env://"
        elif world_size in (None, 1):
            init_method, world_size, rank = f"tcp://127.0.0.1:{_free_port()}", 1, 0
        else:
            raise ValueError("a group of several processes needs init_method or "
                             "MASTER_ADDR and MASTER_PORT (torchrun sets them)")
    world_size = 1 if world_size is None else world_size
    rank = 0 if rank is None else rank
    backend = backend or choose_backend(device, world_size)
    if backend == "nccl":
        torch.cuda.set_device(local_rank() if _env_int("LOCAL_RANK") is not None
                              else rank % torch.cuda.device_count())
    print(f"[distributed] rank {rank} of {world_size}: backend {backend} "
          f"({init_method})", flush=True)
    dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                            rank=rank, timeout=timeout)


def is_distributed() -> bool:
    return is_initialized() and dist.get_world_size() > 1


def world_size() -> int:
    return dist.get_world_size() if is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if is_initialized() else 0


def local_device(device: str = "cuda") -> torch.device:
    """This rank's device: the CPU when asked for, else ``cuda:LOCAL_RANK``
    (modulo the cards of the host, when ranks share them)."""
    if torch.device(device).type == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("device='cuda' needs a GPU; pass device='cpu'")
    return torch.device("cuda", local_rank() % torch.cuda.device_count())


def process_env_slice(n_global_envs: int, world: Optional[int] = None,
                      r: Optional[int] = None) -> slice:
    """The env rows [r E/P, (r+1) E/P) of rank r of P (JAX
    ``process_env_slice``); raises ValueError unless P divides E."""
    p = world_size() if world is None else world
    r = rank() if r is None else r
    if n_global_envs % p:
        raise ValueError(f"{n_global_envs} envs not divisible by {p} processes")
    per = n_global_envs // p
    return slice(r * per, (r + 1) * per)


def map_tree(fn, tree):
    """``fn`` on every tensor leaf of NamedTuples, dicts, lists and tuples;
    other leaves (None, numbers) as they are."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_tree(fn, v) for v in tree))
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tree(fn, v) for v in tree)
    return tree


def local_rows(tree, n_global: int, device=None, world: Optional[int] = None,
               r: Optional[int] = None):
    """This rank's rows of a host-made global env tree (JAX
    ``global_env_tree``: there is no global array in torch): every tensor
    leaf of n_global leading rows is cut to ``process_env_slice`` (of
    ``world`` ranks and rank ``r``, the group's by default) and copied to
    ``device`` (its own device if None); 0-d leaves are kept whole on
    every rank; None stays None."""
    rows = process_env_slice(n_global, world, r)

    def cut(x):
        if x.dim() == 0:
            return x if device is None else x.to(device)
        if x.shape[0] != n_global:
            raise ValueError(f"a leaf of {x.shape[0]} rows in a tree of {n_global} envs")
        return x[rows].to(device or x.device, copy=True)

    return map_tree(cut, tree)


def all_gather_rows(tree, group=None):
    """Every rank's rows of an env tree, concatenated in rank order (for
    evaluation and metrics): each tensor leaf's rows are gathered along
    its first axis; 0-d leaves are taken from this rank.  Ranks may hold
    different row counts.  Under gloo, card tensors go through the host."""
    if not is_initialized() or dist.get_world_size(group) == 1:
        return tree

    def gather(x):
        if x.dim() == 0:
            return x
        counts = draws.gather_counts(x.shape[0], group)
        dev = draws.collective_device(group)
        dt = torch.uint8 if x.dtype == torch.bool else x.dtype
        buf = torch.zeros((max(counts),) + tuple(x.shape[1:]), dtype=dt, device=dev)
        buf[:x.shape[0]] = x.to(device=dev, dtype=dt)
        out = [torch.empty_like(buf) for _ in counts]
        dist.all_gather(out, buf, group=group)
        return torch.cat([o[:c] for o, c in zip(out, counts)]).to(x.device, x.dtype)

    return map_tree(gather, tree)


def barrier(group=None) -> None:
    if is_initialized():
        if dist.get_backend(group) == "nccl":
            dist.barrier(group=group, device_ids=[torch.cuda.current_device()])
        else:
            dist.barrier(group=group)


def shutdown() -> None:
    """Leave the process group (a no-op outside one)."""
    if is_initialized():
        dist.destroy_process_group()
