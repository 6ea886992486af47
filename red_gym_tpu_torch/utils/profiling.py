"""Profiling and on-device metrics.

PyTorch counterpart of ``red_gym_tpu/utils/profiling.py``: a torch.profiler
trace context, a wall-clock step timer that waits for the device before it
reads the clock, and metric accumulators of 0-d device tensors, so a
training loop sums its metrics without a host sync a step.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Dict

import torch

from red_gym_tpu_torch.config import resolve_device


@contextlib.contextmanager
def trace(logdir: str):
    """torch.profiler trace of the block (host, and the card where there is
    one), written to ``logdir/trace.json`` (chrome://tracing, Perfetto)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        try:
            yield prof
        finally:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def _tensors(tree: Any):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def force(tree: Any) -> None:
    """Wait until the work behind the tensors of ``tree`` (a tensor, or
    nested dicts, lists and tuples of them) is done: a synchronize of each
    CUDA device they lie on; CPU tensors are ready already."""
    for dev in {t.device for t in _tensors(tree) if t.is_cuda}:
        torch.cuda.synchronize(dev)


class StepTimer:
    """Wall-clock rate meter for step functions."""

    def __init__(self):
        self.reset()

    def reset(self):
        self._t0 = time.time()
        self._count = 0

    def tick(self, n: int = 1):
        self._count += n

    def rate(self, out: Any = None) -> float:
        if out is not None:
            force(out)
        dt = time.time() - self._t0
        return self._count / dt if dt > 0 else float("inf")


class Metrics:
    """Metric accumulators: sums and a count, 0-d tensors on one device."""

    @staticmethod
    def init(names, dtype=torch.float32, device="cuda") -> Dict[str, torch.Tensor]:
        device = resolve_device(device)
        d = {n: torch.zeros((), dtype=dtype, device=device) for n in names}
        d["_count"] = torch.zeros((), dtype=dtype, device=device)
        return d

    @staticmethod
    def update(acc, **values):
        out = dict(acc)
        for k, v in values.items():
            # cast to the accumulator dtype, as JAX does to keep its carry
            out[k] = acc[k] + torch.as_tensor(v, device=acc[k].device).to(acc[k].dtype)
        out["_count"] = acc["_count"] + 1.0
        return out

    @staticmethod
    def means(acc) -> Dict[str, float]:
        """The mean of each metric, read on the host in one copy."""
        keys = [k for k in acc if k != "_count"]
        vals = torch.stack([acc[k] for k in keys] + [acc["_count"]]).tolist()
        n = max(vals[-1], 1.0)
        return {k: v / n for k, v in zip(keys, vals)}
