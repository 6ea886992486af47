"""Profiling: spans and counters on the profiler's clock, set-up timing,
and on-device metrics.

PyTorch counterpart of ``red_gym_tpu/utils/profiling.py``, and the port's
one tracing module:

- ``span(name)`` marks a stretch of the step path.  While a torch.profiler
  session records, it is a ``record_function`` range, on the clock of the
  device's operations, so a trace attributes each idle gap of the device
  to the innermost span around it.  With no session recording it costs
  one flag check.
- ``count(name, n)`` adds ``n`` to a counter while a session records, so
  a traced window's counters hold that window.  ``n`` is a host number:
  a counter never reads a device tensor (that would wait for the device).
- ``setup_span(name)`` is a span that also times work done once per
  process or per map (params, maps, EDTs, textures), always: its seconds
  end in a synchronize of the card, so they hold the device work it
  queued.
- ``span_totals``, ``counter_totals`` and ``reset_totals`` read and clear
  the set-up spans' seconds and the counters; ``trace(logdir)`` exports a
  profiled block with them beside it.

Also ``force`` (wait for a tree of tensors) and ``Metrics``, accumulators
of 0-d device tensors, so a training loop sums its metrics without a host
sync a step.  Unlike the JAX package there is no ``StepTimer``: a rate is
measured by the caller around work that ends in a synchronize.

The span names are a contract: the benchmark's per-layer metrics read
them (``env/*`` and ``scan/prep`` in ``env.py`` and ``ops/scan_fast.py``,
``rollout/*`` in ``rollout.py``, ``ppo/*`` and ``plan/*`` in
``agents/``, ``setup/*`` where the params are made).
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import time
from typing import Any, Dict

import torch
from torch.autograd import profiler as _autograd_profiler

from red_gym_tpu_torch.config import resolve_device

# set-up spans by name ({"count", "seconds"}) and counters by name
_SPANS: Dict[str, dict] = {}
_COUNTERS: Dict[str, float] = {}


class span:
    """A ``record_function`` range named ``name`` while a profiler session
    records (the flag the profiler sets as it starts and clears as it
    stops); otherwise nothing but that flag check.  A class, not a
    generator: entering and leaving it allocate nothing else."""

    __slots__ = ("name", "_range")

    def __init__(self, name: str):
        self.name = name
        self._range = None

    def __enter__(self):
        if _autograd_profiler._is_profiler_enabled:
            self._range = _autograd_profiler.record_function(self.name).__enter__()
        return self

    def __exit__(self, *exc):
        if self._range is not None:
            self._range.__exit__(*exc)
        return False


def count(name: str, n) -> None:
    """Add the host number ``n`` to counter ``name`` while a profiler
    session records; otherwise nothing but the flag check."""
    if _autograd_profiler._is_profiler_enabled:
        if isinstance(n, torch.Tensor):
            raise TypeError(f"counter {name!r} takes a host number, not a tensor: "
                            "reading one would wait for the device")
        _COUNTERS[name] = _COUNTERS.get(name, 0) + n


class setup_span(span):
    """A span that always adds its seconds and its count to the set-up
    spans' totals.  Its seconds end in a synchronize of the card (where
    CUDA is in use), so they hold the device work queued inside it; once
    per process or per map, that costs nothing on a step.  A context
    manager, and a decorator as ``@setup_span(name)``."""

    __slots__ = ("_t0",)

    def __enter__(self):
        super().__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if exc[0] is None and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        entry = _SPANS.setdefault(self.name, {"count": 0, "seconds": 0.0})
        entry["count"] += 1
        entry["seconds"] += time.perf_counter() - self._t0
        return super().__exit__(*exc)

    def __call__(self, fn):
        @functools.wraps(fn)
        def timed(*args, **kwargs):
            with setup_span(self.name):
                return fn(*args, **kwargs)
        return timed


def span_totals() -> Dict[str, dict]:
    """{name: {"count", "seconds"}} of the set-up spans so far."""
    return {k: dict(v) for k, v in _SPANS.items()}


def counter_totals() -> Dict[str, float]:
    """{name: total} of the counters so far."""
    return dict(_COUNTERS)


def reset_totals() -> None:
    """Clear the set-up spans' totals and the counters."""
    _SPANS.clear()
    _COUNTERS.clear()


@contextlib.contextmanager
def trace(logdir: str):
    """torch.profiler trace of the block (host, and the card where there is
    one), written to ``logdir/trace.json`` (chrome://tracing, Perfetto),
    with the registry (``span_totals``, ``counter_totals``) beside it in
    ``logdir/spans.json``."""
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
    with open(os.path.join(logdir, "spans.json"), "w") as f:
        json.dump({"spans": span_totals(), "counters": counter_totals()}, f, indent=1)


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
