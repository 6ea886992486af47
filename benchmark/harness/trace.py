"""A traced window: torch.profiler over a stretch of the run, reduced to
device busy time, device operations by name, host ranges, and the idle
gaps of the device labelled by the host range they fall in."""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from dataclasses import dataclass, field

TOP = 10   # entries of each breakdown list
# host ranges of the program (agents/ppo.py) and of the harness
RANGE_PREFIXES = ("ppo/", "bench/")


@dataclass
class Trace:
    window_s: float                       # host clock over the traced stretch
    device: list = field(default_factory=list)   # [(name, start_us, end_us)], by start
    ranges: list = field(default_factory=list)   # host ranges [(name, start_us, end_us)]

    @property
    def busy_s(self) -> float:
        """Seconds in which some operation ran on the device (the union of
        the device operations' intervals)."""
        return sum(b - a for a, b in self.busy_intervals()) / 1e6

    def busy_intervals(self) -> list:
        merged = []
        for _, a, b in self.device:
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return merged

    def ops(self, *patterns: str) -> list:
        """Device operations whose name holds one of ``patterns``, in order."""
        return [e for e in self.device if any(p in e[0] for p in patterns)]

    def range_seconds(self, name: str) -> float:
        return sum(b - a for n, a, b in self.ranges if n == name) / 1e6

    def idle_gaps(self) -> dict:
        """Idle seconds of the device by the innermost host range that holds
        each gap's midpoint ("outside any range" where none does)."""
        out = defaultdict(float)
        merged = self.busy_intervals()
        for (_, end), (start, _) in zip(merged, merged[1:]):
            mid = 0.5 * (end + start)
            inner = [(b - a, n) for n, a, b in self.ranges if a <= mid <= b]
            out[min(inner)[1] if inner else "outside any range"] += (start - end) / 1e6
        return dict(out)

    def breakdown(self) -> dict:
        by_op = defaultdict(float)
        for name, a, b in self.device:
            by_op[name] += (b - a) / 1e6
        top = sorted(by_op.items(), key=lambda kv: -kv[1])[:TOP]
        gaps = sorted(self.idle_gaps().items(), key=lambda kv: -kv[1])[:TOP]
        return {"device_ops": [[n, s] for n, s in top],
                "idle_gaps": [[n, s] for n, s in gaps]}


@contextlib.contextmanager
def traced(out: list, device):
    """Profile the body (CPU and CUDA activity); on exit, synchronise and
    append the body's Trace to ``out``."""
    from torch.profiler import ProfilerActivity, profile

    from harness import clock

    activities = [ProfilerActivity.CPU]
    if _on_cuda(device):
        activities.append(ProfilerActivity.CUDA)
    clock.sync(device)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        yield
        clock.sync(device)
        window_s = time.perf_counter() - t0
    out.append(reduce(prof, window_s))


def _on_cuda(device) -> bool:
    import torch

    return torch.device(device).type == "cuda"


def reduce(prof, window_s: float) -> Trace:
    """Device operations (kernels, copies, sets) and host ranges
    (``record_function`` names) of a finished profiler.  The profiler also
    records each host range on the device's timeline; those are ranges,
    not operations, and are left out of the device's list."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    events = list(prof.events())
    ranges = [(e.name, e.time_range.start, e.time_range.end) for e in events
              if e.device_type != cuda and (getattr(e, "is_user_annotation", False)
                                            or e.name.startswith(RANGE_PREFIXES))]
    names = {n for n, _, _ in ranges}
    device = sorted((e.name, e.time_range.start, e.time_range.end) for e in events
                    if e.device_type == cuda and e.name not in names
                    and not getattr(e, "is_user_annotation", False))
    device.sort(key=lambda e: e[1])
    return Trace(window_s=window_s, device=device, ranges=ranges)
