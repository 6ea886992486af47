"""Host clocks of a run: the process's age, and the percentile of a list."""

from __future__ import annotations

import os
import time


def process_age_s() -> float:
    """Seconds since this process started (Linux: /proc/self/stat's start
    time against /proc/uptime, 10 ms resolution)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def now() -> float:
    return time.perf_counter()


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100) by linear interpolation between the
    order statistics (numpy's default)."""
    v = sorted(values)
    if not v:
        raise ValueError("no values")
    pos = (len(v) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def sync(device) -> None:
    """Wait for the device (the CPU needs no wait)."""
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def peak_bytes(device) -> int:
    """The device's peak of allocated memory in this process (0 on the CPU)."""
    import torch

    if torch.device(device).type != "cuda":
        return 0
    return int(torch.cuda.max_memory_allocated(device))


def release(device) -> None:
    """Hand the caching allocator's free blocks back (the CPU holds none)."""
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def say(msg: str) -> None:
    """A line of the run's progress on standard error, with the process's age."""
    import sys

    print(f"[{process_age_s():7.2f} s] {msg}", file=sys.stderr, flush=True)
