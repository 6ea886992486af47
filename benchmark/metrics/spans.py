"""The program's spans as the per-layer readers see them: the seconds of a
set-up span (``red_gym_tpu_torch.utils.profiling.span_totals``), and the
device's idle time inside a host range of the traced window.  A program
without the registry or without the span gives None."""

from __future__ import annotations

import bisect


def setup_seconds(name: str):
    """Seconds of the program's set-up spans ``name`` (host clock, each
    ending in a synchronize of the card), or None."""
    from red_gym_tpu_torch.utils import profiling

    totals = getattr(profiling, "span_totals", None)
    entry = None if totals is None else totals().get(name)
    return None if entry is None else entry["seconds"]


def idle_inside(trace, name: str):
    """Seconds of the device's idle gaps (between the merged busy intervals,
    as ``Trace.idle_gaps`` takes them) whose midpoint lies inside some host
    range ``name``; overlapping or nested ranges count a gap once.  None if
    the trace holds no such range or no device operation."""
    ranges = sorted((a, b) for n, a, b in trace.ranges if n == name)
    if not ranges or not trace.device:
        return None
    union = []
    for a, b in ranges:
        if union and a <= union[-1][1]:
            union[-1][1] = max(union[-1][1], b)
        else:
            union.append([a, b])
    starts = [a for a, _ in union]
    busy = trace.busy_intervals()
    total = 0.0
    for (_, end), (start, _) in zip(busy, busy[1:]):
        mid = 0.5 * (end + start)
        i = bisect.bisect_right(starts, mid) - 1
        if i >= 0 and mid <= union[i][1]:
            total += start - end
    return total / 1e6


def idle_pct_inside(run, name: str):
    """100 x ``idle_inside`` over the traced window, or None."""
    if run.trace is None:
        return None
    idle = idle_inside(run.trace, name)
    return None if idle is None else 100.0 * idle / run.trace.window_s
