"""The result line, the numbers compared for ``correct``, and the guard
against JAX in the process."""

from __future__ import annotations

import json
import math
import sys
from dataclasses import dataclass, field

from harness import manifest

# top-level module names that no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "red_gym_tpu")


@dataclass
class Run:
    """What a runner hands back: the end-to-end readings of the window, the
    counters and the trace that the per-layer readers read, and the
    comparison with the reference."""

    setup_s: float
    end_to_end: dict                 # {metric: value} measured by the host clock
    counters: dict                   # program and harness counts of the window
    attempted: int
    memory_peak_bytes: int
    checks: list = field(default_factory=list)   # [(number, reading, limit)]
    trace: object = None             # trace.Trace of a --trace 1 run

    @property
    def failed(self) -> int:
        """The numbers compared that are over their limits (or not finite)."""
        return sum(not (math.isfinite(v) and v <= lim) for _, v, lim in self.checks)

    @property
    def correct(self) -> bool:
        return bool(self.checks) and self.failed == 0


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name, the part before the first dot,
    is one of FORBIDDEN (compared whole: red_gym_tpu_torch is not
    red_gym_tpu)."""
    return sorted({name for name in list(sys.modules)
                   if name.split(".")[0] in FORBIDDEN})


def end_to_end_metrics(cell: manifest.Cell, run: Run) -> dict:
    out = {}
    for m in cell.end_to_end:
        value = run.setup_s if m["name"] == "setup_s" else run.end_to_end[m["name"]]
        out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def per_layer_metrics(cell: manifest.Cell, run: Run) -> dict:
    """Each per-layer metric of the cell that its reader finds; a reader
    that finds nothing to read returns None and the metric is left out."""
    out = {}
    for m in cell.per_layer:
        value = manifest.reader(cell.bench_dir, m["name"])(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def device_record(run: Run, device) -> dict:
    import torch

    rec = {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1,
           "memory_peak_bytes": int(run.memory_peak_bytes)}
    if run.trace is not None:
        rec["busy_s"] = run.trace.busy_s
        rec["window_s"] = run.trace.window_s
    return rec


def emit(cell: manifest.Cell, run: Run, metrics: dict, device) -> None:
    """Standard error ends with each number compared beside its limit;
    standard output ends with the result line, whose last key holds the
    same numbers."""
    checks = {name: {"value": value, "limit": limit} for name, value, limit in run.checks}
    for name, value, limit in run.checks:
        verdict = "ok" if math.isfinite(value) and value <= limit else "FAILS"
        print(f"check {name}: {value!r} (limit {limit!r}) {verdict}", file=sys.stderr)
    line = {"correct": run.correct, "attempted": int(run.attempted),
            "failed": int(run.failed), "metrics": metrics,
            "device": device_record(run, device)}
    if run.trace is not None:
        line["breakdown"] = run.trace.breakdown()
    line["checks"] = checks
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
