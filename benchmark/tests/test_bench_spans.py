"""The readers of the program's spans: the device's idle time inside a host
range (gaps inside, across and outside the ranges; nested ranges counting
a gap once), the set-up span's seconds, and None wherever the program has
no such span.  The tiny CPU form of each cell, traced, records the step's
spans, and the trainer's yields the set-up span's metric."""

import pytest
import torch
from conftest import tiny

from harness import manifest, result, sim, train
from harness.trace import Trace

CPU = torch.device("cpu")


class Run:
    def __init__(self, trace=None, **counters):
        self.trace, self.counters = trace, counters


def read(cells, name):
    cell = next(c for c in cells.values() if any(m["name"] == name for m in c.per_layer))
    return manifest.reader(cell.bench_dir, name)


@pytest.fixture
def registry():
    from red_gym_tpu_torch.utils import profiling

    profiling.reset_totals()
    yield profiling
    profiling.reset_totals()


def trace_of(ranges):
    """Busy [0, 10], [20, 30], [40, 50], [60, 70] us: gaps of 10 us with
    midpoints 15, 35 and 55; a 100 us window."""
    device = [("k", a, a + 10.0) for a in (0.0, 20.0, 40.0, 60.0)]
    return Trace(window_s=1e-4, device=device, ranges=ranges)


@pytest.mark.parametrize("metric,span", [("restart_idle_pct.sim", "rollout/restart"),
                                         ("restart_idle_pct.train", "rollout/restart"),
                                         ("dynamics_idle_pct.train", "env/dynamics")])
def test_idle_inside_a_span(cells, metric, span):
    r = read(cells, metric)
    # the first gap inside, the second across a range's end (its midpoint
    # outside), the third outside any range of this name
    tr = trace_of([(span, 8.0, 25.0), (span, 30.0, 34.0), ("other", 50.0, 60.0)])
    assert r(Run(tr)) == pytest.approx(10.0)
    # ranges nested in each other, or overlapping, count a gap once
    tr = trace_of([(span, 5.0, 40.0), (span, 12.0, 18.0), (span, 30.0, 60.0)])
    assert r(Run(tr)) == pytest.approx(30.0)
    # a range that holds every gap's midpoint but no gap's whole
    tr = trace_of([(span, 14.0, 56.0)])
    assert r(Run(tr)) == pytest.approx(30.0)
    assert r(Run(trace_of([("other", 0.0, 70.0)]))) is None
    assert r(Run(Trace(window_s=1e-4, ranges=[(span, 0.0, 70.0)]))) is None
    assert r(Run()) is None


def test_params_seconds(cells, registry, monkeypatch):
    r = read(cells, "params_s.train")
    assert r(Run()) is None
    with registry.setup_span("setup/params"):
        with registry.setup_span("setup/map_load"):
            pass
    seconds = registry.span_totals()["setup/params"]["seconds"]
    assert r(Run()) == seconds > 0
    monkeypatch.delattr(registry, "span_totals")
    assert r(Run()) is None


def test_tiny_sim_cell_traces_the_spans(cells, registry):
    cell = tiny(cells["fast_default.random"])
    run = sim.run(cell, 3000000017, 0.3, True, CPU)
    names = {n for n, _, _ in run.trace.ranges}
    assert {"rollout/done_read", "env/dynamics", "env/scan", "env/laps"} <= names
    # a CPU trace holds no device operation: the idle readers give nothing
    got = result.per_layer_metrics(cell, run)
    assert "restart_idle_pct.sim" not in got


def test_tiny_train_cell_reads_the_params_span(cells, registry):
    cell = tiny(cells["ppo_multimap.train"])
    run = train.run(cell, 3000000018, 0.3, True, CPU)
    got = result.per_layer_metrics(cell, run)
    totals = registry.span_totals()
    assert got["params_s.train"]["value"] == totals["setup/params"]["seconds"] > 0
    assert totals["setup/map_load"]["count"] == 2
