"""The frozen roofline counts give the bounds PERF.md's kernel table holds
at K = 32768 rows (16384 envs x 2 agents, 1080 beams, 128 theta bins)."""

import os
import sys

import pytest
from conftest import BENCH

sys.path.insert(0, os.path.join(BENCH, "metrics"))
import roofline  # noqa: E402


def test_megakernel_pair_bound():
    assert roofline.megakernel_ms(16384, 2, 1080, 128) == pytest.approx(0.490, abs=5e-4)


def test_kernel4_bound():
    assert roofline.kernel4_ms(16384, 2, 1080, 128) == pytest.approx(0.442, abs=5e-4)


def test_bounds_scale_with_rows():
    assert roofline.megakernel_ms(32768, 2, 1080, 128) == pytest.approx(
        2 * roofline.megakernel_ms(16384, 2, 1080, 128), rel=1e-6)


def test_launch_time_takes_the_full_calls():
    from harness.trace import Trace

    events = []
    t = 0.0
    for dur in (4.0, 1.0, 4.2, 0.5, 3.9, 4.1):   # ms; two small restart calls
        events += [("mega_spectra_kernel<x>", t, t + 100.0),
                   ("mega_render_kernel<y>", t + 100.0, t + 1e3 * dur)]
        t += 1e4
    tr = Trace(window_s=1.0, device=events)
    got = roofline.launch_ms(tr, ("mega_spectra_kernel", "mega_render_kernel"), 4)
    assert got == pytest.approx(0.5 * (4.0 + 4.1))
