"""scan_roofline_pct.sim: the scan megakernel's share (%) of its roofline:
the frozen ``mega_bound`` at the cell's rows (envs x agents) over the
median device time of a call (its spectra kernel, then its render kernel)
among the window's full-size calls, one a step.  Moves env_steps_per_s."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import roofline  # noqa: E402

KERNELS = ("mega_spectra_kernel", "mega_render_kernel")


def read(run):
    if run.trace is None:
        return None
    c = run.counters
    ms = roofline.launch_ms(run.trace, KERNELS, c["steps"])
    if ms is None:
        return None
    return 100.0 * roofline.megakernel_ms(c["envs"], c["agents"], c["beams"],
                                          c["theta_bins"]) / ms
