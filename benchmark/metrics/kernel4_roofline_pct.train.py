"""kernel4_roofline_pct.train: the epilogue kernel 4's share (%) of its
roofline (``blend_kernels.theta_shuffle_blend_edge_ttc_opp``: the edge
render with noise, iTTC and the opponent cast): the frozen ``blend_bound``
at the cell's rows (envs x agents) over the median device time of its
full-size launches, one a rollout step.  Moves train_env_steps_per_s."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import roofline  # noqa: E402

KERNELS = ("theta_blend_kernel<2",)


def read(run):
    if run.trace is None:
        return None
    c = run.counters
    ms = roofline.launch_ms(run.trace, KERNELS, c["steps"])
    if ms is None:
        return None
    return 100.0 * roofline.kernel4_ms(c["envs"], c["agents"], c["beams"],
                                       c["theta_bins"]) / ms
