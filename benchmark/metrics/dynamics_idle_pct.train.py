"""dynamics_idle_pct.train: the share (%) of the traced trainer window in
which the device idles inside the program's ``env/dynamics`` span (the
state kernel, or on stacked maps the eager pre-scan chain, of the step
and of the restart's re-run): idle gaps whose midpoint lies inside such
a range, over the window.  Moves train_env_steps_per_s."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import spans  # noqa: E402


def read(run):
    return spans.idle_pct_inside(run, "env/dynamics")
