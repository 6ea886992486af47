"""restart_idle_pct.sim: the share (%) of the traced window in which the
device idles inside the program's ``rollout/restart`` span (the restart's
draws and its re-run of the env step on the done envs): idle gaps whose
midpoint lies inside such a range, over the window.  Moves
env_steps_per_s."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import spans  # noqa: E402


def read(run):
    return spans.idle_pct_inside(run, "rollout/restart")
