"""reset_step_pct.sim: the share (%) of the window's steps in which
``rollout.reset_done`` restarted some env (the harness's count of its
``reset_any``).  Each such step re-runs the env step on the done envs.
Moves step_ms_p95."""


def read(run):
    steps = run.counters.get("steps", 0)
    if "reset_steps" not in run.counters or not steps:
        return None
    return 100.0 * run.counters["reset_steps"] / steps
