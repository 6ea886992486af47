"""device_ops_per_step.sim: device operations (kernels, copies, sets) of
the traced window over its steps, restarts included: what the host
dispatches for a step of ``env.step`` and ``rollout.reset_done``.  Moves
env_steps_per_s."""


def read(run):
    steps = run.counters.get("steps", 0)
    if run.trace is None or not steps or not run.trace.device:
        return None
    return len(run.trace.device) / steps
