"""idle_pct.sim: the share (%) of the traced window in which no operation
ran on the device, 100 x (1 - busy / window), busy being the union of
the device operations' intervals (torch.profiler).  Moves env_steps_per_s."""


def read(run):
    if run.trace is None or not run.trace.device:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
