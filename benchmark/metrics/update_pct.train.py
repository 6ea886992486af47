"""update_pct.train: the share (%) of the traced window that the trainer's
host spent inside its update (the program's ``ppo/update`` range: GAE and
the minibatch epochs of ``PPO._update``).  Moves train_env_steps_per_s."""

RANGE = "ppo/update"


def read(run):
    if run.trace is None or not any(n == RANGE for n, _, _ in run.trace.ranges):
        return None
    return 100.0 * run.trace.range_seconds(RANGE) / run.trace.window_s
