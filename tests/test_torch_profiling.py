"""The port's profiling helpers (``red_gym_tpu_torch/utils/profiling.py``)
against the JAX package's: ``Metrics`` accumulates in the accumulator's
dtype and its means equal JAX's on the same values; the trace context
runs on the CPU.  (The step timer is gone: the port has no ``StepTimer``.)"""

import os

import jax.numpy as jnp
import numpy as np
import torch

from red_gym_tpu.utils.profiling import Metrics as JMetrics
from red_gym_tpu_torch.utils import profiling


def test_metrics_means_equal_jax():
    rng = np.random.default_rng(0)
    rows = [dict(reward=rng.normal(), done=float(rng.random() < 0.2),
                 actor_loss=rng.normal(0, 3)) for _ in range(37)]
    names = ("reward", "done", "actor_loss")
    jacc = JMetrics.init(names)
    tacc = profiling.Metrics.init(names, device="cpu")
    for r in rows:
        jacc = JMetrics.update(jacc, **{k: jnp.asarray(v) for k, v in r.items()})
        tacc = profiling.Metrics.update(tacc, **{k: torch.tensor(v, dtype=torch.float64)
                                                 for k, v in r.items()})
    assert all(v.dtype == torch.float32 for v in tacc.values())
    assert profiling.Metrics.means(tacc) == JMetrics.means(jacc)
    assert profiling.Metrics.means(profiling.Metrics.init(names, device="cpu")) == \
        {k: 0.0 for k in names}


def test_step_timer_and_trace(tmp_path):
    assert not hasattr(profiling, "StepTimer")
    with profiling.trace(str(tmp_path)):
        torch.ones(8).sum()
    assert os.path.getsize(tmp_path / "trace.json") > 0
    assert os.path.getsize(tmp_path / "spans.json") > 0
    profiling.force({"a": [torch.zeros(1)], "b": None})
