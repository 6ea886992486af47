"""The port's iTTC check and opponent ray cast against JAX, in float64.

Bars: iTTC flags exactly equal; opponent-shortened scans within 1e-12.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from red_gym_tpu.config import SimConfig as JSimConfig
from red_gym_tpu.ops import agent_scan as jas, collision as jcol, scan as jscan
from red_gym_tpu_torch.config import SimConfig as TSimConfig
from red_gym_tpu_torch.ops import agent_scan as tas, collision as tcol, scan as tscan

B = 270
LENGTH, WIDTH = 0.58, 0.31


def _tables():
    kw = dict(num_beams=B, dtype="float64")
    return (jscan.build_tables(JSimConfig(**kw), WIDTH, LENGTH),
            tscan.build_tables(TSimConfig(**kw), WIDTH, LENGTH))


def test_build_tables_match():
    jt, tt = _tables()
    for f in jt._fields:
        if getattr(jt, f) is not None:
            np.testing.assert_array_equal(getattr(tt, f).numpy(),
                                          np.asarray(getattr(jt, f)), err_msg=f)


def test_check_ttc_matches():
    rng = np.random.default_rng(0)
    jt, tt = _tables()
    e_n = 512
    scan = rng.uniform(0.0, 3.0, (e_n, B))
    vel = rng.uniform(-5.0, 10.0, e_n)
    vel[:32] = 0.0
    j = np.asarray(jas.check_ttc(jnp.asarray(scan), jnp.asarray(vel), jt, 0.3))
    t = tas.check_ttc(torch.from_numpy(scan), torch.from_numpy(vel), tt, 0.3).numpy()
    np.testing.assert_array_equal(t, j)
    assert 0.05 < t.mean() < 0.95, "fixture needs both hits and misses"


@pytest.mark.parametrize("num_agents", [2, 3])
def test_ray_cast_all_opponents_matches(num_agents):
    rng = np.random.default_rng(num_agents)
    jt, tt = _tables()
    e_n = 256
    poses = np.concatenate([rng.uniform(-2.0, 2.0, (e_n, num_agents, 2)),
                            rng.uniform(0, 2 * np.pi, (e_n, num_agents, 1))], -1)
    scans = rng.uniform(0.5, 10.0, (e_n, num_agents, B))

    def one(p, s):
        return jas.ray_cast_all_opponents(
            p, s, jcol.get_vertices(p, LENGTH, WIDTH), jt)

    j = np.asarray(jax.vmap(one)(jnp.asarray(poses), jnp.asarray(scans)))
    tp = torch.from_numpy(poses)
    t = tas.ray_cast_all_opponents(tp, torch.from_numpy(scans),
                                   tcol.get_vertices(tp, LENGTH, WIDTH), tt).numpy()
    np.testing.assert_allclose(t, j, rtol=1e-12, atol=1e-12)
    assert (t < scans - 1e-6).any(), "fixture guard: no beam blocked"
