"""The port's pure pursuit (red_gym_tpu_torch/agents/pure_pursuit.py) against
the JAX package's on the packaged track_0019 raceline, in float64.

JAX's functions take one car and are vmapped here (run op by op, unjitted);
the port's take every pose at once.  Poses are drawn with numpy from a
seed: near the raceline, a few metres off it, and past ``max_reacquire``
(20 m), plus poses on the last metre of the table, where the lookahead
circle crosses the wrap segment (traj[-1], traj[0]).  Bar: values within
1e-12, segment indices and flags exactly equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from red_gym_tpu.agents import pure_pursuit as jpp
from red_gym_tpu_torch import assets, interop
from red_gym_tpu_torch.agents import pure_pursuit as tpp

TOL = 1e-12


@pytest.fixture(scope="module")
def raceline():
    path = assets.waypoints_csv("track_0019")
    jw = jpp.load_waypoints_csv(path, dtype=jnp.float64)
    tw = tpp.load_waypoints_csv(path, dtype=torch.float64, device="cpu")
    return jpp.make_params(jw), tpp.make_params(tw)


def _poses(waypoints, seed=0):
    """(x, y, theta) float64 arrays: 256 near the raceline, 128 at 1-15 m,
    128 at 20-40 m off it, and 8 on the table's last metre."""
    rng = np.random.default_rng(seed)
    w = np.asarray(waypoints)
    n = w.shape[0]
    seg = rng.integers(0, n - 1, 512)
    frac = rng.uniform(0.0, 1.0, 512)
    base = w[seg, :2] + frac[:, None] * (w[seg + 1, :2] - w[seg, :2])
    d = w[seg + 1, :2] - w[seg, :2]
    normal = np.stack([-d[:, 1], d[:, 0]], 1) / np.linalg.norm(d, axis=1)[:, None]
    off = np.concatenate([rng.uniform(-1.5, 1.5, 256), rng.uniform(1.0, 15.0, 128),
                          rng.uniform(20.0, 40.0, 128)])
    off *= rng.choice([-1.0, 1.0], 512)
    xy = base + off[:, None] * normal
    tail = w[n - 8:, :2]          # on the raceline, the table's last metre
    xy = np.concatenate([xy, tail])
    theta = rng.uniform(-np.pi, np.pi, len(xy))
    return xy[:, 0], xy[:, 1], theta


def _t(a):
    return torch.from_numpy(np.array(a))


def test_load_and_make_params_equal_jax(raceline):
    jp, tp = raceline
    for f in jpp.PurePursuitParams._fields:
        np.testing.assert_array_equal(getattr(tp, f).numpy(), np.asarray(getattr(jp, f)))
    assert tp.waypoints.shape == (600, 3) and tp.waypoints.dtype == torch.float64


def test_nearest_point_matches_jax(raceline):
    jp, tp = raceline
    x, y, _ = _poses(jp.waypoints)
    traj = jp.waypoints[:, :2]
    jproj, jd, jt, ji = jax.vmap(lambda px, py: jpp.nearest_point(
        jnp.stack([px, py]), traj))(jnp.asarray(x), jnp.asarray(y))
    proj, d, t, i = tpp.nearest_point(_t(x), _t(y), tp.waypoints[:, :2])
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(proj.numpy(), np.asarray(jproj), rtol=0, atol=TOL)
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=0, atol=TOL)
    np.testing.assert_allclose(t.numpy(), np.asarray(jt), rtol=0, atol=TOL)


def test_first_intersection_matches_jax(raceline):
    """Forward, wrap-segment and wrapped-positive wins all occur, and far
    poses find nothing."""
    jp, tp = raceline
    x, y, _ = _poses(jp.waypoints, seed=1)
    traj = jp.waypoints[:, :2]
    _, _, jt, ji = jax.vmap(lambda px, py: jpp.nearest_point(
        jnp.stack([px, py]), traj))(jnp.asarray(x), jnp.asarray(y))
    t0 = np.asarray(ji + jt)
    jfound, ji2 = jax.vmap(lambda px, py, t: jpp.first_intersection(
        jnp.stack([px, py]), jp.tlad, traj, t))(jnp.asarray(x), jnp.asarray(y),
                                                jnp.asarray(t0))
    found, i2 = tpp.first_intersection(_t(x), _t(y), tp.tlad, tp.waypoints[:, :2], _t(t0))
    np.testing.assert_array_equal(found.numpy(), np.asarray(jfound))
    np.testing.assert_array_equal(i2.numpy(), np.asarray(ji2))
    n = traj.shape[0]
    i2 = i2.numpy()
    assert (i2 == n - 1).any(), "no pose took the wrap segment"
    assert ((i2 < np.floor(t0)) & found.numpy()).any(), "no wrapped-positive win"
    assert (~found.numpy()).any(), "every pose found an intersection"


def test_plan_matches_jax(raceline):
    """plan on (E, A)-shaped poses equals JAX's vmapped plan on the flat
    ones; far poses take the (4.0, 0.0) fallback."""
    jp, tp = raceline
    x, y, th = _poses(jp.waypoints, seed=2)
    js, jst = jax.vmap(lambda a, b, c: jpp.plan(a, b, c, jp))(
        jnp.asarray(x), jnp.asarray(y), jnp.asarray(th))
    shape = (len(x) // 2, 2)
    speed, steer = tpp.plan(_t(x).reshape(shape), _t(y).reshape(shape),
                            _t(th).reshape(shape), tp)
    assert speed.shape == steer.shape == shape
    np.testing.assert_allclose(speed.reshape(-1).numpy(), np.asarray(js), rtol=0, atol=TOL)
    np.testing.assert_allclose(steer.reshape(-1).numpy(), np.asarray(jst), rtol=0, atol=TOL)
    far = tpp.nearest_point(_t(x), _t(y), tp.waypoints[:, :2])[1].numpy() >= 20.0
    assert far.sum() >= 20, "too few poses past max_reacquire"
    assert (np.asarray(js)[far] == 4.0).all() and (np.asarray(jst)[far] == 0.0).all()


def test_stack_params_and_per_env_tables(raceline):
    """stack_params equals JAX's; unequal tables raise in both; a plan on
    per-env tables gathered from the stack equals each map's own plan."""
    jp0, tp0 = raceline
    path = assets.waypoints_csv("track_0042")
    jp1 = jpp.make_params(jpp.load_waypoints_csv(path, dtype=jnp.float64))
    tp1 = tpp.make_params(tpp.load_waypoints_csv(path, dtype=torch.float64, device="cpu"))
    js = jpp.stack_params([jp0, jp1])
    ts = tpp.stack_params([tp0, tp1])
    for f in jpp.PurePursuitParams._fields:
        np.testing.assert_array_equal(getattr(ts, f).numpy(), np.asarray(getattr(js, f)))
    carried = interop.pure_pursuit_from_numpy({k: np.asarray(v) for k, v in
                                               js._asdict().items()}, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(carried, ts))
    short = tpp.make_params(tp1.waypoints[:500])
    with pytest.raises(ValueError, match="differ in length"):
        tpp.stack_params([tp0, short])
    with pytest.raises(ValueError, match="differ in length"):
        jpp.stack_params([jp0, jpp.make_params(jp1.waypoints[:500])])

    x, y, th = (_t(a)[:64].reshape(32, 2) for a in _poses(jp0.waypoints, seed=3))
    midx = torch.arange(32) % 2
    sel = tpp.PurePursuitParams(*(f[midx][:, None] for f in ts))
    speed, steer = tpp.plan(x, y, th, sel)
    for m, alone in enumerate((tp0, tp1)):
        s_m, st_m = tpp.plan(x[midx == m], y[midx == m], th[midx == m], alone)
        assert torch.equal(speed[midx == m], s_m) and torch.equal(steer[midx == m], st_m)


def test_flippy_planner_matches_jax():
    jf, tf = jpp.FlippyPlanner(speed=1.5, flip_every=3), tpp.FlippyPlanner(1.5, 3)
    for k in range(8):
        js, jst = jf.plan_step(k)
        ts, tst = tf.plan_step(k)
        assert float(ts) == float(js) and float(tst) == float(jst)
