"""The port's vertex-form SAT (``ops/collision.collision``,
``collision_multiple``) against the JAX package's, on the same numpy inputs.

Bars: booleans, partner indices and the float flags exactly equal to JAX's,
on fuzzed float64 pairs that include exactly touching bodies and bodies on
the verge of touching; ``collision_multiple``'s flags equal to the env
step's pose form ``pairwise_hits_from_poses``.  Mirrors
tests/test_collision.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from red_gym_tpu.ops import collision as jcol
from red_gym_tpu_torch.ops import collision as tcol

L, W = 0.58, 0.31


def _poses(rng, shape, spread):
    return np.stack([rng.uniform(-spread, spread, shape), rng.uniform(-spread, spread, shape),
                     rng.uniform(0, 2 * np.pi, shape)], axis=-1)


def _verts(poses):
    """float64 corners from JAX's get_vertices: one input for both packages."""
    return np.array(jcol.get_vertices(jnp.asarray(poses), L, W))


def _fuzzed_pairs(n, seed):
    """(verts1, verts2) (n, 4, 2): a third overlapping or apart at random, a
    third placed one body length ahead along the heading (touching up to
    rounding), and a third touching exactly on dyadic coordinates (an edge,
    a corner or a side shared by axis-aligned boxes)."""
    rng = np.random.default_rng(seed)
    k = n // 3
    p1 = _poses(rng, n, 1.0)
    p2 = _poses(rng, n, 1.0)
    th = p1[k:2 * k, 2]
    p2[k:2 * k] = p1[k:2 * k]
    p2[k:2 * k, 0] += L * np.cos(th)
    p2[k:2 * k, 1] += L * np.sin(th)
    v1, v2 = _verts(p1), _verts(p2)
    m = n - 2 * k
    base = np.array([[0.0, 0.0], [0.5, 0.0], [0.5, 0.25], [0.0, 0.25]])
    shift = np.array([[0.5, 0.0], [0.0, 0.25], [0.5, 0.25], [-0.5, 0.0], [0.25, 0.25]])
    off = rng.integers(-8, 8, (m, 1, 2)) * 0.125
    v1[2 * k:] = base + off
    v2[2 * k:] = base + off + shift[np.arange(m) % len(shift)][:, None, :]
    return v1, v2


def test_collision_equals_jax_on_fuzzed_pairs():
    v1, v2 = _fuzzed_pairs(2000, seed=0)
    want = np.asarray(jax.jit(jcol.collision)(jnp.asarray(v1), jnp.asarray(v2)))
    got = tcol.collision(torch.from_numpy(v1), torch.from_numpy(v2))
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    # the fixture holds both answers, and the exact contacts count as apart
    assert 0.1 < want.mean() < 0.9, want.mean()
    assert not want[2 * (2000 // 3):].any()


@pytest.mark.parametrize("n_bodies", [2, 3, 5])
def test_collision_multiple_equals_jax(n_bodies):
    rng = np.random.default_rng(n_bodies)
    verts = _verts(_poses(rng, (400, n_bodies), 0.8))
    want_c, want_i = jax.jit(jcol.collision_multiple)(jnp.asarray(verts))
    got_c, got_i = tcol.collision_multiple(torch.from_numpy(verts))
    assert got_c.dtype == got_i.dtype == torch.float64
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    assert 0.0 < float(np.asarray(want_c).mean()) < 1.0


@pytest.mark.parametrize("a_n", [1, 2, 3, 4, 5])
def test_collision_multiple_equals_pose_form(a_n):
    """The env step's closed-form rectangle SAT agrees with the general quad
    SAT for 1..5 agents, dense and sparse spawns."""
    rng = np.random.default_rng(7)
    for spread in (0.5, 1.5, 4.0):
        poses = torch.from_numpy(_poses(rng, (64, a_n), spread))
        want, _ = tcol.collision_multiple(tcol.get_vertices(poses, L, W))
        got = tcol.pairwise_hits_from_poses(poses, L, W)
        np.testing.assert_array_equal(got.numpy(), want.numpy().astype(bool),
                                      err_msg=f"agents={a_n} spread={spread}")


def test_perturbed_self_collision():
    """A body always collides with a jittered copy of itself (reference
    collision_models.py:306-313, seed and scale kept)."""
    np.random.seed(1234)
    a = np.array([[4, 11.0], [5, 5], [9, 9], [10, 10]])
    b = a + np.random.normal(size=(1000, 4, 2)) / 100.0
    assert bool(tcol.collision(torch.from_numpy(a), torch.from_numpy(b)).all())


def test_separated_and_touching():
    v = lambda x: tcol.get_vertices(torch.tensor([x, 0.0, 0.0], dtype=torch.float64),  # noqa: E731
                                    L, W)
    assert not bool(tcol.collision(v(0.0), v(10.0)))
    assert not bool(tcol.collision(v(0.0), v(L)))      # shared edge: no collision
    assert bool(tcol.collision(v(0.0), v(0.57)))       # tiny overlap: collision


def test_project_interval():
    verts = torch.tensor([[0.0, 0.0], [2.0, 0.0], [2.0, 1.0], [0.0, 1.0]])
    lo, hi = tcol._project_interval(verts, torch.tensor([1.0, 1.0]))
    assert float(lo) == 0.0 and float(hi) == 3.0
