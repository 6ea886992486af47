"""The port's policy export (``utils/export.py``, torch.export .pt2) against
the JAX package's greedy heads.

The PPO head (hidden 32, stride 8, 1080 beams) and the SAC actor (64 x 64
bitmaps, 8 actions) carry JAX's weights (``interop.policy_from_numpy``,
``interop.sac_from_numpy``).  Bars: the direct head within 1e-5 of JAX's
``deterministic_ppo_control`` / ``deterministic_sac_action`` (float32; the
JAX suite's own bar for AOT code against jit); the served program within
1e-6 of the direct head.  A symbolic batch serves 1, 3 and 7; a fixed
batch rejects 4; the artifact runs in a fresh interpreter that imports no
red_gym_tpu_torch.
"""

import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from red_gym_tpu.agents import ppo as jppo
from red_gym_tpu.agents import sac as jsac
from red_gym_tpu.utils import export as jex
from red_gym_tpu_torch import interop
from red_gym_tpu_torch.agents import ppo as tppo
from red_gym_tpu_torch.agents import sac as tsac
from red_gym_tpu_torch.utils import export as ex


@pytest.fixture(scope="module")
def heads():
    policy = jppo.ScanPolicy(hidden=32, scan_stride=8)
    scan = jnp.ones((3, 1080), jnp.float32) * 5.0
    vel = jnp.ones((3,), jnp.float32)
    params = policy.init(jax.random.PRNGKey(0), scan, vel)
    jfn = jex.deterministic_ppo_control(policy, jppo.PPOConfig(), params)
    tpol = tppo.ScanPolicy(hidden=32, scan_stride=8)
    tpol.load_state_dict(interop.policy_from_numpy(jax.tree.map(np.asarray, params)))
    return jfn, ex.deterministic_ppo_control(tpol, tppo.PPOConfig())


def _inputs(n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, 30, (n, 1080)).astype(np.float32),
            rng.uniform(0, 8, (n,)).astype(np.float32))


def test_direct_head_matches_jax(heads):
    jfn, head = heads
    s, v = _inputs(64)
    with torch.no_grad():
        got = head(torch.from_numpy(s), torch.from_numpy(v)).numpy()
    np.testing.assert_allclose(got, np.asarray(jfn(jnp.asarray(s), jnp.asarray(v))),
                               rtol=1e-5, atol=1e-5)


def test_ppo_roundtrip_matches_direct_and_respects_the_squash(heads, tmp_path):
    _, head = heads
    s, v = _inputs(3, 1)
    path = tmp_path / "racer.pt2"
    ex.save_policy(path, head, (torch.from_numpy(s), torch.from_numpy(v)), device="cpu")
    with torch.no_grad():
        served = ex.load_policy(path).module()(torch.from_numpy(s), torch.from_numpy(v))
        direct = head(torch.from_numpy(s), torch.from_numpy(v))
    np.testing.assert_allclose(served.numpy(), direct.numpy(), rtol=0, atol=1e-6)
    assert served.shape == (3, 2) and served.dtype == torch.float32
    pcfg = tppo.PPOConfig()
    assert torch.all(served[:, 0].abs() <= pcfg.max_steer)
    assert torch.all((served[:, 1] >= 0) & (served[:, 1] <= pcfg.max_speed))


def test_symbolic_batch_serves_any_size(heads, tmp_path):
    _, head = heads
    s, v = _inputs(1)                       # a batch-1 example still exports symbolic
    path = tmp_path / "racer.pt2"
    ex.save_policy(path, head, (torch.from_numpy(s), torch.from_numpy(v)), device="cpu")
    racer = ex.load_policy(path).module()
    for n in (1, 3, 7):
        s, v = _inputs(n, n)
        with torch.no_grad():
            out = racer(torch.from_numpy(s), torch.from_numpy(v))
            assert out.shape == (n, 2)
            np.testing.assert_allclose(out.numpy(),
                                       head(torch.from_numpy(s), torch.from_numpy(v)).numpy(),
                                       rtol=0, atol=1e-6)


def test_fixed_batch_rejects_other_sizes(heads, tmp_path):
    _, head = heads
    s, v = _inputs(3)
    path = tmp_path / "racer_fixed.pt2"
    ex.save_policy(path, head, (torch.from_numpy(s), torch.from_numpy(v)), batch=None,
                   device="cpu")
    racer = ex.load_policy(path).module()
    assert racer(torch.from_numpy(s), torch.from_numpy(v)).shape == (3, 2)
    s4, v4 = _inputs(4)
    with pytest.raises(Exception):
        racer(torch.from_numpy(s4), torch.from_numpy(v4))


def test_sac_actor_roundtrip_matches_jax(tmp_path):
    actor = jsac.Actor(action_dim=8, compute_dtype=jnp.float32)
    obs = np.random.default_rng(0).integers(0, 255, (2, 64, 64)).astype(np.uint8)
    params = actor.init(jax.random.PRNGKey(1), jnp.asarray(obs))
    jfn = jex.deterministic_sac_action(actor, params)
    tact = tsac.Actor(obs_shape=(64, 64), action_dim=8, compute_dtype=torch.float32)
    tact.load_state_dict(interop.sac_from_numpy(jax.tree.map(np.asarray, params), "actor"))
    head = ex.deterministic_sac_action(tact)
    with torch.no_grad():
        direct = head(torch.from_numpy(obs))
    np.testing.assert_allclose(direct.numpy(), np.asarray(jfn(jnp.asarray(obs))),
                               rtol=1e-5, atol=1e-5)
    path = tmp_path / "sac.pt2"
    ex.save_policy(path, head, (torch.from_numpy(obs),), device="cpu")
    with torch.no_grad():
        out = ex.load_policy(path).module()(torch.from_numpy(obs))
    np.testing.assert_allclose(out.numpy(), direct.numpy(), rtol=0, atol=1e-6)
    assert out.shape == (2, 8) and torch.all(out.abs() <= 1.0)


def test_heads_keep_their_own_weights(heads):
    """The head copies the policy: training it further changes nothing."""
    _, head = heads
    pol = tppo.ScanPolicy(hidden=32)
    h = ex.deterministic_ppo_control(pol, tppo.PPOConfig())
    s, v = _inputs(2)
    with torch.no_grad():
        before = h(torch.from_numpy(s), torch.from_numpy(v)).clone()
        pol.mean.weight.add_(1.0)
        assert torch.equal(h(torch.from_numpy(s), torch.from_numpy(v)), before)


def test_artifact_runs_without_the_package(heads, tmp_path):
    _, head = heads
    s, v = _inputs(5, 2)
    path = tmp_path / "racer.pt2"
    ex.save_policy(path, head, (torch.from_numpy(s[:1]), torch.from_numpy(v[:1])), device="cpu")
    np.save(tmp_path / "s.npy", s)
    np.save(tmp_path / "v.npy", v)
    code = ("import sys, numpy as np, torch\n"
            "m = torch.export.load(sys.argv[1]).module()\n"
            "out = m(torch.from_numpy(np.load(sys.argv[2])), torch.from_numpy(np.load(sys.argv[3])))\n"
            "np.save(sys.argv[4], out.detach().numpy())\n"
            "assert not [k for k in sys.modules if k.startswith('red_gym')], 'package imported'\n")
    proc = subprocess.run([sys.executable, "-c", code, str(path), str(tmp_path / "s.npy"),
                           str(tmp_path / "v.npy"), str(tmp_path / "out.npy")],
                          capture_output=True, text=True, cwd=str(tmp_path), timeout=120)
    assert proc.returncode == 0, proc.stderr
    with torch.no_grad():
        direct = head(torch.from_numpy(s), torch.from_numpy(v)).numpy()
    np.testing.assert_allclose(np.load(tmp_path / "out.npy"), direct, rtol=0, atol=1e-6)
