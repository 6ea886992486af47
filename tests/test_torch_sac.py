"""The port's SAC (``red_gym_tpu_torch/agents/sac.py``) against the JAX
package's, on the same numpy inputs and params, in float64, on the CPU.

The flax networks run with ``compute_dtype=jnp.float64``; their heads and
the casts around them are pinned to ``jnp.float32`` in the module's source,
so the float64 comparisons run the JAX module with its ``jnp`` name bound
to a view of jax.numpy whose ``float32`` is float64 (``_f64_sac``): every
layer and every draw of both sides is then float64.  Params come across
with ``interop.sac_from_numpy``.

Bars: ``Actor``, ``Critic``, ``ScanActor``, ``ScanCritic`` forwards within
1e-10; ``sample_action`` with JAX's normal draw injected within 1e-10; one
``SAC.update`` with the batch and both of JAX's draws injected (the key
split into k_next, k_new as the JAX update splits it): every parameter,
target and loss within 1e-9, without a clip, with a clip that does not bind
and with one that binds; ``push_batch`` wrap-around equal to JAX's; a
checkpoint round trip torch.equal; a float32 and a bfloat16 forward against
flax's own.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from red_gym_tpu.agents import sac as jsac
from red_gym_tpu_torch import interop
from red_gym_tpu_torch.agents import sac as tsac
from red_gym_tpu_torch.utils import checkpoint

OBS = (64, 64)
BEAMS, HIDDEN, STRIDE = 64, 32, 4
A, B = 16, 6


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


class _Float64Numpy(types.ModuleType):
    """jax.numpy with float32 meaning float64."""

    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


@pytest.fixture
def _f64_sac(monkeypatch):
    monkeypatch.setattr(jsac, "jnp", _Float64Numpy("jnp64"))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(t, j, tol=1e-10):
    np.testing.assert_allclose(np.asarray(t.detach() if isinstance(t, torch.Tensor) else t),
                               np.asarray(j), rtol=tol, atol=tol)


# (flax module, port module, kind, obs of a batch)
def _pair(kind, dtype=jnp.float64):
    tdt = {jnp.float64: torch.float64, jnp.float32: torch.float32,
           jnp.bfloat16: torch.bfloat16}[dtype]
    if kind == "actor":
        return jsac.Actor(A, dtype), tsac.Actor(OBS, A, tdt), OBS
    if kind == "critic":
        return jsac.Critic(dtype), tsac.Critic(OBS, A, tdt), OBS
    if kind == "scan_actor":
        return (jsac.ScanActor(A, HIDDEN, STRIDE, dtype),
                tsac.ScanActor(BEAMS, A, HIDDEN, STRIDE, tdt), (BEAMS,))
    return (jsac.ScanCritic(HIDDEN, STRIDE, dtype),
            tsac.ScanCritic(BEAMS, A, HIDDEN, STRIDE, tdt), (BEAMS,))


def _obs(shape, seed=0):
    rng = np.random.default_rng(seed)
    if len(shape) == 2:
        return rng.integers(0, 256, (B,) + shape).astype(np.uint8)
    return rng.uniform(0.0, 20.0, (B,) + shape)


def _init(jmod, tmod, obs, kind, dtype=jnp.float64):
    args = (jnp.asarray(obs),) + ((jnp.zeros((B, A), dtype),) if "critic" in kind else ())
    params = jmod.init(jax.random.PRNGKey(0), *args)
    params = jax.tree.map(lambda x: x.astype(dtype), params)
    tmod.to(torch.promote_types(torch.float32, tmod.compute_dtype))
    tmod.load_state_dict(interop.sac_from_numpy(_np_tree(params), kind))
    return params


@pytest.mark.parametrize("kind", ["actor", "critic", "scan_actor", "scan_critic"])
def test_forward_matches_flax(_f64_sac, kind):
    jmod, tmod, shape = _pair(kind)
    obs = _obs(shape)
    params = _init(jmod, tmod, obs, kind)
    act = np.random.default_rng(1).uniform(-1, 1, (B, A))
    if "critic" in kind:
        _close(tmod(_t(obs), _t(act)), jmod.apply(params, jnp.asarray(obs), jnp.asarray(act)))
    else:
        (tm, tl), (jm, jl) = tmod(_t(obs)), jmod.apply(params, jnp.asarray(obs))
        _close(tm, jm)
        _close(tl, jl)


@pytest.mark.parametrize("dtype,tol", [(jnp.float32, 1e-5), (jnp.bfloat16, 3e-2)])
def test_actor_forward_in_its_own_types_matches_flax(dtype, tol):
    """The bitmap actor unpatched: float32, and the default bfloat16 trunk
    (bf16 rounds at other places in the two libraries)."""
    jmod, tmod, shape = _pair("actor", dtype)
    obs = _obs(shape, seed=3)
    params = jmod.init(jax.random.PRNGKey(0), jnp.asarray(obs))
    tmod.load_state_dict(interop.sac_from_numpy(_np_tree(params), "actor"))
    (tm, tl), (jm, jl) = tmod(_t(obs)), jmod.apply(params, jnp.asarray(obs))
    assert tm.dtype == torch.float32
    _close(tm, jm, tol)
    _close(tl, jl, tol)


def test_sample_action_matches_jax(_f64_sac):
    jmod, tmod, shape = _pair("actor")
    obs = _obs(shape)
    params = _init(jmod, tmod, obs, "actor")
    key = jax.random.PRNGKey(7)
    ja, jl = jsac.sample_action(params, jmod, jnp.asarray(obs), key)
    eps = np.asarray(jax.random.normal(key, (B, A), jnp.float64))
    ta, tl = tsac.sample_action(tmod, _t(obs), noise=_t(eps))
    _close(ta, ja)
    _close(tl, jl)


def _sac_pair(kind, grad_clip):
    """A JAX SAC and the port's on the same float64 params, Adam fresh."""
    if kind == "bitmap":
        jactor, tactor, shape = _pair("actor")
        jcritic, tcritic, _ = _pair("critic")
        kinds = ("actor", "critic")
    else:
        jactor, tactor, shape = _pair("scan_actor")
        jcritic, tcritic, _ = _pair("scan_critic")
        kinds = ("scan_actor", "scan_critic")
    obs_dtype = jnp.uint8 if kind == "bitmap" else jnp.float64
    js = jsac.SAC(obs_shape=shape, action_dim=A, actor=jactor, critic=jcritic,
                  obs_dtype=obs_dtype, compute_dtype=jnp.float64, grad_clip=grad_clip)
    ts = tsac.SAC(obs_shape=shape, action_dim=A, actor=tactor, critic=tcritic,
                  obs_dtype=torch.uint8 if kind == "bitmap" else torch.float64,
                  compute_dtype=torch.float64, grad_clip=grad_clip, device="cpu")
    st = js.init(jax.random.PRNGKey(3))
    f64 = lambda tree: jax.tree.map(lambda x: x.astype(jnp.float64), tree)  # noqa: E731
    ap, c1, c2 = f64(st.actor_params), f64(st.critic1_params), f64(st.critic2_params)
    # targets a step away from the critics, so the polyak average is seen
    t1 = jax.tree.map(lambda x: x * 0.9, c1)
    t2 = jax.tree.map(lambda x: x * 1.1, c2)
    jstate = jsac.SACState(ap, c1, c2, t1, t2, js.actor_tx.init(ap), js.critic_tx.init(c1),
                           js.critic_tx.init(c2))
    tstate = ts.init(torch.Generator().manual_seed(0))
    for mod, tree, k in ((tstate.actor, ap, kinds[0]), (tstate.critic1, c1, kinds[1]),
                         (tstate.critic2, c2, kinds[1]), (tstate.target1, t1, kinds[1]),
                         (tstate.target2, t2, kinds[1])):
        mod.load_state_dict(interop.sac_from_numpy(_np_tree(tree), k))
    return js, jstate, ts, tstate, shape, kinds


def _batch(shape, seed=4):
    rng = np.random.default_rng(seed)
    return (_obs(shape, seed), rng.uniform(-1, 1, (B, A)), rng.normal(0, 5, B),
            _obs(shape, seed + 1), (rng.random(B) < 0.3).astype(np.float64))


@pytest.mark.parametrize("kind,grad_clip", [("bitmap", None), ("bitmap", 1e6),
                                            ("bitmap", 0.05), ("scan", None),
                                            ("scan", 0.05)])
def test_update_matches_jax(_f64_sac, kind, grad_clip):
    js, jstate, ts, tstate, shape, kinds = _sac_pair(kind, grad_clip)
    batch = _batch(shape)
    key = jax.random.PRNGKey(11)
    k_next, k_new = jax.random.split(key)
    noise = tuple(_t(jax.random.normal(k, (B, A), jnp.float64)) for k in (k_next, k_new))
    norms, clip = [], ts._clip

    def recording_clip(params):
        grads = [p.grad for p in params]
        norms.append(float(torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))))
        clip(params)

    ts._clip = recording_clip
    jnew, jl = js.update(jstate, tuple(map(jnp.asarray, batch)), key)
    tnew, tl = ts.update(tstate, tuple(map(_t, batch)), noise=noise)
    assert len(norms) == 3
    for name in ("actor_loss", "critic1_loss", "critic2_loss"):
        _close(tl[name], jl[name], 1e-9)
    for field, kind_of in (("actor", 0), ("critic1", 1), ("critic2", 1), ("target1", 1),
                           ("target2", 1)):
        want = interop.sac_from_numpy(_np_tree(getattr(jnew, f"{field}_params")),
                                      kinds[kind_of])
        got = getattr(tnew, field).state_dict()
        for k, v in want.items():
            _close(got[k], v, 1e-9)
    if grad_clip is not None:   # the small clip binds on every network, the large never
        assert all((n > grad_clip) == (grad_clip < 1.0) for n in norms), norms


def test_push_batch_wraparound_matches_jax():
    jbuf = jsac.ReplayBuffer.create(10, (3,), 2, obs_dtype=jnp.float32)
    tbuf = tsac.ReplayBuffer.create(10, (3,), 2, obs_dtype=torch.float32, device="cpu")
    obs = np.arange(7 * 3, dtype=np.float32).reshape(7, 3)
    act = np.ones((7, 2), np.float32)
    r = np.arange(7, dtype=np.float32)
    d = np.zeros(7, np.float32)
    for bump in (0.0, 10.0):
        jbuf = jbuf.push_batch(*map(jnp.asarray, (obs, act, r + bump, obs, d)))
        tbuf.push_batch(*map(_t, (obs, act, r + bump, obs, d)))
    for f in ("obs", "action", "reward", "next_obs", "done"):
        np.testing.assert_array_equal(getattr(tbuf, f).numpy(), np.asarray(getattr(jbuf, f)))
    assert (tbuf.ptr, tbuf.size) == (int(jbuf.ptr), int(jbuf.size)) == (4, 10)
    tbuf.push(_t(obs[0]), _t(act[0]), torch.tensor(5.0), _t(obs[1]), torch.tensor(1.0))
    assert (tbuf.ptr, tbuf.size) == (5, 10)
    assert float(tbuf.reward[4]) == 5.0 and float(tbuf.done[4]) == 1.0
    sample = tbuf.sample(torch.Generator().manual_seed(0), 32)
    assert sample[0].shape == (32, 3) and bool((sample[2] >= 0).all())


def test_checkpoint_round_trip(tmp_path):
    ts = tsac.SAC(obs_shape=OBS, action_dim=A, compute_dtype=torch.float32, grad_clip=10.0,
                  device="cpu")
    state = ts.init(torch.Generator().manual_seed(0))
    buf = tsac.ReplayBuffer.create(50, OBS, A, device="cpu")
    rng = np.random.default_rng(0)
    buf.push_batch(*map(_t, (_obs(OBS), rng.uniform(-1, 1, (B, A)), rng.normal(size=B),
                             _obs(OBS, 1), np.zeros(B))))
    gen = torch.Generator().manual_seed(1)
    state, _ = ts.update(state, buf.sample(gen, 8), gen)
    path = checkpoint.save(str(tmp_path / "sac.pt"), {"sstate": state, "it": 3})
    like = {"sstate": ts.init(torch.Generator().manual_seed(99)), "it": 0}
    got = checkpoint.restore(path, like=like)
    assert got["it"] == 3
    for a, b in zip(state, got["sstate"]):
        sa, sb = a.state_dict(), b.state_dict()
        if isinstance(a, torch.nn.Module):
            assert all(torch.equal(sa[k], sb[k]) for k in sa)
        else:
            assert all(torch.equal(v, sb["state"][i][k])
                       for i, s in sa["state"].items() for k, v in s.items())
    obs = _t(_obs(OBS, 5))
    assert torch.equal(ts.select_action(state, obs, evaluate=True),
                       ts.select_action(got["sstate"], obs, evaluate=True))


def test_init_follows_flax_lecun_normal():
    """Conv kernels: std within 10 % of 1/sqrt(kh * kw * in); biases 0; the
    targets equal the critics; a generator fixes the draw."""
    assert tsac.ConvTrunk.features((256, 256)) == 25088   # the SAL model's width
    ts = tsac.SAC(obs_shape=(128, 128), action_dim=A, device="cpu")
    s1 = ts.init(torch.Generator().manual_seed(0))
    s2 = ts.init(torch.Generator().manual_seed(0))
    assert s1.actor.dense_0.in_features == tsac.ConvTrunk.features((128, 128)) == 4608
    for conv in (s1.actor.trunk.conv_0, s1.actor.trunk.conv_1, s1.actor.trunk.conv_2):
        fan_in = conv.weight[0].numel()
        assert abs(float(conv.weight.detach().std()) * fan_in ** 0.5 - 1.0) < 0.1
        assert float(conv.bias.detach().abs().max()) == 0.0
    assert all(torch.equal(a, b) for a, b in zip(s1.critic1.parameters(),
                                                 s1.target1.parameters()))
    assert all(torch.equal(a, b) for a, b in zip(s1.actor.parameters(), s2.actor.parameters()))
    assert not torch.equal(s1.critic1.dense_0.weight, s1.critic2.dense_0.weight)
