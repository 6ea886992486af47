"""The float64 fast scan and ``scan_backend="xla"`` against the JAX package.

Where no kernel applies (float64, or ``scan_backend="xla"``), the port runs
JAX's XLA branches eagerly: the prep chain, then ``scan_fast.xla_tail``,
then the env step's separate noise add, iTTC check and opponent pass.  JAX
runs its float64 fast scan with ``scan_backend="xla"`` (no Pallas kernel);
the port gets JAX's texture, tables, map and an all-equal noise pool
through ``interop``, so each package's own row pick cannot matter.

Size: 8 envs x 2 agents x 108 beams, ``rt_theta_bins`` 16, texture stride
16 on track_0019 (the size of tests/test_vec_env.py:104).  Bars (float64):
scans within 1e-9 m, poses within 1e-10 m, collisions, lap counts and
done exactly equal, over 20 steps from waypoint starts with random
actions.  ``scan_backend="xla"`` in float32 meets the float32 scan bar of
tests/test_scan_fast.py:890-896 (p99 |diff| < 1e-3 m, < 0.2 % of beams off
by more than 4 texture cells) against JAX, and no scan kernel twin runs.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from red_gym_tpu import env as jenv
from red_gym_tpu import rollout as jrollout
from red_gym_tpu.config import SimConfig as JSimConfig
from red_gym_tpu_torch import assets, env as tenv, interop, rollout as trollout
from red_gym_tpu_torch import vec_env
from red_gym_tpu_torch.config import SimConfig as TSimConfig
from red_gym_tpu_torch.ops import (blend_kernels, scan_fast, scan_kernels,
                                   spectral_kernels, state_kernels)

E, A, B = 8, 2, 108
STEPS = 20
TRACK = "track_0019"
BASE = dict(num_agents=A, num_beams=B, scan_mode="fast", rt_theta_bins=16,
            rt_pose_stride=16, ttc_thresh=2.0)
MODES = {
    "default": {},
    "bilinear_edge": dict(rt_spatial="bilinear"),
    "legacy": dict(rt_spatial="bilinear", rt_occlusion="off", rt_grad=False),
    "spectral": dict(scan_interp="spectral", rt_occlusion="off", rt_grad=False),
    "snap": dict(rt_spatial="bilinear", rt_occlusion="snap"),
}


def _leaves(nt):
    return {k: np.asarray(v) for k, v in nt._asdict().items() if v is not None}


def _setup(kw, dtype):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RED_GYM_TPU_TEXTURE_CACHE", "off")
        cfg_j = JSimConfig(**BASE, **kw, dtype=dtype, scan_backend="xla")
        jp = jenv.make_params(cfg_j, assets.named_map_yaml(TRACK))
    rng = np.random.default_rng(0)
    np_dtype = np.float64 if dtype == "float64" else np.float32
    row = rng.normal(0.0, 0.01, (1, B)).astype(np_dtype)
    pool = jnp.asarray(np.repeat(row, cfg_j.noise_pool_rows, axis=0))
    if dtype == "float32":
        pool = pool.astype(jnp.bfloat16)
    jp = jp._replace(noise_pool=pool)
    port_kw = dict(BASE, **kw, dtype=dtype)
    if dtype == "float32":
        port_kw["scan_backend"] = "xla"
    cfg_t = TSimConfig(**port_kw)
    tp = interop.params_from_numpy(
        cfg_t, _leaves(jp.vehicle), _leaves(jp.tables), _leaves(jp.tmap),
        _leaves(jp.rtex), np.asarray(jp.noise_pool), device="cpu")
    poses = np.tile(assets.waypoint_start_poses(TRACK, A)[None], (E, 1, 1))
    poses[:, :, 2] += np.linspace(-0.3, 0.3, E)[:, None]      # varied headings
    actions = np.stack([rng.uniform(-0.4, 0.4, (STEPS + 1, E, A)),
                        rng.uniform(1.0, 8.0, (STEPS + 1, E, A))],
                       axis=-1).astype(np_dtype)
    return cfg_j, jp, cfg_t, tp, poses.astype(np_dtype), actions


def _kernel_calls(monkeypatch):
    """Count calls of every scan-kernel wrapper (their twins run on the CPU)."""
    calls = []
    for mod, names in ((scan_kernels, ("mega_edge_ttc",)),
                       (blend_kernels, [f.__name__ for f in blend_kernels.KERNELS]),
                       (spectral_kernels, ("theta_spectral_ttc",)),
                       (state_kernels, ("prestep",))):
        for name in names:
            real = getattr(mod, name)
            monkeypatch.setattr(mod, name, lambda *a, _r=real, _n=name, **k:
                                calls.append(_n) or _r(*a, **k))
    return calls


def _run(setup, check):
    cfg_j, jp, cfg_t, tp, poses, actions = setup
    keys = jax.random.split(jax.random.PRNGKey(0), E)
    js, jo, _, jd, _ = jrollout.batched_reset(cfg_j, jp, jnp.asarray(poses), keys)
    gen = torch.Generator().manual_seed(0)
    ts, to, _, td, _ = trollout.batched_reset(cfg_t, tp, torch.from_numpy(poses), gen)
    step_j = jax.jit(jax.vmap(lambda s, a: jenv.step(cfg_j, jp, s, a)))
    n_coll = 0
    for i in range(STEPS + 1):
        if i:
            js, jo, _, jd, _ = step_j(js, jnp.asarray(actions[i]))
            ts, to, _, td, _ = trollout.batched_step(
                cfg_t, tp, ts, torch.from_numpy(actions[i]), gen)
        check(ts, to, td, js, jo, jd)
        n_coll += int(np.asarray(js.collisions).sum())
    return n_coll


@pytest.mark.parametrize("mode", list(MODES))
def test_float64_fast_scan_matches_jax(mode, monkeypatch):
    torch.set_num_threads(2)
    setup = _setup(MODES[mode], "float64")
    calls = _kernel_calls(monkeypatch)

    def check(ts, to, td, js, jo, jd):
        # float64 bars: scans within 1e-9 m, poses within 1e-10 m
        np.testing.assert_allclose(to.scans.numpy(), np.asarray(jo.scans), rtol=0, atol=1e-9)
        np.testing.assert_allclose(ts.x.numpy(), np.asarray(js.x), rtol=0, atol=1e-10)
        np.testing.assert_array_equal(ts.collisions.numpy(), np.asarray(js.collisions))
        np.testing.assert_array_equal(ts.lap_counts.numpy(), np.asarray(js.lap_counts))
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))

    _run(setup, check)
    assert setup[3].rtex.rt.dtype == torch.float64
    assert calls == [], f"scan kernels ran on the float64 path: {set(calls)}"


def _scan_bar(a, b, cell):
    err = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    assert np.quantile(err, 0.99) < 1e-3, np.quantile(err, 0.99)
    assert np.mean(err > 4 * cell) < 2e-3, np.mean(err > 4 * cell)


@pytest.mark.parametrize("mode", ["default", "bilinear_edge", "spectral"])
def test_xla_backend_float32_matches_jax(mode, monkeypatch):
    torch.set_num_threads(2)
    setup = _setup(MODES[mode], "float32")
    calls = _kernel_calls(monkeypatch)
    cell = float(setup[3].rtex.cell)

    def check(ts, to, td, js, jo, jd):
        np.testing.assert_allclose(ts.x[..., [0, 1, 4]].numpy(),
                                   np.asarray(js.x)[..., [0, 1, 4]], rtol=0, atol=1e-4)
        _scan_bar(to.scans.numpy(), jo.scans, cell)
        np.testing.assert_array_equal(ts.collisions.numpy(), np.asarray(js.collisions))
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))

    _run(setup, check)
    assert calls == [], f"scan kernels ran under scan_backend='xla': {set(calls)}"


@pytest.mark.parametrize("kw, knob", [
    (dict(dtype="float64", scan_megakernel="on"), "scan_megakernel='on'"),
    (dict(dtype="float64", fuse_scan_ttc="on"), "fuse_scan_ttc='on'"),
    (dict(dtype="float64", fuse_scan_opp="on"), "fuse_scan_opp='on'"),
    (dict(scan_backend="xla", scan_megakernel="on"), "scan_megakernel='on'"),
    (dict(scan_backend="xla", fuse_scan_ttc="on"), "fuse_scan_ttc='on'"),
])
def test_on_knobs_raise_where_no_kernel_applies(kw, knob):
    """"on" out of the kernels' scope raises, naming float32, as JAX's
    use_megakernel does; "auto" resolves off."""
    cfg = TSimConfig(**{**BASE, **kw})
    with pytest.raises(ValueError, match=knob) as err:
        tenv.make_params(cfg, assets.named_map_yaml(TRACK), device="cpu")
    assert "float32" in str(err.value)
    auto = dataclasses.replace(cfg, scan_megakernel="auto", fuse_scan_ttc="auto",
                               fuse_scan_opp="auto")
    assert not scan_fast.use_megakernel(auto) and not scan_fast.use_fused_ttc(auto)
    assert not scan_fast.use_fused_opp(auto) and not scan_fast.use_fused_opp_mega(auto)


def test_vec_env_float64_fast_steps(tmp_path, monkeypatch):
    """VecF110Env in the float64 fast scan: 20 steps with auto-reset, every
    output float64 and finite, no scan kernel, and each step equal to a
    hand loop of env.step on the same params."""
    monkeypatch.setenv("RED_GYM_TPU_TEXTURE_CACHE", str(tmp_path))
    calls = _kernel_calls(monkeypatch)
    vec = vec_env.VecF110Env(assets.named_map_yaml(TRACK), num_envs=4, num_agents=A,
                             num_beams=B, dtype="float64", scan_mode="fast",
                             rt_theta_bins=16, rt_pose_stride=16, device="cpu")
    obs, *_ = vec.reset(np.tile(assets.waypoint_start_poses(TRACK, A)[None], (4, 1, 1)))
    rng = np.random.default_rng(3)
    for _ in range(20):
        act = np.stack([rng.uniform(-0.4, 0.4, (4, A)), rng.uniform(0.0, 6.0, (4, A))], -1)
        obs, rew, done, info = vec.step(act)
        assert obs["scans"].dtype == torch.float64
        assert torch.isfinite(obs["scans"]).all()
    assert float(obs["scans"].max()) > 1.0
    assert calls == []
