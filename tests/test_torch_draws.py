"""The laws of the port's random draws, held on the CPU beside the JAX
package's own draws of the same laws.

The parity tests feed both packages the same draws, so they say nothing of
the draws themselves; JAX threefry and torch Philox streams never match.
Each test here runs one law function of ``chip_smoke.py`` (D1-D9, listed
there above ``DRAW_STEPS``; the ``[draws]`` phase runs the same functions on
the card at the main path's sizes), which draws through the port's own
functions, and applies the same statistics at the same size to the JAX
package's draw of that law, so that each bar is one the reference meets.
The model is ``tests/test_infra.py::test_noise_pool_statistics_match_fresh``
and its bars.  Seeds are fixed; a miss is a finding about a draw, not a
seed to change.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
from red_gym_tpu import env as jenv
from red_gym_tpu import rollout as jrollout
from red_gym_tpu.agents import sac as jsac
from red_gym_tpu.config import SimConfig as JSimConfig
from red_gym_tpu.maps.loader import load_map as jload_map
from red_gym_tpu.ops import scan as jscan
from red_gym_tpu_torch import assets, env
from red_gym_tpu_torch.config import SimConfig

ROWS, BEAMS = 1024, 128          # JAX's test size (tests/test_infra.py:391)
PICK_ENVS, PICK_STEPS = 1024, 64  # 65,536 picks, as its 64 * 1024 keys
ROT_ENVS, ROT_CALLS = 1024, 2048
RESET_ENVS, RESET_DONE, RESET_CALLS = 64, 13, 1024
MAP_ENVS = 4096
POLICY_ENVS = 4096
PPO_ENVS, PPO_STEPS, PPO_EPOCHS, MINIBATCHES = 512, 8, 256, 4
SAC_N, SAC_CAPACITY, SAC_FILLED, SAC_BATCH, SAC_SAMPLES = 65536, 4096, 3000, 64, 2048
SIGMA = SimConfig().scan_noise_std


def held(stats):
    missed = [cs.say_stat(s) for s in stats if not s["ok"]]
    assert not missed, missed


def to_torch(x):
    """A JAX array as a torch tensor (bfloat16 read as float64)."""
    x = np.array(x)
    return torch.from_numpy(x.astype(np.float64) if x.dtype == jnp.bfloat16 else x)


def keys(seed: int, n: int):
    return jax.random.split(jax.random.PRNGKey(seed), n)


def jax_normal(kind: str):
    """JAX's draw of each N(0, sigma) law at the port test's size: the pool
    (red_gym_tpu/env.py:131-138), the fresh row an env
    (red_gym_tpu/env.py:331-333) and the exact scan's noise, the noisy scan
    less the clean one (red_gym_tpu/ops/scan.py:221-232)."""
    if kind.startswith("pool"):
        dtype = kind.split("_")[1]
        pool = jenv._make_noise_pool(JSimConfig(num_agents=1, num_beams=BEAMS, dtype=dtype,
                                                noise_mode="pool", noise_pool_rows=ROWS))
        want = jnp.bfloat16 if dtype == "float32" else jnp.float64
        return [cs.equal("storage", str(pool.dtype), str(jnp.dtype(want))),
                *cs.normal_stats(to_torch(pool), SIGMA)]
    if kind == "fresh":
        cfg = JSimConfig(num_beams=BEAMS, dtype="float32", noise_mode="fresh")
        slab = jax.vmap(lambda k: cfg.scan_noise_std * jax.random.normal(
            k, (cfg.num_beams,), dtype=cfg.jdtype))(keys(15, 256))
        return cs.normal_stats(to_torch(slab), SIGMA)
    cfg = JSimConfig(num_beams=BEAMS, dtype="float64")
    tmap = jload_map(assets.named_map_yaml(cs.TRACK), ".png", dtype=jnp.float64)
    tables = jscan.build_tables(cfg, 0.31, 0.58, dtype=jnp.float64)
    poses = jnp.asarray(assets.waypoint_start_poses(cs.TRACK, 64))
    scan = jax.jit(lambda p, k: jscan.scan(p, k, tables, tmap, cfg) - jscan.scan(
        p, None, tables, tmap, cfg))
    return cs.normal_stats(to_torch(scan(poses, jax.random.PRNGKey(16))), SIGMA)


@pytest.mark.parametrize("kind", ["pool_float32", "pool_float64", "fresh", "exact"])
def test_normal_draws_meet_jax_bars(kind):
    """D1 (the noise pool, bfloat16 storage in float32 runs) and D5 (fresh
    noise, the exact scan's beam noise): N(0, sigma) at JAX's bars, |mean| <
    4 sigma / sqrt(N) and |std - sigma| < 3 sigma / sqrt(2N - 2), JAX's own
    draw of each law at the same size meeting them too."""
    port = {"pool_float32": lambda: cs.pool_law("cpu", BEAMS, ROWS, "float32"),
            "pool_float64": lambda: cs.pool_law("cpu", BEAMS, ROWS, "float64"),
            "fresh": lambda: cs.fresh_law("cpu", 256, BEAMS, 5),
            "exact": lambda: cs.exact_noise_law("cpu", 64, BEAMS, 6)}[kind]
    held(port())
    held(jax_normal(kind))


@pytest.mark.parametrize("noise_mode", ["pool", "pool_rot"])
def test_pool_picks_are_uniform(noise_mode):
    """D2: "pool", and "pool_rot" without the megakernel, pick one pool row
    an env a step, shared by the env's agents (an (E, B) slab; JAX
    red_gym_tpu/env.py:313-315, the reference's one seed a car): the
    picks' chi^2 in JAX's band 800-1300 at 1024 rows, the per-beam mean of
    512 picks within 5 sigma / sqrt(512), at JAX's test size.  JAX's picks:
    one randint a (step, env) key (tests/test_infra.py:410-412)."""
    held(cs.pick_law("cpu", PICK_ENVS, PICK_STEPS, BEAMS, ROWS, noise_mode, 1))
    pool = jenv._make_noise_pool(JSimConfig(num_agents=1, num_beams=BEAMS, dtype="float32",
                                            noise_mode="pool", noise_pool_rows=ROWS))
    picks = jax.vmap(lambda k: jax.random.randint(k, (), 0, ROWS))(
        keys(7, PICK_ENVS * PICK_STEPS))
    held(cs.pick_stats(to_torch(picks), to_torch(pool), SIGMA))


@pytest.fixture(scope="module")
def rot_params():
    """The megakernel's pool_rot config on track_0019 at a coarse texture."""
    cfg = SimConfig(num_agents=2, num_beams=64, scan_mode="fast", rt_pose_stride=8,
                    noise_mode="pool_rot")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RED_GYM_TPU_TEXTURE_CACHE", "off")
        return cfg, env.make_params(cfg, assets.named_map_yaml(cs.TRACK), device="cpu")


def jax_offsets(seed: int, calls: int):
    """JAX's pool_rot offsets: one randint a step (red_gym_tpu/env.py:349-359),
    quantized to a multiple of 16 by the kernel (pallas_scan.py:995-1001)."""
    off = jax.vmap(lambda k: jax.random.randint(k, (1,), 0, ROWS, jnp.int32))(
        keys(seed, calls))[:, 0]
    return to_torch(off & ~15).long()


@pytest.mark.parametrize("where", ["step", "reset_step"])
def test_pool_rot_rotates_by_one_offset_a_call(where, rot_params):
    """D3 (a step) and D4 (the reset step, ``rollout.reset_done``): one
    offset a call, uniform on the multiples of 16; the envs of a call read
    rows (pos + off) % rows, evenly spread (distinct for no more envs than
    rows); a fixed env's row uniform over its class mod 16.  At a step pos
    is the env g, in JAX too.  The reset step passes the done envs alone,
    so the j-th of them reads (j + off') % rows; JAX re-steps every env and
    keeps the done ones, so there done env g reads (g + off') % rows.  The
    class of a done env's row is j's here and g's there; the batch's law,
    which make_rollout's docstring states, is the same."""
    if where == "step":
        held(cs.rotation_law("cpu", ROT_ENVS, ROT_CALLS, BEAMS, ROWS, 3))
        pos, calls = torch.arange(ROT_ENVS), ROT_CALLS
    else:
        cfg, params = rot_params
        held(cs.reset_rotation_law(cfg, params, RESET_ENVS, RESET_DONE, RESET_CALLS, 4))
        pick = torch.randperm(RESET_ENVS, generator=torch.Generator().manual_seed(4))
        pos, calls = pick[:RESET_DONE].sort().values, RESET_CALLS
    rows = (pos[None, :] + jax_offsets(17, calls)[:, None]) % ROWS
    held(cs.rotation_stats(rows, pos, ROWS))


def test_randomize_starts_draws_maps_uniformly():
    """D6: with every env done, ``reset_done(randomize_starts=...)`` draws
    each env's next map uniformly on the 11 packaged tracks (chi^2) and
    restarts it at ``randomize_starts[m]``; JAX's draw, one randint over
    the envs (red_gym_tpu/rollout.py:101-106), meets the same bar."""
    cfg = SimConfig(num_agents=2, num_beams=16)
    tracks = assets.packaged_tracks()
    params = env.make_multimap_params(cfg, tracks, device="cpu")
    starts = torch.as_tensor(assets.start_pose_table(tracks, 2), dtype=cfg.tdtype)
    held(cs.map_draw_law(cfg, params, starts, MAP_ENVS, 7))
    maps = jax.random.randint(jax.random.PRNGKey(18), (MAP_ENVS,), 0, len(tracks))
    held([cs.chi2_stat(f"{MAP_ENVS} maps", to_torch(maps), len(tracks))])


def test_random_policy_is_uniform():
    """D7: steer U(-0.4, 0.4) and speed U(1, 8), mean and variance within 5
    standard errors, every draw in its interval; JAX's
    ``rollout.random_policy`` at the same size too."""
    held(cs.random_policy_law("cpu", POLICY_ENVS, 2, 8))
    obs = types.SimpleNamespace(scans=jnp.zeros((POLICY_ENVS, 2, 1), jnp.float32))
    act = to_torch(jrollout.random_policy(JSimConfig())(obs, jax.random.PRNGKey(19)))
    held([*cs.uniform_stats("steer", act[..., 0], -0.4, 0.4),
          *cs.uniform_stats("speed", act[..., 1], 1.0, 8.0)])


def test_ppo_draws():
    """D8: PPO's action noise N(0, 1) at D1's bars; an epoch's permutation
    a permutation whose minibatch of a fixed sample is uniform over the 4
    minibatches.  JAX's: ``jax.random.normal`` of the action shape and
    ``jax.random.permutation`` an epoch (red_gym_tpu/agents/ppo.py:216,
    :356)."""
    held(cs.ppo_law("cpu", PPO_ENVS, PPO_STEPS, 64, PPO_EPOCHS, 9))
    noise = jax.vmap(lambda k: jax.random.normal(k, (PPO_ENVS, 2)))(keys(20, PPO_STEPS))
    held(cs.normal_stats(to_torch(noise), 1.0))
    n = PPO_ENVS * PPO_STEPS
    perms = (to_torch(jax.random.permutation(k, n)) for k in keys(21, PPO_EPOCHS))
    held(cs.permutation_stats(perms, MINIBATCHES))


def test_sac_draws():
    """D9: SAC's ``sample_action`` eps N(0, 1); replay indices uniform on
    [0, size), none past it.  JAX's ``sample_action`` (an actor of mean and
    log std 0) and ``ReplayBuffer.sample`` (red_gym_tpu/agents/sac.py:63,
    :142) at the same size."""
    held(cs.sac_law("cpu", SAC_N, SAC_CAPACITY, SAC_FILLED, SAC_BATCH, SAC_SAMPLES, 10))
    actor = types.SimpleNamespace(apply=lambda _, o: (jnp.zeros_like(o), jnp.zeros_like(o)))
    act, _ = jsac.sample_action(None, actor, jnp.zeros((SAC_N, 2), jnp.float64),
                                jax.random.PRNGKey(22))
    held(cs.normal_stats(torch.atanh(to_torch(act)), 1.0))
    buf = jsac.ReplayBuffer.create(SAC_CAPACITY, (1,), 2).push_batch(
        jnp.zeros((SAC_FILLED, 1), jnp.uint8), jnp.zeros((SAC_FILLED, 2)),
        jnp.arange(1, SAC_FILLED + 1, dtype=jnp.float32),
        jnp.zeros((SAC_FILLED, 1), jnp.uint8), jnp.zeros(SAC_FILLED))
    labels = jax.vmap(lambda k: buf.sample(k, SAC_BATCH)[2])(keys(23, SAC_SAMPLES))
    held(cs.index_stats(to_torch(labels).reshape(-1).long() - 1, SAC_FILLED))
