"""noise_mode="pool_rot": the megakernel's resident-pool variant (plain
PyTorch twin) and the rollout's reset rotation.

1. The pool twin is bit-exactly its slab twin fed the rows
   pool[(arange(E) + (off & ~15)) % rows], with and without opponents (the
   JAX package's own check, tests/test_scan_fast.py::
   test_megakernel_pool_rot_matches_slab), at off = rows - 37 so that the
   16-row quantization and the modulo seam both matter.
2. The twin against JAX's interpret-mode pool_rot kernel, which reads the
   wrap-extended pool, at the float32 bar of tests/test_scan_fast.py.
3. ``rollout.make_rollout``: the k-th env of the whole batch reads row
   (k + off) % rows, and the j-th re-stepped env of the reset step reads
   (j + off') % rows with the reset step's own offset.
4. Without the megakernel, "pool_rot" picks one pool row per env, as the
   JAX package does.
"""

import dataclasses
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from red_gym_tpu.ops import pallas_scan
from red_gym_tpu_torch import assets, env as tenv, rollout
from red_gym_tpu_torch.config import SimConfig
from red_gym_tpu_torch.interop import to_tensor
from red_gym_tpu_torch.ops import scan_kernels
from tests.test_torch_mega import A, B, E, T, TTC, _torch_args, operands  # noqa: F401
from tests.test_torch_opp import opp_packs  # noqa: F401

ROWS = 256
OFF = ROWS - 37


@pytest.fixture(scope="module")
def pool():
    rng = np.random.default_rng(7)
    p = rng.normal(0.0, 0.01, (ROWS, B)).astype(np.float32)
    return to_tensor(p).to(torch.bfloat16)


def test_pool_rot_rows_quantize_and_wrap():
    rows = scan_kernels.pool_rot_rows(E, ROWS, torch.tensor([OFF], dtype=torch.int32))
    base = OFF & ~15
    assert base == 208 and rows[0] == base and rows[ROWS - base] == 0
    np.testing.assert_array_equal(rows.numpy(), (np.arange(E) + base) % ROWS)


@pytest.mark.parametrize("with_opp", [False, True], ids=["plain", "opp"])
def test_pool_rot_twin_is_slab_twin_bit_exactly(operands, opp_packs, pool,  # noqa: F811
                                                with_opp):
    rt, per_row, consts, _ = operands
    args = _torch_args(rt, per_row, consts, "bfloat16")
    if with_opp:
        opp, sines = opp_packs
        args.update(sines=to_tensor(sines), opp=to_tensor(opp))
    off = torch.tensor([OFF], dtype=torch.int32)
    out_r, hit_r = scan_kernels.mega_edge_ttc(**{**args, "noise": pool}, pool_off=off)
    slab = pool[(torch.arange(E) + (OFF & ~15)) % ROWS]
    out_s, hit_s = scan_kernels.mega_edge_ttc(**{**args, "noise": slab})
    assert torch.equal(out_r, out_s) and torch.equal(hit_r, hit_s)
    assert hit_s.any(), "fixture guard: no iTTC hits"
    assert not any(scan_kernels.mega_edge_ttc.launches.values())


def test_pool_rot_twin_matches_jax_kernel(operands, pool):  # noqa: F811
    rt, per_row, consts, cell = operands
    p = {k: jnp.asarray(v) for k, v in per_row.items()}
    c = {k: jnp.asarray(v) for k, v in consts.items()}
    pool_np = np.asarray(pool.float().numpy())
    pool_j = jnp.asarray(pool_np).astype(jnp.bfloat16)
    # JAX reads a wrap-extended pool: rows + one 256-row tile of envs
    pool_ext = jnp.concatenate([pool_j, pool_j[:256 // A]], axis=0)
    j_out, j_hit = pallas_scan.mega_edge_ttc(
        jnp.asarray(rt)[p["rows"]], p["dx"], p["dy"], p["f_s"], p["i_f"],
        p["inb"], p["vel"], c["fmat"], c["fmat_sw"], c["shift1"], c["gmat"],
        c["c_frac"], jnp.full((E, 1), OFF, jnp.int32), c["cosines"],
        c["side_dist"], 30.0, TTC, A, T, ew_dtype=jnp.float32,
        pool=pool_ext, pool_rows=ROWS)
    args = _torch_args(rt, per_row, consts, "float32")
    t_out, t_hit = scan_kernels.mega_edge_ttc_reference(
        **{**args, "noise": pool}, pool_off=torch.tensor([OFF], dtype=torch.int32))
    err = np.abs(t_out.numpy() - np.asarray(j_out))
    assert np.quantile(err, 0.99) < 1e-3, np.quantile(err, 0.99)
    assert np.mean(err > 4 * cell) < 2e-3, np.mean(err > 4 * cell)
    np.testing.assert_array_equal(t_hit.numpy(), np.asarray(j_hit))
    # dead rows read exactly their env's pool row
    dead = per_row["inb"] == 0
    rows = (np.arange(E) + (OFF & ~15)) % ROWS
    want = np.repeat(pool_np[rows], A, axis=0)
    np.testing.assert_array_equal(t_out.numpy()[dead], want[dead])


@pytest.mark.parametrize("kw", [dict(scan_megakernel="off"),
                                dict(rt_spatial="bilinear")],
                         ids=["megakernel_off", "bilinear"])
def test_pool_rot_without_megakernel_picks_one_pool_row_per_env(kw):
    """Only the megakernel reads the resident pool.  Without it, "pool_rot"
    hands the scan an (E, B) slab of one pool row per env, as "pool" does
    and as the JAX package does (red_gym_tpu/env.py:349-361); the same
    draws give the same rows."""
    cfg = SimConfig(num_agents=2, num_beams=B, scan_mode="fast",
                    noise_mode="pool_rot", noise_pool_rows=ROWS, **kw)
    rng = np.random.default_rng(9)
    pool = to_tensor(rng.normal(0, 0.01, (ROWS, B)).astype(np.float32)).to(torch.bfloat16)
    params = tenv.EnvParams(vehicle=None, tables=types.SimpleNamespace(
        beam_cosines=torch.zeros(B)), tmap=None, noise_pool=pool)
    noise, off = tenv._noise_rows(cfg, params, E, torch.Generator().manual_seed(4))
    assert off is None and noise.shape == (E, B) and noise.dtype == torch.bfloat16
    want, _ = tenv._noise_rows(dataclasses.replace(cfg, noise_mode="pool"), params, E,
                               torch.Generator().manual_seed(4))
    assert torch.equal(noise, want)
    # the megakernel keeps the resident pool and a device offset
    mega = dataclasses.replace(cfg, scan_megakernel="auto", rt_spatial="nearest1")
    noise, off = tenv._noise_rows(mega, params, E, torch.Generator())
    assert noise is pool and off.shape == (1,) and off.dtype == torch.int32


def test_rollout_reset_step_rotates_over_the_reset_envs(tmp_path, monkeypatch):
    """Pool row r is the constant c_r, so each env's pool row is the median
    of its noisy-minus-clean scan.  Envs 3, 7 and 12 finish their laps in
    the step and are re-stepped as a batch of three."""
    monkeypatch.setenv("RED_GYM_TPU_TEXTURE_CACHE", str(tmp_path))
    rows, e_n, done_envs = 64, 24, [3, 7, 12]
    cfg = SimConfig(num_agents=2, num_beams=B, scan_mode="fast", rt_pose_stride=8,
                    noise_mode="pool_rot", noise_pool_rows=rows)
    params = tenv.make_params(cfg, assets.named_map_yaml("track_0019"))
    levels = (1e-3 * torch.arange(rows, dtype=torch.float32)).to(torch.bfloat16)
    noisy = params._replace(noise_pool=levels[:, None].expand(rows, B).contiguous())
    clean = params._replace(noise_pool=torch.zeros((rows, B), dtype=torch.bfloat16))
    poses = torch.as_tensor(np.tile(assets.waypoint_start_poses("track_0019", 2)[None],
                                    (e_n, 1, 1)), dtype=torch.float32)
    act = torch.tensor([0.0, 1.0]).expand(e_n, 2, 2)

    def run(p):
        gen = torch.Generator().manual_seed(5)
        state, obs, *_ = rollout.batched_reset(cfg, p, poses, gen)
        toggles = state.toggle_list.clone()
        toggles[done_envs] = cfg.laps_to_finish_toggles
        state = state._replace(toggle_list=toggles)
        gen.manual_seed(123)
        carry, outs = rollout.make_rollout(cfg, p, lambda o, g: act, 1)(
            rollout.RolloutCarry(state, obs), gen)
        assert torch.nonzero(outs["done"][0]).squeeze(1).tolist() == done_envs
        return carry.obs.scans

    diff = (run(noisy) - run(clean))[:, 0]          # ego scans (E, B)
    row_of = (diff.median(dim=1).values[:, None]
              - levels.float()[None, :]).abs().argmin(dim=1)
    gen = torch.Generator().manual_seed(123)
    off_step, off_reset = (int(torch.randint(0, rows, (1,), generator=gen,
                                             dtype=torch.int32)) & ~15
                           for _ in range(2))
    want = (torch.arange(e_n) + off_step) % rows
    want[done_envs] = (torch.arange(len(done_envs)) + off_reset) % rows
    assert row_of.tolist() == want.tolist()
