"""CUDA-only checks of the port (marker ``cuda``); they skip without a GPU.

This file imports no JAX, so it also runs on a GPU machine without JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

It covers what chip_smoke.py does not: every storage variant of the scan
megakernel (bfloat16 / float32 texture, bfloat16 pool / float32 fresh
noise, bfloat16 / float32 e/w taps), a row count that leaves a partial
block, and one whole env step on the GPU against the same step on the CPU.
"""

import numpy as np
import pytest
import torch

from chip_smoke import random_free_poses
from red_gym_tpu_torch import assets, env, rollout
from red_gym_tpu_torch.config import SimConfig
from red_gym_tpu_torch.maps.loader import load_map
from red_gym_tpu_torch.ops import scan_fast, scan_kernels

pytestmark = pytest.mark.cuda
TRACK = "track_0019"


@pytest.fixture(scope="module")
def gpu_params():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = SimConfig(num_agents=2, num_beams=1080, scan_mode="fast",
                    rt_pose_stride=8, ttc_thresh=0.5)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RED_GYM_TPU_TEXTURE_CACHE", "off")
        params = env.make_params(cfg, assets.named_map_yaml(TRACK),
                                 device=torch.device("cuda"))
    return cfg, params


def _operands(cfg, params, e_n, noise_dtype, seed=0):
    dev = params.rtex.rt.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    poses = random_free_poses(params, e_n * 2, gen).reshape(e_n, 2, 3)
    vel = -2.0 + 10.0 * torch.rand((e_n, 2), generator=gen, device=dev)
    noise = (0.01 * torch.randn((e_n, cfg.num_beams), generator=gen,
                                device=dev)).to(noise_dtype)
    return list(scan_fast.mega_operands(poses, params.tables, params.tmap,
                                        params.rtex, cfg, noise, vel))


@pytest.mark.parametrize("rt_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("noise_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("ew_dtype", [torch.bfloat16, torch.float32])
def test_kernel_variants_match_plain_twin(gpu_params, rt_dtype, noise_dtype,
                                          ew_dtype):
    cfg, params = gpu_params
    ops = _operands(cfg, params, 1001, noise_dtype)   # 2002 rows: partial block
    ops[0] = ops[0].to(rt_dtype)
    ops[-1] = ew_dtype
    before = scan_kernels.mega_edge_ttc.launches
    out, hit = scan_kernels.mega_edge_ttc(*ops)
    assert scan_kernels.mega_edge_ttc.launches == before + 1
    ref_out, ref_hit = scan_kernels.mega_edge_ttc_reference(*ops)
    torch.cuda.synchronize()
    err = (out - ref_out).abs()
    cell = float(params.rtex.cell)
    assert torch.isfinite(out).all()
    assert float(torch.quantile(err.flatten(), 0.99)) < 1e-3
    assert float((err > 4 * cell).float().mean()) < 2e-3
    assert torch.equal(hit, ref_hit)
    assert hit.sum() > 0, "fixture guard: no iTTC hits"


def test_kernel_rejects_what_it_cannot_take(gpu_params):
    cfg, params = gpu_params
    ops = _operands(cfg, params, 8, torch.bfloat16)
    bad = list(ops)
    bad[8] = ops[8].double()                        # fmat
    with pytest.raises(ValueError, match="fmat must be float32"):
        scan_kernels.mega_edge_ttc(*bad)
    bad = list(ops)
    bad[19] = 256                                   # t_bins
    bad[0] = torch.zeros((4, 5 * 256), device=ops[0].device)
    with pytest.raises(ValueError, match="rt_theta_bins=128"):
        scan_kernels.mega_edge_ttc(*bad)


@pytest.mark.parametrize("noise_mode", ["pool", "fresh"])
def test_env_step_on_gpu_matches_cpu(gpu_params, noise_mode):
    """One reset + 5 steps on the GPU (kernel) and the CPU (plain twin) from
    identical inputs.  The generators of the two devices differ, so "pool"
    runs on a pool whose rows are all equal (bfloat16 noise in the kernel)
    and "fresh" runs without noise (float32 noise in the kernel)."""
    _, params_g = gpu_params
    cfg = SimConfig(num_agents=2, num_beams=1080, scan_mode="fast",
                    rt_pose_stride=8, ttc_thresh=0.5, noise_mode=noise_mode,
                    scan_noise_std=0.01 if noise_mode == "pool" else 0.0,
                    rt_ew_dtype="bfloat16")
    row = 0.01 * torch.randn((1, cfg.num_beams), generator=torch.Generator().manual_seed(1))
    pool = row.expand(cfg.noise_pool_rows, -1).to(torch.bfloat16)

    def on(dev):
        def move(v):
            if v is None:
                return None
            if isinstance(v, tuple):
                return type(v)(*[move(t) for t in v])
            return v.to(dev)
        return move(params_g._replace(noise_pool=pool))

    poses = torch.as_tensor(np.tile(assets.waypoint_start_poses(TRACK, 2)[None],
                                    (64, 1, 1)), dtype=torch.float32)
    actions = torch.rand((6, 64, 2, 2), generator=torch.Generator().manual_seed(0))
    actions[..., 0] = 0.8 * actions[..., 0] - 0.4
    actions[..., 1] = 1.0 + 7.0 * actions[..., 1]
    out = {}
    for dev in ("cuda", "cpu"):
        params = on(dev)
        gen = torch.Generator(device=dev)
        s, o, *_ = rollout.batched_reset(cfg, params, poses.to(dev), gen)
        for i in range(5):
            s, o, *_ = rollout.batched_step(cfg, params, s, actions[i].to(dev), gen)
        out[dev] = (s.x.cpu(), o.scans.cpu(), s.collisions.cpu())
    x_g, scan_g, coll_g = out["cuda"]
    x_c, scan_c, coll_c = out["cpu"]
    torch.testing.assert_close(x_g, x_c, rtol=0, atol=1e-4)
    err = (scan_g - scan_c).abs()
    assert float(torch.quantile(err.flatten(), 0.99)) < 1e-3
    assert torch.equal(coll_g, coll_c)


def test_texture_built_on_gpu_matches_cpu(gpu_params):
    """The stride-8 texture marched on the GPU against the CPU build, in
    float32 storage: validity exact, ranges and channels within 1e-3 on all
    but the few bins whose edge bisection a last-bit difference flips."""
    cfg = SimConfig(num_agents=2, num_beams=1080, scan_mode="fast",
                    rt_pose_stride=8, rt_dtype="float32")
    yaml_path = assets.named_map_yaml(TRACK)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RED_GYM_TPU_TEXTURE_CACHE", "off")
        rt = {dev: scan_fast.build_range_texture(
            load_map(yaml_path, dtype=torch.float32, device=dev), cfg)
            for dev in ("cuda", "cpu")}
    assert torch.equal(rt["cuda"].valid.cpu(), rt["cpu"].valid)
    err = (rt["cuda"].rt.cpu() - rt["cpu"].rt).abs()
    assert float((err <= 1e-3).float().mean()) >= 0.999
