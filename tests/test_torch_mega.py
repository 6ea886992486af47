"""The scan megakernel's plain PyTorch twin against the JAX Pallas kernel.

``red_gym_tpu.ops.pallas_scan.mega_edge_ttc`` runs in interpret mode on the
CPU, as the JAX package's own tests run it.  Both get identical operands:
texture rows of a JAX-built stride-8 track_0019 texture (bfloat16 storage),
per-row scalars and per-env noise made with numpy.  160 envs x 2 agents =
320 rows span two of the JAX kernel's 256-row tiles, and the fixture
requires iTTC hits beyond row 256: the round-5 ``beam_tile`` regression
(tests/test_scan_fast.py::test_megakernel_matches_unfused) dropped exactly
those.  The CUDA kernel itself is compared with this twin on the GPU by
chip_smoke.py.

Bar (the float32 bar of tests/test_scan_fast.py): p99 |diff| < 1e-3 m,
< 0.2 % of beams off by more than 4 texture cells, hits exactly equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from red_gym_tpu.config import SimConfig as JSimConfig
from red_gym_tpu.maps.loader import load_map as jload_map
from red_gym_tpu.ops import pallas_scan, scan as jscan, scan_fast as jsf
from red_gym_tpu_torch import assets
from red_gym_tpu_torch.interop import to_tensor
from red_gym_tpu_torch.ops import scan_kernels

E, A, B, T = 160, 2, 270, 128
TTC = 2.0


@pytest.fixture(scope="module")
def operands():
    torch.set_num_threads(2)
    cfg = JSimConfig(num_agents=A, num_beams=B, dtype="float32",
                     scan_mode="fast", rt_pose_stride=8, ttc_thresh=TTC)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RED_GYM_TPU_TEXTURE_CACHE", "off")
        tmap = jload_map(assets.named_map_yaml("track_0019"), ".png",
                         dtype=jnp.float32)
        rtex = jsf.build_range_texture(tmap, cfg)
    tables = jscan.build_tables(cfg, 0.31, 0.58, dtype=jnp.float32)
    rng = np.random.default_rng(0)
    k_n = E * A
    cell = float(rtex.cell)
    valid = np.nonzero(np.asarray(rtex.valid))[0]
    f32 = np.float32
    per_row = dict(
        rows=rng.choice(valid, k_n).astype(np.int32),
        dx=rng.uniform(-cell / 2, cell / 2, k_n).astype(f32),
        dy=rng.uniform(-cell / 2, cell / 2, k_n).astype(f32),
        f_s=rng.uniform(0, 1, k_n).astype(f32),
        i_f=rng.integers(0, T, k_n).astype(f32),
        inb=(rng.uniform(0, 1, k_n) > 0.02).astype(f32),
        vel=rng.uniform(-2, 6, k_n).astype(f32))
    fmat = np.asarray(rtex.fmat)
    consts = dict(
        fmat=fmat, fmat_sw=np.roll(fmat, -T // 2, axis=1),
        shift1=np.roll(np.eye(T, dtype=f32), -1, axis=1),
        gmat=np.asarray(rtex.gmat),
        c_frac=np.mod(np.asarray(tables.scan_angles) * f32(T / (2 * np.pi)), f32(1)),
        noise=rng.normal(0, 0.01, (E, B)).astype(f32),
        cosines=np.asarray(tables.beam_cosines),
        side_dist=np.asarray(tables.side_distances))
    return np.asarray(rtex.rt), per_row, consts, cell


def _jax_mega(rt, per_row, consts, ew):
    p = {k: jnp.asarray(v) for k, v in per_row.items()}
    c = {k: jnp.asarray(v) for k, v in consts.items()}
    out, hit = pallas_scan.mega_edge_ttc(
        jnp.asarray(rt)[p["rows"]], p["dx"], p["dy"], p["f_s"], p["i_f"],
        p["inb"], p["vel"], c["fmat"], c["fmat_sw"], c["shift1"], c["gmat"],
        c["c_frac"], c["noise"], c["cosines"], c["side_dist"], 30.0, TTC, A, T,
        ew_dtype=jnp.dtype(ew))
    return np.asarray(out), np.asarray(hit)


def _torch_args(rt, per_row, consts, ew):
    p = {k: torch.from_numpy(v) for k, v in per_row.items()}
    c = {k: to_tensor(v) for k, v in consts.items()}
    return (to_tensor(rt), p["rows"], p["dx"], p["dy"], p["f_s"], p["i_f"],
            p["inb"], p["vel"], c["fmat"], c["fmat_sw"], c["shift1"], c["gmat"],
            c["c_frac"], c["noise"], c["cosines"], c["side_dist"], 30.0, TTC, A,
            T, getattr(torch, ew))


@pytest.mark.parametrize("ew", ["float32", "bfloat16"])
def test_reference_matches_jax_kernel(operands, ew):
    rt, per_row, consts, cell = operands
    j_out, j_hit = _jax_mega(rt, per_row, consts, ew)
    t_out, t_hit = scan_kernels.mega_edge_ttc_reference(
        *_torch_args(rt, per_row, consts, ew))
    assert t_out.shape == (E * A, B) and t_out.dtype == torch.float32
    err = np.abs(t_out.numpy() - j_out)
    assert np.quantile(err, 0.99) < 1e-3, np.quantile(err, 0.99)
    assert np.mean(err > 4 * cell) < 2e-3, np.mean(err > 4 * cell)
    np.testing.assert_array_equal(t_hit.numpy(), j_hit)
    # fixture guards: hits in the second JAX row tile; invalid rows read 0
    assert j_hit[256:].any(), "no iTTC hits beyond the first row tile"
    dead = per_row["inb"] == 0
    assert dead.any()
    noise_rows = np.repeat(consts["noise"], A, axis=0)
    np.testing.assert_array_equal(t_out.numpy()[dead], noise_rows[dead])


def test_dispatcher_on_cpu_is_the_reference(operands):
    rt, per_row, consts, _ = operands
    args = _torch_args(rt, per_row, consts, "bfloat16")
    before = scan_kernels.mega_edge_ttc.launches
    out, hit = scan_kernels.mega_edge_ttc(*args)
    ref_out, ref_hit = scan_kernels.mega_edge_ttc_reference(*args)
    assert torch.equal(out, ref_out) and torch.equal(hit, ref_hit)
    assert scan_kernels.mega_edge_ttc.launches == before == 0


def test_dispatcher_rejects_bad_operands(operands):
    rt, per_row, consts, _ = operands
    args = list(_torch_args(rt, per_row, consts, "bfloat16"))
    bad_noise = list(args)
    bad_noise[13] = args[13][:-1]          # one env short
    with pytest.raises(ValueError, match="noise"):
        scan_kernels.mega_edge_ttc(*bad_noise)
    bad_rows = list(args)
    bad_rows[2] = args[2][:-1]             # dx one row short
    with pytest.raises(ValueError, match=r"\(K,\)"):
        scan_kernels.mega_edge_ttc(*bad_rows)
    bad_rt = list(args)
    bad_rt[0] = args[0][:, :-1]
    with pytest.raises(ValueError, match="rt must be"):
        scan_kernels.mega_edge_ttc(*bad_rt)
    bad_dev = list(args)
    bad_dev[0] = args[0].to("meta")
    with pytest.raises(ValueError, match="one device"):
        scan_kernels.mega_edge_ttc(*bad_dev)
