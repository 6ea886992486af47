"""The scan megakernel's plain PyTorch twin against the JAX Pallas kernel.

``red_gym_tpu.ops.pallas_scan.mega_edge_ttc`` runs in interpret mode on the
CPU, as the JAX package's own tests run it.  Both get identical operands:
texture rows of a JAX-built stride-8 track_0019 texture (bfloat16 storage),
per-row scalars and per-env noise made with numpy.  160 envs x 2 agents =
320 rows span two of the JAX kernel's 256-row tiles, and the fixture
requires iTTC hits beyond row 256: the round-5 ``beam_tile`` regression
(tests/test_scan_fast.py::test_megakernel_matches_unfused) dropped exactly
those.  The CUDA kernels themselves are compared with this twin on the GPU
by chip_smoke.py and tests/test_torch_cuda.py.  At B = 1080 the twins of
the megakernel's two CUDA kernels (spectra, then render) are held to
compose into the whole twin exactly, and the composition is held against
the JAX kernel in every variant.

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
from red_gym_tpu_torch import assets, env
from red_gym_tpu_torch.config import SimConfig
from red_gym_tpu_torch.interop import to_tensor
from red_gym_tpu_torch.ops import agent_scan, collision, scan_fast, scan_kernels

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
    """Keyword arguments of scan_kernels.mega_edge_ttc."""
    p = {k: torch.from_numpy(v) for k, v in per_row.items()}
    scal = torch.stack([p[k] for k in ("dx", "dy", "f_s", "i_f", "inb", "vel")]
                       + [torch.zeros(E * A)] * 2, dim=-1)
    return dict(rt=to_tensor(rt, device="cpu"), rows=p["rows"], scal=scal,
                **{k: to_tensor(v, device="cpu") for k, v in consts.items()},
                max_range=30.0, ttc_thresh=TTC, agents_per_env=A, t_bins=T,
                ew_dtype=getattr(torch, ew))


@pytest.mark.parametrize("ew", ["float32", "bfloat16"])
def test_reference_matches_jax_kernel(operands, ew):
    rt, per_row, consts, cell = operands
    j_out, j_hit = _jax_mega(rt, per_row, consts, ew)
    t_out, t_hit = scan_kernels.mega_edge_ttc_reference(
        **_torch_args(rt, per_row, consts, ew))
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
    before = dict(scan_kernels.mega_edge_ttc.launches)
    out, hit = scan_kernels.mega_edge_ttc(**args)
    ref_out, ref_hit = scan_kernels.mega_edge_ttc_reference(**args)
    assert torch.equal(out, ref_out) and torch.equal(hit, ref_hit)
    assert scan_kernels.mega_edge_ttc.launches == before
    assert not any(before.values())


def test_dispatcher_rejects_bad_operands(operands):
    rt, per_row, consts, _ = operands
    args = _torch_args(rt, per_row, consts, "bfloat16")
    for key, bad, match in [
            ("noise", args["noise"][:-1], "noise"),          # one env short
            ("scal", args["scal"][:-1], r"scal \(K, 8\)"),   # one row short
            ("rt", args["rt"][:, :-1], "rt must be"),
            ("rt", args["rt"].to("meta"), "one device")]:
        with pytest.raises(ValueError, match=match):
            scan_kernels.mega_edge_ttc(**{**args, key: bad})


@pytest.fixture(scope="module")
def wide_operands():
    """Operands of every megakernel variant at K = 320 rows (160 envs x 2
    agents) and B = 1080 beams on the port's own stride-8 track_0019
    texture, from numpy draws: car 0 of each env in a random valid texture
    cell, car 1 within 2.5 m of it, random headings and speeds, one noise
    row per env and the resident pool at offset rows - 37."""
    torch.set_num_threads(2)
    cfg = SimConfig(num_agents=A, num_beams=1080, scan_mode="fast",
                    rt_pose_stride=8, ttc_thresh=TTC)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RED_GYM_TPU_TEXTURE_CACHE", "off")
        params = env.make_params(cfg, assets.named_map_yaml("track_0019"),
                                 device="cpu")
    rng = np.random.default_rng(7)
    rtex, tmap = params.rtex, params.tmap
    valid = np.nonzero(rtex.valid.numpy())[0]
    pick = rng.choice(valid, E)
    wc, cell = int(rtex.wc), float(rtex.cell)
    x_rot = ((pick % wc) + rng.uniform(0, 1, E)) * cell
    y_rot = ((pick // wc) + rng.uniform(0, 1, E)) * cell
    c, s = float(tmap.orig_c), float(tmap.orig_s)
    base = np.stack([x_rot * c - y_rot * s + float(tmap.orig_x),
                     x_rot * s + y_rot * c + float(tmap.orig_y)], axis=-1)
    other = base + rng.uniform(-2.5, 2.5, (E, 2))
    xy = np.stack([base, other], axis=1)
    heading = rng.uniform(0, 2 * np.pi, (E, A, 1))
    poses = torch.from_numpy(np.concatenate([xy, heading], -1).astype(np.float32))
    vel = torch.from_numpy(rng.uniform(-2, 8, (E, A)).astype(np.float32))
    verts = collision.get_vertices(poses, params.vehicle.length, params.vehicle.width)
    opp = agent_scan.opponent_slab_scalars(poses, verts, params.tables)
    slab = params.noise_pool[torch.from_numpy(rng.integers(0, cfg.noise_pool_rows, E))]
    pool_off = torch.tensor([cfg.noise_pool_rows - 37], dtype=torch.int32)
    return float(rtex.cell), {variant: scan_fast.mega_operands(
        poses, params.tables, tmap, rtex, cfg,
        params.noise_pool if "pool_rot" in variant else slab, vel,
        opp=opp if "opp" in variant else None,
        pool_off=pool_off if "pool_rot" in variant else None)
        for variant in ("plain", "opp", "pool_rot", "opp+pool_rot")}


def _jnp(t):
    """A CPU tensor as a JAX array of the same dtype and values."""
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
    return jnp.asarray(t.numpy())


def _jax_wide(ops):
    """JAX's interpret-mode megakernel on the port's megakernel operands:
    the texture rows gathered, the scalars unpacked, and the resident pool
    wrap-extended by one 256-row tile of envs, with the offset as its noise
    operand, as the JAX kernel reads them."""
    scal = ops["scal"]
    per_row = [_jnp(scal[:, i].contiguous()) for i in range(6)]
    extra = {}
    noise = _jnp(ops["noise"])
    if ops.get("opp") is not None:
        extra.update(sines=_jnp(ops["sines"]), opp=_jnp(ops["opp"]))
    if ops["pool_off"] is not None:
        e_n = ops["rows"].shape[0] // A
        extra.update(pool=jnp.concatenate([noise, noise[:256 // A]], axis=0),
                     pool_rows=noise.shape[0])
        noise = jnp.full((e_n, 1), int(ops["pool_off"][0]), jnp.int32)
    out, hit = pallas_scan.mega_edge_ttc(
        _jnp(ops["rt"][ops["rows"].long()]), *per_row, _jnp(ops["fmat"]),
        _jnp(ops["fmat_sw"]), _jnp(ops["shift1"]), _jnp(ops["gmat"]),
        _jnp(ops["c_frac"]), noise, _jnp(ops["cosines"]), _jnp(ops["side_dist"]),
        ops["max_range"], ops["ttc_thresh"], ops["agents_per_env"], T,
        ew_dtype=jnp.dtype(str(ops["ew_dtype"]).removeprefix("torch.")), **extra)
    return np.asarray(out), np.asarray(hit)


@pytest.mark.parametrize("ew", ["bfloat16", "float32"])
@pytest.mark.parametrize("variant", ["plain", "opp", "pool_rot", "opp+pool_rot"])
def test_spectra_then_render_is_the_megakernel(wide_operands, variant, ew):
    """The contract between the megakernel's two CUDA kernels, on their
    twins: the spectra kernel's outputs (mega_spectra_reference: the rolled
    spectra (K, 3T) and f_s, wsum, vel (K,)), read by the render kernel as
    three (K, T) views of row stride 3T (edge_render_reference, then
    noise_ttc_reference on the env's slab or pool row, then
    opp_cast_reference), give exactly mega_edge_ttc_reference's scan and
    hits, and meet the float32 bar against JAX's interpret-mode kernel,
    a witness that shares no code with the twins."""
    cell, wide = wide_operands
    ops = dict(wide[variant], ew_dtype=getattr(torch, ew))
    k_n, b_n = ops["rows"].shape[0], ops["c_frac"].shape[0]
    spec, f_s, wsum, vel = scan_kernels.mega_spectra_reference(
        ops["rt"], ops["rows"], ops["scal"], ops["fmat"], ops["fmat_sw"],
        ops["shift1"], ops["max_range"], T, ops["ew_dtype"])
    assert spec.shape == (k_n, 3 * T) and spec.dtype == torch.float32
    assert f_s.shape == wsum.shape == vel.shape == (k_n,)
    if ew == "bfloat16":   # the e/w spectra leave the spectra kernel rounded
        assert torch.equal(spec[:, T:], spec[:, T:].to(torch.bfloat16).float())
    out = scan_kernels.edge_render_reference(
        spec[:, :T], spec[:, T:2 * T], spec[:, 2 * T:], f_s[:, None],
        wsum[:, None], ops["gmat"], ops["c_frac"], ops["max_range"],
        ops["ew_dtype"])
    noise = ops["noise"]
    if ops["pool_off"] is not None:
        noise = noise[scan_kernels.pool_rot_rows(k_n // A, noise.shape[0],
                                                 ops["pool_off"])]
    out, hit = scan_kernels.noise_ttc_reference(
        out, noise, vel[:, None], ops["cosines"], ops["side_dist"],
        ops["ttc_thresh"], ops["agents_per_env"])
    if "opp" in ops:
        out = scan_kernels.opp_cast_reference(out, ops["opp"], ops["cosines"],
                                              ops["sines"])
    want_out, want_hit = scan_kernels.mega_edge_ttc_reference(**ops)
    assert out.shape == (k_n, b_n)
    assert torch.equal(out, want_out) and torch.equal(hit, want_hit)
    assert hit.sum() > 0, "fixture guard: no iTTC hits"
    j_out, j_hit = _jax_wide(ops)
    err = np.abs(out.numpy() - j_out)
    assert np.quantile(err, 0.99) < 1e-3, np.quantile(err, 0.99)
    assert np.mean(err > 4 * cell) < 2e-3, np.mean(err > 4 * cell)
    np.testing.assert_array_equal(hit.numpy(), j_hit)
