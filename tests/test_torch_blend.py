"""The unfused scan's epilogue kernels (plain PyTorch twins) against JAX.

The twins of ``blend_kernels`` (kernels 7, 6, 3 and 4 of the TPU kernel
table) are held against the JAX Pallas kernels of
``red_gym_tpu/ops/pallas_scan.py``, run in interpret mode on the CPU as the
JAX package's own tests run them, on identical numpy operands: the rolled
spectra that the port's prep chain (``scan_fast.rolled_spectra``) makes on
a JAX-built bilinear edge + grad texture of track_0019 (stride 8), for
160 envs x 2 cars near each other, with numpy speeds, noise and opponent
packs.  K = 320 rows span two of the JAX kernels' 256-row tiles and
B = 1080 beams three 384-beam tiles: the fixture requires iTTC hits beyond
row 256 and in the last beam tile, and an opponent window across a beam
tile boundary (the TPU kernel offsets its window by the tile's first beam).
Kernel 7 also runs at K = 322 (161 envs), no multiple of the CUDA kernel's
128-row tile, and on the strided spec[:, 0] view of (K, 3, T) spectra that
the CUDA kernel reads in place.

Also ``scan_fast._cells_and_theta`` in its bilinear and nearest forms
against JAX in float64, and the dispatchers on CPU tensors.

Bar (the float32 bar of tests/test_scan_fast.py): p99 |diff| < 1e-3 m,
< 0.2 % of beams off by more than 4 texture cells, hits exactly equal.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from red_gym_tpu import env as jenv
from red_gym_tpu.config import SimConfig as JSimConfig
from red_gym_tpu.maps.loader import load_map as jload_map
from red_gym_tpu.ops import pallas_scan, scan as jscan, scan_fast as jsf
from red_gym_tpu_torch import assets, interop
from red_gym_tpu_torch.config import SimConfig as TSimConfig
from red_gym_tpu_torch.maps.loader import load_map as tload_map
from red_gym_tpu_torch.ops import agent_scan, blend_kernels, collision
from red_gym_tpu_torch.ops import scan_fast as tsf

E, A, B, T = 160, 2, 1080, 128
TTC = 2.0
MAX_RANGE = 30.0
TRACK = "track_0019"
CFG_KW = dict(num_agents=A, num_beams=B, dtype="float32", scan_mode="fast",
              rt_pose_stride=8, rt_spatial="bilinear", ttc_thresh=TTC)


def _leaves(nt):
    return {k: np.asarray(v) for k, v in nt._asdict().items() if v is not None}


def close_poses(rng, rtex, tmap, e_n, a_n):
    """(e_n, a_n, 3) numpy poses: car 0 uniform in a random free texture
    cell, the others within 2.5 m of it (some in walls), random headings."""
    valid = np.nonzero(np.asarray(rtex.valid))[0]
    wc, cell = int(rtex.wc), float(rtex.cell)
    pick = rng.choice(valid, e_n)
    x_rot = ((pick % wc) + rng.uniform(0, 1, e_n)) * cell
    y_rot = ((pick // wc) + rng.uniform(0, 1, e_n)) * cell
    oc, osn = float(tmap.orig_c), float(tmap.orig_s)
    base = np.stack([x_rot * oc - y_rot * osn + float(tmap.orig_x),
                     x_rot * osn + y_rot * oc + float(tmap.orig_y)], -1)
    xy = np.concatenate([base[:, None],
                         base[:, None] + rng.uniform(-2.5, 2.5, (e_n, a_n - 1, 2))], 1)
    return np.concatenate([xy, rng.uniform(0, 2 * np.pi, (e_n, a_n, 1))], -1)


@pytest.fixture(scope="module")
def texture():
    """The bilinear config and its JAX-built texture, carried to the port."""
    torch.set_num_threads(2)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RED_GYM_TPU_TEXTURE_CACHE", "off")
        jp = jenv.make_params(JSimConfig(**CFG_KW), assets.named_map_yaml(TRACK))
    cfg = TSimConfig(**CFG_KW)
    tp = interop.params_from_numpy(cfg, _leaves(jp.vehicle), _leaves(jp.tables),
                                   _leaves(jp.tmap), _leaves(jp.rtex), device="cpu")
    return cfg, tp


def _operands(cfg, tp, e_n, seed):
    """Numpy operands of the four kernels, K = e_n * A rows, and the cell."""
    rng = np.random.default_rng(seed)
    poses = torch.from_numpy(close_poses(rng, tp.rtex, tp.tmap, e_n, A).astype(np.float32))
    sp = tsf.rolled_spectra(poses, tp.tmap, tp.rtex, cfg)
    spec = sp.spec_r.reshape(e_n * A, 3, T)
    verts = collision.get_vertices(poses, tp.vehicle.length, tp.vehicle.width)
    opp = agent_scan.opponent_slab_scalars(poses, verts, tp.tables)
    noise = rng.normal(0, 0.01, (e_n, B)).astype(np.float32)
    ops = dict(
        spec_r=spec[:, 0].numpy(), spec_e=spec[:, 1].numpy(), spec_w=spec[:, 2].numpy(),
        f_s=sp.f_s.reshape(-1).numpy(), wsum=sp.wsum.reshape(-1).numpy(),
        vel=rng.uniform(-2, 6, e_n * A).astype(np.float32),
        gmat=tp.rtex.gmat.numpy(), c_frac=tp.rtex.c_frac.numpy(),
        noise=noise, cosines=tp.tables.beam_cosines.numpy(),
        sines=tp.tables.beam_sines.numpy(), side_dist=tp.tables.side_distances.numpy(),
        opp=opp.reshape(e_n * A, -1).numpy())
    assert (ops["wsum"] == 0).any() and (ops["wsum"] > 0).mean() > 0.5
    return ops, float(tp.rtex.cell)


@pytest.fixture(scope="module")
def operands(texture):
    return _operands(*texture, E, 0)


@pytest.fixture(scope="module")
def operands_322(texture):
    return _operands(*texture, E + 1, 3)


def _jax(ops, names, noise_dtype=None):
    out = []
    for n in names:
        v = jnp.asarray(ops[n])
        out.append(v.astype(jnp.bfloat16) if n == "noise" and noise_dtype == "bfloat16"
                   else v)
    return out


def _torch(ops, names, noise_dtype=None):
    out = []
    for n in names:
        v = np.asarray(jnp.asarray(ops[n]).astype(jnp.bfloat16)) \
            if n == "noise" and noise_dtype == "bfloat16" else ops[n]
        out.append(interop.to_tensor(v, device="cpu"))
    return out


def _bar(t_out, j_out, cell):
    err = np.abs(t_out.numpy() - np.asarray(j_out))
    assert np.quantile(err, 0.99) < 1e-3, np.quantile(err, 0.99)
    assert np.mean(err > 4 * cell) < 2e-3, np.mean(err > 4 * cell)


EDGE = ("spec_r", "spec_e", "spec_w", "f_s", "wsum")
TTC_OPS = EDGE + ("vel", "gmat", "c_frac", "noise", "cosines", "side_dist")
OPP_OPS = EDGE + ("vel", "gmat", "c_frac", "noise", "cosines", "sines",
                  "side_dist", "opp")


@pytest.mark.parametrize("rows, layout", [
    (E * A, "contiguous"), ((E + 1) * A, "contiguous"), (E * A, "strided")],
    ids=["320", "322", "320-strided"])
def test_blend_reference_matches_jax_kernel(request, rows, layout):
    """Kernel 7 (occlusion off) on the range spectra; "strided" passes them
    as the spec[:, 0] view of the (K, 3, T) spectra (row stride 3T), which
    must give the twin's result on a contiguous copy bit for bit."""
    ops, cell = request.getfixturevalue("operands" if rows == E * A else "operands_322")
    names = ("spec_r", "f_s", "wsum", "gmat", "c_frac")
    j = pallas_scan.theta_shuffle_blend(*_jax(ops, names), MAX_RANGE)
    args = _torch(ops, names)
    t = blend_kernels.theta_shuffle_blend_reference(*args, MAX_RANGE)
    if layout == "strided":
        full = torch.from_numpy(np.stack([ops[n] for n in ("spec_r", "spec_e", "spec_w")], 1))
        view = full[:, 0]
        assert view.stride() == (3 * T, 1)
        t_view = blend_kernels.theta_shuffle_blend_reference(view, *args[1:], MAX_RANGE)
        assert torch.equal(t_view, t)
    assert t.shape == (rows, B) and t.dtype == torch.float32
    _bar(t, j, cell)
    assert (t.numpy()[ops["wsum"] == 0] == 0).all()


@pytest.mark.parametrize("ew", ["float32", "bfloat16"])
def test_edge_reference_matches_jax_kernel(operands, ew):
    """Kernel 6: the edge render alone."""
    ops, cell = operands
    names = EDGE + ("gmat", "c_frac")
    j = pallas_scan.theta_shuffle_blend_edge(*_jax(ops, names), MAX_RANGE,
                                             ew_dtype=jnp.dtype(ew))
    t = blend_kernels.theta_shuffle_blend_edge_reference(
        *_torch(ops, names), MAX_RANGE, ew_dtype=getattr(torch, ew))
    _bar(t, j, cell)


def _beam_hits(out, ops):
    """Per-beam iTTC predicate of a noisy scan (K, B), numpy."""
    pv = ops["vel"][:, None] * ops["cosines"][None, :]
    num = out - ops["side_dist"][None, :]
    return ((pv > 0) & (num >= 0) & (num < TTC * pv)) | (
        (pv < 0) & (num <= 0) & (num > TTC * pv))


@pytest.mark.parametrize("noise", ["float32", "bfloat16"])
@pytest.mark.parametrize("ew", ["float32", "bfloat16"])
def test_edge_ttc_reference_matches_jax_kernel(operands, ew, noise):
    """Kernel 3: edge render + per-env noise + iTTC."""
    ops, cell = operands
    j_out, j_hit = pallas_scan.theta_shuffle_blend_edge_ttc(
        *_jax(ops, TTC_OPS, noise), MAX_RANGE, TTC, A, ew_dtype=jnp.dtype(ew))
    t_out, t_hit = blend_kernels.theta_shuffle_blend_edge_ttc_reference(
        *_torch(ops, TTC_OPS, noise), MAX_RANGE, TTC, A, ew_dtype=getattr(torch, ew))
    _bar(t_out, j_out, cell)
    np.testing.assert_array_equal(t_hit.numpy(), np.asarray(j_hit))
    # fixture guards: hits in the second row tile and in the last beam tile
    beam_hits = _beam_hits(t_out.numpy(), ops)
    assert beam_hits[256:].any(), "no iTTC hits beyond the first row tile"
    assert beam_hits[:, 768:].any(), "no iTTC hits in the last beam tile"
    assert 0 < t_hit.mean() < 1


@pytest.mark.parametrize("noise", ["float32", "bfloat16"])
@pytest.mark.parametrize("ew", ["float32", "bfloat16"])
def test_edge_ttc_opp_reference_matches_jax_kernel(operands, ew, noise):
    """Kernel 4: kernel 3, then the opponent cast in absolute beam indices."""
    ops, cell = operands
    j_out, j_hit = pallas_scan.theta_shuffle_blend_edge_ttc_opp(
        *_jax(ops, OPP_OPS, noise), MAX_RANGE, TTC, A, ew_dtype=jnp.dtype(ew))
    args = _torch(ops, OPP_OPS, noise)
    t_out, t_hit = blend_kernels.theta_shuffle_blend_edge_ttc_opp_reference(
        *args, MAX_RANGE, TTC, A, ew_dtype=getattr(torch, ew))
    _bar(t_out, j_out, cell)
    np.testing.assert_array_equal(t_hit.numpy(), np.asarray(j_hit))
    base, base_hit = blend_kernels.theta_shuffle_blend_edge_ttc_reference(
        *[a for a, n in zip(args, OPP_OPS) if n not in ("sines", "opp")],
        MAX_RANGE, TTC, A, ew_dtype=getattr(torch, ew))
    assert torch.equal(t_hit, base_hit), "hits must be the pre-opponent scan's"
    shortened = (t_out < base - 1e-6).numpy()
    assert shortened.any() and (t_out <= base).all()
    # fixture guard: a shortened window across a 384-beam tile boundary
    lo, hi = ops["opp"][:, 0], ops["opp"][:, 1]
    across = ((lo < 384) & (hi >= 384)) | ((lo < 768) & (hi >= 768))
    assert (shortened[across][:, [383, 384, 767, 768]]).any(), \
        "no shortened opponent window across a beam tile boundary"


def test_dispatchers_on_cpu_are_the_twins(operands):
    """On CPU tensors each dispatcher returns its twin's result and counts
    no launch."""
    ops, _ = operands
    blend_kernels.reset_launches()
    cases = [
        (blend_kernels.theta_shuffle_blend, blend_kernels.theta_shuffle_blend_reference,
         ("spec_r", "f_s", "wsum", "gmat", "c_frac"), ()),
        (blend_kernels.theta_shuffle_blend_edge,
         blend_kernels.theta_shuffle_blend_edge_reference, EDGE + ("gmat", "c_frac"),
         ()),
        (blend_kernels.theta_shuffle_blend_edge_ttc,
         blend_kernels.theta_shuffle_blend_edge_ttc_reference, TTC_OPS, (TTC, A)),
        (blend_kernels.theta_shuffle_blend_edge_ttc_opp,
         blend_kernels.theta_shuffle_blend_edge_ttc_opp_reference, OPP_OPS, (TTC, A))]
    for fn, ref, names, extra in cases:
        args = _torch(ops, names, "bfloat16")
        got, want = fn(*args, MAX_RANGE, *extra), ref(*args, MAX_RANGE, *extra)
        for g, w in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            assert torch.equal(g, w)
    assert not any(fn.launches for fn in blend_kernels.KERNELS)


def test_dispatchers_reject_bad_operands(operands):
    ops, _ = operands
    args = dict(zip(OPP_OPS, _torch(ops, OPP_OPS)))
    kw = dict(max_range=MAX_RANGE, ttc_thresh=TTC, agents_per_env=A)
    fn = blend_kernels.theta_shuffle_blend_edge_ttc_opp
    for key, bad, match in [
            ("noise", args["noise"][:-1], "noise"),             # one env short
            ("spec_e", args["spec_e"][:-1], "spectra"),         # one row short
            ("vel", args["vel"][:-1], "vel"),
            ("opp", args["opp"][:, :7], r"opp must be \(K, 10"),
            ("sines", args["sines"][:-1], "beam tables"),
            ("gmat", args["gmat"][:, :-1], "gmat"),
            ("spec_r", args["spec_r"].to("meta"), "one device")]:
        with pytest.raises(ValueError, match=match):
            fn(**{**args, key: bad}, **kw)
    with pytest.raises(ValueError, match="multiple of agents_per_env"):
        fn(**args, **{**kw, "agents_per_env": 3})


@pytest.mark.parametrize("spatial", ["bilinear", "nearest"])
def test_cells_and_theta_matches_jax(spatial):
    """The 4-cell lookup in float64, poses inside and around the map: rows
    and the zero pattern of the weights (the in-bounds flags; no pose sits
    on a cell boundary) exactly equal, weights and offsets within 1e-12."""
    kw = dict(num_beams=B, dtype="float64", scan_mode="fast", rt_pose_stride=8,
              rt_spatial=spatial)
    yaml = assets.named_map_yaml(TRACK)
    jm = jload_map(yaml, ".png", dtype=jnp.float64)
    tm = tload_map(yaml, dtype=torch.float64, device="cpu")
    stride, res = 8, float(tm.resolution)
    hc, wc = (int(tm.height) + stride - 1) // stride, (int(tm.width) + stride - 1) // stride
    cell = stride * res
    jr = types.SimpleNamespace(hc=jnp.int32(hc), wc=jnp.int32(wc), cell=jnp.float64(cell),
                               fmat=jnp.zeros((T, T), jnp.float64))
    tr = types.SimpleNamespace(hc=torch.tensor(hc, dtype=torch.int32),
                               wc=torch.tensor(wc, dtype=torch.int32),
                               cell=torch.tensor(cell, dtype=torch.float64),
                               fmat=torch.zeros((T, T), dtype=torch.float64))
    rng = np.random.default_rng(7)
    lo = np.array([float(tm.orig_x), float(tm.orig_y)]) - 3.0
    span = np.array([wc, hc]) * cell + 6.0
    poses = np.concatenate([lo + span * rng.uniform(0, 1, (400, 2)),
                            rng.uniform(0, 2 * np.pi, (400, 1))], -1).reshape(200, 2, 3)
    jt = jscan.build_tables(JSimConfig(**kw), 0.31, 0.58)
    j_rows, j_wgt, _, j_dx, j_dy = jsf._cells_and_theta(
        jnp.asarray(poses), jt, jm, jr, JSimConfig(**kw))
    t_rows, t_wgt, t_dx, t_dy = tsf._cells_and_theta(
        torch.from_numpy(poses), None, tm, tr, TSimConfig(**kw))
    assert t_rows.shape == (200, 2, 4) and t_wgt.dtype == torch.float64
    np.testing.assert_array_equal(t_rows.numpy(), np.asarray(j_rows))
    np.testing.assert_array_equal(t_wgt.numpy() == 0, np.asarray(j_wgt) == 0)
    for t, j in ((t_wgt, j_wgt), (t_dx, j_dx), (t_dy, j_dy)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=1e-12)
    out = (t_wgt.numpy() == 0).all(-1)
    assert out.any() and not out.all(), "fixture needs poses in and out of the map"
