"""The port's element-gather fast scan ``scan_fast.trace_fast`` against JAX's,
and the port's ``trace_fast_mxu`` held to it.

Both packages read one JAX-built texture of track_0019 at stride 8 (edge +
grad channels); a config without some channels reads its column slices, as
in tests/test_torch_scan_modes.py.  Poses: 64 envs x 2 cars near each
other, some in walls.  Modes: rt_spatial nearest1 / nearest / bilinear x
rt_occlusion edge / off / snap x grad channels on / off, each in float64
(the texture's floats cast to float64 in both packages) and float32.

Bars.  Float64, port against JAX: 1e-9 m on every beam (both run the same
arithmetic; what differs is the order of a few sums).  Float32: the float32
bar of tests/test_scan_fast.py (p99 |diff| < 1e-3 m, < 0.2 % of beams off
by more than 4 texture cells).  The float64 runs build the lidar tables
and the DFT matrices in float64, as a float64 config does.  ``trace_fast_mxu`` against ``trace_fast``
of the port: the float32 bar with the kernels' plain twins (float32), and
JAX's own bar between its two scans in float64, 1e-7.  Multi-map: a stack
of two maps (track_0019's texture and the same texture with its rows
rolled, under another origin), each pose reading map ``midx``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from red_gym_tpu import env as jenv
from red_gym_tpu.config import SimConfig as JSimConfig
from red_gym_tpu.maps.loader import TrackMap as JTrackMap
from red_gym_tpu.ops import scan_fast as jsf
from red_gym_tpu.ops.scan import ScanTables as JScanTables
from red_gym_tpu_torch import assets, interop
from red_gym_tpu_torch.config import SimConfig as TSimConfig
from red_gym_tpu_torch.ops import scan as tscan, scan_fast as tsf
from tests.test_torch_blend import close_poses

E, A, B, T = 64, 2, 1080, 128
TRACK = "track_0019"
BASE_KW = dict(num_agents=A, num_beams=B, scan_mode="fast", rt_pose_stride=8,
               scan_megakernel="off", fuse_scan_ttc="off")
F64_BAR = 1e-9


def _leaves(nt):
    return {k: np.asarray(v) for k, v in nt._asdict().items() if v is not None}


@pytest.fixture(scope="module")
def setup():
    torch.set_num_threads(2)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RED_GYM_TPU_TEXTURE_CACHE", "off")
        jp = jenv.make_params(JSimConfig(**BASE_KW, dtype="float32"),
                              assets.named_map_yaml(TRACK))
    leaves = {k: _leaves(getattr(jp, k)) for k in ("vehicle", "tables", "tmap", "rtex")}
    rng = np.random.default_rng(3)
    tp = interop.params_from_numpy(TSimConfig(**BASE_KW, dtype="float32"),
                                   *leaves.values(), device="cpu")
    poses = close_poses(rng, tp.rtex, tp.tmap, E, A)
    return leaves, poses


def _channels(rt, occlusion, grad):
    cols = [slice(0, T)]
    if occlusion == "edge":
        cols.append(slice(T, 3 * T))
    if grad:
        cols.append(slice(3 * T, 5 * T))
    return np.concatenate([rt[:, c] for c in cols], axis=1)


def _cast(d, dtype):
    return {k: v.astype(dtype) if np.issubdtype(v.dtype, np.floating) else v
            for k, v in d.items()}


def _pair(setup, kw, dtype):
    """(JAX cfg, tables, tmap, rtex) and the port's, for mode kw in dtype
    ("float32" or "float64")."""
    leaves, _ = setup
    np_dt = np.float64 if dtype == "float64" else np.float32
    cfg_j = JSimConfig(**BASE_KW, dtype=dtype, **kw)
    cfg_t = TSimConfig(**BASE_KW, dtype=dtype, **kw)
    rtex = dict(leaves["rtex"])
    rtex["rt"] = _channels(rtex["rt"].astype(np.float32), cfg_t.rt_eff_occlusion,
                           kw["rt_grad"])
    rtex = _cast(rtex, np_dt)
    tables, tmap = _cast(leaves["tables"], np_dt), _cast(leaves["tmap"], np_dt)
    if dtype == "float64":
        # the lidar tables and the DFT matrices in float64, as a float64
        # config builds them
        veh = leaves["vehicle"]
        built = tscan.build_tables(cfg_t, width=float(veh["width"]),
                                   length=float(veh["lf"] + veh["lr"]),
                                   dtype=torch.float64, device="cpu")
        tables = {k: v.numpy() for k, v in built._asdict().items()
                  if v is not None and k in tables}
        consts = tsf.texture_constants(cfg_t, torch.float64, "cpu")
        rtex.update({k: consts[k].numpy() for k in ("fmat", "gmat", "smat")})
    jt = JScanTables(**{k: jnp.asarray(v) for k, v in tables.items()})
    jm = JTrackMap(**{k: jnp.asarray(v) for k, v in tmap.items()})
    jr = jsf.RangeTexture(**{k: jnp.asarray(v) for k, v in rtex.items()})
    tt = interop.params_from_numpy(cfg_t, _cast(leaves["vehicle"], np_dt), tables,
                                   tmap, rtex, device="cpu")
    return (cfg_j, jt, jm, jr), (cfg_t, tt.tables, tt.tmap, tt.rtex)


MODES = [dict(rt_spatial=s, rt_occlusion=o, rt_grad=g)
         for s in ("nearest1", "nearest", "bilinear")
         for o in ("edge", "off", "snap") for g in (True, False)]


def _ids(kw):
    return "-".join([kw["rt_spatial"], kw["rt_occlusion"],
                     "grad" if kw["rt_grad"] else "nograd"])


def _f32_bar(t_out, ref, cell):
    err = np.abs(np.asarray(t_out) - np.asarray(ref))
    assert np.quantile(err, 0.99) < 1e-3, np.quantile(err, 0.99)
    assert np.mean(err > 4 * cell) < 2e-3, np.mean(err > 4 * cell)


@pytest.mark.parametrize("kw", MODES, ids=_ids)
def test_trace_fast_matches_jax_float64(setup, kw):
    poses = setup[1]
    (cj, jt, jm, jr), (ct, tt, tm, tr) = _pair(setup, kw, "float64")
    j = np.asarray(jsf.trace_fast(jnp.asarray(poses), jt, jm, jr, cj))
    t = tsf.trace_fast(torch.from_numpy(poses), tt, tm, tr, ct)
    assert t.shape == (E, A, B) and t.dtype == torch.float64
    np.testing.assert_allclose(t.numpy(), j, rtol=0, atol=F64_BAR)
    assert (t > 1.0).double().mean() > 0.5, "degenerate scans"


@pytest.mark.parametrize("kw", MODES, ids=_ids)
def test_trace_fast_matches_jax_float32_and_mxu(setup, kw):
    """Float32: the port's gather scan against JAX's at the float32 bar,
    and the port's trace_fast_mxu (the blend kernels' twins) against the
    port's gather scan at the same bar."""
    poses = setup[1].astype(np.float32)
    (cj, jt, jm, jr), (ct, tt, tm, tr) = _pair(setup, kw, "float32")
    j = np.asarray(jsf.trace_fast(jnp.asarray(poses), jt, jm, jr, cj))
    t = tsf.trace_fast(torch.from_numpy(poses), tt, tm, tr, ct)
    assert t.dtype == torch.float32
    cell = float(tr.cell)
    _f32_bar(t.numpy(), j, cell)
    m = tsf.trace_fast_mxu(torch.from_numpy(poses), tt, tm, tr, ct)
    _f32_bar(m.numpy(), t.numpy(), cell)


@pytest.mark.parametrize("kw", [MODES[0], MODES[8], MODES[15]], ids=_ids)
def test_mxu_matches_gather_float64(setup, kw):
    """JAX's bar between its two scans (tests/test_scan_fast.py), held by
    the port's: the float64 trace_fast_mxu (prep chain + xla_tail)."""
    poses = torch.from_numpy(setup[1])
    _, (ct, tt, tm, tr) = _pair(setup, kw, "float64")
    a = tsf.trace_fast(poses, tt, tm, tr, ct)
    b = tsf.trace_fast_mxu(poses, tt, tm, tr, ct)
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-7, atol=1e-7)


def _stack(jpair, tpair):
    """Two-map stacks of the pair's map and texture: map 1 is map 0 moved
    by (3.1, -1.7) m with its texture rows rolled by 37."""
    (cj, jt, jm, jr), (ct, tt, tm, tr) = jpair, tpair
    out = []
    for pkg, tmap, rtex, xp in (("j", jm, jr, jnp), ("t", tm, tr, torch)):
        def st(a, b):
            return xp.stack([a, b])
        rt, valid = rtex.rt, rtex.valid
        rolled = (xp.roll(rt, 37, 0) if pkg == "j" else torch.roll(rt, 37, 0),
                  xp.roll(valid, 37, 0) if pkg == "j" else torch.roll(valid, 37, 0))
        r2 = rtex._replace(rt=st(rt, rolled[0]), valid=st(valid, rolled[1]),
                           hc=st(rtex.hc, rtex.hc), wc=st(rtex.wc, rtex.wc),
                           cell=st(rtex.cell, rtex.cell))
        fields = {}
        for f in tmap._fields:
            v = getattr(tmap, f)
            if f == "orig_x":
                v2 = v + 3.1
            elif f == "orig_y":
                v2 = v - 1.7
            else:
                v2 = v
            fields[f] = st(v, v2)
        out.append((type(tmap)(**fields), r2))
    return (cj, jt, *out[0]), (ct, tt, *out[1])


@pytest.mark.parametrize("kw", [MODES[0], MODES[7], MODES[14]], ids=_ids)
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_trace_fast_stacked_maps_match_jax(setup, kw, dtype):
    poses = setup[1]
    if dtype == "float32":
        poses = poses.astype(np.float32)
    jpair, tpair = _stack(*_pair(setup, kw, dtype))
    (cj, jt, jm, jr), (ct, tt, tm, tr) = jpair, tpair
    midx = (np.arange(E * A) % 2).reshape(E, A).astype(np.int32)
    j = np.asarray(jsf.trace_fast(jnp.asarray(poses), jt, jm, jr, cj,
                                  jnp.asarray(midx)))
    t = tsf.trace_fast(torch.from_numpy(poses), tt, tm, tr, ct, torch.from_numpy(midx))
    if dtype == "float64":
        np.testing.assert_allclose(t.numpy(), j, rtol=0, atol=F64_BAR)
    else:
        _f32_bar(t.numpy(), j, float(tr.cell[0]))
    # map 0's rows equal the one-map scan
    (_, _, tm1, tr1) = _pair(setup, kw, dtype)[1]
    one = tsf.trace_fast(torch.from_numpy(poses), tt, tm1, tr1, ct)
    assert torch.equal(t[midx == 0], one[torch.from_numpy(midx == 0)])
    # map 1 is another map: its scans differ
    assert not torch.allclose(t[midx == 1], one[torch.from_numpy(midx == 1)])


def test_trace_fast_checks_its_inputs(setup):
    kw = MODES[0]
    _, (ct, tt, tm, tr) = _pair(setup, kw, "float32")
    poses = torch.from_numpy(setup[1].astype(np.float32))
    with pytest.raises(ValueError, match="channels"):
        tsf.trace_fast(poses, tt, tm, tr._replace(rt=tr.rt[:, :T]), ct)
    with pytest.raises(ValueError, match="midx"):
        tsf.trace_fast(poses, tt, tm, tr, ct, torch.zeros(E, A, dtype=torch.int32))
