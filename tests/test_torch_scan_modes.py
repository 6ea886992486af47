"""The unfused fast scan (prep chain + epilogue) against the JAX package.

``scan_fast.trace_fast_mxu`` of the port against JAX's, for every
linear-theta mode outside the megakernel: rt_spatial nearest1 / nearest /
bilinear x rt_occlusion edge / off / snap x grad channels on / off, with
``scan_megakernel="off"``; and for occlusion edge with grad channels, the
fused forms with noise and iTTC (kernel 3) and with the opponent cast
(kernel 4).  JAX runs its Pallas epilogues in interpret mode
(``scan_backend="pallas"``), except for snap, which has no kernel and runs
under "auto" (XLA); the port runs its plain twins on the CPU.

Both packages read one JAX-built texture of track_0019 at stride 8 (edge +
grad channels); the configs without some channels read its column slices
[R | e w] or [R | gx gy] or [R] (the build computes each channel the same
way whatever the others).  Poses: 64 envs x 2 cars near each other, some in
walls.  Bar: the float32 bar of tests/test_scan_fast.py (p99 |diff| < 1e-3
m, < 0.2 % of beams off by more than 4 texture cells, hits exactly equal).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from red_gym_tpu import env as jenv
from red_gym_tpu.config import SimConfig as JSimConfig
from red_gym_tpu.ops import agent_scan as jas, collision as jcol, scan_fast as jsf
from red_gym_tpu_torch import assets, interop
from red_gym_tpu_torch.config import SimConfig as TSimConfig
from red_gym_tpu_torch.ops import scan_fast as tsf
from tests.test_torch_blend import close_poses

E, A, B, T = 64, 2, 1080, 128
TTC = 2.0
TRACK = "track_0019"
BASE_KW = dict(num_agents=A, num_beams=B, dtype="float32", scan_mode="fast",
               rt_pose_stride=8, ttc_thresh=TTC, scan_megakernel="off")


def _leaves(nt):
    return {k: np.asarray(v) for k, v in nt._asdict().items() if v is not None}


@pytest.fixture(scope="module")
def setup():
    torch.set_num_threads(2)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RED_GYM_TPU_TEXTURE_CACHE", "off")
        jp = jenv.make_params(JSimConfig(**BASE_KW), assets.named_map_yaml(TRACK))
    cfg = TSimConfig(**BASE_KW)
    tp = interop.params_from_numpy(cfg, _leaves(jp.vehicle), _leaves(jp.tables),
                                   _leaves(jp.tmap), _leaves(jp.rtex))
    rng = np.random.default_rng(3)
    poses = close_poses(rng, tp.rtex, tp.tmap, E, A).astype(np.float32)
    noise = rng.normal(0, 0.01, (E, B)).astype(np.float32)
    vel = rng.uniform(-2, 6, (E, A)).astype(np.float32)
    return jp, tp, poses, noise, vel


def _channels(rt, occlusion, grad):
    """Column slice of a [R | e w | gx gy] texture with these channels."""
    cols = [slice(0, T)]
    if occlusion == "edge":
        cols.append(slice(T, 3 * T))
    if grad:
        cols.append(slice(3 * T, 5 * T))
    return np.concatenate([rt[:, c] for c in cols], axis=1)


def _pair(setup, kw):
    """(JAX config, params) and (port config, params) for the mode kw."""
    jp, tp, *_ = setup
    backend = "auto" if kw["rt_occlusion"] == "snap" else "pallas"
    cfg_j = JSimConfig(**BASE_KW, scan_backend=backend, **kw)
    cfg_t = TSimConfig(**BASE_KW, scan_backend=backend, **kw)
    rt = _channels(np.asarray(jp.rtex.rt), kw["rt_occlusion"], kw["rt_grad"])
    assert rt.shape[1] == cfg_t.rt_channels * T
    jp = jp._replace(rtex=jp.rtex._replace(rt=jnp.asarray(rt)))
    tp = tp._replace(rtex=tp.rtex._replace(rt=interop.to_tensor(rt)))
    return (cfg_j, jp), (cfg_t, tp)


def _bar(t_out, j_out, cell):
    err = np.abs(t_out.numpy() - np.asarray(j_out))
    assert np.quantile(err, 0.99) < 1e-3, np.quantile(err, 0.99)
    assert np.mean(err > 4 * cell) < 2e-3, np.mean(err > 4 * cell)


MODES = [dict(rt_spatial=s, rt_occlusion=o, rt_grad=g)
         for s in ("nearest1", "nearest", "bilinear")
         for o in ("edge", "off", "snap") for g in (True, False)]


def _ids(kw):
    return "-".join([kw["rt_spatial"], kw["rt_occlusion"],
                     "grad" if kw["rt_grad"] else "nograd"])


@pytest.mark.parametrize("kw", MODES, ids=_ids)
def test_unfused_scan_matches_jax(setup, kw):
    _, _, poses, _, _ = setup
    (cfg_j, jp), (cfg_t, tp) = _pair(setup, dict(kw, fuse_scan_ttc="off"))
    j = jsf.trace_fast_mxu(jnp.asarray(poses), jp.tables, jp.tmap, jp.rtex, cfg_j)
    t = tsf.trace_fast_mxu(torch.from_numpy(poses), tp.tables, tp.tmap, tp.rtex, cfg_t)
    assert t.shape == (E, A, B) and t.dtype == torch.float32
    _bar(t, j, float(tp.rtex.cell))
    assert (t > 1.0).float().mean() > 0.5, "degenerate scans"


@pytest.mark.parametrize("opp", [False, True], ids=["ttc", "ttc_opp"])
@pytest.mark.parametrize("spatial", ["nearest1", "nearest", "bilinear"])
def test_fused_scan_matches_jax(setup, spatial, opp):
    """Edge + grad with the noise add and iTTC (and the opponent cast) in
    the epilogue kernel."""
    _, _, poses, noise, vel = setup
    (cfg_j, jp), (cfg_t, tp) = _pair(setup, dict(
        rt_spatial=spatial, rt_occlusion="edge", rt_grad=True, fuse_scan_ttc="on",
        fuse_scan_opp="on" if opp else "off"))
    jpose = jnp.asarray(poses)
    fused = (jnp.asarray(noise), jnp.asarray(vel))
    t_opp = None
    if opp:
        verts = jcol.get_vertices(jpose, jp.vehicle.length, jp.vehicle.width)
        j_opp = jnp.stack([jas.opponent_slab_scalars(jpose[e], verts[e], jp.tables)
                           for e in range(E)])
        fused += (j_opp,)
        t_opp = interop.to_tensor(np.asarray(j_opp))
    j_out, j_hit = jsf.trace_fast_mxu(jpose, jp.tables, jp.tmap, jp.rtex, cfg_j,
                                      fused_ttc=fused)
    t_out, t_hit = tsf.trace_fast_mxu(
        torch.from_numpy(poses), tp.tables, tp.tmap, tp.rtex, cfg_t,
        fused_ttc=(torch.from_numpy(noise), torch.from_numpy(vel)), opp=t_opp)
    _bar(t_out, j_out, float(tp.rtex.cell))
    np.testing.assert_array_equal(t_hit.numpy(), np.asarray(j_hit))
    assert 0 < t_hit.mean() < 1
