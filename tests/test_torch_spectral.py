"""Kernel 5's plain twin, its dispatcher and its scope, against JAX.

The twin of ``spectral_kernels.theta_spectral_ttc`` (TPU kernel 5, the
spectral render with the noise add and the wall iTTC) is held against the
JAX Pallas kernel ``red_gym_tpu/ops/pallas_scan.py::theta_spectral_ttc``,
run in interpret mode on the CPU as the JAX package's own tests run it, on
identical numpy operands: the spectra that the port's prep chain
(``scan_fast.rolled_spectra`` with the real-valued roll) makes in bench.py's
``ultra`` config (spectral theta, nearest1 cells, a 1-channel JAX-built
texture of track_0019 at stride 8), for 160 envs x 2 cars near each other,
with numpy speeds and noise.  K = 320 rows span two of the JAX kernel's
256-row tiles and B = 1080 beams three 384-beam tiles; the fixture requires
iTTC hits beyond row 256 and in the last beam tile.  K = 322 (161 envs) is
no multiple of the CUDA kernel's 128-row tile either.

Bar: max |diff scan| <= 1e-4 m (float32 sums of 128 terms in another
order), hit flags exactly equal, at least one hit and one miss among moving
rows.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from red_gym_tpu import env as jenv
from red_gym_tpu.config import SimConfig as JSimConfig
from red_gym_tpu.ops import pallas_scan, scan_fast as jsf
from red_gym_tpu_torch import assets, interop
from red_gym_tpu_torch.config import SimConfig as TSimConfig
from red_gym_tpu_torch.ops import scan_fast as tsf, spectral_kernels
from tests.test_torch_blend import close_poses

E, A, B, T = 160, 2, 1080, 128
TTC = 2.0
MAX_RANGE = 30.0
TRACK = "track_0019"
ULTRA_KW = dict(num_agents=A, num_beams=B, dtype="float32", scan_mode="fast",
                rt_pose_stride=8, scan_interp="spectral", rt_grad=False,
                rt_occlusion="off", ttc_thresh=TTC)
NAMES = ("spec_r", "wsum", "vel", "smat", "noise", "cosines", "side_dist")


def _leaves(nt):
    return {k: np.asarray(v) for k, v in nt._asdict().items() if v is not None}


@pytest.fixture(scope="module")
def texture():
    """The ultra config and its JAX-built texture, carried to the port."""
    torch.set_num_threads(2)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RED_GYM_TPU_TEXTURE_CACHE", "off")
        jp = jenv.make_params(JSimConfig(**ULTRA_KW), assets.named_map_yaml(TRACK))
    cfg = TSimConfig(**ULTRA_KW)
    tp = interop.params_from_numpy(cfg, _leaves(jp.vehicle), _leaves(jp.tables),
                                   _leaves(jp.tmap), _leaves(jp.rtex), device="cpu")
    assert tp.rtex.rt.shape[1] == T, "the ultra config reads a 1-channel texture"
    return cfg, tp


def _operands(cfg, tp, e_n, seed):
    """Numpy operands of kernel 5, K = e_n * A rows."""
    rng = np.random.default_rng(seed)
    poses = torch.from_numpy(close_poses(rng, tp.rtex, tp.tmap, e_n, A).astype(np.float32))
    sp = tsf.rolled_spectra(poses, tp.tmap, tp.rtex, cfg)
    ops = dict(spec_r=sp.spec_r.reshape(e_n * A, T).numpy(),
               wsum=sp.wsum.reshape(-1).numpy(),
               vel=rng.uniform(-2, 6, e_n * A).astype(np.float32),
               smat=tp.rtex.smat.numpy(),
               noise=rng.normal(0, 0.01, (e_n, B)).astype(np.float32),
               cosines=tp.tables.beam_cosines.numpy(),
               side_dist=tp.tables.side_distances.numpy())
    assert (ops["wsum"] == 0).any() and (ops["wsum"] > 0).mean() > 0.5
    return ops


@pytest.fixture(scope="module")
def operands(texture):
    return _operands(*texture, E, 1)


@pytest.fixture(scope="module")
def operands_322(texture):
    return _operands(*texture, E + 1, 2)


def _jax(ops, noise_dtype):
    return [jnp.asarray(ops[n]).astype(jnp.bfloat16)
            if n == "noise" and noise_dtype == "bfloat16" else jnp.asarray(ops[n])
            for n in NAMES]


def _torch(ops, noise_dtype):
    return [interop.to_tensor(np.asarray(jnp.asarray(ops[n]).astype(jnp.bfloat16))
                              if n == "noise" and noise_dtype == "bfloat16" else ops[n],
                              device="cpu")
            for n in NAMES]


@pytest.mark.parametrize("noise, rows", [
    pytest.param(n, k, id=n if k == E * A else f"{n}-{k}")
    for k in (E * A, (E + 1) * A) for n in ("float32", "bfloat16")])
def test_twin_matches_jax_kernel(request, noise, rows):
    ops = request.getfixturevalue("operands" if rows == E * A else "operands_322")
    j_out, j_hit = pallas_scan.theta_spectral_ttc(*_jax(ops, noise), MAX_RANGE, TTC, A)
    t_out, t_hit = spectral_kernels.theta_spectral_ttc_reference(
        *_torch(ops, noise), MAX_RANGE, TTC, A)
    assert t_out.shape == (rows, B) and t_out.dtype == torch.float32
    assert float(np.abs(t_out.numpy() - np.asarray(j_out)).max()) <= 1e-4
    np.testing.assert_array_equal(t_hit.numpy(), np.asarray(j_hit))
    moving = ops["vel"] != 0
    assert t_hit.numpy()[moving].any() and not t_hit.numpy()[moving].all()
    # fixture guards: hits in the second row tile and in the last beam tile
    out = t_out.numpy()
    pv = ops["vel"][:, None] * ops["cosines"][None, :]
    num = out - ops["side_dist"][None, :]
    beam_hits = ((pv > 0) & (num >= 0) & (num < TTC * pv)) | (
        (pv < 0) & (num <= 0) & (num > TTC * pv))
    assert beam_hits[256:].any(), "no iTTC hits beyond the first row tile"
    assert beam_hits[:, 768:].any(), "no iTTC hits in the last beam tile"
    # masked rows read the noise alone
    empty = ops["wsum"] == 0
    np.testing.assert_array_equal(
        out[empty], np.repeat(np.asarray(_torch(ops, noise)[4]
                                         .to(torch.float32)), A, axis=0)[empty])


def test_dispatcher_on_cpu_is_the_twin(operands):
    """On CPU tensors the dispatcher returns its twin's result and counts
    no launch."""
    args = _torch(operands, "bfloat16")
    before = spectral_kernels.theta_spectral_ttc.launches
    got = spectral_kernels.theta_spectral_ttc(*args, MAX_RANGE, TTC, A)
    want = spectral_kernels.theta_spectral_ttc_reference(*args, MAX_RANGE, TTC, A)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert spectral_kernels.theta_spectral_ttc.launches == before


def test_dispatcher_rejects_bad_operands(operands):
    args = dict(zip(NAMES, _torch(operands, "float32")))
    kw = dict(max_range=MAX_RANGE, ttc_thresh=TTC, agents_per_env=A)
    fn = spectral_kernels.theta_spectral_ttc
    for key, bad, match in [
            ("noise", args["noise"][:-1], "noise"),              # one env short
            ("spec_r", args["spec_r"][:, :-1], "smat"),          # T mismatch
            ("wsum", args["wsum"][:-1], "wsum"),
            ("vel", args["vel"][:-1], "vel"),
            ("side_dist", args["side_dist"][:-1], "beam tables"),
            ("spec_r", args["spec_r"][None], r"spec_r must be \(K, T\)"),
            ("spec_r", args["spec_r"].to("meta"), "one device")]:
        with pytest.raises(ValueError, match=match):
            fn(**{**args, key: bad}, **kw)
    with pytest.raises(ValueError, match="multiple of agents_per_env"):
        fn(**args, **{**kw, "agents_per_env": 3})


def test_fused_ttc_covers_spectral():
    """Kernel 5 is in fuse_scan_ttc's scope: "auto" and "on" resolve on
    under spectral theta whatever rt_occlusion says; "off" gives the
    unfused render."""
    for kw in (dict(ULTRA_KW), dict(ULTRA_KW, rt_occlusion="edge")):
        assert tsf.use_fused_ttc(TSimConfig(**kw))
        assert tsf.use_fused_ttc(TSimConfig(**kw, fuse_scan_ttc="on")) is True
        assert tsf.use_fused_ttc(TSimConfig(**kw, fuse_scan_ttc="off")) is False
        assert not tsf.use_megakernel(TSimConfig(**kw))
    # JAX: "on" resolves on for spectral too
    assert jsf.use_fused_ttc(JSimConfig(**ULTRA_KW, scan_backend="pallas",
                                        fuse_scan_ttc="on"))


@pytest.mark.parametrize("occlusion", ["edge", "off"])
def test_fused_opp_is_off_for_spectral_as_in_jax(occlusion):
    """The spectral render kernel has no opponent form: fuse_scan_opp
    "auto" resolves off with spectral theta even though fuse_scan_ttc
    resolves on, and "on" raises ValueError, in both packages."""
    kw = dict(ULTRA_KW, rt_occlusion=occlusion, scan_backend="pallas",
              fuse_scan_ttc="on")
    assert tsf.use_fused_ttc(TSimConfig(**kw))
    assert tsf.use_fused_opp(TSimConfig(**kw)) is False
    assert jsf.use_fused_opp(JSimConfig(**kw)) is False
    for mod, cfg_cls in ((tsf, TSimConfig), (jsf, JSimConfig)):
        with pytest.raises(ValueError, match="fuse_scan_opp='on'"):
            mod.use_fused_opp(cfg_cls(**kw, fuse_scan_opp="on"))
