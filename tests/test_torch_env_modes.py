"""The port's env step in the unfused scan modes, as a whole, against JAX.

The same sequences as tests/test_torch_env.py (reset + 30 steps, and one
make_rollout step with auto-reset, at 160 envs x 2 agents x 270 beams on
track_0019 at texture stride 8, an all-equal bf16 noise pool), in the modes
that run the unfused scan's epilogue kernels:

- ``bilinear`` (bench.py's mode): fused noise + iTTC + opponent cast in
  the edge epilogue (kernel 4);
- ``bilinear`` with ``fuse_scan_ttc="off"``: the edge render alone
  (kernel 6), then the eager noise add, iTTC check and opponent pass;
- ``legacy`` (bench.py's mode: bilinear, occlusion off, no grad channels):
  the plain 3-tap blend (kernel 7) and the eager tail, on a 1-channel
  texture;
- ``nearest`` + snap: the eager snap epilogue and the eager tail.

JAX runs its Pallas epilogues in interpret mode (``scan_backend="pallas"``;
snap has no kernel and runs under "auto"), the port its plain twins.  Both
read one JAX-built edge + grad texture carried across by interop; the
legacy and snap modes read its column slices [R] and [R | gx gy].  Bars as
in tests/test_torch_env.py: poses within 1e-4 m, the float32 scan bar,
collisions, lap counts and done exactly equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from red_gym_tpu import env as jenv
from red_gym_tpu.config import SimConfig as JSimConfig
from red_gym_tpu_torch import assets
from red_gym_tpu_torch.config import SimConfig as TSimConfig
from red_gym_tpu_torch.ops import scan_fast
from tests.test_torch_env import CFG_KW, TRACK, _check_auto_reset_step, _check_step_sequence
from tests.test_torch_env import _setup_from
from tests.test_torch_scan_modes import _channels

BASE_KW = dict(CFG_KW, scan_megakernel="auto", fuse_scan_ttc="auto",
               fuse_scan_opp="auto", state_kernel="auto")
MODES = {
    "bilinear": dict(rt_spatial="bilinear", fuse_scan_ttc="on", fuse_scan_opp="on"),
    "bilinear_ttc_off": dict(rt_spatial="bilinear", fuse_scan_ttc="off"),
    "legacy": dict(rt_spatial="bilinear", rt_occlusion="off", rt_grad=False),
    "nearest_snap": dict(rt_spatial="nearest", rt_occlusion="snap",
                         scan_backend="auto"),
}


@pytest.fixture(scope="module")
def jax_params():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RED_GYM_TPU_TEXTURE_CACHE", "off")
        return jenv.make_params(JSimConfig(**BASE_KW), assets.named_map_yaml(TRACK))


@pytest.fixture(scope="module", params=list(MODES))
def setup(request, jax_params):
    kw = dict(BASE_KW, **MODES[request.param])
    cfg_t = TSimConfig(**kw)
    rt = _channels(np.asarray(jax_params.rtex.rt), cfg_t.rt_occlusion, cfg_t.rt_grad)
    jp = jax_params._replace(rtex=jax_params.rtex._replace(rt=jnp.asarray(rt)))
    # fixture guard: none of these modes may take the megakernel
    assert not scan_fast.use_megakernel(cfg_t)
    return _setup_from(JSimConfig(**kw), jp, cfg_t)


def test_step_sequence_matches_jax(setup):
    _check_step_sequence(setup)


def test_rollout_auto_reset_step_matches_jax(setup):
    _check_auto_reset_step(setup)
