"""The port's host viewer (``render/viewer.py``) and ``F110Env.render``.

A frame drawn by the port's Viewer from a state carried across from JAX
through ``interop`` is pixel-equal to the frame JAX's Viewer draws from
that state (Agg backend, the first frame, which has no FPS readout in its
caption); then the FPS readout from frame 2 on, ``animate`` writing a GIF
of a time-stacked batched state, pan, zoom and follow from synthesized
events, a stacked map's raster, the gymnasium facade's ``rgb_array``, and
``F110Env.render`` with its callbacks.  Mirrors tests/test_infra.py's
viewer tests.
"""

import os

import matplotlib

matplotlib.use("Agg")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from red_gym_tpu import env as jenv  # noqa: E402
from red_gym_tpu.config import SimConfig as JSimConfig  # noqa: E402
from red_gym_tpu.render.viewer import Viewer as JViewer  # noqa: E402
from red_gym_tpu_torch import assets, env as tenv, interop  # noqa: E402
from red_gym_tpu_torch.config import SimConfig as TSimConfig  # noqa: E402
from red_gym_tpu_torch.render.viewer import Viewer  # noqa: E402

TRACK = "track_0019"
CFG_KW = dict(num_agents=2, num_beams=108, dtype="float32", scan_noise_std=0.0)
ACT = np.array([[0.1, 3.0], [0.0, 2.0]], np.float32)


def _leaves(nt):
    return {k: np.asarray(v) for k, v in nt._asdict().items() if v is not None}


@pytest.fixture(scope="module")
def pair():
    """(jax cfg, params, one-env state after 20 steps; the port's cfg,
    params and (1, ...) state carried across)."""
    cfg_j = JSimConfig(**CFG_KW)
    jp = jenv.make_params(cfg_j, assets.named_map_yaml(TRACK))
    js, *_ = jenv.reset(cfg_j, jp, jnp.asarray(assets.waypoint_start_poses(TRACK, 2),
                                              jnp.float32), jax.random.PRNGKey(0))
    step = jax.jit(lambda s, a: jenv.step(cfg_j, jp, s, a))
    for _ in range(20):
        js, *_ = step(js, jnp.asarray(ACT))
    cfg_t = TSimConfig(**CFG_KW)
    tp = interop.params_from_numpy(cfg_t, _leaves(jp.vehicle), _leaves(jp.tables),
                                   _leaves(jp.tmap), None, device="cpu")
    ts = interop.state_from_numpy({k: v[None] for k, v in _leaves(js).items()},
                                  device="cpu")
    return cfg_j, jp, js, cfg_t, tp, ts


def _frame(viewer, path):
    viewer.draw(save_path=str(path))
    return plt.imread(str(path))


def test_first_frame_equals_jax(pair, tmp_path):
    cfg_j, jp, js, cfg_t, tp, ts = pair
    jv, tv = JViewer(jp, cfg_j), Viewer(tp, cfg_t)
    jv.update(js)
    tv.update(ts)
    for v in (jv, tv):
        v.draw_polyline(np.array([[0.0, 0.0], [1.0, 1.0]]))
    want, got = _frame(jv, tmp_path / "jax.png"), _frame(tv, tmp_path / "port.png")
    assert tv._caption.get_text() == jv._caption.get_text()
    assert "fps" not in tv._caption.get_text()
    jv.close()
    tv.close()
    assert got.shape == want.shape and got.shape[-1] in (3, 4)
    np.testing.assert_array_equal(got, want)
    assert os.path.getsize(tmp_path / "port.png") > 10000


def test_fps_caption_from_frame_two(pair, tmp_path):
    *_, cfg_t, tp, ts = pair
    v = Viewer(tp, cfg_t)
    v.update(ts)
    v.draw(save_path=str(tmp_path / "f.png"))
    assert v._fps is None and "fps" not in v._caption.get_text()
    v.draw(save_path=str(tmp_path / "f.png"))
    assert v._fps is not None and "fps" in v._caption.get_text()
    v.close()


def test_animate_writes_a_gif(pair, tmp_path):
    """Offline replay: the states of a port rollout stacked on a time axis,
    (T, E, ...), render to an animated GIF."""
    *_, cfg_t, tp, ts = pair
    hist, state = [], ts
    gen = torch.Generator().manual_seed(0)
    for _ in range(4):
        state, *_ = tenv.step(cfg_t, tp, state, torch.from_numpy(ACT)[None], gen)
        hist.append(state)
    stacked = tenv.EnvState(*(None if f[0] is None else torch.stack(f) for f in zip(*hist)))
    assert stacked.x.shape[:2] == (4, 1)
    v = Viewer(tp, cfg_t, follow=False)
    frames = []
    out = v.animate(stacked, str(tmp_path / "lap.gif"), fps=5,
                    callback=lambda viewer, t: frames.append(t))
    v.close()
    assert os.path.getsize(out) > 1000
    assert set(frames) == {0, 1, 2, 3}


def test_interaction_pan_zoom_follow(pair):
    """Synthesized mouse events drive the camera: scroll zooms about the
    cursor, drag pans, 'f' re-engages follow (reference rendering.py:163-227)."""
    from matplotlib.backend_bases import KeyEvent, MouseEvent

    *_, cfg_t, tp, ts = pair
    v = Viewer(tp, cfg_t, follow=True)
    v.update(ts)
    v.draw()
    xl0 = v.ax.get_xlim()
    x_pix, y_pix = v.ax.transAxes.transform((0.5, 0.5))
    ev = MouseEvent("scroll_event", v.fig.canvas, x_pix, y_pix, step=1)
    ev.button = "up"
    v.fig.canvas.callbacks.process("scroll_event", ev)
    xl1 = v.ax.get_xlim()
    assert (xl1[1] - xl1[0]) < (xl0[1] - xl0[0]), "scroll did not zoom in"
    assert v.follow is False, "a manual zoom must disengage the follow camera"
    press = MouseEvent("button_press_event", v.fig.canvas, x_pix, y_pix, button=1)
    v.fig.canvas.callbacks.process("button_press_event", press)
    move = MouseEvent("motion_notify_event", v.fig.canvas, x_pix + 30, y_pix, button=1)
    v.fig.canvas.callbacks.process("motion_notify_event", move)
    assert v.ax.get_xlim()[0] != xl1[0], "drag did not pan"
    v.fig.canvas.callbacks.process("key_press_event",
                                   KeyEvent("key_press_event", v.fig.canvas, "f"))
    assert v.follow is True
    v.draw()
    xl3 = v.ax.get_xlim()
    ego_x = float(ts.x[0, cfg_t.ego_idx, 0])
    assert abs((xl3[0] + xl3[1]) / 2 - ego_x) < 1e-5
    v.disable_interaction()
    assert v._cids == []
    v.close()


def test_stacked_maps_draw_the_chosen_map():
    tracks = assets.packaged_tracks()[:2]
    cfg = TSimConfig(**CFG_KW)
    params = tenv.make_multimap_params(cfg, tracks, device="cpu")
    v = Viewer(params, cfg, map_idx=1)
    shown = np.asarray(v.ax.images[0].get_array())
    np.testing.assert_array_equal(shown, params.tmap.occupancy[1].numpy())
    assert v._map_extent[0] == float(params.tmap.orig_x[1])
    v.close()


def test_rgb_array_and_render_callbacks():
    gymnasium = pytest.importorskip("gymnasium")
    import red_gym_tpu_torch  # noqa: F401  (registers the id)

    env = gymnasium.make("red_gym_tpu_torch/f110-v0", render_mode="rgb_array",
                         map=assets.named_map_yaml(TRACK), num_agents=2, num_beams=108,
                         device="cpu")
    seen = []
    env.unwrapped.add_render_callback(lambda viewer: seen.append(viewer))
    env.reset(options={"poses": assets.waypoint_start_poses(TRACK, 2)})
    frame = env.render()
    assert frame.ndim == 3 and frame.shape[-1] == 3 and frame.dtype == np.uint8
    assert frame.shape[0] > 100 and frame.shape[1] > 100
    assert len(seen) == 1 and isinstance(seen[0], Viewer)
    inner = env.unwrapped.env
    renderer = inner._renderer
    inner.render(mode="human_fast")
    assert inner._renderer is renderer and len(seen) == 2
    inner.update_map(assets.named_map_yaml("track_0007"))
    assert inner._renderer is None       # the map raster changed
    env.close()
