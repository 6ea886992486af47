"""The port's rasterizer (``red_gym_tpu_torch/ops/rasterize.py``) against the
JAX package's on the same numpy scans, on the CPU, where the fill and the
segment draw run their plain twins (``ops/raster_kernels.py``).

Bars: bitmaps equal pixel for pixel in every draw mode, both background
colours, 1, 3 and 4 channels, with and without the centre marker, on fuzzed
scans (zero ranges, the max range, beams whose endpoints leave the canvas);
``beam_endpoints`` equal in float32 and float64; ``scans_to_legacy_tensors``
equal; the chunked fill twin equal to the formula in one chunk; JAX and the
twin draw a segment whose endpoints are one pixel as that pixel.
"""

import itertools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from red_gym_tpu.ops import rasterize as jr
from red_gym_tpu_torch.ops import raster_kernels as rk
from red_gym_tpu_torch.ops import rasterize as tr


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _scans(n, beams=108, seed=0, dtype=np.float32):
    """Fuzzed scans: uniform ranges, some beams 0, some at 30 m (off a
    64-px canvas at 10 px/m), and one all-zero scan."""
    rng = np.random.default_rng(seed)
    s = rng.uniform(0.0, 8.0, (n, beams))
    s[rng.random((n, beams)) < 0.05] = 0.0
    s[rng.random((n, beams)) < 0.05] = 30.0
    s[0] = 0.0
    return s.astype(dtype)


def _jax_bitmaps(scans, **kw):
    """JAX's lidar_to_bitmap draws one scan; vmapped over the batch, as the
    JAX planning env runs it."""
    return np.asarray(jax.vmap(lambda s: jr.lidar_to_bitmap(s, **kw))(jnp.asarray(scans)))


@pytest.fixture(scope="module")
def small_scans():
    return _scans(4)


MODES = ("FILL", "POLYGON", "RAYS")


@pytest.mark.parametrize("mode,bg,channels,center",
                         list(itertools.product(MODES, ("black", "white"), (1, 3, 4),
                                                (True, False))))
def test_bitmap_equals_jax(small_scans, mode, bg, channels, center):
    kw = dict(bg_color=bg, draw_mode=mode, channels=channels, draw_center=center,
              output_image_dims=(64, 64), target_beam_count=108)
    want = _jax_bitmaps(small_scans, **kw)
    got = tr.lidar_to_bitmap(torch.from_numpy(small_scans), **kw)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("mode", MODES)
def test_full_size_bitmap_equals_jax(mode):
    """One 256 x 256 image of a 1080-beam scan, 600 beams drawn, the
    defaults (and a max_scan_radius scale, a CW winding on RAYS)."""
    scan = _scans(2, beams=1080, seed=3)[1:] * 1.5
    kw = dict(draw_mode=mode)
    if mode == "RAYS":
        kw.update(max_scan_radius=12.0, winding_dir="CW")
    want = _jax_bitmaps(scan, **kw)
    got = tr.lidar_to_bitmap(torch.from_numpy(scan), **kw)
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < int((got == 0).sum()) < got.numel()


def test_batched_leading_dims():
    scans = _scans(6, seed=1).reshape(2, 3, 108)
    kw = dict(output_image_dims=(64, 64), target_beam_count=108)
    got = tr.lidar_to_bitmap(torch.from_numpy(scans), **kw)
    assert got.shape == (2, 3, 64, 64)
    flat = tr.lidar_to_bitmap(torch.from_numpy(scans.reshape(6, 108)), **kw)
    assert torch.equal(got.reshape(6, 64, 64), flat)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_beam_endpoints_equal_jax(dtype):
    scans = _scans(8, beams=1080, seed=2, dtype=dtype)
    for sf, start in ((10.0, -math.pi / 2), (256 / 11.3, 0.3)):
        want = np.asarray(jr.beam_endpoints(jnp.asarray(scans), 600, (256, 256), sf,
                                            starting_angle=start))
        got = tr.beam_endpoints(torch.from_numpy(scans), 600, (256, 256), sf,
                                starting_angle=start)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


def test_scans_to_legacy_tensors_equal_jax():
    scans = np.random.default_rng(4).uniform(0.0, 35.0, (5, 1080))
    np.testing.assert_array_equal(tr.scans_to_legacy_tensors(scans),
                                  jr.scans_to_legacy_tensors(scans))


def test_segment_table_equals_jnp_linspace():
    want = np.asarray(jnp.linspace(0.0, 1.0, rk.SEGMENT_SAMPLES, dtype=jnp.float32))
    np.testing.assert_array_equal(rk.segment_t(torch.device("cpu")).numpy(), want)


def test_chunked_fill_twin_equals_one_chunk():
    scans = torch.from_numpy(_scans(5, seed=5))
    pts = tr.beam_endpoints(scans, 108, (64, 64), 10.0)
    whole = rk.fill_polygon_reference(pts, (64, 64), max_elems=1 << 40)
    for elems in (1, 64 * 108 * 3, 64 * 108 * 64 * 2):
        assert torch.equal(rk.fill_polygon_reference(pts, (64, 64), max_elems=elems), whole)
    assert 0 < int(whole.sum()) < whole.numel()


@pytest.mark.parametrize("dims", [(64, 64), (48, 80)])
def test_one_pixel_segments_draw_their_pixel(dims):
    """JAX's ``_draw_segments`` and the twin draw one-pixel segments as their
    pixel clipped to the canvas, inside the canvas and far off it."""
    h, w = dims
    m = 4096
    rng = np.random.default_rng(h)
    pts = np.concatenate([rng.integers(-8, max(h, w) + 8, (40, 2)),
                          rng.integers(-m, m + 1, (20, 2)),
                          np.array([[-m, -m], [m, m], [-m, m], [0, 0], [w - 1, h - 1]])])
    pts = pts.astype(np.int32)
    want = np.zeros((h, w), dtype=bool)
    want[np.clip(pts[:, 1], 0, h - 1), np.clip(pts[:, 0], 0, w - 1)] = True
    got_jax = np.asarray(jr._draw_segments(jnp.asarray(pts), jnp.asarray(pts), dims))
    np.testing.assert_array_equal(got_jax, want)
    p = torch.from_numpy(pts)[None]
    got = rk.draw_segments_reference(torch.zeros((1, h, w), dtype=torch.uint8), p, p.clone(),
                                     rk.segment_t(torch.device("cpu")))
    np.testing.assert_array_equal(got[0].numpy().astype(bool), want)


def test_wrappers_refuse_wrong_inputs():
    pts = torch.zeros((1, 4, 2), dtype=torch.int64)
    with pytest.raises(ValueError, match="int32"):
        rk.fill_polygon(pts, (8, 8))
    mask = torch.zeros((1, 8, 8), dtype=torch.uint8)
    ok = torch.zeros((1, 4, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="images of the mask"):
        rk.draw_segments(mask, ok, torch.zeros((2, 4, 2), dtype=torch.int32),
                         rk.segment_t(torch.device("cpu")))
