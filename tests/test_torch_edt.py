"""Kernel E's plain twin and the device-EDT map load against the JAX package.

``ops/edt_kernels.edt_reference`` (the twin the CUDA kernel is held
against on the card, and what ``ops/edt.edt`` runs on the CPU) must be
BIT-equal to ``red_gym_tpu.ops.edt.edt``: every squared distance is an
integer below 2^24, so any order of the minimum gives the same float32.
Against scipy: the bar of tests/test_edt.py:18, rtol 1e-6, atol 1e-5.
``load_map(edt_backend="device", device="cpu")`` must give JAX's
``load_map(edt_backend="device")`` dt exactly, with and without ``pad_to``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.ndimage import distance_transform_edt as scipy_edt

from red_gym_tpu.maps.loader import load_map as jax_load_map
from red_gym_tpu.ops import edt as jax_edt
from red_gym_tpu_torch import assets
from red_gym_tpu_torch.maps import loader
from red_gym_tpu_torch.ops import edt, edt_kernels


def _both(img, resolution=1.0):
    got = edt.edt(torch.as_tensor(img), resolution)
    want = np.asarray(jax_edt.edt(jnp.asarray(img), resolution))
    return got.numpy(), want


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("shape", [(64, 64), (63, 41), (128, 96)])
def test_twin_bit_equal_to_jax_on_random_grids(seed, shape):
    rng = np.random.default_rng(seed)
    img = (rng.random(shape) > 0.05).astype(np.float32)   # sparse walls
    got, want = _both(img, 0.0625)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got, scipy_edt(img) * 0.0625, rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("shape", [(3, 64), (64, 3), (2, 2), (5, 7)])
def test_twin_on_tiny_grids(shape):
    rng = np.random.default_rng(7)
    img = (rng.random(shape) > 0.3).astype(np.float32)
    img.flat[0] = 0.0                      # at least one wall
    got, want = _both(img)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got, scipy_edt(img), rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("fill", [1.0, 0.0])
def test_degenerate_grids_match_jax(fill):
    """All free: JAX's sentinel 3.4e38 survives the column pass, so every
    pixel reads sqrt(3.4e38) * resolution, not inf.  All occupied: 0."""
    img = np.full((9, 11), fill, np.float32)
    got, want = _both(img, 0.5)
    np.testing.assert_array_equal(got, want)
    assert np.isfinite(got).all()


@pytest.mark.parametrize("chunk", [1, 5, 8, 64])
def test_twin_chunk_does_not_change_the_result(chunk):
    rng = np.random.default_rng(4)
    img = torch.as_tensor((rng.random((33, 21)) > 0.1).astype(np.float64))
    np.testing.assert_array_equal(edt_kernels.edt_reference(img, 0.05, chunk).numpy(),
                                  edt_kernels.edt_reference(img, 0.05).numpy())


def test_twin_bit_equal_to_jax_on_track_0019():
    occ = loader.load_map_image(assets.named_map_yaml("track_0019")[:-5] + ".png")
    got, want = _both(occ, 0.0625)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got, scipy_edt(occ) * 0.0625, rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("pad_to", [None, (900, 960)])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_load_map_device_edt_equals_jax(pad_to, dtype):
    path = assets.named_map_yaml("track_0019")
    tmap = loader.load_map(path, dtype=getattr(torch, dtype), device="cpu",
                           pad_to=pad_to, edt_backend="device")
    jmap = jax_load_map(path, dtype=getattr(jnp, dtype), pad_to=pad_to,
                        edt_backend="device")
    assert tmap.dt.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(tmap.dt.numpy(), np.asarray(jmap.dt))
    np.testing.assert_array_equal(tmap.occupancy.numpy(), np.asarray(jmap.occupancy))
    host = loader.load_map(path, device="cpu", pad_to=pad_to)
    np.testing.assert_allclose(tmap.dt.numpy(), host.dt.numpy(), rtol=1e-6, atol=1e-5)


def test_load_map_rejects_unknown_backend():
    with pytest.raises(ValueError, match="edt_backend"):
        loader.load_map(assets.named_map_yaml("track_0019"), device="cpu",
                        edt_backend="gpu")


def test_wrapper_refuses_other_shapes():
    with pytest.raises(ValueError, match="one"):
        edt.edt(torch.ones((2, 3, 4)))
