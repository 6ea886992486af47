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


# ---------------------------------------------------------------------------
# a numpy model of csrc/edt.cu's two passes, held bit-equal to JAX's edt
# ---------------------------------------------------------------------------

_BIG = np.float32(3.4e38)
_NONE = 2 ** 31 - 1           # INT_MAX: no zero pixel to the right
_FULL = 0xFFFFFFFF


def _clz(m):
    return 32 - int(m).bit_length()


def _ffs(m):
    return (int(m) & -int(m)).bit_length()


def _model_row_pass(zero, chunk_words=32):
    """The ballot row pass: each row in chunks of ``chunk_words`` words of 32
    pixels (32 in the kernel: a word a lane); a word's last and first zero by
    __clz / __ffs, the nearest zero in the words before and after by a max
    and a min scan over the chunk's words, a carry from the chunks before
    and a look-ahead to the first zero after the chunk; then each pixel's L
    and R inside its word from the word masked to bits <= b and >= b."""
    h, w = zero.shape
    chunk = 32 * chunk_words
    d1 = np.empty((h, w), np.float32)
    for r in range(h):
        row = zero[r]

        def words(base):
            out = []
            for j in range(chunk_words):     # pass j's ballot: lane j's word
                x = base + 32 * j + np.arange(32)
                bits = (x < w) & row[np.minimum(x, w - 1)]
                out.append(int(np.sum(bits.astype(np.int64) << np.arange(32))))
            return out

        left, ahead = -1, -1
        for base in range(0, w, chunk):
            end = base + chunk
            if ahead < end:
                ahead = _NONE
                b = end
                while b < w and ahead == _NONE:
                    ahead = min(b + 32 * j + _ffs(m) - 1 if m else _NONE
                                for j, m in enumerate(words(b)))
                    b += chunk
            ms = words(base)
            lo = np.maximum.accumulate([base + 32 * j + 31 - _clz(m) if m else -1
                                        for j, m in enumerate(ms)])
            hi = np.minimum.accumulate([base + 32 * j + _ffs(m) - 1 if m else _NONE
                                        for j, m in enumerate(ms)][::-1])[::-1]
            before = [left] + [max(left, int(v)) for v in lo[:-1]]
            after = [min(ahead, int(v)) for v in hi[1:]] + [ahead]
            left = max(left, int(lo[-1]))
            for j, m in enumerate(ms):
                p = base + 32 * j
                for lane in range(min(32, w - p)):
                    x = p + lane
                    below = m & (_FULL >> (31 - lane))
                    above = m & (_FULL << lane) & _FULL
                    lz = p + 31 - _clz(below) if below else before[j]
                    rz = p + _ffs(above) - 1 if above else after[j]
                    best = _BIG
                    if lz >= 0:
                        best = np.float32(x - lz) * np.float32(x - lz)
                    if rz != _NONE:
                        best = min(best, np.float32(rz - x) * np.float32(rz - x))
                    d1[r, x] = best
    return d1


def _square(k):
    return np.float32(k) * np.float32(k)


def _model_col_pass(d1, rows=16, lanes=32, step=8, stop_square=_square):
    """The column pass's exact search: a lane owns ``rows`` consecutive
    output rows of one column, ``lanes`` adjacent columns make a warp (the
    kernel: 16 and 32; 1 and 1 is the rule a pixel alone).  From the tile's
    own rows it folds in the rows k .. k + step - 1 above and below the
    tile, for k = 1, 1 + step, ..., while some lane of the warp finds
    stop_square(k) (k^2) below its largest best, or until both ends of the
    column are reached; a side with no row left is not folded."""
    h, w = d1.shape
    nt, ng = -(-h // rows), -(-w // lanes)
    r0 = np.arange(nt) * rows
    i = np.arange(rows)
    n = np.minimum(rows, h - r0)
    best = np.where((i[None, :] < n[:, None])[..., None], _BIG, np.float32(0))
    best = np.broadcast_to(best, (nt, rows, w)).astype(np.float32)
    for j in range(rows):
        v = d1[np.minimum(r0 + j, h - 1)][:, None, :]
        cand = v + np.float32(1) * ((i - j) ** 2).astype(np.float32)[None, :, None]
        best = np.where((j < n)[:, None, None], np.minimum(best, cand), best)
    lane_col = np.minimum(np.arange(ng * lanes), w - 1)    # lanes past the edge repeat it
    live = np.ones((nt, ng), bool)
    for k in range(1, h + 1, step):
        has_up, has_dn = k <= r0, r0 + rows - 1 + k < h
        worst = best.max(axis=1)[:, lane_col].reshape(nt, ng, lanes)
        live &= (has_up | has_dn)[:, None] & (stop_square(k) < worst).any(axis=-1)
        if not live.any():
            break
        on = np.repeat(live, lanes, axis=1)[:, None, :w]
        for s in range(step):
            sq = (np.float32(k + s) + i.astype(np.float32)) ** 2
            ru, rd = r0 - k - s, r0 + rows - 1 + k + s
            up = d1[np.clip(ru, 0, h - 1)][:, None, :] + sq[None, :, None]
            dn = d1[np.clip(rd, 0, h - 1)][:, None, :] + sq[::-1][None, :, None]
            best = np.where(on & (ru >= 0)[:, None, None], np.minimum(best, up), best)
            best = np.where(on & (rd < h)[:, None, None], np.minimum(best, dn), best)
    return best.reshape(nt * rows, w)[:h]


def _model_edt(img, resolution, chunk_words=32, rows=16, lanes=32, step=8,
               stop_square=_square):
    d1 = _model_row_pass(np.asarray(img) == 0, chunk_words)
    d2 = _model_col_pass(d1, rows, lanes, step, stop_square)
    return np.sqrt(d2.astype(np.float64)).astype(np.float32) * np.float32(resolution)


def _grid(name):
    """The small adversarial grids (1 = free, 0 = wall), each <= 256 a side."""
    rng = np.random.default_rng(len(name))
    if name == "border_64":
        g = np.ones((64, 64), np.float32)
        g[[0, -1], :] = 0
        g[:, [0, -1]] = 0
    elif name == "corner_97x131":
        g = np.ones((97, 131), np.float32)
        g[0, 0] = 0
    elif name == "rows_first_last":
        g = np.ones((60, 90), np.float32)
        g[[0, -1], :] = 0
    elif name == "cols_first_last":
        g = np.ones((50, 200), np.float32)
        g[:, [0, -1]] = 0
    elif name == "all_free":
        g = np.ones((40, 50), np.float32)
    else:                                              # width_1, width_7, width_33
        g = (rng.random((70, int(name.split("_")[1]))) > 0.08).astype(np.float32)
    return g


MODEL_GRIDS = ["border_64", "corner_97x131", "rows_first_last", "cols_first_last",
               "all_free", "width_1", "width_7", "width_33"]


@pytest.mark.parametrize("form", [(32, 16, 32, 8), (2, 16, 32, 8), (32, 1, 1, 1)],
                         ids=["kernel", "two_word_chunks", "a_pixel_alone"])
@pytest.mark.parametrize("name", MODEL_GRIDS)
def test_kernel_model_bit_equal_to_jax(name, form):
    """The model of csrc/edt.cu's ballot row pass and stopping column
    search, at the kernel's shape (chunks of 32 words; 16-row tiles on 32
    lanes, 8 offsets a vote), with chunks of 2 words (the carry and
    look-ahead across chunks) and at a pixel a lane alone, one offset a
    vote, bit-equal to JAX's edt."""
    img = _grid(name)
    chunk_words, rows, lanes, step = form
    got = _model_edt(img, 0.05, chunk_words, rows, lanes, step)
    want = np.asarray(jax_edt.edt(jnp.asarray(img), 0.05))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", MODEL_GRIDS)
def test_model_row_pass_equals_the_dense_row_pass(name):
    """The ballot row pass's D1 equals the dense min over each row's zeros of
    (x - y)^2 (JAX's row_pass), chunks of 32 and of 2 words."""
    zero = _grid(name) == 0
    xs = np.arange(zero.shape[1], dtype=np.float32)
    d2 = (xs[:, None] - xs[None, :]) ** 2
    want = np.where(zero[:, None, :], d2[None], _BIG).min(axis=-1)
    for chunk_words in (32, 2):
        np.testing.assert_array_equal(_model_row_pass(zero, chunk_words), want)


@pytest.mark.parametrize("rows, lanes, step", [(1, 1, 1), (8, 32, 1)],
                         ids=["a_pixel_alone", "tiles"])
def test_column_stop_one_offset_early_differs_from_jax(rows, lanes, step):
    """Mutation check: a search that stops where (k + 1)^2 >= best, and so
    skips offset k, must differ from JAX on at least one grid, a pixel a
    lane alone and in 8-row tiles on 32 lanes."""
    differ = []
    for name in MODEL_GRIDS:
        img = _grid(name)
        got = _model_edt(img, 1.0, rows=rows, lanes=lanes, step=step,
                         stop_square=lambda k: _square(k + 1))
        differ.append(not np.array_equal(got, np.asarray(jax_edt.edt(jnp.asarray(img), 1.0))))
    assert any(differ), "the early stop went unseen on every grid"
