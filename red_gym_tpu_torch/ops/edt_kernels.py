"""The exact Euclidean distance transform as a CUDA kernel (kernel E).

Replaces no TPU kernel: the JAX package's device EDT is two dense min-plus
passes that XLA fuses (``red_gym_tpu/ops/edt.py:34-75``).  Here the two
passes are the two launches of ``red_gym_tpu_torch/csrc/edt.cu``: a row pass
that finds each pixel's nearest zero pixel to its left and right (a warp a
row, the row's zero pixels made 32-bit words by ``__ballot_sync``), and a
column pass whose search stops once no unread row can lower a pixel's
minimum (a lane 16 output rows of a column, a warp 32 adjacent columns, 8
row offsets a step).

:func:`edt_transform` launches the kernel on a CUDA tensor, or raises;
on a CPU tensor it runs the plain twin :func:`edt_reference`, JAX's chunked
dense form.  ``edt_transform.launches`` counts kernel calls (one a
transform, for its two launches).  Every squared distance of a map up to
2896 px a side is an integer below 2^24, so kernel, twin and JAX agree bit
for bit.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from red_gym_tpu_torch.ops import _build

BIG = 3.4e38   # JAX's sentinel for a row with no zero pixel (edt.py:31)


def _zero_mask(occupancy) -> torch.Tensor:
    if occupancy.dim() != 2:
        raise ValueError(f"the EDT takes one (H, W) grid, got {tuple(occupancy.shape)}")
    return occupancy == 0


def _chunked(fn, arr, chunk: int):
    """``fn`` over leading-axis chunks of ``chunk`` rows, the remainder padded
    by wrapping as JAX's ``_chunked`` pads it (the padding is cut off)."""
    n = arr.shape[0]
    pad = (-n) % chunk
    if pad:
        idx = torch.arange(n + pad, device=arr.device) % n
        arr = arr[idx]
    out = torch.cat([fn(arr[i:i + chunk]) for i in range(0, arr.shape[0], chunk)])
    return out[:n]


def edt_reference(occupancy, resolution: float = 1.0, chunk: int = 8):
    """Plain twin of the kernel, JAX's dense form (``ops/edt.py``): the row
    pass as a masked (C, W, W) broadcast and min, the column pass as a
    (C, H, H) broadcast add and min, ``chunk`` rows or columns at a time,
    then the correctly rounded root times float32(resolution).
    occupancy (H, W), nonzero = free -> float32 (H, W) metres."""
    zero = _zero_mask(occupancy)
    h, w = zero.shape
    dev = zero.device
    xs = torch.arange(w, dtype=torch.float32, device=dev)
    rs = torch.arange(h, dtype=torch.float32, device=dev)
    big = torch.tensor(BIG, dtype=torch.float32, device=dev)
    d2_row = (xs[:, None] - xs[None, :]) ** 2                    # (W, W)
    dr2 = (rs[:, None] - rs[None, :]) ** 2                       # (H, H)

    def row_pass(rows):                                          # (C, W) bool
        return torch.where(rows[:, None, :], d2_row[None], big).amin(dim=-1)

    def col_pass(cols):                                          # (C, H)
        return (cols[:, None, :] + dr2[None]).amin(dim=-1)

    d1 = _chunked(row_pass, zero, chunk)
    d2 = _chunked(col_pass, d1.T.contiguous(), chunk).T
    res = torch.tensor(resolution, dtype=torch.float32, device=dev)
    # correctly rounded float32 sqrt, as XLA's and the kernel's: the float64
    # root rounded to float32 is (torch's vectorised float32 sqrt on the CPU
    # is off by an ulp for some integers)
    return torch.sqrt(d2.to(torch.float64)).to(torch.float32) * res


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("edt")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.edt_launch.argtypes = [p, i, i, ctypes.c_float, p, p, p]
    lib.edt_launch.restype = ctypes.c_int
    return lib


def edt_transform(occupancy, resolution: float = 1.0):
    """The EDT kernel on a CUDA tensor, its twin (:func:`edt_reference`)
    on a CPU one: distance from each nonzero (free) pixel of ``occupancy``
    (H, W) to the nearest zero pixel, times ``resolution``, float32."""
    if occupancy.device.type == "cpu":
        return edt_reference(occupancy, resolution)
    if occupancy.device.type != "cuda":
        raise ValueError(f"the EDT runs on cuda or cpu, not {occupancy.device}")
    zero = _zero_mask(occupancy).to(torch.uint8).contiguous()
    h, w = zero.shape
    d1 = torch.empty((h, w), dtype=torch.float32, device=zero.device)
    out = torch.empty((h, w), dtype=torch.float32, device=zero.device)
    if zero.numel() == 0:
        return out
    err = _lib().edt_launch(zero.data_ptr(), h, w, float(resolution), d1.data_ptr(),
                            out.data_ptr(),
                            torch._C._cuda_getCurrentRawStream(zero.device.index))
    if err != 0:
        raise RuntimeError(f"edt kernel launch failed: CUDA error {err}")
    edt_transform.launches += 1
    return out


edt_transform.launches = 0


def reset_launches() -> None:
    edt_transform.launches = 0
