"""Exact Euclidean distance transform on the device.

PyTorch counterpart of ``red_gym_tpu/ops/edt.py``.  The map loader computes
its EDT on the host with scipy by default; ``load_map(...,
edt_backend="device")`` computes it here instead, so an occupancy grid made
on the device goes to a distance transform without a host round trip.

The exact EDT factorises into two 1-D min-plus passes:

    D1[r, x] = min over zero pixels (r, y) of (x - y)^2        (row pass)
    D2[r, c] = min over r' of D1[r', c] + (r - r')^2            (column pass)
    edt      = resolution * sqrt(D2)

On a CUDA device both passes run in kernel E (``ops/edt_kernels.py``,
``csrc/edt.cu``), on the CPU in its plain twin, JAX's dense chunked form.
Every squared distance of a map up to 2896 px a side is an integer below
2^24, so the float32 result is exact and equal to JAX's bit for bit.
"""

from __future__ import annotations

import torch

from red_gym_tpu_torch.ops import edt_kernels


def edt(occupancy, resolution: float = 1.0) -> torch.Tensor:
    """Distance from each nonzero (free) pixel to the nearest zero pixel.

    occupancy: (H, W) tensor, 0 = occupied / wall, nonzero = free (scipy's
    ``distance_transform_edt`` input semantics), on the device it is
    computed on.  Returns float32 (H, W) in units of ``resolution``; a grid
    with no zero pixel reads sqrt(3.4e38) * resolution everywhere, as in
    JAX."""
    return edt_kernels.edt_transform(torch.as_tensor(occupancy), resolution)
