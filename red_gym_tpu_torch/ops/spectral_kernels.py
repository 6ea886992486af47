"""The spectral fast scan's render kernel: rolled spectrum -> noisy scan + iTTC.

Replaces the TPU kernel ``red_gym_tpu/ops/pallas_scan.py::theta_spectral_ttc``
(``_spec_ttc_kernel``, kernel 5 of the TPU kernel table), the fused consumer
of ``scan_interp="spectral"``: per row k (one car) and beam b,

    out[k, b] = clip(where(wsum[k] > 0, (spec_r @ smat)[k, b], 0), 0, max_range)

with the phase-rolled packed spectrum ``spec_r`` (K, T) of
``scan_fast.rolled_spectra`` and the windowed trig evaluation matrix
``smat`` (T, B); then the env's noise row is added (row k belongs to env
k // agents_per_env of the (E, B) slab) and the wall-iTTC test runs on the
noisy scan (the tail of ``scan_kernels.noise_ttc_reference``).

The CUDA C++ source is ``red_gym_tpu_torch/csrc/theta_spectral.cu`` (one
kernel, one C entry point; the noise + iTTC tail is in
``csrc/scan_tail.cuh``).  :func:`theta_spectral_ttc` has the JAX
signature: on CUDA tensors it launches the kernel or raises (a build, check
or launch failure is an error, never a fallback), on CPU tensors it runs
its plain twin :func:`theta_spectral_ttc_reference`, and
``theta_spectral_ttc.launches`` counts kernel launches.

What bounds it on an H100: at K = 32768 rows and B = 1080 beams the product
is 9.06 GFLOP (2 x K x 128 x B), 0.135 ms at the published 67 TFLOP/s of
float32 outside the tensor cores; its bytes are the 16.8 MB of spectra,
the 35.4 MB bf16 (E, B) noise slab and the 141.6 MB (K, B) scan written
once, about 195 MB or 0.058 ms at 3.35 TB/s.  So float32 FMAs bound it, and
the product must stay out of TF32.  The design is the register-tiled
mainloop of ``csrc/rowtile_gemm.cuh``, shared with kernel 7: a block of 256
threads owns 128 rows and all beams, keeps the rows' spectra in shared
memory and streams smat through a 3-stage cp.async ring, 16 lanes a chunk;
each thread holds 8 rows x 8 beams of accumulators (two float4 of spectra
and two of smat feed 64 FMAs a lane), summed in lane order, and the noise,
iTTC and store tail runs on those registers.  Two blocks a SM (127
registers a thread); the grid is persistent.  The work is one plain
product, so ``torch.matmul(spec_r, smat)`` (cuBLAS) is its yardstick
(PERF.md has both times).  Tensor cores would change the rounding of every
beam (ROADMAP D).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from red_gym_tpu_torch.ops import _build
from red_gym_tpu_torch.ops.scan_kernels import noise_ttc_reference

T_BINS = 128   # the CUDA kernel's theta-bin count (compile-time constant)


def spectral_render(spec_r, wsum, smat, max_range: float):
    """The spectral render: spec_r (K, T) @ smat (T, B), masked where
    wsum (K,) is 0, clipped to [0, max_range] -> (K, B).  The unfused
    spectral scan runs this as it stands (the JAX package leaves it to
    XLA); kernel 5 fuses it with the tail."""
    out = torch.matmul(spec_r, smat)
    out = torch.where(wsum[:, None] > 0.0, out, torch.zeros_like(out))
    return torch.clamp(out, 0.0, max_range)


def theta_spectral_ttc_reference(spec_r, wsum, vel, smat, noise, cosines,
                                 side_dist, max_range: float,
                                 ttc_thresh: float, agents_per_env: int):
    """Plain twin of kernel 5 (the TPU ``_spec_ttc_kernel``): the render of
    :func:`spectral_render`, then row k gets noise row k // agents_per_env
    of the (E, B) slab, then the iTTC test against vel (K,).  -> (noisy
    scan (K, B), hit (K,) 0/1, before the ``vel != 0`` mask)."""
    out = spectral_render(spec_r, wsum, smat, max_range)
    return noise_ttc_reference(out, noise, vel[:, None].to(out.dtype), cosines,
                               side_dist, ttc_thresh, agents_per_env)


def _check(spec_r, wsum, vel, smat, noise, cosines, side_dist,
           agents_per_env: int) -> None:
    """Shapes and devices every caller must meet."""
    if spec_r.dim() != 2:
        raise ValueError(f"spec_r must be (K, T), got {tuple(spec_r.shape)}")
    k_n, t_bins = spec_r.shape
    if smat.dim() != 2 or smat.shape[0] != t_bins:
        raise ValueError(f"smat must be (T, B) = ({t_bins}, B), got "
                         f"{tuple(smat.shape)}")
    b_n = smat.shape[1]
    for name, v in (("wsum", wsum), ("vel", vel)):
        if v.shape != (k_n,):
            raise ValueError(f"{name} must be (K,) = ({k_n},), got {tuple(v.shape)}")
    for name, v in (("cosines", cosines), ("side_dist", side_dist)):
        if v.shape != (b_n,):
            raise ValueError(f"beam tables must be (B,) = ({b_n},), got "
                             f"{name} {tuple(v.shape)}")
    if agents_per_env < 1 or k_n % agents_per_env:
        raise ValueError(f"K = {k_n} rows must be a multiple of "
                         f"agents_per_env = {agents_per_env}")
    if noise.shape != (k_n // agents_per_env, b_n):
        raise ValueError(f"noise must be (K / agents_per_env, B) = "
                         f"({k_n} / {agents_per_env}, {b_n}), got "
                         f"{tuple(noise.shape)}")
    devices = {v.device for v in (spec_r, wsum, vel, smat, noise, cosines,
                                  side_dist)}
    if len(devices) != 1:
        raise ValueError(f"all operands must be on one device, got {devices}")
    if spec_r.device.type not in ("cpu", "cuda"):
        raise ValueError(f"theta_spectral_ttc runs on cuda or cpu, not "
                         f"{spec_r.device}")


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("theta_spectral")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.theta_spectral_launch.argtypes = [p, p, p, p, p, i, p, p, p, p, i, i, i,
                                          f, f, p]
    lib.theta_spectral_launch.restype = ctypes.c_int
    return lib


def theta_spectral_ttc(spec_r, wsum, vel, smat, noise, cosines, side_dist,
                       max_range: float, ttc_thresh: float,
                       agents_per_env: int):
    """Kernel 5 on a CUDA device, its plain twin on the CPU (same arguments
    and result as :func:`theta_spectral_ttc_reference`).  Callers apply the
    ``vel != 0`` mask to the hits."""
    _check(spec_r, wsum, vel, smat, noise, cosines, side_dist, agents_per_env)
    if spec_r.device.type == "cpu":
        return theta_spectral_ttc_reference(spec_r, wsum, vel, smat, noise,
                                            cosines, side_dist, max_range,
                                            ttc_thresh, agents_per_env)
    k_n, t_bins = spec_r.shape
    b_n = smat.shape[1]
    if t_bins != T_BINS:
        raise ValueError(f"the CUDA kernel takes rt_theta_bins={T_BINS}, got {t_bins}")
    if noise.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"noise must be bfloat16 or float32, got {noise.dtype}")
    for name, v in (("spec_r", spec_r), ("wsum", wsum), ("vel", vel),
                    ("smat", smat), ("cosines", cosines),
                    ("side_dist", side_dist)):
        if v.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 on CUDA, got {v.dtype}")
    spec_r, wsum, vel, smat, noise, cosines, side_dist = (
        v.contiguous() for v in (spec_r, wsum, vel, smat, noise, cosines, side_dist))
    out = torch.empty((k_n, b_n), dtype=torch.float32, device=spec_r.device)
    hit = torch.empty((k_n,), dtype=torch.float32, device=spec_r.device)
    if k_n == 0:
        return out, hit
    err = _lib().theta_spectral_launch(
        spec_r.data_ptr(), wsum.data_ptr(), vel.data_ptr(), smat.data_ptr(),
        noise.data_ptr(), int(noise.dtype == torch.bfloat16), cosines.data_ptr(),
        side_dist.data_ptr(), out.data_ptr(), hit.data_ptr(), k_n, b_n,
        agents_per_env, float(max_range), float(ttc_thresh),
        torch.cuda.current_stream(spec_r.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"theta_spectral kernel launch failed: CUDA error {err}")
    theta_spectral_ttc.launches += 1
    return out, hit


theta_spectral_ttc.launches = 0
