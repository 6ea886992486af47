"""The unfused fast scan's epilogue kernels: rolled spectra -> scan.

Replace four TPU kernels of ``red_gym_tpu/ops/pallas_scan.py``, the
epilogues of the linear-theta scan without the megakernel
(``scan_fast.trace_fast_mxu``, unfused branch):

- ``theta_shuffle_blend`` (kernel 7, ``_kernel``): occlusion "off", the
  plain 3-tap theta blend;
- ``theta_shuffle_blend_edge`` (kernel 6, ``_edge_kernel``): the edge-ramp
  render;
- ``theta_shuffle_blend_edge_ttc`` (kernel 3, ``_edge_ttc_kernel``): the
  edge render, then the per-env noise add and the wall-iTTC test;
- ``theta_shuffle_blend_edge_ttc_opp`` (kernel 4, ``_edge_ttc_opp_kernel``):
  kernel 3, then the opponent slab ray cast inside each blocked window.

The CUDA C++ source is ``red_gym_tpu_torch/csrc/theta_blend.cu`` (one
kernel template, one C entry point; the noise + iTTC tail and the opponent
cast are in ``csrc/scan_tail.cuh``).  Each function here has the JAX
signature, with the beam count taken from ``c_frac``: on CUDA tensors it
launches the kernel or raises (a build, check or launch failure is an
error, never a fallback), on CPU tensors it runs its plain twin
(``*_reference``), and ``<function>.launches`` counts kernel launches.

The twins follow the TPU kernels' formulas
(``scan_kernels.edge_render_reference``, ``noise_ttc_reference``,
``opp_cast_reference``): the e/w taps round their inputs to ``ew_dtype``
and sum in float32, and the tap outputs are not rounded.

What bounds them on an H100: at K = 32768 rows and B = 1080 beams the edge
kernels do seven (T x B) tap products per row, 63.4 GFLOP (7 x K x 128 x B
x 2), about 0.95 ms at the published 67 TFLOP/s of float32 outside the
tensor cores; kernel 7 does three, 27.2 GFLOP.  Their bytes are 50 MB of
spectra in, the 142 MB (K, B) scan out and, for 3 and 4, the 35 MB bf16
(E, B) noise slab: about 70 us at 3.35 TB/s.  So they are bound by float32
FMAs, and the taps must stay out of TF32.  The design: one block of 256
threads per 8 rows stages the rows' spectra (1 or 3 x 128 floats each,
e/w rounded to bf16 there when ``ew_dtype`` is bfloat16) in shared memory;
each thread owns beams b, b + 256, ... and sweeps the 128 spectral lanes
four at a time, so one float4 shared-memory broadcast feeds four FMAs and
each gmat column read from L2 (1.66 MB, resident) serves 8 rows.  Two
blocks per SM are pinned (``__launch_bounds__``, 128 registers a thread).
No tensor cores, no TMA: that is for later work.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from red_gym_tpu_torch.ops import _build
from red_gym_tpu_torch.ops.scan_kernels import (OPP_PACK, edge_render_reference,
                                                noise_ttc_reference,
                                                opp_cast_reference)

T_BINS = 128   # the CUDA kernel's theta-bin count (compile-time constant)
_TAIL = {"none": 0, "ttc": 1, "ttc_opp": 2}


def theta_shuffle_blend_reference(spec_r, f_s, wsum, gmat, c_frac,
                                  max_range: float):
    """Plain twin of kernel 7 (the TPU ``_kernel``): g_t = spec_r @ gmat
    block t, weights from alpha = f_s + c_frac (w0 = max(1 - alpha, 0),
    w2 = max(alpha - 1, 0), w1 = 1 - w0 - w2), mask, clip.
    spec_r (K, T), f_s and wsum (K,), gmat (T, 3B), c_frac (B,) -> (K, B)."""
    b_n = c_frac.shape[0]
    g0, g1, g2 = (spec_r @ gmat[:, t * b_n:(t + 1) * b_n] for t in range(3))
    alpha = f_s[:, None] + c_frac[None, :]
    w0 = torch.clamp(1.0 - alpha, min=0.0)
    w2 = torch.clamp(alpha - 1.0, min=0.0)
    w1 = 1.0 - w0 - w2
    out = w0 * g0 + w1 * g1 + w2 * g2
    out = torch.where(wsum[:, None] > 0.0, out, torch.zeros_like(out))
    return torch.clamp(out, 0.0, max_range)


def theta_shuffle_blend_edge_reference(spec_r, spec_e, spec_w, f_s, wsum,
                                       gmat, c_frac, max_range: float,
                                       ew_dtype=torch.bfloat16):
    """Plain twin of kernel 6 (the TPU ``_edge_kernel``): the edge-ramp
    render of ``scan_kernels.edge_render_reference``.
    spec_r/spec_e/spec_w (K, T), f_s and wsum (K,) -> (K, B)."""
    return edge_render_reference(spec_r, spec_e, spec_w, f_s[:, None],
                                 wsum[:, None], gmat, c_frac, max_range,
                                 ew_dtype)


def theta_shuffle_blend_edge_ttc_reference(
        spec_r, spec_e, spec_w, f_s, wsum, vel, gmat, c_frac, noise, cosines,
        side_dist, max_range: float, ttc_thresh: float, agents_per_env: int,
        ew_dtype=torch.bfloat16):
    """Plain twin of kernel 3 (the TPU ``_edge_ttc_kernel``): kernel 6, then
    row k gets noise row k // agents_per_env of the (E, B) slab, then the
    iTTC test against vel (K,).  -> (noisy scan (K, B), hit (K,) 0/1,
    before the ``vel != 0`` mask)."""
    out = theta_shuffle_blend_edge_reference(spec_r, spec_e, spec_w, f_s, wsum,
                                             gmat, c_frac, max_range, ew_dtype)
    return noise_ttc_reference(out, noise, vel[:, None].to(out.dtype), cosines,
                               side_dist, ttc_thresh, agents_per_env)


def theta_shuffle_blend_edge_ttc_opp_reference(
        spec_r, spec_e, spec_w, f_s, wsum, vel, gmat, c_frac, noise, cosines,
        sines, side_dist, opp, max_range: float, ttc_thresh: float,
        agents_per_env: int, ew_dtype=torch.bfloat16):
    """Plain twin of kernel 4 (the TPU ``_edge_ttc_opp_kernel``): kernel 3,
    then each opponent of opp (K, 10 * n_opp) shortens the beams inside its
    window [lo, hi] (absolute beam indices).  The hits are the
    pre-opponent scan's."""
    out, hit = theta_shuffle_blend_edge_ttc_reference(
        spec_r, spec_e, spec_w, f_s, wsum, vel, gmat, c_frac, noise, cosines,
        side_dist, max_range, ttc_thresh, agents_per_env, ew_dtype)
    return opp_cast_reference(out, opp.to(out.dtype), cosines, sines), hit


def _check(specs, f_s, wsum, gmat, c_frac, vel=None, noise=None, beams=(),
           opp=None, agents_per_env=1):
    """Shapes and devices every caller must meet."""
    k_n, t_bins = specs[0].shape if specs[0].dim() == 2 else (-1, -1)
    b_n = c_frac.shape[0]
    for s in specs:
        if s.dim() != 2 or s.shape != (k_n, t_bins):
            raise ValueError(f"spectra must be (K, T) alike, got "
                             f"{[tuple(v.shape) for v in specs]}")
    for name, v in (("f_s", f_s), ("wsum", wsum), ("vel", vel)):
        if v is not None and v.shape != (k_n,):
            raise ValueError(f"{name} must be (K,) = ({k_n},), got {tuple(v.shape)}")
    if c_frac.dim() != 1 or gmat.shape != (t_bins, 3 * b_n):
        raise ValueError(f"gmat must be (T, 3B) and c_frac (B,), got "
                         f"{tuple(gmat.shape)} and {tuple(c_frac.shape)}")
    for v in beams:
        if v.shape != (b_n,):
            raise ValueError(f"beam tables must be (B,) = ({b_n},), got "
                             f"{tuple(v.shape)}")
    if noise is not None:
        if agents_per_env < 1 or k_n % agents_per_env:
            raise ValueError(f"K = {k_n} rows must be a multiple of "
                             f"agents_per_env = {agents_per_env}")
        if noise.shape != (k_n // agents_per_env, b_n):
            raise ValueError(f"noise must be (K / agents_per_env, B) = "
                             f"({k_n} / {agents_per_env}, {b_n}), got "
                             f"{tuple(noise.shape)}")
    if opp is not None and (opp.dim() != 2 or opp.shape[0] != k_n
                            or opp.shape[1] < OPP_PACK or opp.shape[1] % OPP_PACK):
        raise ValueError(f"opp must be (K, 10 * n_opp), got {tuple(opp.shape)}")
    ops = [*specs, f_s, wsum, gmat, c_frac, *beams]
    ops += [v for v in (vel, noise, opp) if v is not None]
    devices = {v.device for v in ops}
    if len(devices) != 1:
        raise ValueError(f"all operands must be on one device, got {devices}")
    device = specs[0].device
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"the epilogue kernels run on cuda or cpu, not {device}")


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("theta_blend")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.theta_blend_launch.argtypes = [
        p, p, p, i, p, p, p, p, p, p, i, p, p, p, p, i, p, p, i, i, i, f, f,
        i, i, i, p]
    lib.theta_blend_launch.restype = ctypes.c_int
    return lib


def _launch(tail: str, specs, f_s, wsum, gmat, c_frac, max_range: float,
            ew_dtype=torch.float32, vel=None, noise=None, cosines=None,
            sines=None, side_dist=None, opp=None, ttc_thresh: float = 0.0,
            agents_per_env: int = 1):
    """Launch the CUDA kernel on checked CUDA operands -> (out, hit or None)."""
    k_n, t_bins = specs[0].shape
    b_n = c_frac.shape[0]
    device = specs[0].device
    if t_bins != T_BINS:
        raise ValueError(f"the CUDA kernel takes rt_theta_bins={T_BINS}, got {t_bins}")
    if ew_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"ew_dtype must be bfloat16 or float32, got {ew_dtype}")
    if noise is not None and noise.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"noise must be bfloat16 or float32, got {noise.dtype}")
    named = [("spec", s) for s in specs] + [
        ("f_s", f_s), ("wsum", wsum), ("vel", vel), ("gmat", gmat),
        ("c_frac", c_frac), ("cosines", cosines), ("sines", sines),
        ("side_dist", side_dist), ("opp", opp)]
    for name, v in named:
        if v is not None and v.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 on CUDA, got {v.dtype}")
    # the spectra may be rows of one (K, 3, T) tensor: one row stride for all
    if not (all(s.stride(1) == 1 for s in specs)
            and len({s.stride(0) for s in specs}) == 1):
        specs = [s.contiguous() for s in specs]
    ld = specs[0].stride(0)
    f_s, wsum, gmat, c_frac = (v.contiguous() for v in (f_s, wsum, gmat, c_frac))
    vel, noise, cosines, sines, side_dist, opp = (
        None if v is None else v.contiguous()
        for v in (vel, noise, cosines, sines, side_dist, opp))
    out = torch.empty((k_n, b_n), dtype=torch.float32, device=device)
    hit = (torch.empty((k_n,), dtype=torch.float32, device=device)
           if tail != "none" else None)
    if k_n == 0:
        return out, hit

    def ptr(v):
        return None if v is None else v.data_ptr()

    sr, se, sw = (specs + [None, None])[:3]
    n_opp = 0 if opp is None else opp.shape[1] // OPP_PACK
    err = _lib().theta_blend_launch(
        ptr(sr), ptr(se), ptr(sw), ld, ptr(f_s), ptr(wsum), ptr(vel),
        ptr(gmat), ptr(c_frac), ptr(noise),
        int(noise is not None and noise.dtype == torch.bfloat16),
        ptr(cosines), ptr(sines), ptr(side_dist), ptr(opp), n_opp, ptr(out),
        ptr(hit), k_n, b_n, agents_per_env, float(max_range), float(ttc_thresh),
        int(len(specs) == 3), _TAIL[tail], int(ew_dtype == torch.bfloat16),
        torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"theta_blend kernel launch failed: CUDA error {err}")
    return out, hit


def theta_shuffle_blend(spec_r, f_s, wsum, gmat, c_frac, max_range: float):
    """Kernel 7 on a CUDA device, its plain twin on the CPU (same arguments
    and result as :func:`theta_shuffle_blend_reference`)."""
    _check([spec_r], f_s, wsum, gmat, c_frac)
    if spec_r.device.type == "cpu":
        return theta_shuffle_blend_reference(spec_r, f_s, wsum, gmat, c_frac,
                                             max_range)
    out, _ = _launch("none", [spec_r], f_s, wsum, gmat, c_frac, max_range)
    theta_shuffle_blend.launches += 1
    return out


def theta_shuffle_blend_edge(spec_r, spec_e, spec_w, f_s, wsum, gmat, c_frac,
                             max_range: float, ew_dtype=torch.bfloat16):
    """Kernel 6 on a CUDA device, its plain twin on the CPU (see
    :func:`theta_shuffle_blend_edge_reference`)."""
    specs = [spec_r, spec_e, spec_w]
    _check(specs, f_s, wsum, gmat, c_frac)
    if spec_r.device.type == "cpu":
        return theta_shuffle_blend_edge_reference(*specs, f_s, wsum, gmat, c_frac,
                                                  max_range, ew_dtype)
    out, _ = _launch("none", specs, f_s, wsum, gmat, c_frac, max_range, ew_dtype)
    theta_shuffle_blend_edge.launches += 1
    return out


def theta_shuffle_blend_edge_ttc(spec_r, spec_e, spec_w, f_s, wsum, vel, gmat,
                                 c_frac, noise, cosines, side_dist,
                                 max_range: float, ttc_thresh: float,
                                 agents_per_env: int, ew_dtype=torch.bfloat16):
    """Kernel 3 on a CUDA device, its plain twin on the CPU (see
    :func:`theta_shuffle_blend_edge_ttc_reference`)."""
    specs = [spec_r, spec_e, spec_w]
    _check(specs, f_s, wsum, gmat, c_frac, vel, noise, (cosines, side_dist),
           agents_per_env=agents_per_env)
    if spec_r.device.type == "cpu":
        return theta_shuffle_blend_edge_ttc_reference(
            *specs, f_s, wsum, vel, gmat, c_frac, noise, cosines, side_dist,
            max_range, ttc_thresh, agents_per_env, ew_dtype)
    out = _launch("ttc", specs, f_s, wsum, gmat, c_frac, max_range, ew_dtype,
                  vel=vel, noise=noise, cosines=cosines, side_dist=side_dist,
                  ttc_thresh=ttc_thresh, agents_per_env=agents_per_env)
    theta_shuffle_blend_edge_ttc.launches += 1
    return out


def theta_shuffle_blend_edge_ttc_opp(spec_r, spec_e, spec_w, f_s, wsum, vel,
                                     gmat, c_frac, noise, cosines, sines,
                                     side_dist, opp, max_range: float,
                                     ttc_thresh: float, agents_per_env: int,
                                     ew_dtype=torch.bfloat16):
    """Kernel 4 on a CUDA device, its plain twin on the CPU (see
    :func:`theta_shuffle_blend_edge_ttc_opp_reference`)."""
    specs = [spec_r, spec_e, spec_w]
    _check(specs, f_s, wsum, gmat, c_frac, vel, noise,
           (cosines, sines, side_dist), opp, agents_per_env)
    if spec_r.device.type == "cpu":
        return theta_shuffle_blend_edge_ttc_opp_reference(
            *specs, f_s, wsum, vel, gmat, c_frac, noise, cosines, sines,
            side_dist, opp, max_range, ttc_thresh, agents_per_env, ew_dtype)
    out = _launch("ttc_opp", specs, f_s, wsum, gmat, c_frac, max_range, ew_dtype,
                  vel=vel, noise=noise, cosines=cosines, sines=sines,
                  side_dist=side_dist, opp=opp, ttc_thresh=ttc_thresh,
                  agents_per_env=agents_per_env)
    theta_shuffle_blend_edge_ttc_opp.launches += 1
    return out


KERNELS = (theta_shuffle_blend, theta_shuffle_blend_edge,
           theta_shuffle_blend_edge_ttc, theta_shuffle_blend_edge_ttc_opp)


def reset_launches() -> None:
    """Set every kernel's launch count to 0."""
    for fn in KERNELS:
        fn.launches = 0


reset_launches()
