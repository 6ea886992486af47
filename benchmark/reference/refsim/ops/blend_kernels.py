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

The CUDA C++ source is ``red_gym_tpu_torch/csrc/theta_blend.cu`` (kernel
7's own kernel on the mainloop of ``csrc/rowtile_gemm.cuh``, the edge
forms on the render tile of ``csrc/edge_render.cuh``, one C entry point;
the noise + iTTC tail and the opponent cast are in ``csrc/scan_tail.cuh``).  Each function here has the JAX
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
x 2): the three float32 range taps take about 0.41 ms at the published 67
TFLOP/s of float32 outside the tensor cores, the four bf16-input e/w taps
0.04 ms at the bf16 tensor-core rate; kernel 7 does three float32 taps,
27.2 GFLOP.  Their bytes are 50 MB of
spectra in, the 142 MB (K, B) scan out and, for 3 and 4, the 35 MB bf16
(E, B) noise slab: about 70 us at 3.35 TB/s.  So they are bound by float32
FMAs, and the taps must stay out of TF32.

Kernel 7 is one plain product and an elementwise blend, so it runs on the
register-tiled mainloop of ``csrc/rowtile_gemm.cuh`` (shared with kernel
5): a block of 256 threads owns 128 rows and all beams, keeps the rows'
range spectra in shared memory (read in place from a strided spec[:, 0]
view) and streams gmat's three taps of the same beams through a 3-stage
cp.async ring; each thread holds 8 rows x 4 beams x 3 taps of accumulators,
summed in lane order, and blends them with each operation rounded as the
twin rounds it.  One block a SM (167 registers a thread).  Its yardstick
is ``spec_r @ gmat`` (cuBLAS).

The edge forms (6, 3, 4) are ``csrc/edge_render.cuh``'s register tile,
the same kernel body as the megakernel's render: a block of 256 threads
owns 64 rows with their three spectra resident in shared memory (e/w
rounded to bf16 there when ``ew_dtype`` is bfloat16, read in place from
the strided spec[:, c] views) and walks the 64-beam tiles, gmat streaming
through a 3-stage cp.async ring whose g0/g1 chunks are rounded to bf16 once
as they land; each thread keeps 4 rows x 4 beams, runs the four e/w taps
to the ramp weight, then the three range taps, then the render and tail on
those registers.  One block a SM; each form and noise type is a kernel
instance of its own.
"""

from __future__ import annotations

import torch

from refsim.ops.scan_kernels import (OPP_PACK, edge_render_reference,
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


def theta_shuffle_blend(spec_r, f_s, wsum, gmat, c_frac, max_range: float):
    """Kernel 7's plain twin on every device."""
    _check([spec_r], f_s, wsum, gmat, c_frac)
    return theta_shuffle_blend_reference(spec_r, f_s, wsum, gmat, c_frac, max_range)


def theta_shuffle_blend_edge(spec_r, spec_e, spec_w, f_s, wsum, gmat, c_frac,
                             max_range: float, ew_dtype=torch.bfloat16):
    """Kernel 6's plain twin on every device."""
    specs = [spec_r, spec_e, spec_w]
    _check(specs, f_s, wsum, gmat, c_frac)
    return theta_shuffle_blend_edge_reference(*specs, f_s, wsum, gmat, c_frac,
                                              max_range, ew_dtype)


def theta_shuffle_blend_edge_ttc(spec_r, spec_e, spec_w, f_s, wsum, vel, gmat,
                                 c_frac, noise, cosines, side_dist,
                                 max_range: float, ttc_thresh: float,
                                 agents_per_env: int, ew_dtype=torch.bfloat16):
    """Kernel 3's plain twin on every device."""
    specs = [spec_r, spec_e, spec_w]
    _check(specs, f_s, wsum, gmat, c_frac, vel, noise, (cosines, side_dist),
           agents_per_env=agents_per_env)
    return theta_shuffle_blend_edge_ttc_reference(
        *specs, f_s, wsum, vel, gmat, c_frac, noise, cosines, side_dist,
        max_range, ttc_thresh, agents_per_env, ew_dtype)


def theta_shuffle_blend_edge_ttc_opp(spec_r, spec_e, spec_w, f_s, wsum, vel,
                                     gmat, c_frac, noise, cosines, sines,
                                     side_dist, opp, max_range: float,
                                     ttc_thresh: float, agents_per_env: int,
                                     ew_dtype=torch.bfloat16):
    """Kernel 4's plain twin on every device."""
    specs = [spec_r, spec_e, spec_w]
    _check(specs, f_s, wsum, gmat, c_frac, vel, noise,
           (cosines, sines, side_dist), opp, agents_per_env)
    return theta_shuffle_blend_edge_ttc_opp_reference(
        *specs, f_s, wsum, vel, gmat, c_frac, noise, cosines, sines,
        side_dist, opp, max_range, ttc_thresh, agents_per_env, ew_dtype)
