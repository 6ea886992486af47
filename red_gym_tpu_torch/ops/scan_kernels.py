"""The scan megakernel: texture rows -> finished noisy scan + iTTC flags.

Replaces the TPU kernel ``red_gym_tpu/ops/pallas_scan.py::mega_edge_ttc``
(``_mega_kernel``), plain variant: no in-kernel opponent cast, no resident
noise pool.  The CUDA C++ source is ``red_gym_tpu_torch/csrc/mega_edge_ttc.cu``.

Per row k (one car), from its texture row [R | e | w | gx | gy] (T = 128 bins
each) and its scalars (dx, dy, f_s, i_f, inb, vel):

1. gradient fold ``clip(R + dx*gx + dy*gy, 0, max_range)``;
2. exact corner-bearing parallax on e (atan2 of the occluding corner seen
   from the pose);
3. packed-rfft integer roll of the range, e and w rows: ``spec*P + spec_sw*QR``
   with ``spec = X @ fmat`` and per-row twiddles;
4. validity ``inb * min(R[0]*1e3, 1)``;
5. three float32 range taps and four e/w taps (``ew_dtype``: bfloat16 rounds
   the e/w spectra and the g0/g1 columns, then multiplies and accumulates
   in float32) against the (T, 3B) ``gmat``, then the edge-ramp render,
   mask and clip;
6. the env's noise row (row k reads noise row k // agents_per_env) is
   added, and the iTTC test runs on the noisy scan over the B beams.

What bounds it on an H100: at K = 32768 rows and B = 1080 beams the seven
tap products are 63.4 GFLOP per step (7 x K x 128 x B x 2), about 0.95 ms
at the published 67 TFLOP/s of float32 outside the tensor cores, while the
bytes (the K texture rows, 42 MB in bfloat16; the (E, B) noise, 35 MB; the
(K, B) scan written once, 142 MB) take about 65 us at 3.35 TB/s.  So it is
bound by float32 FMAs, and the range taps must stay out of TF32.  The design
does about that: one block of 256 threads per 8 rows stages the rows'
rolled spectra (3 x 128 floats each) in shared memory once, then each
thread owns one beam and sweeps the 128 spectral lanes four at a time, so
one float4 shared-memory broadcast feeds four FMAs and each gmat column
read from L2 (1.66 MB, resident) serves 8 rows x 7 taps.  The texture-row
gather happens inside the kernel (the JAX package gathers in XLA because
Mosaic cannot), atan2f replaces the TPU's polynomial, and the T/2 column
rotation of ``fmat_sw`` and the one-lane shift of ``shift1`` are index
arithmetic instead of matrix products.  Tensor cores (wgmma, with the taps
split into bf16 pieces or TF32x3) and TMA are for later work.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from red_gym_tpu_torch.ops import _build

T_BINS = 128   # the CUDA kernel's theta-bin count (compile-time constant)


def mega_edge_ttc_reference(rt, rows, dx, dy, f_s, i_f, inb, vel, fmat,
                            fmat_sw, shift1, gmat, c_frac, noise, cosines,
                            side_dist, max_range: float, ttc_thresh: float,
                            agents_per_env: int, t_bins: int,
                            ew_dtype=torch.bfloat16):
    """Plain PyTorch version of the megakernel (same signature).

    rt (N, 5T) texture, rows (K,) texture-row index, dx/dy/f_s/i_f/inb/vel
    (K,), fmat/fmat_sw/shift1 (T, T), gmat (T, 3B), c_frac/cosines/side_dist
    (B,), noise (E, B) with K = E * agents_per_env.  Returns (scan (K, B),
    hit (K,) float 0/1).  Computes in fmat's dtype; matrix products are
    torch.matmul, so on a CUDA device TF32 must be off for float32."""
    T = t_bins
    cd = fmat.dtype
    k_n, b_n = rows.shape[0], c_frac.shape[0]
    raw = rt[rows.long()]
    R, e, w, gx, gy = (raw[:, i * T:(i + 1) * T].to(cd) for i in range(5))
    dxc, dyc, fsc, iic, inbc, velc = (v.to(cd)[:, None]
                                      for v in (dx, dy, f_s, i_f, inb, vel))

    rr_c = torch.clamp(R + dxc * gx + dyc * gy, 0.0, max_range)

    two_pi = 2.0 * math.pi
    dth = two_pi / T
    lane = torch.arange(T, device=rt.device, dtype=torch.int32)[None, :]
    theta_e = (lane.to(cd) + e) * dth
    r_next = R @ shift1
    r_fore = torch.clamp(torch.minimum(R, r_next), min=0.05)
    ex = r_fore * torch.cos(theta_e) - dxc
    ey = r_fore * torch.sin(theta_e) - dyc
    dbeta = torch.atan2(ey, ex) - theta_e
    # products with reciprocal constants, not divisions: PyTorch's CUDA
    # division by a Python number is a product with its reciprocal, and the
    # CUDA kernel spells out the same products
    dbeta = dbeta - torch.round(dbeta * (1.0 / two_pi)) * two_pi
    e = e + (1.0 - w) * dbeta * (T / two_pi)

    half = T // 2
    l_eff = torch.where(lane <= half, lane, lane - half)
    m = (iic.to(torch.int32) * l_eff) % T
    phi = m.to(cd) * (two_pi / T)
    cphi, sphi = torch.cos(phi), torch.sin(phi)
    qmask = ((lane >= 1) & (lane <= half - 1)).to(cd)
    rmask = (lane >= half + 1).to(cd)
    qr = -sphi * qmask + sphi * rmask

    def rolled(x):
        # spectra summed in float64 and rounded once to the compute dtype,
        # so that they do not depend on the matmul's order of summation:
        # the e/w spectra are rounded to ew_dtype below, and the CUDA
        # kernel must land on the same values
        x64 = x.to(torch.float64)
        spec = (x64 @ fmat.to(torch.float64)).to(cd)
        spec_sw = (x64 @ fmat_sw.to(torch.float64)).to(cd)
        return spec * cphi + spec_sw * qr

    sr, se, sw = rolled(rr_c), rolled(e), rolled(w)
    wsum = inbc * torch.clamp(R[:, 0:1] * 1e3, max=1.0)

    g0m, g1m, g2m = gmat[:, :b_n], gmat[:, b_n:2 * b_n], gmat[:, 2 * b_n:]
    g0, g1, g2 = sr @ g0m, sr @ g1m, sr @ g2m

    def ew(v):   # the ew_dtype input rounding of a bf16 x bf16 -> f32 product
        return v.to(ew_dtype).to(cd)

    se, sw, g0b, g1b = ew(se), ew(sw), ew(g0m), ew(g1m)
    e_a, e_b, w_a, w_b = se @ g0b, se @ g1b, sw @ g0b, sw @ g1b

    alpha = fsc + c_frac[None, :]
    lt = alpha < 1.0
    frac = alpha - torch.floor(alpha)
    ga = torch.where(lt, g0, g1)
    gb = torch.where(lt, g1, g2)
    e_sel = torch.clamp(torch.where(lt, e_a, e_b), 0.0, 1.0)
    w_sel = torch.clamp(torch.where(lt, w_a, w_b), 1.0 / 32.0, 1.0)
    aa = torch.clamp((frac - (e_sel - 0.5 * w_sel)) / w_sel, 0.0, 1.0)
    out = ga + aa * (gb - ga)
    out = torch.where(wsum > 0.0, out, torch.zeros_like(out))
    out = torch.clamp(out, 0.0, max_range)

    out = (out.reshape(-1, agents_per_env, b_n)
           + noise.to(cd)[:, None, :]).reshape(k_n, b_n)
    pv = velc * cosines[None, :]
    num = out - side_dist[None, :]
    hit = (((pv > 0.0) & (num >= 0.0) & (num < ttc_thresh * pv))
           | ((pv < 0.0) & (num <= 0.0) & (num > ttc_thresh * pv)))
    return out, hit.any(dim=1).to(cd)


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("mega_edge_ttc")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.mega_edge_ttc_launch.argtypes = [
        p, i, p, p, p, p, p, p, i, p, p, p, p, i, i, i, f, f, i, p]
    lib.mega_edge_ttc_launch.restype = ctypes.c_int
    return lib


def _check(rt, rows, per_row, consts, noise, agents_per_env, t_bins, b_n):
    """Shapes and devices every caller must meet."""
    k_n = rows.shape[0]
    if rt.dim() != 2 or rt.shape[1] != 5 * t_bins:
        raise ValueError(f"rt must be (N, 5*{t_bins}) [R|e|w|gx|gy], got "
                         f"{tuple(rt.shape)}")
    if rows.dim() != 1 or any(v.shape != (k_n,) for v in per_row):
        raise ValueError("rows, dx, dy, f_s, i_f, inb and vel must all be (K,)")
    if agents_per_env < 1 or noise.dim() != 2 or \
            noise.shape != (k_n // agents_per_env, b_n) or \
            k_n % agents_per_env:
        raise ValueError(f"noise must be (K / agents_per_env, B) = "
                         f"({k_n} / {agents_per_env}, {b_n}), got "
                         f"{tuple(noise.shape)}")
    devices = {t.device for t in (rt, rows, noise, *per_row, *consts)}
    if len(devices) != 1:
        raise ValueError(f"all operands must be on one device, got {devices}")


def mega_edge_ttc(rt, rows, dx, dy, f_s, i_f, inb, vel, fmat, fmat_sw,
                  shift1, gmat, c_frac, noise, cosines, side_dist,
                  max_range: float, ttc_thresh: float, agents_per_env: int,
                  t_bins: int, ew_dtype=torch.bfloat16):
    """The megakernel on a CUDA device, its plain twin on the CPU.

    Same arguments and result as :func:`mega_edge_ttc_reference`; ``rows``
    must index ``rt`` (``scan_fast.mega_operands`` clamps them).  On CUDA
    tensors it launches the kernel or raises: a build, check or launch
    failure is an error, never a fallback.  ``mega_edge_ttc.launches``
    counts kernel launches."""
    b_n = c_frac.shape[0]
    per_row = (dx, dy, f_s, i_f, inb, vel)
    consts = (fmat, fmat_sw, shift1, gmat, c_frac, cosines, side_dist)
    _check(rt, rows, per_row, consts, noise, agents_per_env, t_bins, b_n)
    device = rt.device
    if device.type == "cpu":
        return mega_edge_ttc_reference(
            rt, rows, dx, dy, f_s, i_f, inb, vel, fmat, fmat_sw, shift1, gmat,
            c_frac, noise, cosines, side_dist, max_range, ttc_thresh,
            agents_per_env, t_bins, ew_dtype)
    if device.type != "cuda":
        raise ValueError(f"mega_edge_ttc runs on cuda or cpu, not {device}")
    if t_bins != T_BINS:
        raise ValueError(f"the CUDA kernel takes rt_theta_bins={T_BINS}, "
                         f"got {t_bins}")
    if rt.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"rt must be bfloat16 or float32, got {rt.dtype}")
    if noise.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"noise must be bfloat16 or float32, got {noise.dtype}")
    if ew_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"ew_dtype must be bfloat16 or float32, got {ew_dtype}")
    for name, v in (("fmat", fmat), ("gmat", gmat), ("c_frac", c_frac),
                    ("cosines", cosines), ("side_dist", side_dist)):
        if v.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 on CUDA, got {v.dtype}")
    if fmat.shape != (t_bins, t_bins) or gmat.shape != (t_bins, 3 * b_n):
        raise ValueError(f"fmat must be (T, T) and gmat (T, 3B), got "
                         f"{tuple(fmat.shape)} and {tuple(gmat.shape)}")

    k_n = rows.shape[0]
    scal = torch.stack([v.to(torch.float32) for v in per_row]
                       + [torch.zeros_like(dx, dtype=torch.float32)] * 2,
                       dim=-1).contiguous()
    rows32 = rows.to(torch.int32).contiguous()
    rt, noise = rt.contiguous(), noise.contiguous()
    fmat, gmat, c_frac = fmat.contiguous(), gmat.contiguous(), c_frac.contiguous()
    cosines, side_dist = cosines.contiguous(), side_dist.contiguous()
    out = torch.empty((k_n, b_n), dtype=torch.float32, device=device)
    hit = torch.empty((k_n,), dtype=torch.float32, device=device)
    if k_n == 0:
        return out, hit
    err = _lib().mega_edge_ttc_launch(
        rt.data_ptr(), int(rt.dtype == torch.bfloat16), rows32.data_ptr(),
        scal.data_ptr(), fmat.data_ptr(), gmat.data_ptr(), c_frac.data_ptr(),
        noise.data_ptr(), int(noise.dtype == torch.bfloat16),
        cosines.data_ptr(), side_dist.data_ptr(), out.data_ptr(),
        hit.data_ptr(), k_n, b_n, agents_per_env, float(max_range),
        float(ttc_thresh), int(ew_dtype == torch.bfloat16),
        torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"mega_edge_ttc kernel launch failed: CUDA error {err}")
    mega_edge_ttc.launches += 1
    return out, hit


mega_edge_ttc.launches = 0
