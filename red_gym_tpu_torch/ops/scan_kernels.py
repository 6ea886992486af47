"""The scan megakernel: texture rows -> finished noisy scan + iTTC flags.

Replaces the TPU kernel ``red_gym_tpu/ops/pallas_scan.py::mega_edge_ttc``
(``_mega_kernel``) in all its variants: plain, with the in-kernel opponent
ray cast (``opp``), with the resident noise pool of ``noise_mode="pool_rot"``
(``pool_off``), and with both.  The CUDA C++ source is
``red_gym_tpu_torch/csrc/mega_edge_ttc.cu``.

Per row k (one car), from its texture row [R | e | w | gx | gy] (T = 128 bins
each) and its packed scalars ``scal[k] = [dx, dy, f_s, i_f, inb, vel, -, -]``:

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
6. the env's noise row is added (row k belongs to env g = k // agents_per_env,
   which reads row g of the (E, B) slab, or with ``pool_off`` row
   ``(g + (pool_off & ~15)) % rows`` of the (rows, B) pool), and the iTTC
   test runs on the noisy scan over the B beams;
7. with ``opp`` (K, 10 * n_opp), each opponent's slab ray-box test shortens
   the beams inside its blocked window [lo, hi] (after the iTTC test, as
   the TPU kernel orders it).

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
arithmetic instead of matrix products.  The opponent cast adds two
divisions and a few compares per opponent and beam, negligible next to the
taps; the rows' packs sit in shared memory.  The resident pool replaces the
35 MB (E, B) noise slab with reads from a 2.2 MB pool that stays in L2; its
offset is a device tensor, so no step waits on the host.  Tensor cores
(wgmma, with the taps split into bf16 pieces or TF32x3) and TMA are for
later work.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from red_gym_tpu_torch.ops import _build, agent_scan

T_BINS = 128   # the CUDA kernel's theta-bin count (compile-time constant)
OPP_PACK = 10  # floats per opponent in ``opp`` (agent_scan.opponent_slab_scalars)


def pool_rot_rows(e_n: int, pool_rows: int, pool_off):
    """Pool row of each of e_n envs under ``noise_mode="pool_rot"``: env g
    reads row (g + (pool_off & ~15)) % pool_rows.  The 16-row quantization
    of the offset is the TPU kernel's (pallas_scan.py:1000), kept so that
    the two packages mean the same thing.  Stays on the device."""
    off = pool_off.reshape(-1)[:1].to(torch.int64) & ~15
    return (torch.arange(e_n, device=pool_off.device) + off) % pool_rows


def opp_cast_reference(out, opp, cosines, sines):
    """Opponent ray cast on the noisy scan out (K, B) from the packs
    opp (K, 10 * n_opp) (the TPU kernel's _opp_raycast_tile): beam b of row k
    takes the min with the slab hit of each opponent whose window [lo, hi]
    holds b.  Same association as the CUDA kernel: d = a * cos + b * sin,
    then the slab test of agent_scan._slab."""
    beam_pos = torch.arange(out.shape[1], device=out.device).to(out.dtype)[None, :]
    cos, sin = cosines.to(out.dtype)[None, :], sines.to(out.dtype)[None, :]
    for o in range(opp.shape[1] // OPP_PACK):
        lo, hi, a_u, b_u, a_w, b_w, o_u, o_w, hu, hw = (
            opp[:, OPP_PACK * o + j:OPP_PACK * o + j + 1] for j in range(OPP_PACK))
        d_u = a_u * cos + b_u * sin
        d_w = a_w * cos + b_w * sin
        t = agent_scan._slab(o_u, o_w, d_u, d_w, hu, hw)
        mask = (beam_pos >= lo) & (beam_pos <= hi)
        out = torch.where(mask, torch.minimum(out, t), out)
    return out


def mega_edge_ttc_reference(rt, rows, scal, fmat, fmat_sw, shift1, gmat,
                            c_frac, noise, cosines, side_dist,
                            max_range: float, ttc_thresh: float,
                            agents_per_env: int, t_bins: int,
                            ew_dtype=torch.bfloat16, sines=None, opp=None,
                            pool_off=None):
    """Plain PyTorch version of the megakernel (same signature).

    rt (N, 5T) texture, rows (K,) texture-row index, scal (K, 8) per-row
    [dx, dy, f_s, i_f, inb, vel, -, -], fmat/fmat_sw/shift1 (T, T), gmat
    (T, 3B), c_frac/cosines/side_dist (B,), and noise (E, B) with K = E *
    agents_per_env, or with ``pool_off`` (1,) int32 the (rows, B) pool of
    ``noise_mode="pool_rot"`` (see :func:`pool_rot_rows`).  ``opp``
    (K, 10 * n_opp) with ``sines`` (B,) adds the opponent ray cast.  Returns
    (scan (K, B), hit (K,) float 0/1); the hits come from the scan before
    the opponent cast.  Computes in fmat's dtype; matrix products are
    torch.matmul, so on a CUDA device TF32 must be off for float32."""
    T = t_bins
    cd = fmat.dtype
    k_n = rows.shape[0]
    raw = rt[rows.long()]
    R, e, w, gx, gy = (raw[:, i * T:(i + 1) * T].to(cd) for i in range(5))
    dxc, dyc, fsc, iic, inbc, velc = (scal[:, i:i + 1].to(cd) for i in range(6))
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
    out = edge_render_reference(sr, se, sw, fsc, wsum, gmat, c_frac, max_range,
                                ew_dtype)
    if pool_off is not None:
        noise = noise[pool_rot_rows(k_n // agents_per_env, noise.shape[0], pool_off)]
    out, hit = noise_ttc_reference(out, noise, velc, cosines, side_dist,
                                   ttc_thresh, agents_per_env)
    if opp is not None:
        out = opp_cast_reference(out, opp.to(cd), cosines, sines)
    return out, hit


def edge_render_reference(spec_r, spec_e, spec_w, f_s, wsum, gmat, c_frac,
                          max_range: float, ew_dtype):
    """The edge-ramp render from rolled spectra (the TPU kernels'
    _edge_render_tile), shared by the megakernel's twin and the edge
    kernels' twins: three range taps spec_r @ gmat, four e/w taps whose
    inputs (spectra and gmat's first two blocks) are rounded to
    ``ew_dtype`` and multiplied and summed in the compute dtype (a
    bf16 x bf16 -> float32 product; the tap outputs are not rounded),
    then the ramp through the active bin pair, the validity mask and the
    clip.  spec_* (K, T), f_s and wsum (K, 1), gmat (T, 3B), c_frac (B,)
    -> (K, B)."""
    cd = spec_r.dtype
    b_n = c_frac.shape[0]
    g0m, g1m, g2m = gmat[:, :b_n], gmat[:, b_n:2 * b_n], gmat[:, 2 * b_n:]
    g0, g1, g2 = spec_r @ g0m, spec_r @ g1m, spec_r @ g2m

    def ew(v):   # the ew_dtype input rounding of a bf16 x bf16 -> f32 product
        return v.to(ew_dtype).to(cd)

    se, sw, g0b, g1b = ew(spec_e), ew(spec_w), ew(g0m), ew(g1m)
    e_a, e_b, w_a, w_b = se @ g0b, se @ g1b, sw @ g0b, sw @ g1b

    alpha = f_s + c_frac[None, :]
    lt = alpha < 1.0
    frac = alpha - torch.floor(alpha)
    ga = torch.where(lt, g0, g1)
    gb = torch.where(lt, g1, g2)
    e_sel = torch.clamp(torch.where(lt, e_a, e_b), 0.0, 1.0)
    w_sel = torch.clamp(torch.where(lt, w_a, w_b), 1.0 / 32.0, 1.0)
    aa = torch.clamp((frac - (e_sel - 0.5 * w_sel)) / w_sel, 0.0, 1.0)
    out = ga + aa * (gb - ga)
    out = torch.where(wsum > 0.0, out, torch.zeros_like(out))
    return torch.clamp(out, 0.0, max_range)


def noise_ttc_reference(out, noise, vel, cosines, side_dist, ttc_thresh: float,
                        agents_per_env: int):
    """The noise add and wall-iTTC test of the fused kernels (the TPU
    kernels' _noise_ttc_tile): row k of out (K, B) gets row k //
    agents_per_env of noise (K / agents_per_env, B); then the sign-split
    iTTC test against vel (K, 1) over the B beams.  -> (noisy out,
    hit (K,) 0/1 in out's dtype)."""
    k_n, b_n = out.shape
    out = (out.reshape(-1, agents_per_env, b_n)
           + noise.to(out.dtype)[:, None, :]).reshape(k_n, b_n)
    pv = vel * cosines[None, :]
    num = out - side_dist[None, :]
    hit = (((pv > 0.0) & (num >= 0.0) & (num < ttc_thresh * pv))
           | ((pv < 0.0) & (num <= 0.0) & (num > ttc_thresh * pv)))
    return out, hit.any(dim=1).to(out.dtype)


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("mega_edge_ttc")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.mega_edge_ttc_launch.argtypes = [
        p, i, p, p, p, p, p, p, i, p, p, p, p, i, i, i, f, f, i, p, p, i, p, i, p]
    lib.mega_edge_ttc_launch.restype = ctypes.c_int
    return lib


def variant(opp, pool_off) -> str:
    """Name of the kernel variant these operands select."""
    return {(False, False): "plain", (True, False): "opp",
            (False, True): "pool_rot", (True, True): "opp+pool_rot"}[
        (opp is not None, pool_off is not None)]


def _check(rt, rows, scal, consts, noise, agents_per_env, t_bins, b_n,
           sines, opp, pool_off):
    """Shapes and devices every caller must meet."""
    k_n = rows.shape[0]
    if rt.dim() != 2 or rt.shape[1] != 5 * t_bins:
        raise ValueError(f"rt must be (N, 5*{t_bins}) [R|e|w|gx|gy], got "
                         f"{tuple(rt.shape)}")
    if rows.dim() != 1 or scal.shape != (k_n, 8):
        raise ValueError(f"rows must be (K,) and scal (K, 8), got "
                         f"{tuple(rows.shape)} and {tuple(scal.shape)}")
    if agents_per_env < 1 or k_n % agents_per_env:
        raise ValueError(f"K = {k_n} rows must be a multiple of "
                         f"agents_per_env = {agents_per_env}")
    if pool_off is not None:
        if pool_off.shape != (1,) or noise.dim() != 2 or noise.shape[0] < 1 \
                or noise.shape[1] != b_n:
            raise ValueError(f"pool_rot needs pool_off (1,) and the pool "
                             f"(rows, {b_n}), got {tuple(pool_off.shape)} and "
                             f"{tuple(noise.shape)}")
    elif noise.dim() != 2 or noise.shape != (k_n // agents_per_env, b_n):
        raise ValueError(f"noise must be (K / agents_per_env, B) = "
                         f"({k_n} / {agents_per_env}, {b_n}), got "
                         f"{tuple(noise.shape)}")
    extra = []
    if opp is not None:
        if sines is None or sines.shape != (b_n,):
            raise ValueError("opp needs the beam sines (B,)")
        if opp.dim() != 2 or opp.shape[0] != k_n or opp.shape[1] < OPP_PACK \
                or opp.shape[1] % OPP_PACK:
            raise ValueError(f"opp must be (K, 10 * n_opp), got {tuple(opp.shape)}")
        extra += [sines, opp]
    if pool_off is not None:
        extra.append(pool_off)
    devices = {t.device for t in (rt, rows, scal, noise, *consts, *extra)}
    if len(devices) != 1:
        raise ValueError(f"all operands must be on one device, got {devices}")


def mega_edge_ttc(rt, rows, scal, fmat, fmat_sw, shift1, gmat, c_frac, noise,
                  cosines, side_dist, max_range: float, ttc_thresh: float,
                  agents_per_env: int, t_bins: int, ew_dtype=torch.bfloat16,
                  sines=None, opp=None, pool_off=None):
    """The megakernel on a CUDA device, its plain twin on the CPU.

    Same arguments and result as :func:`mega_edge_ttc_reference`; ``rows``
    must index ``rt`` (``scan_fast.mega_operands`` clamps them).  On CUDA
    tensors it launches the kernel or raises: a build, check or launch
    failure is an error, never a fallback.  ``mega_edge_ttc.launches``
    counts kernel launches by variant (see :func:`variant`)."""
    b_n = c_frac.shape[0]
    consts = (fmat, fmat_sw, shift1, gmat, c_frac, cosines, side_dist)
    _check(rt, rows, scal, consts, noise, agents_per_env, t_bins, b_n,
           sines, opp, pool_off)
    device = rt.device
    if device.type == "cpu":
        return mega_edge_ttc_reference(
            rt, rows, scal, fmat, fmat_sw, shift1, gmat, c_frac, noise,
            cosines, side_dist, max_range, ttc_thresh, agents_per_env, t_bins,
            ew_dtype, sines, opp, pool_off)
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
    for name, v in (("scal", scal), ("fmat", fmat), ("gmat", gmat),
                    ("c_frac", c_frac), ("cosines", cosines),
                    ("side_dist", side_dist), ("sines", sines), ("opp", opp)):
        if v is not None and v.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 on CUDA, got {v.dtype}")
    if rows.dtype != torch.int32:
        raise ValueError(f"rows must be int32 on CUDA, got {rows.dtype}")
    if pool_off is not None and pool_off.dtype != torch.int32:
        raise ValueError(f"pool_off must be int32, got {pool_off.dtype}")
    if fmat.shape != (t_bins, t_bins) or gmat.shape != (t_bins, 3 * b_n):
        raise ValueError(f"fmat must be (T, T) and gmat (T, 3B), got "
                         f"{tuple(fmat.shape)} and {tuple(gmat.shape)}")

    k_n = rows.shape[0]
    rt, rows, scal, noise = (v.contiguous() for v in (rt, rows, scal, noise))
    fmat, gmat, c_frac = fmat.contiguous(), gmat.contiguous(), c_frac.contiguous()
    cosines, side_dist = cosines.contiguous(), side_dist.contiguous()
    n_opp, sin_p, opp_p = 0, None, None
    if opp is not None:
        opp, sines = opp.contiguous(), sines.contiguous()
        n_opp, sin_p, opp_p = opp.shape[1] // OPP_PACK, sines.data_ptr(), opp.data_ptr()
    pool_rows = noise.shape[0] if pool_off is not None else 0
    off_p = pool_off.contiguous().data_ptr() if pool_off is not None else None
    out = torch.empty((k_n, b_n), dtype=torch.float32, device=device)
    hit = torch.empty((k_n,), dtype=torch.float32, device=device)
    if k_n == 0:
        return out, hit
    err = _lib().mega_edge_ttc_launch(
        rt.data_ptr(), int(rt.dtype == torch.bfloat16), rows.data_ptr(),
        scal.data_ptr(), fmat.data_ptr(), gmat.data_ptr(), c_frac.data_ptr(),
        noise.data_ptr(), int(noise.dtype == torch.bfloat16),
        cosines.data_ptr(), side_dist.data_ptr(), out.data_ptr(),
        hit.data_ptr(), k_n, b_n, agents_per_env, float(max_range),
        float(ttc_thresh), int(ew_dtype == torch.bfloat16), sin_p, opp_p,
        n_opp, off_p, pool_rows, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"mega_edge_ttc kernel launch failed: CUDA error {err}")
    mega_edge_ttc.launches[variant(opp, pool_off)] += 1
    return out, hit


def reset_launches() -> None:
    """Set every variant's launch count to 0."""
    mega_edge_ttc.launches = dict.fromkeys(
        ("plain", "opp", "pool_rot", "opp+pool_rot"), 0)


reset_launches()
