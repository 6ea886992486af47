"""The scan megakernel: texture rows -> finished noisy scan + iTTC flags.

Replaces the TPU kernel ``red_gym_tpu/ops/pallas_scan.py::mega_edge_ttc``
(``_mega_kernel``) in all its variants: plain, with the in-kernel opponent
ray cast (``opp``), with the resident noise pool of ``noise_mode="pool_rot"``
(``pool_off``), and with both.  The CUDA C++ source is
``red_gym_tpu_torch/csrc/mega_edge_ttc.cu`` (its render kernel on
``csrc/edge_render.cuh``).

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
tap products are 63.4 GFLOP per step (7 x K x 128 x B x 2).  The three
float32 range taps take about 0.41 ms at the published 67 TFLOP/s of float32
outside the tensor cores, the four bf16-input e/w taps 0.04 ms at the bf16
tensor-core rate, while the bytes (the K texture rows, 42 MB in bfloat16;
the (E, B) noise, 35 MB; the (K, B) scan written once, 142 MB) take about
65 us at 3.35 TB/s.  So it is bound by float32 FMAs, and the range taps must
stay out of TF32.  Steps 1-4 add the packed rfft of three rows, 3.2 GFLOP in
float64 (about 0.05 ms at the H100's 67 TFLOP/s float64 tensor-core rate,
0.1 ms at its SIMT rate, which the kernel runs at).

The design splits the work in two kernels, launched one after the other:
the spectra kernel (steps 1-4; twin :func:`mega_spectra_reference`) at 16
warps a SM, with fmat staged in float64 in shared memory once a block and
the rows' channels staged in float64, writes the rolled spectra (K, 3T)
and the per-row f_s, wsum and vel to a workspace; the render kernel (steps
5-7; twins :func:`edge_render_reference`, :func:`noise_ttc_reference`,
:func:`opp_cast_reference`) is ``csrc/edge_render.cuh``'s register tile,
shared with the edge epilogues of ``blend_kernels``: 64 rows a block with
their spectra resident in shared memory, gmat through a cp.async ring, the
four e/w taps and then the three range taps on 4 rows x 4 beams a thread,
and the render and tail on those registers.  Each variant is a render
instance of its own.  The round trip of the spectra (50 MB written and read
at K = 32768) costs about 0.03 ms.  The texture-row gather happens inside the
spectra kernel (the JAX package gathers in XLA because Mosaic cannot),
atan2f replaces the TPU's polynomial, and the T/2 column rotation of
``fmat_sw`` and the one-lane shift of ``shift1`` are index arithmetic
instead of matrix products.  The opponent cast adds two divisions and a
few compares per opponent and beam; the rows' packs sit in shared memory.
The resident pool replaces the 35 MB (E, B) noise slab with reads from a
2.2 MB pool that stays in L2; its offset is a device tensor, so no step
waits on the host.  Tensor cores are for later work.
"""

from __future__ import annotations

import math

import torch

from refsim.ops import agent_scan

T_BINS = 128   # the CUDA kernel's theta-bin count (compile-time constant)
OPP_PACK = 10  # floats per opponent in ``opp`` (agent_scan.opponent_slab_scalars)


def pool_rot_rows(e_n: int, pool_rows: int, pool_off):
    """Pool row of each of e_n envs under ``noise_mode="pool_rot"``: env g
    reads row (g + (pool_off & ~15)) % pool_rows.  The 16-row quantization
    of the offset is the TPU kernel's (pallas_scan.py:1000), kept so that
    the two packages mean the same thing.  With pool_off uniform on
    [0, pool_rows) and pool_rows a multiple of 16, env g's row is uniform
    over the pool_rows / 16 rows of its class g mod 16; one call's rows are
    distinct for e_n <= pool_rows, each read floor or ceil(e_n / pool_rows)
    times past that.  Stays on the device."""
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


def mega_spectra_reference(rt, rows, scal, fmat, fmat_sw, shift1,
                           max_range: float, t_bins: int,
                           ew_dtype=torch.bfloat16):
    """Plain PyTorch version of the megakernel's spectra kernel: per row,
    the gradient fold, the corner-bearing parallax, the packed rfft
    summed in float64 and rounded once, and the integer roll.

    rt (N, 5T) texture, rows (K,) texture-row index, scal (K, 8) per-row
    [dx, dy, f_s, i_f, inb, vel, -, -], fmat/fmat_sw/shift1 (T, T).
    Returns what the kernel writes: the rolled spectra (K, 3T) [range | e |
    w] with e and w rounded to ``ew_dtype``, and f_s, wsum and vel (K,).
    Computes in fmat's dtype; the rfft is a float64 torch.matmul."""
    T = t_bins
    cd = fmat.dtype
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

    def ew(v):   # the ew_dtype input rounding of the e/w taps
        return v.to(ew_dtype).to(cd)

    spec = torch.cat([rolled(rr_c), ew(rolled(e)), ew(rolled(w))], dim=1)
    wsum = inbc * torch.clamp(R[:, 0:1] * 1e3, max=1.0)
    return spec, fsc[:, 0], wsum[:, 0], velc[:, 0]


def mega_edge_ttc_reference(rt, rows, scal, fmat, fmat_sw, shift1, gmat,
                            c_frac, noise, cosines, side_dist,
                            max_range: float, ttc_thresh: float,
                            agents_per_env: int, t_bins: int,
                            ew_dtype=torch.bfloat16, sines=None, opp=None,
                            pool_off=None):
    """Plain PyTorch version of the megakernel (same signature): the
    spectra kernel's twin :func:`mega_spectra_reference`, then the render
    kernel's: :func:`edge_render_reference`, :func:`noise_ttc_reference`
    and, with ``opp``, :func:`opp_cast_reference`.

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
    spec, f_s, wsum, vel = mega_spectra_reference(
        rt, rows, scal, fmat, fmat_sw, shift1, max_range, t_bins, ew_dtype)
    sr, se, sw = (spec[:, i * T:(i + 1) * T] for i in range(3))
    out = edge_render_reference(sr, se, sw, f_s[:, None], wsum[:, None], gmat,
                                c_frac, max_range, ew_dtype)
    if pool_off is not None:
        noise = noise[pool_rot_rows(rows.shape[0] // agents_per_env,
                                    noise.shape[0], pool_off)]
    out, hit = noise_ttc_reference(out, noise, vel[:, None], cosines, side_dist,
                                   ttc_thresh, agents_per_env)
    if opp is not None:
        out = opp_cast_reference(out, opp.to(fmat.dtype), cosines, sines)
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
    """The megakernel's plain twin (:func:`mega_edge_ttc_reference`), on
    every device, after the shape checks the kernel's callers meet."""
    _check(rt, rows, scal, (fmat, fmat_sw, shift1, gmat, c_frac, cosines,
                            side_dist), noise, agents_per_env, t_bins,
           c_frac.shape[0], sines, opp, pool_off)
    return mega_edge_ttc_reference(
        rt=rt, rows=rows, scal=scal, fmat=fmat, fmat_sw=fmat_sw, shift1=shift1,
        gmat=gmat, c_frac=c_frac, noise=noise, cosines=cosines,
        side_dist=side_dist, max_range=max_range, ttc_thresh=ttc_thresh,
        agents_per_env=agents_per_env, t_bins=t_bins, ew_dtype=ew_dtype,
        sines=sines, opp=opp, pool_off=pool_off)
