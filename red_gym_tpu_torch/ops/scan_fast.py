"""Fast lidar: a precomputed range texture R(x, y, theta) plus one kernel.

PyTorch counterpart of ``red_gym_tpu/ops/scan_fast.py``.  The texture is
marched once per map with the exact sphere march (``build_range_texture``);
at every step each car reads ONE texture row (nearest1 cell) and the scan
megakernel (``ops/scan_kernels.py``) turns it into the finished noisy scan
and the wall-iTTC flag.

Ported here: the compact texture build (base march, edge localization on
the edge bins only, channel assembly), its disk cache, and the runtime of
the library-default pipeline: nearest1 cell, linear theta interpolation,
edge + grad channels, float32.  The other scan modes raise
``NotImplementedError`` naming the ROADMAP item that ports them.
"""

from __future__ import annotations

import hashlib
import math
import os
import sys
import time
from typing import NamedTuple

import numpy as np
import torch

from red_gym_tpu_torch.config import SimConfig
from red_gym_tpu_torch.maps.loader import TrackMap
from red_gym_tpu_torch.ops import scan as scan_ops
from red_gym_tpu_torch.ops import scan_kernels

_N_GRID = 8          # fine-grid samples per edge bin pair
_EDGE_CHUNK = 1 << 20  # edge bins localized per call (bounds memory)
# rays marched per row batch of the texture build (bounds memory)
_RAY_BUDGET = {"cuda": 1 << 24, "cpu": 1 << 19}
_NP_DTYPES = {torch.float32: np.float32, torch.float64: np.float64}


class RangeTexture(NamedTuple):
    """Precomputed ranges on an (Hc x Wc) cell grid x T theta bins, plus the
    constant matrices of the packed-DFT roll.

    ``rt`` rows are [R | e w | gx gy]: ranges, the sub-bin visibility edge
    position e and transition width w of each bin pair, and dR/dpose.  An
    occupied or out-of-map cell has an all-zero row and valid=False."""

    rt: torch.Tensor       # (Hc * Wc, C * T); storage may be bfloat16
    valid: torch.Tensor    # (Hc * Wc,) bool free-space mask
    hc: torch.Tensor       # int32 rows
    wc: torch.Tensor       # int32 cols
    cell: torch.Tensor     # cell size [m] = stride * map resolution
    fmat: torch.Tensor     # (T, T) packed real rfft: [Re 0..T/2 | Im 1..T/2-1]
    gmat: torch.Tensor     # (T, 3B) packed irfft fused with the beam shuffle
    smat: torch.Tensor     # (T, B) windowed trig evaluation (spectral mode)
    fmat_sw: torch.Tensor  # (T, T) fmat with its columns rotated by T/2
    shift1: torch.Tensor   # (T, T) one-lane circular shift: X @ shift1 = roll(X, -1)
    c_frac: torch.Tensor   # (B,) fractional theta-bin offset of each beam


def check_supported(cfg: SimConfig) -> None:
    """Raise NotImplementedError for a config whose scan path is not ported.

    The port runs the library-default fast scan through the megakernel
    (plain variant).  Each other path names its ROADMAP item."""
    if cfg.scan_mode != "fast":
        raise NotImplementedError(
            "scan_mode='exact' at step time is not ported yet "
            "(ROADMAP queue A: the exact scan)")
    if (cfg.rt_spatial != "nearest1" or cfg.scan_interp != "linear"
            or cfg.rt_eff_occlusion != "edge" or not cfg.rt_grad):
        raise NotImplementedError(
            "only the default fast scan (rt_spatial='nearest1', "
            "scan_interp='linear', rt_occlusion='edge', rt_grad=True) is "
            "ported (ROADMAP queue A: the other scan modes)")
    if cfg.dtype != "float32":
        raise NotImplementedError(
            "the scan megakernel runs in float32 only, as in the JAX package "
            "(ROADMAP queue A: the other scan modes)")
    if cfg.noise_mode == "pool_rot":
        raise NotImplementedError(
            "noise_mode='pool_rot' needs the megakernel's resident-pool "
            "variant (ROADMAP queue B: kernel 1b)")
    if cfg.fuse_scan_opp == "on":
        raise NotImplementedError(
            "fuse_scan_opp='on' needs the megakernel's opponent variant "
            "(ROADMAP queue B: kernel 1a)")
    if cfg.state_kernel == "on":
        raise NotImplementedError(
            "state_kernel='on' needs the pre-scan state kernel "
            "(ROADMAP queue B: kernel 2)")
    if (cfg.scan_megakernel == "off" or cfg.fuse_scan_ttc == "off"
            or cfg.scan_backend == "xla"):
        raise NotImplementedError(
            "the scan paths without the megakernel are not ported "
            "(ROADMAP queue B: kernels 3-7)")


def resolve_ew_dtype(cfg: SimConfig, dtype: torch.dtype,
                     device: torch.device) -> torch.dtype:
    """dtype of the e/w channel taps: explicit values win; "auto" is
    bfloat16 on a CUDA device and the scan dtype on the CPU."""
    if cfg.rt_ew_dtype == "bfloat16":
        return torch.bfloat16
    if cfg.rt_ew_dtype == "float32":
        return dtype
    return torch.bfloat16 if torch.device(device).type == "cuda" else dtype


def _texture_cache_path(tmap: TrackMap, cfg: SimConfig):
    """Content-addressed cache file for the marched (rt, valid) arrays.

    The key tuple is the JAX package's; the distinct recipe prefix keeps a
    texture file written by the JAX package from ever being read here.  Cache dir:
    $RED_GYM_TPU_TEXTURE_CACHE, default ~/.cache/red_gym_tpu; "0"/"off"
    disables it."""
    root = os.environ.get("RED_GYM_TPU_TEXTURE_CACHE",
                          os.path.join(os.path.expanduser("~"),
                                       ".cache", "red_gym_tpu"))
    if root.lower() in ("0", "off", "none", ""):
        return None
    h = hashlib.sha256()
    h.update(b"rtex-torch-v1|")
    dt = np.ascontiguousarray(tmap.dt.cpu().numpy())
    h.update(dt.tobytes())
    key = (cfg.rt_pose_stride, cfg.rt_theta_bins, cfg.max_range, cfg.eps,
           cfg.march_iters, cfg.rt_eff_occlusion == "edge", cfg.rt_grad,
           cfg.rt_occlusion_cells, cfg.rt_edge_iters,
           float(tmap.resolution), float(tmap.orig_x), float(tmap.orig_y),
           float(tmap.orig_c), float(tmap.orig_s),
           int(tmap.height), int(tmap.width), tuple(dt.shape), str(dt.dtype))
    h.update(repr(key).encode())
    return os.path.join(root, f"rtex_torch_{h.hexdigest()[:24]}.npz")


def texture_constants(cfg: SimConfig, dtype: torch.dtype, device) -> dict:
    """The texture's constant matrices, from the JAX package's numpy math:
    fmat/gmat (packed-DFT integer roll fused with the beam shuffle), smat,
    and the per-step constants fmat_sw, shift1 and c_frac, computed once."""
    np_dtype = np.dtype(_NP_DTYPES[dtype])
    t_bins, b_n = cfg.rt_theta_bins, cfg.num_beams
    incr = cfg.fov / (b_n - 1)
    angles = (-cfg.fov / 2.0 + np.arange(b_n) * incr).astype(np_dtype)
    c_b = angles * np_dtype.type(t_bins / (2.0 * math.pi))
    kb = np.floor(c_b).astype(np.int64)
    emat = np.zeros((t_bins, 3 * b_n), dtype=np.float64)
    for t in range(3):
        emat[(kb + t) % t_bins, t * b_n + np.arange(b_n)] = 1.0

    f_bins = t_bins // 2 + 1
    rf = np.fft.rfft(np.eye(t_bins), axis=1)
    fmat = np.concatenate([rf.real, rf.imag[:, 1:-1]], axis=1)
    r_basis = np.fft.irfft(np.eye(f_bins), n=t_bins, axis=1)
    s_basis = np.fft.irfft(1j * np.eye(f_bins), n=t_bins, axis=1)
    gmat = np.concatenate([r_basis @ emat, (s_basis @ emat)[1:-1]], axis=0)

    freqs = np.arange(f_bins)
    sigma = np.sinc(freqs / (t_bins // 2))
    scale = np.where((freqs == 0) | (freqs == t_bins // 2), 1.0, 2.0) / t_bins
    wf = (sigma * scale)[:, None]
    omega_c = (2.0 * math.pi / t_bins) * np.outer(freqs, c_b)
    smat = np.concatenate([wf * np.cos(omega_c),
                           (-wf * np.sin(omega_c))[1:-1]], axis=0)

    fmat = fmat.astype(np_dtype)
    consts = dict(fmat=fmat, gmat=gmat, smat=smat,
                  fmat_sw=np.roll(fmat, -(t_bins // 2), axis=1),
                  shift1=np.roll(np.eye(t_bins), -1, axis=1),
                  c_frac=np.mod(c_b, np_dtype.type(1.0)))
    return {k: torch.as_tensor(v.astype(np_dtype), device=device)
            for k, v in consts.items()}


def build_range_texture(tmap: TrackMap, cfg: SimConfig) -> RangeTexture:
    """March every theta bin from every texture cell centre, on tmap's device.

    Rows are marched in batches of a bounded number of rays.  The build
    is the JAX package's compact recipe: the base march, then the edge
    localization (8-point fine grid, bisection, width probe) on only the
    bins whose jump exceeds the edge threshold, then the channel assembly.
    The result is cached on disk by content hash (_texture_cache_path)."""
    stride, t_bins = cfg.rt_pose_stride, cfg.rt_theta_bins
    h, w = tmap.dt.shape
    hc, wc = (h + stride - 1) // stride, (w + stride - 1) // stride
    cell = stride * float(tmap.resolution)
    dtype, device = tmap.dt.dtype, tmap.dt.device
    angles = torch.as_tensor(np.arange(t_bins) * (2 * math.pi / t_bins),
                             dtype=dtype, device=device)
    need_edge = cfg.rt_eff_occlusion == "edge"
    need_grad = cfg.rt_grad
    dth = 2.0 * math.pi / t_bins
    thr = cfg.rt_occlusion_cells * cell

    def march(xk, yk, ang):
        return scan_ops.march(xk, yk, torch.cos(ang), torch.sin(ang), tmap, cfg)

    def base_rows(r0, n):
        r_idx = r0 + torch.arange(n, device=device)[:, None]
        c_idx = torch.arange(wc, device=device)[None, :].expand(n, wc)
        x_rot = (c_idx.to(dtype) + 0.5) * cell
        y_rot = (r_idx.to(dtype) + 0.5) * cell
        x = x_rot * tmap.orig_c - y_rot * tmap.orig_s + tmap.orig_x
        y = x_rot * tmap.orig_s + y_rot * tmap.orig_c + tmap.orig_y
        ranges = scan_ops.trace_angles(torch.stack([x, y], dim=-1), angles,
                                       tmap, cfg)
        # valid rows are >= 1 mm everywhere: the kernel reads validity
        # off theta column 0 alone
        ranges = torch.clamp(ranges, min=1e-3)
        free = scan_ops.dt_lookup(x, y, tmap) > 0.0
        cy = (r_idx.to(dtype) + 0.5) * stride
        cx = (c_idx.to(dtype) + 0.5) * stride
        free = free & (cy < tmap.height.to(dtype)) & (cx < tmap.width.to(dtype))
        return ranges, free, x, y

    def edge_bins(xk, yk, ang0, rl, rr, jk):
        """Edge localization on a compact vector of edge bins (the JAX
        package's _edge_bins): the steepest of 8 fine-grid intervals, then
        bisection inside it, then a +-h probe for the transition width."""
        samples = [rl]
        for j in range(1, _N_GRID):
            samples.append(march(xk, yk, ang0 + (j / _N_GRID) * dth))
        samples.append(rr)
        m = torch.stack(samples, dim=0)
        jidx = torch.argmax(torch.abs(m[1:] - m[:-1]), dim=0)
        lo = jidx.to(dtype) / _N_GRID
        hi = (jidx.to(dtype) + 1.0) / _N_GRID
        mlo = torch.gather(m, 0, jidx[None])[0]
        mhi = torch.gather(m, 0, jidx[None] + 1)[0]
        for _ in range(cfg.rt_edge_iters):
            mid = 0.5 * (lo + hi)
            rm = march(xk, yk, ang0 + mid * dth)
            left = torch.abs(rm - mlo) < torch.abs(rm - mhi)
            lo = torch.where(left, mid, lo)
            hi = torch.where(left, hi, mid)
            mlo = torch.where(left, rm, mlo)
            mhi = torch.where(left, mhi, rm)
        e = 0.5 * (lo + hi)
        hh = 1.0 / (_N_GRID * 2 ** cfg.rt_edge_iters)
        r_m = march(xk, yk, ang0 + torch.clamp(e - hh, 0.0, 1.0) * dth)
        r_p = march(xk, yk, ang0 + torch.clamp(e + hh, 0.0, 1.0) * dth)
        frac_disc = torch.abs(r_p - r_m) / torch.clamp(jk, min=1e-6)
        w_ = torch.clamp(1.0 - frac_disc, 0.0, 1.0)
        return 0.5 * w_ + e * (1.0 - w_), w_

    def edge_channels(ranges, free, x, y):
        nxt = torch.roll(ranges, -1, dims=-1)
        jump = torch.abs(nxt - ranges)
        # bins of occupied cells are zeroed by the validity mask anyway
        idx = torch.nonzero(((jump > thr) & free[..., None]).reshape(-1)).squeeze(1)
        e = torch.full_like(ranges, 0.5)
        w_ = torch.ones_like(ranges)
        for c0 in range(0, idx.numel(), _EDGE_CHUNK):
            sl = idx[c0:c0 + _EDGE_CHUNK]
            cell_i = sl // t_bins
            e_k, w_k = edge_bins(x.reshape(-1)[cell_i], y.reshape(-1)[cell_i],
                                 angles[sl % t_bins], ranges.reshape(-1)[sl],
                                 nxt.reshape(-1)[sl], jump.reshape(-1)[sl])
            e.view(-1)[sl] = e_k
            w_.view(-1)[sl] = w_k
        return e, w_, idx.numel()

    def finish_rows(ranges, free, x, y, ew):
        chans = [ranges, *ew]
        if need_grad:
            x3, y3 = x[..., None], y[..., None]
            jump = torch.abs(torch.roll(ranges, -1, dims=-1) - ranges)
            cos_t, sin_t = torch.cos(angles), torch.sin(angles)
            hx = x3 + ranges * cos_t
            hy = y3 + ranges * sin_t
            # wall tangent from adjacent hit points, one-sided at edges
            jl = torch.roll(jump, 1, dims=-1) > thr
            jr = jump > thr
            txr = torch.roll(hx, -1, dims=-1) - hx
            tyr = torch.roll(hy, -1, dims=-1) - hy
            txl = hx - torch.roll(hx, 1, dims=-1)
            tyl = hy - torch.roll(hy, 1, dims=-1)
            tx = torch.where(jl, txr, torch.where(jr, txl, txr + txl))
            ty = torch.where(jl, tyr, torch.where(jr, tyl, tyr + tyl))
            nx, ny = -ty, tx
            nd = nx * cos_t + ny * sin_t
            sgn = torch.where(nd > 0, -1.0, 1.0).to(dtype)
            nx, ny, nd = nx * sgn, ny * sgn, nd * sgn
            nd = torch.clamp(nd, max=-1e-9)
            gx = -nx / nd
            gy = -ny / nd
            gn = torch.sqrt(gx * gx + gy * gy)
            sc = torch.clamp(8.0 / torch.clamp(gn, min=1e-9), max=1.0)
            rmax = 0.999 * cfg.max_range
            side_r = torch.roll(ranges, -1, dims=-1) >= rmax
            side_l = torch.roll(ranges, 1, dims=-1) >= rmax
            bad = (jl & jr) | (ranges >= rmax) | torch.where(
                jl, side_r, torch.where(jr, side_l, side_r | side_l))
            sc = torch.where(bad, torch.zeros_like(sc), sc)
            chans += [gx * sc, gy * sc]
        return torch.cat(chans, dim=-1) * free[..., None].to(dtype)

    cache = _texture_cache_path(tmap, cfg)
    if cache is not None and os.path.exists(cache):
        with np.load(cache) as z:
            rt = torch.as_tensor(z["rt"], dtype=dtype, device=device)
            valid = torch.as_tensor(z["valid"], device=device)
    else:
        batch_rows = max(1, _RAY_BUDGET.get(device.type, _RAY_BUDGET["cpu"])
                         // (wc * t_bins))
        rt_rows, valid_rows, n_edge = [], [], 0
        t_build = time.time()
        for r0 in range(0, hc, batch_rows):
            ranges, free, x, y = base_rows(r0, min(batch_rows, hc - r0))
            ew = ()
            if need_edge:
                e, w_, n = edge_channels(ranges, free, x, y)
                ew, n_edge = (e, w_), n_edge + n
            rt_rows.append(finish_rows(ranges, free, x, y, ew))
            valid_rows.append(free)
        print(f"[range-texture] {hc}x{wc} cells x {t_bins} bins marched in "
              f"{time.time() - t_build:.1f}s ({n_edge} edge bins)",
              file=sys.stderr, flush=True)
        rt = torch.cat(rt_rows, dim=0).reshape(hc * wc, cfg.rt_channels * t_bins)
        valid = torch.cat(valid_rows, dim=0).reshape(hc * wc)
        if cache is not None:
            os.makedirs(os.path.dirname(cache), exist_ok=True)
            tmp = cache + f".{os.getpid()}.tmp.npz"
            np.savez(tmp, rt=rt.cpu().numpy(), valid=valid.cpu().numpy())
            os.replace(tmp, cache)

    return RangeTexture(
        rt=rt.to(cfg.rt_tdtype), valid=valid,
        hc=torch.tensor(hc, dtype=torch.int32, device=device),
        wc=torch.tensor(wc, dtype=torch.int32, device=device),
        cell=torch.tensor(cell, dtype=dtype, device=device),
        **texture_constants(cfg, dtype, device))


def _cells_and_theta(pose, tables, tmap: TrackMap, rtex: RangeTexture,
                     cfg: SimConfig):
    """nearest1 cell of each pose: (rows, in-bounds weight, dx, dy), each
    (..., 1), where dx/dy is the pose's world offset from the cell centre."""
    if cfg.rt_spatial != "nearest1":
        raise NotImplementedError("only rt_spatial='nearest1' is ported "
                                  "(ROADMAP queue A: the other scan modes)")
    dtype = rtex.fmat.dtype
    oc, osn, ox, oy = tmap.orig_c, tmap.orig_s, tmap.orig_x, tmap.orig_y
    cell, hc, wc = rtex.cell, rtex.hc, rtex.wc
    x_t = pose[..., 0] - ox
    y_t = pose[..., 1] - oy
    gx = (x_t * oc + y_t * osn) / cell - 0.5
    gy = (-x_t * osn + y_t * oc) / cell - 0.5
    rr = torch.round(gy).to(torch.int32)[..., None]
    cc = torch.round(gx).to(torch.int32)[..., None]
    in_bounds = (rr >= 0) & (rr < hc) & (cc >= 0) & (cc < wc)
    rows = (torch.minimum(torch.clamp(rr, min=0), hc - 1) * wc
            + torch.minimum(torch.clamp(cc, min=0), wc - 1))
    cxr = (rr.to(dtype) + 0.5) * cell
    cxc = (cc.to(dtype) + 0.5) * cell
    cwx = cxc * oc - cxr * osn + ox
    cwy = cxc * osn + cxr * oc + oy
    dx = pose[..., 0:1] - cwx
    dy = pose[..., 1:2] - cwy
    return rows, in_bounds.to(dtype), dx.to(dtype), dy.to(dtype)


def mega_operands(pose, tables, tmap: TrackMap, rtex: RangeTexture,
                  cfg: SimConfig, noise, vel) -> tuple:
    """Arguments of ``scan_kernels.mega_edge_ttc`` for poses (E, A, 3),
    per-env noise rows (E, B) and speeds (E, A): the cell row, offsets and
    in-bounds weight of each car and its theta decomposition
    s = theta * T / 2pi = i_f + f_s, all flattened to K = E * A rows."""
    t_bins = cfg.rt_theta_bins
    dtype = rtex.fmat.dtype
    two_pi = 2.0 * math.pi
    rows, inb, dx, dy = _cells_and_theta(pose, tables, tmap, rtex, cfg)
    s = torch.remainder(pose[..., 2], two_pi) * (t_bins / two_pi)
    i_s = torch.floor(s)
    f_s = (s - i_s).to(dtype)
    i_i = i_s.to(torch.int32)
    # s can round up to exactly T (theta just under 2pi): wrap, don't clamp
    i_i = torch.where(i_i >= t_bins, i_i - t_bins, i_i)
    return (rtex.rt, rows.reshape(-1), dx.reshape(-1), dy.reshape(-1),
            f_s.reshape(-1), i_i.to(dtype).reshape(-1), inb.reshape(-1),
            vel.reshape(-1), rtex.fmat, rtex.fmat_sw, rtex.shift1, rtex.gmat,
            rtex.c_frac, noise, tables.beam_cosines, tables.side_distances,
            cfg.max_range, cfg.ttc_thresh, pose.shape[-2], t_bins,
            resolve_ew_dtype(cfg, dtype, pose.device))


def trace_fast_mxu(pose, tables, tmap: TrackMap, rtex: RangeTexture,
                   cfg: SimConfig, fused_ttc):
    """Noisy fast scan and wall-iTTC flag for poses (E, A, 3).

    ``fused_ttc = (noise (E, B), vel (E, A))``.  Returns (scan (E, A, B),
    hit (E, A) float 0/1); callers apply the ``vel != 0`` mask.  This is the
    megakernel branch of the JAX function: one launch from the texture rows
    to the finished scan."""
    check_supported(cfg)
    noise, vel = fused_ttc
    out, hit = scan_kernels.mega_edge_ttc(
        *mega_operands(pose, tables, tmap, rtex, cfg, noise, vel))
    batch = tuple(pose.shape[:-1])
    return out.reshape(batch + (cfg.num_beams,)), hit.reshape(batch)
