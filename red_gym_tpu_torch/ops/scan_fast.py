"""Fast lidar: a precomputed range texture R(x, y, theta) plus one kernel.

PyTorch counterpart of ``red_gym_tpu/ops/scan_fast.py``.  The texture is
marched once per map with the exact sphere march (``build_range_texture``);
at every step each car reads its texture rows and a kernel turns them into
the scan.

Ported here: the compact texture build (base march, edge localization on
the edge bins only, channel assembly), its disk cache, and the runtime of
the linear-theta fast scan in two branches:

- the megakernel (``ops/scan_kernels.py``) for the library default
  (nearest1 cell, edge + grad channels, float32), in every variant: the
  opponent ray cast in the kernel (``use_fused_opp_mega``), the resident
  noise pool of ``noise_mode="pool_rot"``, and the per-row operands
  computed by the pre-scan state kernel (``pregeo``,
  ``ops/state_kernels.py``);
- the unfused branch for every other linear-theta config (nearest1,
  nearest or bilinear cells; occlusion edge, snap or off; grad channels on
  or off): the torch prep chain (``rolled_spectra``: row gather, spatial
  blend, packed-DFT integer roll), then one epilogue kernel of
  ``ops/blend_kernels.py`` (edge render with or without noise, iTTC and
  opponents, or the plain 3-tap blend) or the eager snap epilogue.

``scan_interp="spectral"``, the exact scan, the float64 fast scan and
``scan_backend="xla"`` raise ``NotImplementedError`` naming the ROADMAP
item that ports them.
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
from red_gym_tpu_torch.ops import blend_kernels, scan_kernels
from red_gym_tpu_torch.ops import scan as scan_ops

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
    """Raise NotImplementedError for a config whose scan path is not ported,
    and ValueError for a kernel knob set "on" outside its kernel's scope.

    The port runs the linear-theta fast scan in float32, through the
    megakernel or the unfused branch.  Each other path names its ROADMAP
    item."""
    if cfg.scan_mode != "fast":
        raise NotImplementedError(
            "scan_mode='exact' at step time is not ported yet "
            "(ROADMAP queue A: the exact scan)")
    if cfg.scan_interp != "linear":
        raise NotImplementedError(
            "scan_interp='spectral' needs TPU kernel 5, theta_spectral_ttc, "
            "which is not ported yet (ROADMAP queue B: kernel 5)")
    if cfg.dtype != "float32":
        raise NotImplementedError(
            "the fast scan runs in float32 only: its kernels take float32 "
            "(ROADMAP queue A: the float64 fast scan)")
    if cfg.scan_backend == "xla":
        raise NotImplementedError(
            "scan_backend='xla' names the TPU compiler's path; the port has "
            "only its kernels (use 'auto' or 'pallas')")
    # the env step resolves these knobs as below; an "on" out of scope
    # raises here, before the texture is built
    use_fused_ttc(cfg)
    if not use_megakernel(cfg):
        use_fused_opp(cfg)


def use_megakernel(cfg: SimConfig) -> bool:
    """Resolution of cfg.scan_megakernel (JAX scan_fast.use_megakernel):
    the one-launch megakernel covers the library-default pipeline only
    (fast, nearest1, linear theta, edge + grad channels, float32).  "auto"
    resolves by that scope alone; "on" outside it raises ValueError.  The
    TPU kernel's row-tile limit on the agent count does not apply."""
    if cfg.scan_megakernel == "off":
        return False
    ok = (cfg.scan_mode == "fast" and cfg.rt_spatial == "nearest1"
          and cfg.scan_interp == "linear" and cfg.rt_eff_occlusion == "edge"
          and cfg.rt_grad and cfg.dtype == "float32")
    if cfg.scan_megakernel == "on" and not ok:
        raise ValueError(
            "scan_megakernel='on' needs scan_mode='fast', "
            "rt_spatial='nearest1', scan_interp='linear', "
            "rt_occlusion='edge', rt_grad=True and dtype='float32'")
    return ok


def use_fused_ttc(cfg: SimConfig) -> bool:
    """Resolution of cfg.fuse_scan_ttc (JAX scan_fast.use_fused_ttc) for
    the unfused branch: noise add and wall iTTC ride the edge-render kernel
    (``blend_kernels.theta_shuffle_blend_edge_ttc``).  In scope: the fast
    scan with occlusion "edge".  "auto" resolves by scope alone; "on"
    outside it raises ValueError.  The TPU kernel's row-tile limit on the
    agent count does not apply."""
    if cfg.fuse_scan_ttc == "off":
        return False
    ok = cfg.scan_mode == "fast" and cfg.rt_eff_occlusion == "edge"
    if cfg.fuse_scan_ttc == "on" and not ok:
        raise ValueError(
            "fuse_scan_ttc='on' needs scan_mode='fast' and rt_occlusion='edge'")
    return ok


def use_fused_opp_mega(cfg: SimConfig) -> bool:
    """True iff the opponent ray cast rides the megakernel (JAX
    scan_fast.use_fused_opp_mega): the megakernel resolves on, and
    ``fuse_scan_opp`` is not "off"; off for fewer than two agents even
    under "on".  On a CUDA device that is the kernel, on the CPU its plain
    twin."""
    return (cfg.fuse_scan_opp != "off" and cfg.num_agents >= 2
            and use_megakernel(cfg))


def use_fused_opp(cfg: SimConfig) -> bool:
    """True iff the opponent ray cast rides the fused edge epilogue of the
    unfused branch (JAX scan_fast.use_fused_opp,
    ``blend_kernels.theta_shuffle_blend_edge_ttc_opp``): needs the fused
    edge + iTTC path (``use_fused_ttc``) and two agents or more.  "auto"
    resolves by scope; "on" outside it raises ValueError."""
    if cfg.fuse_scan_opp == "off" or cfg.num_agents < 2:
        return False
    if not use_fused_ttc(cfg):
        if cfg.fuse_scan_opp == "on":
            raise ValueError(
                "fuse_scan_opp='on' needs the fused edge + iTTC path "
                "(fuse_scan_ttc resolving on, rt_occlusion='edge') and "
                "num_agents >= 2")
        return False
    return True


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
    """Texture cells of each pose (JAX scan_fast._cells_and_theta): (rows,
    wgt, dx, dy), each (..., K), with K = 1 rounded cell (nearest1) or the
    4 floor cells (bilinear, nearest) in the order (r0, c0), (r0, c0 + 1),
    (r0 + 1, c0), (r0 + 1, c0 + 1).  wgt is 1 (nearest1) or the bilinear
    weight, times the in-bounds flag; rows are clamped into the grid; dx/dy
    is the pose's world offset from each cell centre."""
    dtype = rtex.fmat.dtype
    oc, osn, ox, oy = tmap.orig_c, tmap.orig_s, tmap.orig_x, tmap.orig_y
    cell, hc, wc = rtex.cell, rtex.hc, rtex.wc
    x_t = pose[..., 0] - ox
    y_t = pose[..., 1] - oy
    gx = (x_t * oc + y_t * osn) / cell - 0.5
    gy = (-x_t * osn + y_t * oc) / cell - 0.5
    if cfg.rt_spatial == "nearest1":
        rr = torch.round(gy).to(torch.int32)[..., None]
        cc = torch.round(gx).to(torch.int32)[..., None]
        wgt = torch.ones(rr.shape, dtype=dtype, device=pose.device)
    else:
        c0 = torch.floor(gx).to(torch.int32)
        r0 = torch.floor(gy).to(torch.int32)
        fx = (gx - c0.to(gx.dtype)).to(dtype)
        fy = (gy - r0.to(gy.dtype)).to(dtype)
        rr = torch.stack([r0, r0, r0 + 1, r0 + 1], dim=-1)
        cc = torch.stack([c0, c0 + 1, c0, c0 + 1], dim=-1)
        wgt = torch.stack([(1 - fy) * (1 - fx), (1 - fy) * fx,
                           fy * (1 - fx), fy * fx], dim=-1).to(dtype)
    in_bounds = (rr >= 0) & (rr < hc) & (cc >= 0) & (cc < wc)
    rows = (torch.minimum(torch.clamp(rr, min=0), hc - 1) * wc
            + torch.minimum(torch.clamp(cc, min=0), wc - 1))
    cxr = (rr.to(dtype) + 0.5) * cell
    cxc = (cc.to(dtype) + 0.5) * cell
    cwx = cxc * oc - cxr * osn + ox
    cwy = cxc * osn + cxr * oc + oy
    dx = pose[..., 0:1] - cwx
    dy = pose[..., 1:2] - cwy
    return rows, wgt * in_bounds.to(dtype), dx.to(dtype), dy.to(dtype)


def _cell_size(rtex: RangeTexture, dtype) -> torch.Tensor:
    """Texture cell size [m] (JAX scan_fast._cell_size, one map)."""
    return rtex.cell.to(dtype)


def row_scalars(pose, tmap: TrackMap, rtex: RangeTexture, cfg: SimConfig,
                vel):
    """The megakernel's per-row operands of poses (..., 3) and speeds (...):
    the texture row (...) int32 of the nearest1 cell and the packed scalars
    (..., 8) [dx, dy, f_s, i_f, inb, vel, 0, 0], where dx/dy is the offset
    from the cell centre and s = theta * T / 2pi = i_f + f_s."""
    t_bins = cfg.rt_theta_bins
    dtype = rtex.fmat.dtype
    two_pi = 2.0 * math.pi
    rows, inb, dx, dy = _cells_and_theta(pose, None, tmap, rtex, cfg)
    s = torch.remainder(pose[..., 2], two_pi) * (t_bins / two_pi)
    i_s = torch.floor(s)
    f_s = (s - i_s).to(dtype)
    i_i = i_s.to(torch.int32)
    # s can round up to exactly T (theta just under 2pi): wrap, don't clamp
    i_i = torch.where(i_i >= t_bins, i_i - t_bins, i_i)
    zero = torch.zeros_like(f_s)
    scal = torch.stack([dx[..., 0], dy[..., 0], f_s, i_i.to(dtype), inb[..., 0],
                        vel.to(dtype), zero, zero], dim=-1)
    return rows[..., 0], scal


def mega_operands(pose, tables, tmap: TrackMap, rtex: RangeTexture,
                  cfg: SimConfig, noise, vel, opp=None, pool_off=None,
                  pregeo=None) -> dict:
    """Keyword arguments of ``scan_kernels.mega_edge_ttc`` for poses
    (E, A, 3) and speeds (E, A), flattened to K = E * A rows.

    ``noise`` is the (E, B) slab, or with ``pool_off`` (1,) int32 the
    (rows, B) pool of ``noise_mode="pool_rot"``; ``opp`` (E, A, 10(A-1))
    adds the opponent cast; ``pregeo`` = (rows, scal) from the state kernel
    replaces the per-row prep (``row_scalars``)."""
    if pregeo is None:
        pregeo = row_scalars(pose, tmap, rtex, cfg, vel)
    rows, scal = pregeo
    ops = dict(
        rt=rtex.rt, rows=rows.reshape(-1), scal=scal.reshape(-1, 8),
        fmat=rtex.fmat, fmat_sw=rtex.fmat_sw, shift1=rtex.shift1,
        gmat=rtex.gmat, c_frac=rtex.c_frac, noise=noise,
        cosines=tables.beam_cosines, side_dist=tables.side_distances,
        max_range=cfg.max_range, ttc_thresh=cfg.ttc_thresh,
        agents_per_env=pose.shape[-2], t_bins=cfg.rt_theta_bins,
        ew_dtype=resolve_ew_dtype(cfg, rtex.fmat.dtype, pose.device),
        pool_off=pool_off)
    if opp is not None:
        ops.update(sines=tables.beam_sines, opp=opp.reshape(-1, opp.shape[-1]))
    return ops


class Spectra(NamedTuple):
    """Operands of the unfused branch's epilogue (``rolled_spectra``)."""

    spec_r: torch.Tensor  # (..., T), or (..., 3, T) [range, e, w] with edge
    f_s: torch.Tensor     # (...,) fractional theta bin of the heading
    wsum: torch.Tensor    # (...,) summed cell weight; 0 reads an empty scan
    i_i: torch.Tensor     # (...,) int32 integer theta bin of the heading


def rolled_spectra(pose, tmap: TrackMap, rtex: RangeTexture,
                   cfg: SimConfig) -> Spectra:
    """The torch prep chain of the unfused branch (JAX trace_fast_mxu
    :971-1108) for poses (..., 3): gather the cells' texture rows, drop
    occupied cells (column 0 is 0), pick the best cell ("nearest"), fold
    the gradient channels, re-bear the occlusion edges from the pose (exact
    corner parallax), blend the cells (and snap bins whose valid cells
    disagree by more than the edge threshold), then the packed rfft
    ``blended @ fmat`` and the exact integer roll by the heading's theta
    bin, with phases from integer modular arithmetic.  float32 matrix
    products, so on a CUDA device TF32 must be off."""
    t_bins = cfg.rt_theta_bins
    f_bins = t_bins // 2 + 1
    dtype = rtex.fmat.dtype
    two_pi = 2.0 * math.pi
    eff_occ = cfg.rt_eff_occlusion
    rows, wgt, dx, dy = _cells_and_theta(pose, None, tmap, rtex, cfg)

    s = torch.remainder(pose[..., 2], two_pi) * (t_bins / two_pi)
    i_s = torch.floor(s)
    f_s = (s - i_s).to(dtype)
    i_i = i_s.to(torch.int32)
    # s can round up to exactly T (theta just under 2pi): wrap, don't clamp
    i_i = torch.where(i_i >= t_bins, i_i - t_bins, i_i)

    rows_v = rtex.rt[rows.long()]                            # (..., K, C*T)
    rr = rows_v[..., :t_bins]
    # valid rows are >= 1 mm everywhere (build-time floor), occupied cells
    # all zero: column 0 alone carries validity
    wgt = wgt * (rr[..., 0] > 0).to(dtype)
    k_cells = wgt.shape[-1]
    if cfg.rt_spatial == "nearest":
        # the single best valid cell: a real marched scan from one pose
        best = torch.argmax(wgt, dim=-1)
        wgt = (torch.nn.functional.one_hot(best, k_cells).to(dtype)
               * (wgt.amax(dim=-1, keepdim=True) > 0).to(dtype))
    wsum = wgt.sum(dim=-1, keepdim=True)
    wnorm = wgt / torch.clamp(wsum, min=1e-12)

    off = t_bins
    e_rows = w_rows = None
    rr_c = rr.to(dtype)
    if eff_occ == "edge":
        e_rows = rows_v[..., off:off + t_bins].to(dtype)
        w_rows = rows_v[..., off + t_bins:off + 2 * t_bins].to(dtype)
        off += 2 * t_bins
    if cfg.rt_grad:
        gxr = rows_v[..., off:off + t_bins].to(dtype)
        gyr = rows_v[..., off + t_bins:off + 2 * t_bins].to(dtype)
        rr_c = torch.clamp(rr_c + dx[..., None] * gxr + dy[..., None] * gyr,
                           0.0, cfg.max_range)
    if eff_occ == "edge":
        # the visibility edge is a fixed world point (the occluding
        # corner): rebuild it from the stored sub-bin angle and the
        # foreground range, re-bear it from the pose; smooth pairs (w = 1)
        # keep e = 0.5
        dth = two_pi / t_bins
        lane = torch.arange(t_bins, dtype=dtype, device=pose.device)
        theta_e = (lane + e_rows) * dth
        r_fore = torch.clamp(torch.minimum(rr, torch.roll(rr, -1, dims=-1))
                             .to(dtype), min=0.05)
        ex = r_fore * torch.cos(theta_e) - dx[..., None]
        ey = r_fore * torch.sin(theta_e) - dy[..., None]
        dbeta = torch.atan2(ey, ex) - theta_e
        dbeta = dbeta - torch.round(dbeta / two_pi) * two_pi
        e_rows = e_rows + (1.0 - w_rows) * dbeta / dth

    def blend(v):
        return (v * wnorm[..., :, None]).sum(dim=-2)          # (..., T)

    blended = blend(rr_c)
    e_b = blend(e_rows) if e_rows is not None else None
    w_b = blend(w_rows) if w_rows is not None else None
    if eff_occ != "off" and k_cells > 1:
        # cells across a visibility edge would mix foreground and
        # background: where the valid cells disagree by more than the edge
        # threshold, take the max-weight cell's bin instead of the blend
        ok = (wgt > 0)[..., None]
        big = 1e9
        vmax = torch.where(ok, rr_c, torch.full_like(rr_c, -big)).amax(dim=-2)
        vmin = torch.where(ok, rr_c, torch.full_like(rr_c, big)).amin(dim=-2)
        snap = (vmax - vmin) > cfg.rt_occlusion_cells * _cell_size(rtex, dtype)
        best = torch.argmax(wgt, dim=-1)[..., None, None]
        best = best.expand(best.shape[:-1] + (t_bins,))

        def take_best(v):
            return torch.take_along_dim(v, best, dim=-2)[..., 0, :]

        blended = torch.where(snap, take_best(rr_c), blended)
        if e_b is not None:
            e_b = torch.where(snap, take_best(e_rows), e_b)
            w_b = torch.where(snap, take_best(w_rows), w_b)

    if e_b is not None:
        blended = torch.stack([blended, e_b, w_b], dim=-2)     # (..., 3, T)
    spec = torch.matmul(blended, rtex.fmat)
    re, im = spec[..., :f_bins], spec[..., f_bins:]
    freqs = torch.arange(f_bins, dtype=torch.int32, device=pose.device)
    m = torch.remainder(i_i[..., None] * freqs, t_bins)
    phi = m.to(dtype) * (two_pi / t_bins)                      # (..., F)
    cphi, sphi = torch.cos(phi), torch.sin(phi)
    if e_b is not None:
        cphi, sphi = cphi[..., None, :], sphi[..., None, :]
    zero = torch.zeros_like(re[..., 0:1])
    im_full = torch.cat([zero, im, zero], dim=-1)              # (..., F)
    re_r = re * cphi - im_full * sphi
    im_r = (re * sphi + im_full * cphi)[..., 1:-1]
    spec_r = torch.cat([re_r, im_r], dim=-1)                   # (..., [3,] T)
    return Spectra(spec_r, f_s, wsum[..., 0], i_i)


def snap_epilogue(spec_r, f_s, wsum, gmat, c_frac, max_range: float,
                  thresh) -> torch.Tensor:
    """The eager epilogue of ``rt_occlusion="snap"`` (JAX trace_fast_mxu
    :1193-1226; it has no TPU kernel): spec_r (K, T) @ gmat gives the three
    shuffled taps; the active pair (0, 1) or (1, 2) is lerped, or snapped
    to the nearer bin where the pair differs by more than ``thresh``;
    mask, clip.  f_s, wsum (K,), c_frac (B,) -> (K, B)."""
    b_n = c_frac.shape[0]
    g = torch.matmul(spec_r, gmat)
    g0, g1, g2 = g[..., :b_n], g[..., b_n:2 * b_n], g[..., 2 * b_n:]
    alpha = f_s[..., None] + c_frac
    frac = alpha - torch.floor(alpha)
    lt = alpha < 1.0
    ga = torch.where(lt, g0, g1)
    gb = torch.where(lt, g1, g2)
    lerp = ga + frac * (gb - ga)
    out = torch.where(torch.abs(gb - ga) > thresh,
                      torch.where(frac < 0.5, ga, gb), lerp)
    out = torch.where(wsum[..., None] > 0, out, torch.zeros_like(out))
    return torch.clamp(out, 0.0, max_range)


def _check_fp32_matmul(device) -> None:
    """The unfused branch's float32 matrix products must not run in TF32."""
    if torch.device(device).type == "cuda" and (
            torch.get_float32_matmul_precision() != "highest"):
        raise RuntimeError(
            "the fast scan needs full float32 matrix products on CUDA: set "
            "torch.backends.cuda.matmul.allow_tf32 = False (float32 matmul "
            f"precision is {torch.get_float32_matmul_precision()!r})")


def trace_fast_mxu(pose, tables, tmap: TrackMap, rtex: RangeTexture,
                   cfg: SimConfig, fused_ttc=None, opp=None, pool_off=None,
                   pregeo=None):
    """Fast scan for poses (E, A, 3) (JAX scan_fast.trace_fast_mxu).

    ``fused_ttc = (noise, vel (E, A))`` asks for the noisy scan and the
    wall-iTTC flag: returns (scan (E, A, B), hit (E, A) float 0/1), and
    callers apply the ``vel != 0`` mask.  Without it, returns the clean
    scan (E, A, B).  ``opp`` (E, A, 10(A-1)) adds the opponent ray cast to
    a fused call.

    With ``fused_ttc`` and ``use_megakernel``, this is one megakernel
    launch from the texture rows to the finished scan; noise as in
    ``mega_operands``, and ``pool_off`` and ``pregeo`` select its
    variants.  Otherwise the prep chain (``rolled_spectra``) runs, then one
    epilogue: the edge render with noise and iTTC (kernel 3) and
    opponents (kernel 4), the edge render alone (kernel 6), the plain 3-tap
    blend for occlusion "off" (kernel 7), or the eager snap epilogue.  The
    noise is then the (E, B) slab of one row per env."""
    check_supported(cfg)
    batch = tuple(pose.shape[:-1])
    b_n = cfg.num_beams
    if fused_ttc is not None and use_megakernel(cfg):
        noise, vel = fused_ttc
        out, hit = scan_kernels.mega_edge_ttc(**mega_operands(
            pose, tables, tmap, rtex, cfg, noise, vel, opp, pool_off, pregeo))
        return out.reshape(batch + (b_n,)), hit.reshape(batch)
    if pregeo is not None or pool_off is not None:
        raise ValueError("pregeo and pool_off need the megakernel branch "
                         "(scan_megakernel resolving on, and fused_ttc)")
    if opp is not None and fused_ttc is None:
        raise ValueError("opp needs fused_ttc: the opponent cast rides the "
                         "fused edge epilogue")
    eff_occ = cfg.rt_eff_occlusion
    if fused_ttc is not None and eff_occ != "edge":
        raise ValueError("fused_ttc needs rt_occlusion='edge': only the edge "
                         "render has a fused noise + iTTC epilogue")
    _check_fp32_matmul(pose.device)
    t_bins = cfg.rt_theta_bins
    sp = rolled_spectra(pose, tmap, rtex, cfg)
    f_s, wsum = sp.f_s.reshape(-1), sp.wsum.reshape(-1)
    if eff_occ == "edge":
        spec = sp.spec_r.reshape(-1, 3, t_bins)
        ew_dtype = resolve_ew_dtype(cfg, rtex.fmat.dtype, pose.device)
        edge = (spec[:, 0], spec[:, 1], spec[:, 2], f_s, wsum)
        if fused_ttc is None:
            out = blend_kernels.theta_shuffle_blend_edge(
                *edge, rtex.gmat, rtex.c_frac, cfg.max_range, ew_dtype)
            return out.reshape(batch + (b_n,))
        noise, vel = fused_ttc
        tail = dict(max_range=cfg.max_range, ttc_thresh=cfg.ttc_thresh,
                    agents_per_env=pose.shape[-2], ew_dtype=ew_dtype)
        if opp is None:
            out, hit = blend_kernels.theta_shuffle_blend_edge_ttc(
                *edge, vel.reshape(-1), rtex.gmat, rtex.c_frac, noise,
                tables.beam_cosines, tables.side_distances, **tail)
        else:
            out, hit = blend_kernels.theta_shuffle_blend_edge_ttc_opp(
                *edge, vel.reshape(-1), rtex.gmat, rtex.c_frac, noise,
                tables.beam_cosines, tables.beam_sines, tables.side_distances,
                opp.reshape(-1, opp.shape[-1]), **tail)
        return out.reshape(batch + (b_n,)), hit.reshape(batch)
    spec = sp.spec_r.reshape(-1, t_bins)
    if eff_occ == "off":
        out = blend_kernels.theta_shuffle_blend(
            spec, f_s, wsum, rtex.gmat, rtex.c_frac, cfg.max_range)
    else:
        out = snap_epilogue(spec, f_s, wsum, rtex.gmat, rtex.c_frac,
                            cfg.max_range,
                            cfg.rt_occlusion_cells * _cell_size(rtex, spec.dtype))
    return out.reshape(batch + (b_n,))
