"""Standalone MPC demo: track a path with the batched ADMM QP on the device.

PyTorch counterpart of ``examples/mpc_demo.py`` (reference demo
src/MPC/MPC.py:17-213): the path comes from ``--points``, ``--draw`` (click
points on a canvas, Enter to finish) or a built-in squiggle;
``agents.mpc.mpc_controller`` solves the receding-horizon box-QPs on the
device; the double integrator is replayed on the host under the control
history and the mean nearest-waypoint tracking error printed, as the JAX
script prints it.

The strip plot (``--out``), the car playback (``--animate``, GIF/MP4) and
``--draw`` are ``render.viewer``'s and need matplotlib; without it they
stop with a ``SystemExit`` naming it, as JAX's ``--draw`` does headless.  Where the JAX script always
writes its strip plot (to /tmp), this one writes it only where ``--out``
names a file.

Usage:
    python -m red_gym_tpu_torch.examples.mpc_demo [--points x0,y0 x1,y1 ...]
        [--out mpc.png] [--animate mpc.gif] [--device cuda]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from red_gym_tpu_torch.agents import mpc
from red_gym_tpu_torch.config import resolve_device
from red_gym_tpu_torch.render import viewer


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=str, default="",
                    help="write the strip plot to this png (needs matplotlib)")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--velocity", type=float, default=2.0)
    ap.add_argument("--draw", action="store_true",
                    help="draw the track interactively (click points, Enter; needs "
                         "matplotlib and a display)")
    ap.add_argument("--points", type=str, nargs="*", help="track waypoints as x,y pairs")
    ap.add_argument("--animate", type=str, default=None,
                    help="also write an animated car playback (gif/mp4; needs "
                         "matplotlib)")
    ap.add_argument("--device", type=str, default="cuda")
    return ap.parse_args(argv)


def _plotting(flag: str, fn, *args):
    """``fn(*args)`` of ``render.viewer``; without matplotlib a SystemExit
    naming it and ``flag``."""
    try:
        return fn(*args)
    except ImportError as e:
        if (e.name or "").split(".")[0] != "matplotlib":
            raise
        raise SystemExit(f"{flag} needs matplotlib, which is not installed; "
                         f"drop {flag}") from None


def default_path() -> np.ndarray:
    """The built-in squiggle (a stand-in for drawing)."""
    t = np.linspace(0, 3 * np.pi, 24)
    return np.stack([t, 1.5 * np.sin(t)], axis=1).astype(np.float32)


def replay(path, u_hist, dt: float) -> np.ndarray:
    """The double integrator from path[0] at rest under ``u_hist`` (T, 2)
    -> positions (T + 1, 2)."""
    A = np.array([[1, 0, dt, 0], [0, 1, 0, dt], [0, 0, 1, 0], [0, 0, 0, 1]])
    B = np.array([[0.5 * dt**2, 0], [0, 0.5 * dt**2], [dt, 0], [0, dt]])
    x = np.array([path[0, 0], path[0, 1], 0.0, 0.0])
    traj = [x[:2].copy()]
    for u in u_hist:
        x = A @ x + B @ u
        traj.append(x[:2].copy())
    return np.array(traj)


def tracking_error(path, traj) -> float:
    """Mean nearest-waypoint distance of the trajectory."""
    return float(np.linalg.norm(traj[:, None, :] - path[None, :, :], axis=-1)
                 .min(axis=1).mean())


def main(argv=None):
    """-> (path (K, 2), control history (steps, 2), trajectory, error)."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    if args.draw:
        path = _plotting("--draw", viewer.draw_track)
    elif args.points:
        path = np.asarray([[float(v) for v in p.split(",")] for p in args.points],
                          np.float32)
    else:
        path = default_path()

    cfg = mpc.default_mpc_config(torch.float32)
    dev = lambda t: t.to(device)  # noqa: E731
    u_hist = mpc.mpc_controller(
        torch.as_tensor(path, device=device)[None],
        torch.tensor(args.velocity, dtype=torch.float32, device=device),
        dev(cfg.timestep), dev(cfg.Q), dev(cfg.R), dev(cfg.Qf),
        total_steps=args.steps, horizon=cfg.horizon)[0].cpu().numpy()
    traj = replay(path, u_hist, float(cfg.timestep))
    err = tracking_error(path, traj)
    if args.out:
        _plotting("--out", viewer.plot_mpc_strip, path, traj, cfg.horizon, args.out)
        print(f"wrote {args.out}; mean nearest-waypoint error {err:.3f} m")
    else:
        print(f"mean nearest-waypoint error {err:.3f} m")
    if args.animate:
        _plotting("--animate", viewer.animate_car, path, traj, args.animate)
        print(f"wrote {args.animate}")
    return path, u_hist, traj, err


if __name__ == "__main__":
    main()
