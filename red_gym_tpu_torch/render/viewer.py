"""Host-side visualization (out of the sim hot path).

PyTorch counterpart of ``red_gym_tpu/render/viewer.py``: the reference's
pyglet EnvRenderer (gym/f110_gym/envs/rendering.py:50-335) rebuilt on
matplotlib so that it works headless (Agg) as well as interactively: map
raster, car body polygons, lap-time/count caption with an FPS readout,
camera follow, pan, zoom and keys, and user draw callbacks.  The port's
states are batched (E, ...), so a frame draws env 0 of the batch; tensors
cross to the host with ``.cpu().numpy()``.  matplotlib is imported when a
Viewer is made, never at module import.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from red_gym_tpu_torch.ops.collision import get_vertices


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


class Viewer:
    """Stateful renderer fed from batched EnvState snapshots."""

    def __init__(self, env_params, cfg, figsize=(8, 8), follow: bool = True,
                 window: float = 15.0, map_idx: int = 0):
        import matplotlib.pyplot as plt

        self._plt = plt
        self.cfg = cfg
        self.follow = follow
        self.window = window
        self.fig, self.ax = plt.subplots(figsize=figsize)
        self._cars = []
        self._caption = None
        self._fps = None
        self._last_draw = None
        self._extra_artists = []
        self._state = None

        tmap = env_params.tmap
        pick = (lambda f: f[map_idx]) if tmap.occupancy.dim() == 3 else (lambda f: f)
        occ = _np(pick(tmap.occupancy))
        res = float(pick(tmap.resolution))
        ox, oy = float(pick(tmap.orig_x)), float(pick(tmap.orig_y))
        h, w = occ.shape
        self.ax.imshow(occ, cmap="gray", origin="lower",
                       extent=[ox, ox + w * res, oy, oy + h * res])
        self.ax.set_aspect("equal")
        self._veh = env_params.vehicle
        self._map_extent = (ox, ox + w * res, oy, oy + h * res)
        self._drag_from = None
        self._cids = []
        self.enable_interaction()

    # -- interactivity (reference rendering.py:163-227) -----------------------
    def enable_interaction(self):
        """Live camera controls mirroring the reference pyglet window:
        left-drag pans, the scroll wheel zooms about the cursor (bounded
        between 0.5 m and twice the map), and the 'f' key toggles the follow
        camera (any manual pan or zoom disengages it).  Safe on headless
        backends, where the events never fire."""
        if self._cids:
            return
        c = self.fig.canvas
        self._cids = [
            c.mpl_connect("button_press_event", self._on_press),
            c.mpl_connect("button_release_event", self._on_release),
            c.mpl_connect("motion_notify_event", self._on_motion),
            c.mpl_connect("scroll_event", self._on_scroll),
            c.mpl_connect("key_press_event", self._on_key),
        ]

    def disable_interaction(self):
        for cid in self._cids:
            self.fig.canvas.mpl_disconnect(cid)
        self._cids = []

    def _on_press(self, ev):
        if ev.inaxes is self.ax and ev.button == 1:
            self._drag_from = (ev.xdata, ev.ydata)

    def _on_release(self, ev):
        self._drag_from = None

    def _on_motion(self, ev):
        if (self._drag_from is None or ev.inaxes is not self.ax
                or ev.xdata is None):
            return
        x0, y0 = self._drag_from
        dx, dy = ev.xdata - x0, ev.ydata - y0
        xl, yl = self.ax.get_xlim(), self.ax.get_ylim()
        self.ax.set_xlim(xl[0] - dx, xl[1] - dx)
        self.ax.set_ylim(yl[0] - dy, yl[1] - dy)
        self.follow = False
        self.fig.canvas.draw_idle()

    def _on_scroll(self, ev):
        if ev.inaxes is not self.ax or ev.xdata is None:
            return
        factor = 0.9 if ev.button == "up" else 1.0 / 0.9
        xl, yl = self.ax.get_xlim(), self.ax.get_ylim()
        span = (xl[1] - xl[0]) * factor
        full = self._map_extent[1] - self._map_extent[0]
        if not (0.5 <= span <= 2.0 * full):
            return
        cx, cy = ev.xdata, ev.ydata
        self.ax.set_xlim(cx + (xl[0] - cx) * factor, cx + (xl[1] - cx) * factor)
        self.ax.set_ylim(cy + (yl[0] - cy) * factor, cy + (yl[1] - cy) * factor)
        self.follow = False
        self.fig.canvas.draw_idle()

    def _on_key(self, ev):
        if ev.key == "f":
            self.follow = not self.follow
            self.fig.canvas.draw_idle()

    # -- data feed -----------------------------------------------------------
    def update(self, env_state):
        """Show env 0 of a batched EnvState from the next draw on."""
        self._state = env_state

    # -- callback drawing API (SAL render_arrow compatibility) ----------------
    def draw_polyline(self, points, color="lime", lw=1.5):
        """Draw a world-frame polyline; cleared after the next frame."""
        pts = _np(points)
        (ln,) = self.ax.plot(pts[:, 0], pts[:, 1], color=color, lw=lw)
        self._extra_artists.append(ln)

    def draw_points(self, points, color="cornflowerblue", s=2):
        pts = _np(points)
        sc = self.ax.scatter(pts[:, 0], pts[:, 1], c=color, s=s)
        self._extra_artists.append(sc)

    # -- frame ---------------------------------------------------------------
    def draw(self, block: bool = False, save_path: str | None = None):
        import matplotlib.patches as mpatches

        for c in self._cars:
            c.remove()
        self._cars = []
        if self._state is None:
            return

        x = _np(self._state.x[0])
        length = float(self._veh.length.reshape(-1)[0])
        width = float(self._veh.width.reshape(-1)[0])
        colors = ["tab:red", "tab:blue", "tab:orange", "tab:green"]
        for i in range(x.shape[0]):
            pose = torch.from_numpy(np.array([x[i, 0], x[i, 1], x[i, 4]]))
            verts = get_vertices(pose, length, width).numpy()
            poly = mpatches.Polygon(verts, closed=True,
                                    color=colors[i % len(colors)])
            self.ax.add_patch(poly)
            self._cars.append(poly)

        lap_t = _np(self._state.lap_times[0])
        lap_c = _np(self._state.lap_counts[0])
        # render-rate readout (the reference EnvRenderer's pyglet FPSDisplay,
        # rendering.py:75): EWMA over wall-clock draw intervals
        now = time.monotonic()
        if self._last_draw is not None:
            inst = 1.0 / max(now - self._last_draw, 1e-6)
            self._fps = inst if self._fps is None else 0.9 * self._fps + 0.1 * inst
        self._last_draw = now
        fps_txt = f"  {self._fps:.0f} fps" if self._fps is not None else ""
        cap = f"t={float(self._state.current_time[0]):.2f}s  " \
              f"laps={lap_c.tolist()}  " \
              f"lap_times={np.round(lap_t, 2).tolist()}{fps_txt}"
        if self._caption is None:
            self._caption = self.ax.set_title(cap, fontsize=9)
        else:
            self._caption.set_text(cap)

        if self.follow:
            cx, cy = x[self.cfg.ego_idx, 0], x[self.cfg.ego_idx, 1]
            self.ax.set_xlim(cx - self.window, cx + self.window)
            self.ax.set_ylim(cy - self.window, cy + self.window)

        if save_path:
            self.fig.savefig(save_path, dpi=110)
        else:
            self.fig.canvas.draw_idle()
            if block:
                self._plt.pause(0.001)

        for a in self._extra_artists:
            a.remove()
        self._extra_artists = []

    def animate(self, states_history, save_path: str, fps: int = 30,
                stride: int = 1, callback=None):
        """Render a time-stacked batched EnvState (fields (T, E, ...), e.g.
        the states of a loop stacked with torch.stack) to an animated GIF, or
        MP4 when ``save_path`` ends in ".mp4".  ``callback(viewer, t)`` may
        add per-frame overlays through the draw_* API."""
        from matplotlib import animation

        n_frames = states_history.x.shape[0]

        def render_frame(t):
            self.update(type(states_history)(*(None if f is None else f[t]
                                               for f in states_history)))
            if callback is not None:
                callback(self, t)
            self.draw(save_path=None)
            return self._cars

        anim = animation.FuncAnimation(
            self.fig, render_frame, frames=range(0, n_frames, stride),
            interval=1000 / fps, blit=False)
        writer = (animation.FFMpegWriter(fps=fps) if save_path.endswith(".mp4")
                  else animation.PillowWriter(fps=fps))
        anim.save(save_path, writer=writer)
        return save_path

    def close(self):
        self._plt.close(self.fig)


def plot_trajectory(tmap, xs, ys, path: str, title: str, dpi: int = 120) -> None:
    """Write a PNG of the map raster with a trajectory (xs, ys) over it
    (``examples/waypoint_follow.py --render``), headless (Agg)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    occ = _np(tmap.occupancy)
    res = float(tmap.resolution)
    ox, oy = float(tmap.orig_x), float(tmap.orig_y)
    h, w = occ.shape
    fig = plt.figure(figsize=(8, 8))
    plt.imshow(occ, cmap="gray", origin="lower",
               extent=[ox, ox + w * res, oy, oy + h * res])
    plt.plot(_np(xs), _np(ys), "r-", lw=1)
    plt.title(title)
    fig.savefig(path, dpi=dpi)
    plt.close(fig)


def draw_track():
    """Click points on a 40 x 40 canvas, Enter to finish (reference
    src/MPC/MPC.py:17-33; ``examples/mpc_demo.py --draw``) -> (K, 2)
    float32.  Needs an interactive backend; raises SystemExit headless."""
    import matplotlib
    if matplotlib.get_backend().lower() == "agg" and not os.environ.get("MPLBACKEND"):
        raise SystemExit("--draw needs an interactive matplotlib backend (no display "
                         "found); pass --points x,y ... or drop --draw instead")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(8, 8))
    ax.set_title("Draw your racetrack.\nClick to add points; press Enter when finished.")
    ax.set_xlim(0, 40)
    ax.set_ylim(0, 40)
    pts = plt.ginput(n=-1, timeout=0, show_clicks=True)
    plt.close(fig)
    if len(pts) < 2:
        raise SystemExit("need at least 2 clicked points")
    return np.asarray(pts, np.float32)


def plot_mpc_strip(path, traj, horizon: int, out: str, dpi: int = 120) -> None:
    """Write the MPC demo's strip plot: the reference path and the tracked
    trajectory (``examples/mpc_demo.py --out``), headless (Agg)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(10, 4))
    plt.plot(path[:, 0], path[:, 1], "k--", label="reference path")
    plt.plot(traj[:, 0], traj[:, 1], "r-", label="MPC trajectory")
    plt.scatter(traj[::10, 0], traj[::10, 1], c="r", s=12)
    plt.legend()
    plt.title(f"on-device ADMM MPC, horizon {horizon}, |u|<=1")
    fig.savefig(out, dpi=dpi)
    plt.close(fig)


def animate_car(path, traj, out: str) -> None:
    """Rectangle-car playback along a trajectory, heading from the velocity
    vector (reference src/MPC/MPC.py:176-213; ``examples/mpc_demo.py
    --animate``), saved as GIF (pillow) or MP4 (ffmpeg), headless."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib import animation, transforms
    from matplotlib.patches import Rectangle

    fig, ax = plt.subplots(figsize=(8, 8))
    ax.set_xlim(path[:, 0].min() - 5, path[:, 0].max() + 5)
    ax.set_ylim(path[:, 1].min() - 5, path[:, 1].max() + 5)
    ax.set_aspect("equal")
    ax.set_title("MPC following the drawn track")
    ax.plot(path[:, 0], path[:, 1], "r--", label="track")
    ax.plot(traj[:, 0], traj[:, 1], "g-", label="car trajectory")
    ax.legend()
    car = Rectangle((-0.5, -0.25), 1.0, 0.5, fc="tab:blue", ec="black")
    ax.add_patch(car)
    vel = np.gradient(traj, axis=0)

    def frame(i):
        th = np.arctan2(vel[i, 1], vel[i, 0]) if np.hypot(*vel[i]) > 1e-3 else 0.0
        car.set_transform(transforms.Affine2D().rotate(th)
                          .translate(traj[i, 0], traj[i, 1]) + ax.transData)
        return (car,)

    ani = animation.FuncAnimation(fig, frame, frames=len(traj), blit=True, interval=100)
    ani.save(out, writer="pillow" if out.endswith(".gif") else "ffmpeg", fps=10)
    plt.close(fig)
