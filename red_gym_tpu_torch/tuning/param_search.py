"""Population-based vehicle/controller parameter search (CMA-ES).

PyTorch counterpart of ``red_gym_tpu/tuning/param_search.py``.  The
reference's experiment config reserves bounds for [mass, lf, tlad, vgain]
and a CMA optimizer with popsize/budget (reference:
examples/config_example_map.yaml:24-43, optim_method 'CMA').  The whole
population races in one batched rollout: candidates are the env rows of
one batch, each with its own ``VehicleParams`` (leaves of shape (P, 1),
broadcast against the (P, A) cars) and its own pure-pursuit (tlad, vgain,
wheelbase = lf + lr), so a generation is one rollout of P envs on the
device.  CMA-ES itself is a small numpy update on the host, the JAX
package's code, so the same seed asks the same candidates bit for bit.

The rollout runs ``env.step`` once a step for all candidates: with the
default exact scan, the eager pre-scan chain, the march kernel
(``ops/march_kernels.march_beams``) and the eager tail.  Per-env vehicle
parameters are out of the state kernel's scope, so no state kernel runs,
as in JAX, whose evaluator has no state kernel under vmap either.
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence

import numpy as np
import torch

from red_gym_tpu_torch import env as envlib
from red_gym_tpu_torch.agents import pure_pursuit as pp
from red_gym_tpu_torch.config import SimConfig, VehicleParams, resolve_device


class CMAES:
    """Minimal (mu/mu_w, lambda) CMA-ES with box constraints by clipping.

    Standard rank-one + rank-mu covariance adaptation and cumulative
    step-size control, on the host in numpy (the search dimension is tiny;
    the fitness runs on the device through the batched evaluator)."""

    def __init__(self, x0, sigma0: float, popsize: int, seed: int = 0,
                 bounds=None):
        self.n = len(x0)
        self.m = np.asarray(x0, dtype=np.float64).copy()
        self.sigma = float(sigma0)
        self.lam = int(popsize)
        self.rng = np.random.default_rng(seed)
        self.bounds = None if bounds is None else np.asarray(bounds, np.float64)

        n, lam = self.n, self.lam
        self.mu = lam // 2
        w = np.log(self.mu + 0.5) - np.log(np.arange(1, self.mu + 1))
        self.w = w / w.sum()
        self.mu_eff = 1.0 / np.sum(self.w ** 2)

        self.c_sigma = (self.mu_eff + 2) / (n + self.mu_eff + 5)
        self.d_sigma = (1 + 2 * max(0.0, np.sqrt((self.mu_eff - 1) / (n + 1)) - 1)
                        + self.c_sigma)
        self.cc = (4 + self.mu_eff / n) / (n + 4 + 2 * self.mu_eff / n)
        self.c1 = 2 / ((n + 1.3) ** 2 + self.mu_eff)
        self.cmu = min(1 - self.c1,
                       2 * (self.mu_eff - 2 + 1 / self.mu_eff)
                       / ((n + 2) ** 2 + self.mu_eff))
        self.chi_n = np.sqrt(n) * (1 - 1 / (4 * n) + 1 / (21 * n * n))

        self.pc = np.zeros(n)
        self.ps = np.zeros(n)
        self.C = np.eye(n)
        self.gen = 0
        self.best_x = self.m.copy()
        self.best_f = np.inf
        self._z = None

    def ask(self) -> np.ndarray:
        """Sample a (popsize, n) candidate matrix."""
        vals, vecs = np.linalg.eigh(self.C)
        vals = np.maximum(vals, 1e-20)
        self._bd = vecs * np.sqrt(vals)                  # B @ diag(D)
        self._inv_sqrt = (vecs / np.sqrt(vals)) @ vecs.T  # C^{-1/2}
        self._z = self.rng.standard_normal((self.lam, self.n))
        x = self.m + self.sigma * self._z @ self._bd.T
        if self.bounds is not None:
            x = np.clip(x, self.bounds[:, 0], self.bounds[:, 1])
        return x

    def tell(self, xs: np.ndarray, fs: np.ndarray) -> None:
        order = np.argsort(fs)
        if fs[order[0]] < self.best_f:
            self.best_f = float(fs[order[0]])
            self.best_x = xs[order[0]].copy()

        xs_sel = xs[order[: self.mu]]
        m_old = self.m
        self.m = self.w @ xs_sel
        y = (self.m - m_old) / self.sigma

        self.ps = ((1 - self.c_sigma) * self.ps
                   + np.sqrt(self.c_sigma * (2 - self.c_sigma) * self.mu_eff)
                   * (self._inv_sqrt @ y))
        self.gen += 1
        denom = np.sqrt(1 - (1 - self.c_sigma) ** (2 * self.gen))
        h_sigma = (np.linalg.norm(self.ps) / denom
                   < (1.4 + 2 / (self.n + 1)) * self.chi_n)
        self.pc = ((1 - self.cc) * self.pc
                   + h_sigma * np.sqrt(self.cc * (2 - self.cc) * self.mu_eff) * y)

        ys = (xs_sel - m_old) / self.sigma
        rank_mu = (self.w[:, None, None] * (ys[:, :, None] * ys[:, None, :])).sum(0)
        self.C = ((1 - self.c1 - self.cmu) * self.C
                  + self.c1 * (np.outer(self.pc, self.pc)
                               + (1 - h_sigma) * self.cc * (2 - self.cc) * self.C)
                  + self.cmu * rank_mu)
        self.C = (self.C + self.C.T) / 2
        self.sigma *= np.exp((self.c_sigma / self.d_sigma)
                             * (np.linalg.norm(self.ps) / self.chi_n - 1))


# field order of a candidate vector (reference config's varied params)
SEARCH_FIELDS = ("m", "lf", "tlad", "vgain")
DEFAULT_BOUNDS = {  # reference config_example_map.yaml:24-35
    "m": (3.0, 4.0),
    "lf": (0.147, 0.170),
    "tlad": (0.2, 5.0),
    "vgain": (0.5, 1.5),
}


def population_params(cfg: SimConfig, params0: envlib.EnvParams, waypoints,
                      pop: Dict[str, object]):
    """(env params, pure-pursuit params) of a population ``pop`` = {field:
    (P,) values}: every VehicleParams leaf (P, 1), the searched ones from
    ``pop`` and the rest ``params0``'s, and pure pursuit on ``waypoints``
    with (P,) tlad, vgain and wheelbase = lf + lr of each candidate."""
    dt = cfg.tdtype
    device = params0.tables.cosines.device
    p_n = len(next(iter(pop.values())))

    def leaf(v):
        t = torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v, dtype=dt,
                            device=device)
        return torch.broadcast_to(t.reshape(-1), (p_n,))

    vehicle = VehicleParams(*[
        leaf(pop[f] if f in pop else getattr(params0.vehicle, f))[:, None]
        for f in VehicleParams._fields])
    ppp = pp.make_params(waypoints.to(device=device, dtype=dt))
    ppp = ppp._replace(tlad=leaf(pop.get("tlad", ppp.tlad)),
                       vgain=leaf(pop.get("vgain", ppp.vgain)),
                       wheelbase=(vehicle.lf + vehicle.lr)[:, 0])
    return params0._replace(vehicle=vehicle), ppp


def make_laptime_evaluator(cfg: SimConfig, map_yaml: str, waypoints,
                           steps: int, start_pose,
                           fields: Sequence[str] = SEARCH_FIELDS,
                           map_ext: str = ".png", device="cuda") -> Callable:
    """Build the fitness function {field: (P,) values} -> lap fitness (P,)
    (a float tensor on ``device``, the card unless the caller passes
    "cpu").

    Every candidate drives the raceline ``waypoints`` (N, 3) with pure
    pursuit on its own env row for ``steps`` steps from ``start_pose``;
    fitness is the lap time of the laps to finish, with the budget plus
    100 for a candidate that crashed and the budget plus 10 a missing
    finish-line toggle for one that did not finish (JAX's formula).  The
    function carries ``params`` (the env params of the population's
    template), ``rollout``, the race alone: {field: (P,) values} ->
    (final state, final observation, crashed (P,) bool), and ``fitness``
    (final state, crashed) -> the fitness taken from that race."""
    device = resolve_device(device)
    params0 = envlib.make_params(cfg, map_yaml, map_ext, device=device)
    dt = cfg.tdtype
    budget_time = steps * cfg.timestep
    start = torch.as_tensor(np.asarray(start_pose, np.float64), dtype=dt,
                            device=device).reshape(1, 1, 3)

    veh_fields = [f for f in fields if f in VehicleParams._fields]
    pp_fields = [f for f in fields if f in ("tlad", "vgain")]
    assert set(veh_fields) | set(pp_fields) == set(fields)

    def rollout(pop: Dict[str, object]):
        env_params, ppp = population_params(cfg, params0, waypoints, pop)
        p_n = ppp.tlad.shape[0]
        gen = torch.Generator(device=device).manual_seed(0)
        state, obs, *_ = envlib.reset(cfg, env_params, start.expand(p_n, 1, 3), gen)
        crashed = obs.collisions[:, 0] > 0
        for _ in range(steps):
            speed, steer = pp.plan(obs.poses_x[:, 0], obs.poses_y[:, 0],
                                   obs.poses_theta[:, 0], ppp)
            act = torch.stack([steer, speed], dim=-1)[:, None, :]
            state, obs, *_ = envlib.step(cfg, env_params, state, act, gen)
            crashed = crashed | (obs.collisions[:, 0] > 0)
        return state, obs, crashed

    def fitness(state, crashed) -> torch.Tensor:
        toggles = state.toggle_list[:, 0]
        finished = toggles >= cfg.laps_to_finish_toggles
        # crashed: budget + stiff penalty; unfinished: budget + distance-to-go
        penalty = torch.where(crashed, torch.full_like(state.lap_times[:, 0], 100.0),
                              10.0 * (cfg.laps_to_finish_toggles - toggles).to(dt))
        return torch.where(finished & ~crashed, state.lap_times[:, 0],
                           budget_time + penalty)

    def evaluate(pop: Dict[str, object]) -> torch.Tensor:
        state, _, crashed = rollout(pop)
        return fitness(state, crashed)

    evaluate.params = params0
    evaluate.rollout = rollout
    evaluate.fitness = fitness
    return evaluate


def search(cfg: SimConfig, map_yaml: str, waypoints, start_pose,
           popsize: int = 20, generations: int = 10, steps: int = 4500,
           seed: int = 12345, fields: Sequence[str] = SEARCH_FIELDS,
           bounds: Dict[str, tuple] | None = None, log=print, device="cuda"):
    """Run the CMA lap-time search; returns (best_params_dict, best_fitness).
    The rollouts run on ``device`` (the card unless the caller passes
    "cpu")."""
    bounds = {**DEFAULT_BOUNDS, **(bounds or {})}
    bmat = np.asarray([bounds[f] for f in fields])
    x0 = bmat.mean(axis=1)
    sigma0 = 0.3 * float(np.mean(bmat[:, 1] - bmat[:, 0]))
    es = CMAES(x0, sigma0, popsize, seed=seed, bounds=bmat)
    evaluate = make_laptime_evaluator(cfg, map_yaml, waypoints, steps,
                                      start_pose, fields=fields, device=device)
    for g in range(generations):
        xs = es.ask()
        pop = {f: xs[:, i] for i, f in enumerate(fields)}
        fs = evaluate(pop).cpu().numpy()
        es.tell(xs, fs)
        if log:
            log(f"gen {g}: best {fs.min():.3f}s  mean {fs.mean():.3f}s  "
                f"sigma {es.sigma:.4f}")
    return dict(zip(fields, es.best_x)), es.best_f
