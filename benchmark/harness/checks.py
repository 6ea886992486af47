"""The comparison that decides ``correct``: what the window produced, held
to the plain reference (``benchmark/reference``).

The simulator (``sim``).  Each recorded step is stepped again by the
reference's ``env.step`` from the program's own state before it, with the
same actions and the generator where the program's stood, and, where some
env restarted, ``rollout.reset_done`` again from the program's state after
the step.  The reference builds its own params (map, lidar tables, range
texture, noise pool) from the same map files.  Numbers: the 99th
percentile of the scans' gap (m), the share of beams that differ by more
than ``FAR_M`` (%), the widest gap of every other float of the state and
observation, and the count of integer and boolean entries (and done flags)
that differ.

The trainer (``train``).  The reference's learner (``ppo_update.Learner``)
starts from the same first weights and follows the program's first
iterations from the program's rollouts and permutations.  Numbers: the
first iteration's mean minibatch loss (its gap over the loss's scale, the
sum of its three terms' magnitudes, which the loss can lie far below); the
first gradient as the optimizer took it, worked out from Adam's first
moment after one step, by its worst leaf; and the weights' change after
the last checked iteration by its median leaf.  A leaf's gap is the gap
between the program's norm of it and the reference's, over the larger of
the reference's norm of that leaf and of the median leaf.  Later
iterations' losses and the worst leaf's change are printed, not compared:
they are taken at weights that Adam's rounding has already moved apart
(an entry whose gradient is near 0 steps by its rounding), so they swing
from seed to seed by a factor of 100.  Leaves whose first gradient in the
reference is under a thousandth of the median leaf's move by rounding
alone and are left out of the change.  The env steps recorded inside the
rollouts are held to the reference as the simulator's are.
"""

from __future__ import annotations

import math

from harness import clock, inputs

FAR_M = 0.1   # a beam "far off": one texture cell (2 px of 0.05 m)
STATE_FLOATS = ("x", "steer_buf", "collisions", "lap_times", "current_time",
                "start_pose", "start_rot")
STATE_EXACT = ("steer_cnt", "near_starts", "toggle_list", "lap_counts", "step_idx",
               "map_idx")
OBS_FLOATS = ("poses_x", "poses_y", "poses_theta", "linear_vels_x", "linear_vels_y",
              "ang_vels_z", "collisions", "lap_times", "lap_counts")


class Gaps:
    """Gaps between the program's outputs and the reference's, over steps;
    with ``envs`` (a bool (E,) mask a step) of the masked envs alone."""

    def __init__(self):
        self.scan_p99, self.far, self.beams = 0.0, 0, 0
        self.state, self.flags = 0.0, 0

    def add(self, prog: tuple, ref: tuple, envs=None) -> None:
        """prog, ref: (state, obs, done or None), the two sides' NamedTuples."""
        import torch

        if envs is not None:
            prog, ref = (tuple(_rows(x, envs) for x in side) for side in (prog, ref))
        (ps, po, pd), (rs, ro, rd) = prog, ref
        d = torch.nan_to_num((po.scans.float() - ro.scans.float()).abs(), nan=math.inf)
        flat = d.reshape(-1)
        k = max(1, math.ceil(0.99 * flat.numel()))
        self.scan_p99 = max(self.scan_p99, float(torch.kthvalue(flat.cpu(), k).values))
        self.far += int((flat > FAR_M).sum())
        self.beams += flat.numel()
        pairs = [(getattr(ps, f), getattr(rs, f)) for f in STATE_FLOATS]
        pairs += [(getattr(po, f), getattr(ro, f)) for f in OBS_FLOATS]
        for a, b in pairs:
            gap = torch.nan_to_num((a.double() - b.double()).abs(), nan=math.inf)
            self.state = max(self.state, float(gap.max()) if gap.numel() else 0.0)
        exact = [(getattr(ps, f), getattr(rs, f)) for f in STATE_EXACT]
        if pd is not None:
            exact.append((pd, rd))
        for a, b in exact:
            if (a is None) != (b is None):
                self.flags += 1
            elif a is not None:
                self.flags += int((a != b).sum())

    def numbers(self) -> dict:
        return {"scan_p99_m": self.scan_p99,
                "scan_far_pct": 100.0 * self.far / max(self.beams, 1),
                "state_gap": self.state, "flags_differ": float(self.flags)}


def reference_sim(cell, maps: list, device, only=None):
    """The reference's settings and params for the cell's maps.  ``only``
    (indices into ``maps``) builds the range textures of those maps alone:
    the others get all-zero rows, and their envs are left out of the
    comparison (``Gaps(envs=...)``)."""
    import torch

    import refsim.config
    import refsim.env
    from refsim.maps.loader import load_map, pad_map, stack_maps
    from refsim.ops import scan_fast

    t0 = clock.now()
    rcfg = inputs.sim_settings(cell.config, refsim.config.SimConfig,
                               refsim.config.Integrator)
    if len(maps) == 1:
        rparams = refsim.env.make_params(rcfg, maps[0], device=device)
    else:
        raw = [load_map(p, ".png", dtype=rcfg.tdtype, device=device) for p in maps]
        pad = (max(int(m.height) for m in raw), max(int(m.width) for m in raw))
        s = rcfg.rt_pose_stride
        grid = ((pad[0] + s - 1) // s, (pad[1] + s - 1) // s)
        built = {i: scan_fast.pad_texture(scan_fast.build_range_texture(raw[i], rcfg),
                                          *grid)
                 for i in (range(len(maps)) if only is None else only)}
        first = next(iter(built.values()))
        blank = first._replace(rt=torch.zeros_like(first.rt),
                               valid=torch.zeros_like(first.valid))
        vehicle, tables = refsim.env._vehicle_and_tables(rcfg, None, device)
        rparams = refsim.env.EnvParams(
            vehicle=vehicle, tables=tables, tmap=stack_maps([pad_map(m, pad) for m in raw]),
            rtex=scan_fast.stack_textures([built.get(i, blank) for i in range(len(maps))]),
            noise_pool=refsim.env._make_noise_pool(rcfg, device))
    clock.sync(device)
    clock.say(f"reference params of {len(maps)} map(s), "
              f"{len(maps) if only is None else len(only)} textured, in "
              f"{clock.now() - t0:.1f} s")
    return rcfg, rparams


def _rows(x, envs):
    """The rows ``envs`` of every tensor of a NamedTuple (or of a tensor)."""
    if x is None:
        return None
    if isinstance(x, tuple):
        return type(x)(*(_rows(f, envs) for f in x))
    return x[envs]


def reference_step(rcfg, rparams, rec, device):
    """The reference's step of a record, from the program's state before
    it, and its reset from the program's state after it (None where no env
    restarted) -> ((state, obs, done), (state, obs, None) or None)."""
    import torch

    import refsim.env
    import refsim.rollout

    gen = torch.Generator(device=device)
    gen.set_state(rec.gen_step)
    s, o, _, d, _ = refsim.env.step(rcfg, rparams, refsim.env.EnvState(*rec.state),
                                    rec.actions, gen)
    if not rec.reset_any:
        return (s, o, d), None
    gen.set_state(rec.gen_reset)
    ps, po, pd = rec.mid
    s2, o2, _ = refsim.rollout.reset_done(rcfg, rparams, refsim.env.EnvState(*ps),
                                          refsim.env.Observation(*po), pd, gen)
    return (s, o, d), (s2, o2, None)


def compared_envs(rec, only):
    """The envs of a record on the maps ``only`` (None: every env)."""
    import torch

    if only is None:
        return None
    return torch.isin(rec.state.map_idx, torch.as_tensor(only, device=rec.state.x.device,
                                                         dtype=rec.state.map_idx.dtype))


def step_gaps(rcfg, rparams, records, device, only=None) -> Gaps:
    gaps = Gaps()
    for rec in records:
        envs = compared_envs(rec, only)
        mid, out = reference_step(rcfg, rparams, rec, device)
        gaps.add(rec.mid, mid, envs)
        if out is not None:
            gaps.add(rec.out + (None,), out, envs)
    return gaps


def checked_maps(cell, maps: list, seed: int):
    """The maps whose envs the env steps of a multi-map cell are held on:
    ``check["maps"]`` of them drawn from the seed (None: all, or one map)."""
    import random

    k = cell.traffic["check"].get("maps")
    if len(maps) == 1 or k is None or k >= len(maps):
        return None
    return sorted(random.Random(seed).sample(range(len(maps)), k))


def held(numbers: dict, limits: dict) -> list:
    """[(number, reading, limit)] of every number that has a limit (a limit
    of a number that is not worked out is a KeyError)."""
    return [(name, float(numbers[name]), float(limits[name])) for name in limits]


def sim(cell, maps: list, records: list, device) -> list:
    if not records:
        raise RuntimeError("the window recorded no step to check")
    rcfg, rparams = reference_sim(cell, maps, device)
    return held(step_gaps(rcfg, rparams, records, device).numbers(), cell.limits)


def leaf_gaps(prog: dict, ref: dict, leaves) -> dict:
    """{leaf: |‖prog‖ - ‖ref‖| / max(‖ref‖, median leaf's ‖ref‖)}."""
    import torch

    norms = {k: float(torch.linalg.vector_norm(ref[k].double())) for k in leaves}
    med = sorted(norms.values())[len(norms) // 2]
    gaps = {}
    for k in leaves:
        p = float(torch.linalg.vector_norm(prog[k].double()))
        gap = abs(p - norms[k]) / max(norms[k], med, 1e-30)
        gaps[k] = gap if math.isfinite(gap) else math.inf
    return gaps


def worst_leaf(prog: dict, ref: dict, leaves) -> float:
    return max(leaf_gaps(prog, ref, leaves).values())


def follow(cell, learner, rollouts: list, perms: list) -> list:
    """The reference's learner through the program's rollouts, one
    iteration each -> [(mean minibatch loss, its scale)]."""
    import torch

    ego, stride = cell.config["sim"].get("ego_idx", 0), cell.config["policy"]["scan_stride"]
    out = []
    for (_, obs, traj), p in zip(rollouts, perms):
        t = {"feats": traj.feats, "vels": traj.vels, "acts": traj.acts,
             "rewards": traj.rewards, "dones": traj.dones}
        out.append(learner.iteration(t, torch.log1p(obs.scans[:, ego, ::stride].float()),
                                     obs.linear_vels_x[:, ego], p))
    return out


def learner_numbers(cell, weights: dict, rollouts: list, perms: list, losses: list,
                    first_grad: dict, after: dict) -> dict:
    """The trainer's numbers, the reference's learner following the
    program's rollouts."""
    import torch

    import ppo_update

    learner = ppo_update.Learner(weights, cell.config["ppo"])
    loss_gaps = []
    for loss_p, (loss_r, scale) in zip(losses, follow(cell, learner, rollouts, perms)):
        gap = abs(loss_p - loss_r) / max(scale, 1e-30)
        loss_gaps.append(gap if math.isfinite(gap) else math.inf)
    leaves = list(weights)
    g_norm = {k: float(torch.linalg.vector_norm(learner.first_grad[k].double()))
              for k in leaves}
    med = sorted(g_norm.values())[len(leaves) // 2]
    moving = [k for k in leaves if g_norm[k] >= 1e-3 * med]
    change_p = {k: after[k] - weights[k] for k in leaves}
    change_r = {k: learner.w[k].detach() - weights[k] for k in leaves}
    changes = leaf_gaps(change_p, change_r, moving)
    grads = (None if first_grad is None
             else leaf_gaps(first_grad, learner.first_grad, leaves))
    clock.say(f"loss gaps by iteration {loss_gaps}; first gradient's gap by leaf "
              f"{grads}; change's gap by leaf {changes}")
    return {"loss1_gap": loss_gaps[0],
            "grad1_gap": math.inf if grads is None else max(grads.values()),
            "change_gap_median": sorted(changes.values())[len(changes) // 2]}


def train(cell, maps: list, weights: dict, rec, losses: list, first_grad: dict,
          after: dict, device) -> list:
    if not rec.steps:
        raise RuntimeError("the checked iterations recorded no env step")
    numbers = learner_numbers(cell, weights, rec.rollouts, rec.perms, losses,
                              first_grad, after)
    only = checked_maps(cell, maps, rec.seed)
    rcfg, rparams = reference_sim(cell, maps, device, only)
    numbers.update(step_gaps(rcfg, rparams, rec.steps, device, only).numbers())
    return held(numbers, cell.limits)
