"""PPO actor-learner over batched envs, on one device or data-parallel.

PyTorch counterpart of ``red_gym_tpu/agents/ppo.py``.  The JAX package
collects rollouts and learns in one jitted program sharded over an env
mesh; here ``PPO.train_step`` is a Python loop over the env step, the
policy forward and the minibatch updates, all on the envs' device (the
card in training, the CPU in the tests).

Data-parallel.  Given a mesh of P ranks (``parallel.sharding.EnvMesh``),
each rank steps its E/P rows of the E envs and the update computes what
JAX's one global program computes: every rank draws the same permutation
of all T*E samples, keeps the minibatch positions of its envs, normalises
the advantages by the statistics of the whole minibatch (all-reduced),
takes its loss terms as local sums over the global minibatch size, and
SUM-reduces the gradients before ``opt.step()``, so that every rank's Adam
takes the same step.  Every random draw of the rollout is made for all E
envs and sliced (``parallel.draws``).  With one rank, ``train_step`` is
the one-device code.

The policy consumes the lidar scan directly (log-scaled, strided) rather
than a rasterized bitmap.  Rollouts store the compact features
(``featurize_scan``), 8x less trajectory memory than raw 1080-beam scans.

State.  ``PPOState`` holds the policy module, its ``torch.optim.Adam`` and
the device generator that draws every random number of training (action
noise, the env's scan noise, the resets, the minibatch permutations).
``train_step`` updates the module and optimizer in place and returns the
same state; ``utils.checkpoint`` saves and restores it.
"""

from __future__ import annotations

import copy
import inspect
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from red_gym_tpu_torch import rollout
from red_gym_tpu_torch.agents import pure_pursuit as pp
from red_gym_tpu_torch.config import SimConfig
from red_gym_tpu_torch.env import EnvParams, Observation, step
from red_gym_tpu_torch.parallel import draws, sharding
from red_gym_tpu_torch.utils.profiling import span

# flax's lecun_normal: a normal of std 1/sqrt(fan_in) truncated to +-2 of its
# own std, rescaled by the std of a standard normal truncated to [-2, 2] so
# that the result has std 1/sqrt(fan_in) (jax.nn.initializers.variance_scaling)
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(weight: torch.Tensor, gen: torch.Generator | None = None) -> torch.Tensor:
    """Fill a Linear weight (out, in) or a Conv2d weight (out, in, kh, kw)
    as flax's ``lecun_normal`` fills its kernel (in, out) or (kh, kw, in,
    out): truncated normal, variance 1/fan_in (fan_in = in * kh * kw),
    clipped at +-2 sigma of the untruncated normal.  Drawn in float32 on
    ``gen``'s device (the CPU by default), then copied in."""
    fan_in = math.prod(weight.shape[1:])
    sigma = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    dev = gen.device if gen is not None else torch.device("cpu")
    w = torch.empty(weight.shape, dtype=torch.float32, device=dev)
    nn.init.trunc_normal_(w, 0.0, sigma, -2.0 * sigma, 2.0 * sigma, generator=gen)
    with torch.no_grad():
        return weight.copy_(w)


def featurize_scan(scan, stride: int, dtype=torch.float32):
    """The ScanPolicy observation transform: strided + log1p-compressed
    ranges.  Rollouts store these features; the policy consumes either them
    (``featurized=True``) or raw scans."""
    return torch.log1p(scan[..., ::stride].to(dtype))


class ScanPolicy(nn.Module):
    """Gaussian actor + value head over strided log-range features.

    Linear (ceil(B / stride) + 1) -> hidden, tanh, Linear hidden -> hidden,
    tanh, then the mean head and the value head; ``log_std`` starts at -0.5.
    Parameters are float32 and initialised as flax's ``Dense``
    (``lecun_normal`` kernels, zero biases).  The hidden layers compute in
    ``compute_dtype``.  The heads compute in float32, as flax's
    (``dtype=jnp.float32``), or in ``compute_dtype`` where that is wider:
    a float64 policy is float64 throughout."""

    def __init__(self, num_beams: int = 1080, hidden: int = 256, action_dim: int = 2,
                 scan_stride: int = 8, compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_beams, self.hidden, self.action_dim = num_beams, hidden, action_dim
        self.scan_stride, self.compute_dtype = scan_stride, compute_dtype
        n_in = (num_beams + scan_stride - 1) // scan_stride + 1
        self.hidden_0 = nn.Linear(n_in, hidden)
        self.hidden_1 = nn.Linear(hidden, hidden)
        self.mean = nn.Linear(hidden, action_dim)
        self.value = nn.Linear(hidden, 1)
        self.log_std = nn.Parameter(torch.empty(action_dim))
        self.reset_parameters()

    def reset_parameters(self, gen: torch.Generator | None = None) -> None:
        """flax's initialisation, drawn from ``gen`` (a CPU generator)."""
        for lin in (self.hidden_0, self.hidden_1, self.mean, self.value):
            lecun_normal_(lin.weight, gen)
            nn.init.zeros_(lin.bias)
        nn.init.constant_(self.log_std, -0.5)

    @staticmethod
    def _dense(lin: nn.Linear, x, dtype):
        return F.linear(x.to(dtype), lin.weight.to(dtype), lin.bias.to(dtype))

    def forward(self, scan, vel, featurized: bool = False):
        """scan (..., B) raw, or (..., ceil(B/stride)) features; vel (...).
        -> (mean (..., action_dim), log_std (action_dim,), value (...))."""
        cd = self.compute_dtype
        x = scan.to(cd) if featurized else featurize_scan(scan, self.scan_stride, cd)
        x = torch.cat([x, vel[..., None].to(cd)], dim=-1)
        x = torch.tanh(self._dense(self.hidden_0, x, cd))
        x = torch.tanh(self._dense(self.hidden_1, x, cd))
        hd = torch.promote_types(torch.float32, cd)
        mean = self._dense(self.mean, x, hd)
        value = self._dense(self.value, x, hd)[..., 0]
        return mean, self.log_std, value


class PPOConfig(NamedTuple):
    lr: float = 3e-4
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_eps: float = 0.2
    vf_coef: float = 0.5
    ent_coef: float = 0.01
    rollout_len: int = 32
    minibatches: int = 4
    epochs: int = 2
    max_speed: float = 8.0
    max_steer: float = 0.4


class PPOState(NamedTuple):
    policy: nn.Module                   # the learning policy, on the envs' device
    optimizer: torch.optim.Optimizer    # Adam over its parameters
    gen: torch.Generator                # every random draw of training
    # the last rollout's action noise (T, E, action_dim), which the next
    # rollout shifts by pcfg.epochs steps (PPO, "Random streams"); None
    # before the first
    noise: torch.Tensor | None = None


class Trajectory(NamedTuple):
    """One rollout, each field stacked (T, E, ...)."""

    feats: torch.Tensor   # policy inputs (features, or raw scans)
    vels: torch.Tensor    # ego speed
    acts: torch.Tensor    # sampled pre-squash actions (T, E, 2)
    logps: torch.Tensor
    values: torch.Tensor
    rewards: torch.Tensor  # float32
    dones: torch.Tensor    # float32 0/1
    noise: torch.Tensor | None = None  # the action noise of each step (T, E, 2)


def action_to_control(act, pcfg: PPOConfig, dtype):
    """Squash the 2-D policy output into (steer, speed) controls."""
    steer = pcfg.max_steer * torch.tanh(act[..., 0])
    speed = pcfg.max_speed * 0.5 * (torch.tanh(act[..., 1]) + 1.0)
    return torch.stack([steer, speed], dim=-1).to(dtype)


def gaussian_logp(mean, log_std, act):
    return torch.sum(-0.5 * ((act - mean) / torch.exp(log_std)) ** 2
                     - log_std - 0.5 * math.log(2 * math.pi), dim=-1)


def epoch_permutation(n: int, gen: torch.Generator, device) -> torch.Tensor:
    """An epoch's order of the n samples, uniform over the permutations (JAX:
    ``jax.random.permutation``, red_gym_tpu/agents/ppo.py:356); minibatch i
    takes the samples at positions [i * mb, (i + 1) * mb)."""
    return torch.randperm(n, generator=gen, device=device)


def progress_collision_reward(speed_coef: float = 1.0,
                              collision_penalty: float = 10.0):
    """Default PPO shaping: forward progress minus a crash penalty (the
    distilled form of the reference's reward surface, reference
    src/SAL.py:219-250).  Returns fn(cfg, obs, next_obs) -> (E,)."""

    def fn(cfg: SimConfig, obs: Observation, next_obs: Observation):
        ego = cfg.ego_idx
        return (speed_coef * next_obs.linear_vels_x[:, ego] * cfg.timestep
                - collision_penalty * next_obs.collisions[:, ego])

    return fn


def pure_pursuit_opponents(ppp: pp.PurePursuitParams):
    """Opponent-policy hook: every agent tracks the raceline with pure
    pursuit.  Returns fn(obs, map_idx) -> (E, A, 2) [steer, speed] controls
    (map_idx ignored: one shared raceline)."""

    def plan_all(obs: Observation, map_idx=None):
        speed, steer = pp.plan(obs.poses_x, obs.poses_y, obs.poses_theta, ppp)
        return torch.stack([steer, speed], dim=-1)

    return plan_all


def pure_pursuit_opponents_multi(stacked_ppp: pp.PurePursuitParams):
    """Multi-map opponent hook for map-stacked envs: each env's agents track
    the raceline of its track (params from pure_pursuit.stack_params, (M,
    N, 3) tables), gathered per env by ``map_idx`` (E,)."""

    def plan_all(obs: Observation, map_idx):
        if map_idx is None:
            raise ValueError("pure_pursuit_opponents_multi needs map_idx envs "
                             "(make_multimap_params); use pure_pursuit_opponents "
                             "otherwise")
        m = map_idx.long()
        ppp = pp.PurePursuitParams(*(f[m][:, None] for f in stacked_ppp))
        speed, steer = pp.plan(obs.poses_x, obs.poses_y, obs.poses_theta, ppp)
        return torch.stack([steer, speed], dim=-1)

    return plan_all


# the update's statistics that are sums over a rank's samples (all-reduced
# on a mesh), and every diagnostic train_step reports beside JAX's metrics,
# in the order of train_ppo's CSV columns (log_std: one entry an action)
LOCAL_STATS = ("value_loss", "approx_kl", "clip_frac")
DIAGNOSTICS = ("approx_kl", "clip_frac", "log_std_0", "log_std_1", "value_loss",
               "grad_norm")


def grad_norm(policy: nn.Module) -> torch.Tensor:
    """The global L2 norm of the policy's gradients."""
    return torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(q.grad) for q in policy.parameters()
         if q.grad is not None]))


class PPO:
    """Ego-agent PPO over batched envs.  Opponents act through the
    ``opponent_plan`` hook, fn(obs, map_idx) -> (E, A, 2) controls for all
    agents, of which the non-ego rows are used.  Options: None (hold slow
    straight), pure_pursuit_opponents(...) (raceline-tracking traffic),
    pure_pursuit_opponents_multi(...) (per-track racelines on map-stacked
    envs), or the string "self" (self-play: the current policy's mean
    action drives opponents).  ``mesh`` (``parallel.sharding.EnvMesh``) of
    several ranks: the env states and params given are this rank's rows
    (``shard_envs``, ``shard_params``), and ``train_step`` is the
    data-parallel step of the module docstring.

    Random streams.  JAX splits a key per step for the actions and the
    resets, and its ``collect`` steps every env once more from its start
    pose, keeping the done ones (red_gym_tpu/agents/ppo.py:280-290).
    JAX's ``train_step`` hands its state's key to ``collect`` and splits
    that same key again for its epochs (:338-351).  As ``split(k, n)[j]``
    does not depend on n (``jax_threefry_partitionable``, JAX's default
    since 0.5), the key it returns is ``collect``'s key after pcfg.epochs
    steps: iteration i+1's action noise at step t is iteration i's at step
    t + epochs, env by env, and only the last pcfg.epochs steps of a
    rollout draw new noise.  The port keeps the last rollout's noise
    (``PPOState.noise``) and shifts it the same way.  Apart from that, one
    device generator draws, per step, the new action noise, the env step's
    scan noise, then, only when some env is done, the reset step's scan
    noise for the done envs alone (``rollout.reset_done``, shared with
    ``make_rollout``), so a done env gets the same restarted state without a
    second step of every env.  Under ``noise_mode="pool_rot"`` the j-th done
    env reads pool row (j + off') % rows, counted within the done envs, not
    its row in the full batch, so its class of rows mod 16 differs from
    JAX's.  Which draws land where differs from JAX; the law of a batch
    does not (``rollout.make_rollout``)."""

    def __init__(self, cfg: SimConfig, env_params: EnvParams,
                 pcfg: PPOConfig = PPOConfig(), policy: nn.Module | None = None,
                 opponent_plan=None, map_axis=None, reward_fn=None,
                 mesh: sharding.EnvMesh | None = None):
        self.cfg = cfg
        self.env_params = env_params
        self.pcfg = pcfg
        self.policy = policy if policy is not None else ScanPolicy(cfg.num_beams)
        if getattr(self.policy, "num_beams", cfg.num_beams) != cfg.num_beams:
            raise ValueError(f"the policy reads {self.policy.num_beams} beams, the "
                             f"config has {cfg.num_beams}")
        self.opponent_plan = opponent_plan
        # hook arity, decided here (not by a try/except at call time, which
        # would swallow TypeErrors raised inside 2-arg hooks): hooks take
        # (obs, map_idx), older ones (obs)
        self._opp_takes_map = None
        if callable(opponent_plan):
            try:
                ps = inspect.signature(opponent_plan).parameters.values()
                n_pos = sum(p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)
                            for p in ps)
                var_pos = any(p.kind == p.VAR_POSITIONAL for p in ps)
                self._opp_takes_map = var_pos or n_pos >= 2
            except (TypeError, ValueError):   # C callables etc.
                self._opp_takes_map = True
        self.map_axis = map_axis   # 0 -> per-env maps (stacked tmap/rtex)
        self.reward_fn = reward_fn or progress_collision_reward()
        self._feat_stride = getattr(self.policy, "scan_stride", None)
        self.device = env_params.tables.beam_cosines.device
        # the ranks the envs are sharded over; None or one rank: this process
        self.mesh = mesh if mesh is not None and mesh.world_size > 1 else None

    def _featurize(self, scans):
        if self._feat_stride is None:
            return scans
        return featurize_scan(scans, self._feat_stride,
                              getattr(self.policy, "compute_dtype", torch.float32))

    def _apply(self, policy, scan_or_feat, vel):
        if self._feat_stride is None:
            return policy(scan_or_feat, vel)
        return policy(scan_or_feat, vel, featurized=True)

    def init(self, gen: torch.Generator) -> PPOState:
        """A fresh policy (flax's initialisation, drawn from ``gen``, a CPU
        generator), its Adam (optax.adam's arithmetic: betas 0.9, 0.999, eps
        1e-8) and a device generator seeded from ``gen``."""
        policy = copy.deepcopy(self.policy)
        policy.reset_parameters(gen)
        policy = policy.to(self.device)
        opt = torch.optim.Adam(policy.parameters(), lr=self.pcfg.lr,
                               betas=(0.9, 0.999), eps=1e-8)
        seed = int(torch.randint(0, 2 ** 62, (1,), generator=gen))
        return PPOState(policy, opt, torch.Generator(device=self.device).manual_seed(seed))

    # -- rollout collection ---------------------------------------------------
    def _policy_step(self, policy, obs: Observation, gen, noise=None):
        """The ego's action, its log-probability, value and features; the
        action noise is ``noise`` or, if None, drawn from ``gen``."""
        ego = self.cfg.ego_idx
        feat = self._featurize(obs.scans[:, ego])
        mean, log_std, value = self._apply(policy, feat, obs.linear_vels_x[:, ego])
        if noise is None:
            noise = draws.draw_rows(mean.shape[0], lambda n: torch.randn(
                (n,) + tuple(mean.shape[1:]), generator=gen, dtype=mean.dtype,
                device=mean.device))
        act = mean + torch.exp(log_std) * noise
        return act, gaussian_logp(mean, log_std, act), value, feat, noise

    def _env_actions(self, act, obs: Observation, policy=None, map_idx=None):
        """Ego action from the policy; opponents from the opponent_plan hook
        fn(obs, map_idx) (default: cruise slow and straight; "self" =
        self-play, the policy's mean action drives every opponent too).
        ``map_idx`` (E,) is passed for map-stacked envs so that hooks like
        pure_pursuit_opponents_multi can pick per-track racelines."""
        dt = self.cfg.tdtype
        ego_ctrl = action_to_control(act, self.pcfg, dt)
        e, a = act.shape[0], self.cfg.num_agents
        if a == 1:
            return ego_ctrl[:, None]
        if self.opponent_plan == "self":
            mean, _, _ = policy(obs.scans, obs.linear_vels_x)   # (E, A, 2)
            others = action_to_control(mean, self.pcfg, dt)
        elif self.opponent_plan is not None:
            with span("ppo/opponents"):
                others = (self.opponent_plan(obs, map_idx) if self._opp_takes_map
                          else self.opponent_plan(obs)).to(dt)
        else:
            others = torch.tensor([0.0, 1.5], dtype=dt, device=act.device).expand(e, a, 2)
        ctrl = others.clone()
        ctrl[:, self.cfg.ego_idx] = ego_ctrl
        return ctrl

    @torch.no_grad()
    def collect(self, pstate: PPOState, env_states, obs, env_params=None):
        """Roll the env batch pcfg.rollout_len steps, restarting done envs
        (``rollout.reset_done``) -> (env_states, obs, Trajectory).  Rewards
        are computed before the restart, as in JAX.  Step t takes its
        action noise from step t + pcfg.epochs of ``pstate.noise`` where
        there is one, else draws it (class docstring, "Random streams");
        the trajectory holds the noise of every step.  On a mesh, every
        draw is made for all ranks' envs (``sharding.env_draws``)."""
        cfg, ego = self.cfg, self.cfg.ego_idx
        params = env_params if env_params is not None else self.env_params
        maps = rollout._env_maps(params, self.map_axis, env_states.x.shape[0],
                                 env_states.x.device)
        policy, gen = pstate.policy, pstate.gen
        shift = self.pcfg.epochs
        prev = None if pstate.noise is None else pstate.noise.to(obs.scans.device)
        steps = []
        with sharding.env_draws(self.mesh, env_states.x.shape[0]):
            for t in range(self.pcfg.rollout_len):
                kept = (prev[t + shift] if prev is not None and t + shift < prev.shape[0]
                        else None)
                with span("ppo/policy"):
                    act, logp, value, feat, noise = self._policy_step(policy, obs, gen,
                                                                      kept)
                ctrl = self._env_actions(act, obs, policy, map_idx=env_states.map_idx)
                with span("ppo/env_step"):
                    s = env_states if maps is None else env_states._replace(map_idx=maps)
                    s2, obs2, _, done, _ = step(cfg, params, s, ctrl, gen)
                r = self.reward_fn(cfg, obs, obs2)
                with span("ppo/reset"):
                    s2, obs2, _ = rollout.reset_done(cfg, params, s2, obs2, done, gen)
                if maps is not None:
                    s2 = s2._replace(map_idx=None)
                steps.append((feat, obs.linear_vels_x[:, ego], act, logp, value,
                              r.to(torch.float32), done.to(torch.float32), noise))
                env_states, obs = s2, obs2
        return env_states, obs, Trajectory(*(torch.stack(f) for f in zip(*steps)))

    # -- learning -------------------------------------------------------------
    def _gae(self, values, rewards, dones, last_value):
        p = self.pcfg
        gae, next_v = torch.zeros_like(last_value), last_value
        adv = []
        for v, r, d in zip(values.flip(0), rewards.flip(0), dones.flip(0)):
            delta = r + p.gamma * next_v * (1 - d) - v
            gae = delta + p.gamma * p.gae_lambda * (1 - d) * gae
            adv.append(gae)
            next_v = v
        adv = torch.stack(adv[::-1])
        return adv, adv + values

    def _allsum(self, t):
        """The SUM of ``t`` over the mesh's ranks; ``t`` itself without a mesh."""
        return t if self.mesh is None else draws.all_reduce_sum(t, self.mesh.group)

    def _loss(self, policy, batch, mb: int | None = None):
        """The PPO loss of a minibatch of ``mb`` samples (default: all of
        ``batch``) -> (loss, {"pg", "vf", "ratio", "kl", "clip"}).  The
        advantages are normalised by the minibatch's mean and population std
        (JAX's ``adv.std()``), each term is a sum over ``mb``.  ``kl`` is the
        approximate KL ``(r - 1) - log r`` and ``clip`` the share of samples
        with ``|r - 1| > clip_eps``, both over ``mb`` and outside the graph.
        On a mesh ``batch`` holds this rank's samples of the minibatch: the
        statistics are all-reduced and the entropy term, every rank's, is
        taken a P-th, so the ranks' losses and gradients sum to one
        process's."""
        feats, vels, acts, logp_old, adv, returns = batch
        mb = adv.shape[0] if mb is None else mb
        world = 1 if self.mesh is None else self.mesh.world_size
        adv_mean = self._allsum(adv.sum()) / mb
        adv_std = torch.sqrt(self._allsum(((adv - adv_mean) ** 2).sum()) / mb)
        adv_n = (adv - adv_mean) / (adv_std + 1e-8)
        p = self.pcfg
        mean, log_std, value = self._apply(policy, feats, vels)
        log_ratio = gaussian_logp(mean, log_std, acts) - logp_old
        ratio = torch.exp(log_ratio)
        pg = -torch.minimum(ratio * adv_n,
                            torch.clamp(ratio, 1 - p.clip_eps, 1 + p.clip_eps) * adv_n)
        pg = pg.sum() / mb
        vf = (0.5 * (value - returns) ** 2).sum() / mb
        ent = torch.sum(log_std + 0.5 * math.log(2 * math.pi * math.e))
        loss = pg + p.vf_coef * vf - p.ent_coef * ent / world
        with torch.no_grad():
            kl = ((ratio - 1) - log_ratio).sum() / mb
            clip = ((ratio - 1).abs() > p.clip_eps).to(ratio.dtype).sum() / mb
        return loss, {"pg": pg, "vf": vf, "ratio": ratio.sum() / mb, "kl": kl, "clip": clip}

    def _reduce_grads(self, policy, loss):
        """SUM the ranks' gradients and their ``loss`` in one all-reduce ->
        the global loss; the gradients are replaced in place.  Without a
        mesh: ``loss``."""
        if self.mesh is None:
            return loss.detach()
        params = [q for q in policy.parameters() if q.requires_grad]
        grads = [q.grad if q.grad is not None else torch.zeros_like(q) for q in params]
        flat = torch.cat([g.reshape(-1) for g in grads] + [loss.detach().reshape(1)])
        flat = self._allsum(flat)
        off = 0
        for q, g in zip(params, grads):
            q.grad = flat[off:off + g.numel()].view_as(q).clone()
            off += g.numel()
        return flat[-1]

    def _update(self, pstate: PPOState, traj: Trajectory, last_value, _perms=None):
        """GAE, then pcfg.epochs epochs of pcfg.minibatches Adam steps on
        minibatches of a fresh permutation of all T*E samples each
        (``_perms[epoch]`` in place of the draw, for the tests) -> the means
        over the minibatches of: "loss", "value_loss", "approx_kl",
        "clip_frac" (``_loss``'s vf, kl and clip) and "grad_norm" (the
        gradient's global norm before Adam).  On a mesh the permutation is
        over every rank's samples (the generator is replicated) and each
        rank keeps those of its rows [lo, lo + e): global sample g is env g %
        (e P) of step g // (e P).  There "loss" and "grad_norm" are global,
        and "value_loss", "approx_kl" and "clip_frac" this rank's share,
        which ``train_step`` all-reduces."""
        adv, returns = self._gae(traj.values, traj.rewards, traj.dones, last_value)
        t, e = traj.rewards.shape
        data = [x.reshape((t * e,) + x.shape[2:]) for x in
                (traj.feats, traj.vels, traj.acts, traj.logps, adv, returns)]
        world, lo = (1, 0) if self.mesh is None else (self.mesh.world_size,
                                                      e * self.mesh.rank)
        e_all = e * world
        n = t * e_all
        mb = n // self.pcfg.minibatches
        policy, opt = pstate.policy, pstate.optimizer
        stats = {k: [] for k in ("loss", "value_loss", "approx_kl", "clip_frac",
                                 "grad_norm")}
        for ep in range(self.pcfg.epochs):
            perm = (epoch_permutation(n, pstate.gen, adv.device)
                    if _perms is None else _perms[ep])
            for i in range(self.pcfg.minibatches):
                idx = perm[i * mb:(i + 1) * mb]
                if world > 1:
                    env = idx % e_all
                    idx = idx[(env >= lo) & (env < lo + e)]
                    idx = (idx // e_all) * e + (idx % e_all - lo)
                loss, aux = self._loss(policy, [x[idx] for x in data], mb)
                opt.zero_grad(set_to_none=True)
                loss.backward()
                stats["loss"].append(self._reduce_grads(policy, loss))
                stats["grad_norm"].append(grad_norm(policy))
                opt.step()
                stats["value_loss"].append(aux["vf"].detach())
                stats["approx_kl"].append(aux["kl"])
                stats["clip_frac"].append(aux["clip"])
        return {k: torch.stack(v).mean() for k, v in stats.items()}

    def train_step(self, pstate: PPOState, env_states, obs, env_params=None):
        """One PPO iteration: collect, GAE, minibatch epochs.  Updates the
        policy and optimizer of ``pstate`` in place and takes the rollout's
        action noise into the returned state -> (pstate, env_states,
        obs, metrics): JAX's four metrics (loss, reward_mean, done_rate,
        speed_mean), reset_steps (steps that restarted some env) and the
        diagnostics of ``DIAGNOSTICS`` (the update's means of ``_update``
        and the policy's ``log_std`` entries after the update), all tensors
        on the device; nothing here waits for the device.  On a mesh, the
        metrics are those of every rank's envs; the collectives of the
        update and of the resets wait for the other ranks."""
        env_states, obs, traj = self.collect(pstate, env_states, obs, env_params)
        pstate = pstate._replace(noise=traj.noise)
        ego = self.cfg.ego_idx
        with torch.no_grad():
            _, _, last_value = self._apply(pstate.policy,
                                           self._featurize(obs.scans[:, ego]),
                                           obs.linear_vels_x[:, ego])
        with span("ppo/update"):
            upd = self._update(pstate, traj, last_value)
        # the metrics of every rank's envs: their sums, the update's shares
        # and each step's done count, in one all-reduce on a mesh
        t, e = traj.rewards.shape
        f64 = torch.float64
        shares = torch.stack([upd[k] for k in LOCAL_STATS])
        sums = self._allsum(torch.cat([
            torch.stack([traj.rewards.sum(dtype=f64), traj.dones.sum(dtype=f64),
                         traj.vels.sum(dtype=f64)]),
            shares.to(f64), traj.dones.sum(1, dtype=f64)]))
        n = t * e * (1 if self.mesh is None else self.mesh.world_size)
        k = len(LOCAL_STATS)
        metrics = {"loss": upd["loss"],
                   "reward_mean": (sums[0] / n).to(traj.rewards.dtype),
                   "done_rate": (sums[1] / n).to(traj.dones.dtype),
                   "speed_mean": (sums[2] / n).to(traj.vels.dtype),
                   "reset_steps": (sums[3 + k:] > 0).sum()}
        # the diagnostics: they read the update and draw nothing
        metrics.update({name: sums[3 + i].to(shares.dtype)
                        for i, name in enumerate(LOCAL_STATS)})
        metrics["grad_norm"] = upd["grad_norm"]
        log_std = getattr(pstate.policy, "log_std", None)
        if log_std is not None:
            metrics.update({f"log_std_{i}": v for i, v in enumerate(log_std.detach().clone())})
        return pstate, env_states, obs, metrics
