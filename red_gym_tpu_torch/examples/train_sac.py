"""SAC training on lidar bitmaps through the path-planning env, one env.

PyTorch counterpart of ``examples/train_sac.py``, the reference training
loop (reference: src/SAL.py:975-1022): one env (the batched
``PlanningEnv`` at E = 1), the SAL agent hyperparameters (batch 64, an
update every 50 steps after 1000, tau 0.005, gamma 0.99, alpha 0.2), the
bitmap, MPC and replay on the card.

Cuts against the JAX script: ``--map`` defaults to the packaged
``track_0019`` (the JAX default, ``example_map.yaml``, and its start pose
(0, 0, 1.57), SAL.py:71, are not packaged), and the car starts on the
track's ``assets.waypoint_start_poses``; ``--save`` names a checkpoint file
(``utils.checkpoint``), not a directory.

Usage:
    python -m red_gym_tpu_torch.examples.train_sac --episodes 2 --steps 200   # smoke
    python -m red_gym_tpu_torch.examples.train_sac                            # full run

It runs on the card ("cuda") unless ``--device cpu`` is given; there is no
fallback.
"""

import argparse
import time
import types

import torch

from red_gym_tpu_torch import assets, env as envlib
from red_gym_tpu_torch.agents import planning_env as pe
from red_gym_tpu_torch.agents.sac import SAC, ReplayBuffer
from red_gym_tpu_torch.config import SimConfig, resolve_device
from red_gym_tpu_torch.utils import checkpoint as ckpt


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--episodes", type=int, default=1000)
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--update-after", type=int, default=1000)
    ap.add_argument("--update-every", type=int, default=50)
    ap.add_argument("--replay-capacity", type=int, default=50_000)
    ap.add_argument("--bitmap", type=int, default=256)
    ap.add_argument("--save", type=str, default="sac_actor_ckpt.pt",
                    help="checkpoint file (the JAX script's is an orbax directory)")
    ap.add_argument("--map", type=str, default=None,
                    help="map yaml; default the packaged track_0019 (the JAX script's "
                         "example_map.yaml is not packaged); the car starts on the map's "
                         "*_waypoints.csv raceline")
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device; 'cuda' (the default) needs a GPU and does not "
                         "fall back to the CPU")
    return ap.parse_args(argv)


def build(args):
    """The one-env trainer of ``args`` on ``args.device`` (the card by
    default): the planning env, SAC and its state, the replay, the start
    pose and the device generator."""
    device = resolve_device(args.device)
    cfg = SimConfig(num_agents=1, num_beams=1080, timestep=0.015, dtype="float32")
    track = args.map or assets.named_map_yaml("track_0019")
    params = envlib.make_params(cfg, track, ".png", device=device)
    pcfg = pe.default_plan_config(cfg.tdtype)._replace(bitmap_dims=(args.bitmap, args.bitmap))
    env = pe.PlanningEnv(cfg, params, pcfg, device=device)
    sac = SAC(obs_shape=(args.bitmap, args.bitmap), action_dim=pe.ACTION_DIM, device=device)
    start = torch.as_tensor(assets.waypoint_start_poses(track, 1)[None], dtype=cfg.tdtype,
                            device=device)
    return types.SimpleNamespace(
        args=args, device=device, env=env, sac=sac, start=start,
        gen=torch.Generator(device=device).manual_seed(1),
        sstate=sac.init(torch.Generator().manual_seed(0)),
        buf=ReplayBuffer.create(args.replay_capacity, (args.bitmap, args.bitmap),
                                pe.ACTION_DIM, device=device),
        total_steps=0, episodes=0)


def main(argv=None):
    args = parse_args(argv)
    t = build(args)
    t0 = time.time()
    for ep in range(args.episodes):
        ps = t.env.reset(t.start, t.gen)
        t.episodes += 1
        obs = ps.bitmap
        ep_reward = 0.0
        for _ in range(args.steps):
            action = t.sac.select_action(t.sstate, obs, t.gen)
            ps, next_obs, reward, done, _ = t.env.step(ps, action, t.gen)
            t.buf.push(obs[0], action[0], reward[0], next_obs[0], done[0])
            obs = next_obs
            ep_reward += float(reward[0])
            t.total_steps += 1

            if t.total_steps > args.update_after and \
                    t.total_steps % args.update_every == 0:
                batch = t.buf.sample(t.gen, args.batch_size)
                t.sstate, m = t.sac.update(t.sstate, batch, t.gen)
                print(f"step {t.total_steps}: actor={float(m['actor_loss']):.4f} "
                      f"c1={float(m['critic1_loss']):.4f} "
                      f"c2={float(m['critic2_loss']):.4f}", flush=True)
            if bool(done[0]):
                break
        rate = t.total_steps / (time.time() - t0)
        print(f"episode {ep}: reward={ep_reward:.2f} steps={t.total_steps} "
              f"({rate:.1f} env-steps/s)", flush=True)

    ckpt.save(args.save, t.sstate)
    print(f"training complete; checkpoint saved to {args.save}")
    return t


if __name__ == "__main__":
    main()
