"""The port's entry points run on the card unless the caller asks for the CPU.

Every function of ``red_gym_tpu_torch`` that takes ``device`` defaults to
"cuda"; without a GPU such a call raises RuntimeError naming
``device="cpu"``, and nothing falls back to the CPU.
"""

import inspect

import numpy as np
import pytest
import torch

import red_gym_tpu_torch
from red_gym_tpu_torch import assets, env, gym_compat, interop, vec_env
from red_gym_tpu_torch.agents.planning_env import PlanningEnv
from red_gym_tpu_torch.agents.sac import SAC, ReplayBuffer
from red_gym_tpu_torch.config import SimConfig, VehicleParams, resolve_device
from red_gym_tpu_torch.examples import train_sac, train_sac_bitmap_scale, train_sac_scale
from red_gym_tpu_torch.maps import loader
from red_gym_tpu_torch.ops import scan
from red_gym_tpu_torch.utils.profiling import Metrics
from red_gym_tpu_torch.agents import ppo
from red_gym_tpu_torch.agents.pure_pursuit import load_waypoints_csv
from red_gym_tpu_torch.examples import (collect_lidar_dataset, export_policy,
                                        generalization_study, lidar_bitmap_example,
                                        mpc_demo, param_search_cma, profile_components,
                                        scan_error_study, waypoint_follow)
from red_gym_tpu_torch.parallel import distributed as pdist, sharding
from red_gym_tpu_torch.tuning import make_laptime_evaluator, search
from red_gym_tpu_torch.utils import export

TRACK = "track_0019"
CFG = SimConfig(num_beams=270, scan_mode="fast", rt_pose_stride=8)

ENTRY_POINTS = {
    "env.make_params": env.make_params,
    "env.make_multimap_params": env.make_multimap_params,
    "env.F110Env": env.F110Env,
    "maps.loader.load_map": loader.load_map,
    "ops.scan.build_tables": scan.build_tables,
    "config.VehicleParams.default": VehicleParams.default,
    "config.VehicleParams.from_dict": VehicleParams.from_dict,
    "interop.to_tensor": interop.to_tensor,
    "interop.params_from_numpy": interop.params_from_numpy,
    "interop.texture_from_numpy": interop.texture_from_numpy,
    "interop.state_from_numpy": interop.state_from_numpy,
    "vec_env.VecF110Env": vec_env.VecF110Env,
    "parallel.distributed.initialize": pdist.initialize,
    "parallel.distributed.choose_backend": pdist.choose_backend,
    "parallel.distributed.local_device": pdist.local_device,
    "parallel.sharding.make_env_mesh": sharding.make_env_mesh,
    "agents.planning_env.PlanningEnv": PlanningEnv,
    "agents.sac.SAC": SAC,
    "agents.sac.ReplayBuffer.create": ReplayBuffer.create,
    "utils.profiling.Metrics.init": Metrics.init,
    "tuning.make_laptime_evaluator": make_laptime_evaluator,
    "tuning.search": search,
    "utils.export.export_policy": export.export_policy,
    "agents.pure_pursuit.load_waypoints_csv": load_waypoints_csv,
}
TOOL_EXAMPLES = {"param_search_cma": param_search_cma, "export_policy": export_policy,
                 "waypoint_follow": waypoint_follow,
                 "collect_lidar_dataset": collect_lidar_dataset,
                 "profile_components": profile_components,
                 "scan_error_study": scan_error_study,
                 "generalization_study": generalization_study, "mpc_demo": mpc_demo,
                 "lidar_bitmap_example": lidar_bitmap_example}
TOOL_CFG = SimConfig(num_agents=1, num_beams=16, march_iters=8, scan_noise_std=0.0)


def _waypoints_cpu():
    return load_waypoints_csv(assets.waypoints_csv(TRACK), device="cpu")

SAC_TRAINERS = {"train_sac": train_sac, "train_sac_bitmap_scale": train_sac_bitmap_scale,
                "train_sac_scale": train_sac_scale}

CALLS_WITHOUT_DEVICE = {
    "parallel.distributed.initialize": lambda: pdist.initialize(),
    "parallel.distributed.choose_backend": lambda: pdist.choose_backend(),
    "parallel.distributed.local_device": lambda: pdist.local_device(),
    "parallel.sharding.make_env_mesh": lambda: sharding.make_env_mesh(),
    **{f"examples.{name}.main": (lambda m=m: m.main([]))
       for name in ("profile_components", "scan_error_study", "generalization_study",
                    "mpc_demo", "lidar_bitmap_example")
       for m in [__import__(f"red_gym_tpu_torch.examples.{name}", fromlist=["main"])]},
    "env.make_params": lambda: env.make_params(CFG, assets.named_map_yaml(TRACK)),
    "env.make_multimap_params": lambda: env.make_multimap_params(
        CFG, assets.packaged_tracks()[:2]),
    "env.F110Env": lambda: env.F110Env(map=assets.named_map_yaml(TRACK), num_beams=270,
                                       rt_pose_stride=8),
    "maps.loader.load_map": lambda: loader.load_map(assets.named_map_yaml(TRACK)),
    "ops.scan.build_tables": lambda: scan.build_tables(CFG, 0.31, 0.58),
    "config.VehicleParams.default": lambda: VehicleParams.default(),
    "config.VehicleParams.from_dict": lambda: VehicleParams.from_dict({"mu": 0.5}),
    "interop.to_tensor": lambda: interop.to_tensor(np.zeros(3)),
    "interop.params_from_numpy": lambda: interop.params_from_numpy(CFG, {}, {}, {}, {}),
    "interop.texture_from_numpy": lambda: interop.texture_from_numpy(CFG, {}),
    "interop.state_from_numpy": lambda: interop.state_from_numpy({}),
    "vec_env.VecF110Env": lambda: vec_env.VecF110Env(assets.named_map_yaml(TRACK), 2,
                                                     num_beams=270),
    "make": lambda: red_gym_tpu_torch.make(assets.named_map_yaml(TRACK), num_beams=270),
    "make_vec": lambda: red_gym_tpu_torch.make_vec(assets.named_map_yaml(TRACK), 2,
                                                   num_beams=270),
    "gym_compat.make": lambda: gym_compat.make("f110_gym:f110-v0",
                                               map=assets.named_map_yaml(TRACK), num_beams=270),
    "gym_adapter.F110GymnasiumEnv": lambda: _gymnasium().make(
        "red_gym_tpu_torch/f110-v0", map=assets.named_map_yaml(TRACK), num_beams=270),
    "agents.planning_env.PlanningEnv": lambda: PlanningEnv(
        SimConfig(num_agents=1, num_beams=108),
        env.make_params(SimConfig(num_agents=1, num_beams=108), assets.named_map_yaml(TRACK),
                        device="cpu")),
    "agents.sac.SAC": lambda: SAC(obs_shape=(64, 64), action_dim=16),
    "agents.sac.ReplayBuffer.create": lambda: ReplayBuffer.create(4, (3,), 2),
    "utils.profiling.Metrics.init": lambda: Metrics.init(("reward",)),
    **{f"examples.{name}.build": (lambda m=m: m.build(m.parse_args([])))
       for name, m in SAC_TRAINERS.items()},
    "tuning.make_laptime_evaluator": lambda: make_laptime_evaluator(
        TOOL_CFG, assets.named_map_yaml(TRACK), _waypoints_cpu(), 5,
        assets.waypoint_start_poses(TRACK, 1)[0]),
    "tuning.search": lambda: search(TOOL_CFG, assets.named_map_yaml(TRACK), _waypoints_cpu(),
                                    assets.waypoint_start_poses(TRACK, 1)[0], popsize=2,
                                    generations=1, steps=5, log=None),
    "utils.export.export_policy": lambda: export.export_policy(
        export.deterministic_ppo_control(ppo.ScanPolicy(hidden=8), ppo.PPOConfig()),
        (torch.zeros(1, 1080), torch.zeros(1))),
    "agents.pure_pursuit.load_waypoints_csv": lambda: load_waypoints_csv(
        assets.waypoints_csv(TRACK)),
    "gym_vector.F110VectorEnv": lambda: _gymnasium().make_vec(
        "red_gym_tpu_torch/f110-v0", num_envs=2, map=assets.named_map_yaml(TRACK),
        num_beams=270),
}


def _gymnasium():
    return pytest.importorskip("gymnasium")


@pytest.mark.parametrize("name", list(ENTRY_POINTS))
def test_device_defaults_to_cuda(name):
    param = inspect.signature(ENTRY_POINTS[name]).parameters["device"]
    assert param.default == "cuda"


@pytest.mark.parametrize("name", list(CALLS_WITHOUT_DEVICE))
def test_call_without_device_raises_without_a_gpu(name):
    """On a machine without a GPU the default device raises and names the
    CPU opt-in; it never carries on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the default device is usable")
    with pytest.raises(RuntimeError, match="pass device='cpu'"):
        CALLS_WITHOUT_DEVICE[name]()


@pytest.mark.parametrize("name", list(SAC_TRAINERS))
def test_sac_trainer_device_flag_defaults_to_cuda(name):
    assert SAC_TRAINERS[name].parse_args([]).device == "cuda"


@pytest.mark.parametrize("name", ["train_sac_bitmap_scale", "train_sac_scale"])
def test_sac_trainer_seed_defaults_to_zero(name):
    """``--seed 0`` is the committed run: for the scan trainer, whose JAX
    script has no seed, it leaves every generator's seed as it was."""
    assert SAC_TRAINERS[name].parse_args([]).seed == 0


@pytest.mark.parametrize("name", list(TOOL_EXAMPLES))
def test_tool_example_device_flag_defaults_to_cuda(name):
    assert TOOL_EXAMPLES[name].parse_args([]).device == "cuda"


def test_device_edt_follows_the_map_device():
    """load_map(edt_backend="device") runs the EDT on the map's device: the
    default raises without a GPU, as every other entry point."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the default device is usable")
    with pytest.raises(RuntimeError, match="pass device='cpu'"):
        loader.load_map(assets.named_map_yaml(TRACK), edt_backend="device")


def test_resolve_device_passes_cpu_through():
    assert resolve_device("cpu") == torch.device("cpu")
    assert resolve_device(torch.device("cpu")) == torch.device("cpu")
