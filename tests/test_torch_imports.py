"""red_gym_tpu_torch stands alone: no JAX, nothing of red_gym_tpu, and no
Triton import at module level (it exists only on the GPU machine).
gymnasium, which the GPU machine lacks too, is imported only by the
gymnasium modules, and matplotlib only inside the viewer's functions."""

import ast
import glob
import os

import pytest

PKG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "red_gym_tpu_torch")
SOURCES = sorted(glob.glob(os.path.join(PKG, "**", "*.py"), recursive=True))
# learning_ab.py, at the repo root, runs JAX's trainers beside the port's
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "red_gym_tpu", "learning_ab")


def _imports(tree):
    """(module name, at module level) for every import statement."""
    top = {id(n) for n in tree.body}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name, id(node) in top
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module, id(node) in top


def test_package_has_sources():
    names = {os.path.relpath(p, PKG) for p in SOURCES}
    assert {"env.py", "rollout.py", "interop.py", "ops/scan_kernels.py",
            "agents/pure_pursuit.py", "agents/ppo.py", "utils/checkpoint.py",
            "examples/train_ppo.py", "ops/collision.py", "vec_env.py",
            "gym_compat.py", "_registration.py", "gym_adapter.py", "gym_vector.py",
            "render/viewer.py", "utils/debug.py", "utils/profiling.py",
            "ops/rasterize.py", "ops/raster_kernels.py", "ops/bitmap_rewards.py",
            "agents/mpc.py", "agents/planning_env.py", "agents/sac.py",
            "examples/train_sac.py", "examples/train_sac_scale.py",
            "examples/train_sac_bitmap_scale.py", "ops/edt.py", "ops/edt_kernels.py",
            "maps/trackgen.py", "maps/classic.py", "tuning/param_search.py",
            "utils/export.py", "examples/param_search_cma.py",
            "examples/export_policy.py", "examples/waypoint_follow.py",
            "examples/waypoint_follow_compat.py",
            "examples/collect_lidar_dataset.py", "parallel/__init__.py",
            "parallel/distributed.py", "parallel/sharding.py", "parallel/draws.py",
            "examples/profile_components.py", "examples/scan_error_study.py",
            "examples/generalization_study.py", "examples/mpc_demo.py",
            "examples/lidar_bitmap_example.py"} <= names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: os.path.relpath(p, PKG))
def test_no_forbidden_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for name, at_top in _imports(tree):
        root = name.split(".")[0]
        assert root not in FORBIDDEN, f"{path} imports {name}"
        assert not (root == "triton" and at_top), \
            f"{path} imports triton at module level"


GYMNASIUM_MODULES = {"_registration.py", "gym_adapter.py", "gym_vector.py"}


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: os.path.relpath(p, PKG))
def test_gymnasium_and_matplotlib_stay_in_their_modules(path):
    """The torch-only core (the env, VecF110Env, gym_compat, the debug
    helpers) runs where neither gymnasium nor matplotlib is installed."""
    rel = os.path.relpath(path, PKG)
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for name, at_top in _imports(tree):
        root = name.split(".")[0]
        if root == "gymnasium":
            assert rel in GYMNASIUM_MODULES, f"{rel} imports {name}"
        if root == "matplotlib":
            assert rel == "render/viewer.py" and not at_top, \
                f"{rel} imports {name}" + (" at module level" if at_top else "")


# the tooling tier (maps, EDT, tuning, export and their examples), the
# data-parallel trainer and the last five examples: each imports in a
# fresh interpreter where the packages the GPU machine lacks
# (and JAX) cannot be imported at all
TOOL_MODULES = ["red_gym_tpu_torch.ops.edt", "red_gym_tpu_torch.ops.edt_kernels",
                "red_gym_tpu_torch.maps.loader", "red_gym_tpu_torch.maps.trackgen",
                "red_gym_tpu_torch.maps.classic", "red_gym_tpu_torch.tuning",
                "red_gym_tpu_torch.utils.export",
                "red_gym_tpu_torch.examples.param_search_cma",
                "red_gym_tpu_torch.examples.export_policy",
                "red_gym_tpu_torch.examples.waypoint_follow",
                "red_gym_tpu_torch.examples.waypoint_follow_compat",
                "red_gym_tpu_torch.examples.collect_lidar_dataset",
                # the data-parallel trainer and the last five examples
                "red_gym_tpu_torch.parallel.distributed",
                "red_gym_tpu_torch.parallel.sharding",
                "red_gym_tpu_torch.examples.train_ppo",
                "red_gym_tpu_torch.examples.profile_components",
                "red_gym_tpu_torch.examples.scan_error_study",
                "red_gym_tpu_torch.examples.generalization_study",
                "red_gym_tpu_torch.examples.mpc_demo",
                "red_gym_tpu_torch.examples.lidar_bitmap_example"]
ABSENT = ("jax", "jaxlib", "flax", "red_gym_tpu", "PIL", "cv2", "yaml", "gymnasium",
          "matplotlib")


@pytest.mark.parametrize("module", TOOL_MODULES)
def test_tool_modules_need_no_absent_package(module):
    import subprocess
    import sys

    code = (f"import sys\n"
            f"for name in {ABSENT!r}:\n"
            f"    sys.modules[name] = None   # import raises ImportError\n"
            f"import {module}\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=os.path.dirname(PKG), timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
