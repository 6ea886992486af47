"""Parse the arguments, prepare the process, run one cell, print its line."""

from __future__ import annotations

import argparse
import importlib
import os
import sys

from harness import manifest, result

# build and kernel caches of the program and of PyTorch, at fixed paths
# inside the checkout (git-ignored), so that only a checkout's first run
# builds; the program's nvcc builds go to red_gym_tpu_torch/_build/ beside it
CACHE_DIRS = {"TORCH_EXTENSIONS_DIR": "torch_extensions", "TRITON_CACHE_DIR": "triton",
              "CUDA_CACHE_PATH": "cuda"}


def parse(argv: list[str]) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def prepare_environment(root: str) -> None:
    """Cache directories inside the checkout; the program's disk cache of
    range textures off (3.2 GB for the 11 tracks, written anew by every
    run, since HOME does not outlast one)."""
    for var, sub in CACHE_DIRS.items():
        path = os.path.join(root, ".bench_cache", sub)
        os.makedirs(path, exist_ok=True)
        os.environ[var] = path
    os.environ["RED_GYM_TPU_TEXTURE_CACHE"] = "off"


def main(argv: list[str], root: str) -> int:
    args = parse(argv)
    prepare_environment(root)
    cell = manifest.find_cell(manifest.load_manifest(root), args.workload, root)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"needs {cell.chips} CUDA device(s): torch.cuda.is_available() is "
              f"{torch.cuda.is_available()}, device_count() "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    runner = importlib.import_module(f"harness.{cell.traffic['runner']}")
    run = runner.run(cell, args.seed, args.seconds, bool(args.trace), device)
    found = result.forbidden_modules()
    if found:
        print(f"modules of JAX or of the JAX package are loaded: {found}",
              file=sys.stderr)
        return 3
    metrics = (result.per_layer_metrics(cell, run) if args.trace
               else result.end_to_end_metrics(cell, run))
    result.emit(cell, run, metrics, device)
    return 0
