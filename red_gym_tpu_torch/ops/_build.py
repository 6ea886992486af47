"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C entry point.  It is compiled with
``nvcc`` at first use into ``red_gym_tpu_torch/_build/`` (git-ignored) and
loaded with ctypes.  The library file name carries a hash of the sources and
flags, so an edited kernel is rebuilt and an unchanged one is reused.
``build_all`` compiles every source at once, one ``nvcc`` process each.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import re
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# flags of one kernel on top of NVCC_FLAGS: the state kernel, the march, the
# rasterizer and the EDT must round every operation on its own, as the PyTorch code
# they mirror does (no FMA contraction)
EXTRA_FLAGS = {"prestep": ("-fmad=false",), "march": ("-fmad=false",),
               "rasterize": ("-fmad=false",), "edt": ("-fmad=false",)}


def nvcc_path() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, nvcc on PATH, or the
    toolkit's default location."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    if shutil.which("nvcc"):
        candidates.append(shutil.which("nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit (set CUDA_HOME)")


def kernel_names() -> list[str]:
    """Every kernel source under csrc/, by name."""
    return sorted(os.path.splitext(os.path.basename(p))[0]
                  for p in glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless an up-to-date library exists;
    return the library path.  The compiler's report (registers, spills)
    is kept beside it as ``<library>.log``."""
    src = os.path.join(CSRC_DIR, f"{name}.cu")
    flags = NVCC_FLAGS + EXTRA_FLAGS.get(name, ())
    h = hashlib.sha256(" ".join(flags).encode())
    for path in [src] + sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh"))):
        with open(path, "rb") as f:
            h.update(f.read())
    lib = os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")
    if os.path.exists(lib):
        return lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    proc = subprocess.run([nvcc_path(), *flags, "-o", tmp, src],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}{proc.stderr}")
    with open(lib + ".log", "w") as f:
        f.write(proc.stdout + proc.stderr)
    os.replace(tmp, lib)
    return lib


def _demangle(names: list[str]) -> list[str]:
    """C++ symbol names through the toolkit's cu++filt (or c++filt)."""
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    tools = [shutil.which("cu++filt"), os.path.join(cuda_home, "bin", "cu++filt"),
             shutil.which("c++filt")]
    tool = next((t for t in tools if t and os.path.exists(t)), None)
    if tool is None:
        raise RuntimeError("neither cu++filt nor c++filt found to demangle the "
                           "ptxas report")
    proc = subprocess.run([tool], input="\n".join(names) + "\n", capture_output=True,
                          text=True, check=True)
    return proc.stdout.splitlines()[:len(names)]


def ptxas_report(lib: str) -> dict[str, dict]:
    """Registers and spills of each kernel in a built library, from the
    ptxas report kept beside it: {kernel: {"regs": n, "spill_bytes": n}},
    keyed by the demangled name with its template arguments and without
    its namespace and parameters (``theta_spectral_kernel<float, true>``).
    ``spill_bytes`` is the bytes of spill stores plus spill loads."""
    entries, current, props = {}, None, None
    with open(lib + ".log") as f:
        for line in f:
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                current = m.group(1)
                entries[current] = {"regs": None, "spill_bytes": 0}
                continue
            m = re.search(r"Function properties for (\S+)", line)
            if m:
                props = m.group(1)
                continue
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m and props == current and current is not None:
                entries[current]["spill_bytes"] = int(m.group(1)) + int(m.group(2))
                continue
            m = re.search(r"Used (\d+) registers", line)
            if m and current is not None:
                entries[current]["regs"] = int(m.group(1))
    return {kernel_name(d): entries[m] for m, d in zip(entries, _demangle(list(entries)))}


def kernel_name(demangled: str) -> str:
    """``void <unnamed>::k<(int)1, (bool)1>(const float *, int)`` (cu++filt)
    or ``void (anonymous namespace)::k<1, true>(float const*, int)``
    (c++filt) -> ``k<1, true>``."""
    depth = 0
    for i in range(len(demangled) - 1, -1, -1):  # the parameter list's "("
        depth += {")": 1, "(": -1}.get(demangled[i], 0)
        if depth == 0:
            break
    head = demangled[:i].removeprefix("void ")
    head = head.replace("<unnamed>::", "").replace("(anonymous namespace)::", "")
    head = head.replace("(bool)1", "true").replace("(bool)0", "false")
    return re.sub(r"\((?:unsigned )?(?:int|long)\)(-?\d+)", r"\1", head)


def build_all() -> dict[str, str]:
    """Build every kernel under csrc/ in parallel; {name: library path}."""
    names = kernel_names()
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        return dict(zip(names, pool.map(build, names)))


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu`` (built on first call)."""
    return ctypes.CDLL(build(name))
