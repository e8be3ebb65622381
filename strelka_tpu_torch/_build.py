"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own
with nvcc into ``build/lib<name>.so`` at the repository root, loaded
with ctypes (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o build/lib<name>.so csrc/<name>.cu

A library is rebuilt when its source, or a header of csrc/ (``*.cuh``,
which the sources share), is newer. ``build_all`` starts one nvcc per
source at once and waits for all of them. Nothing here runs
when a module is imported: a kernel is built at its first launch.
"""
from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import sys
import time

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_LIBS: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str | None:
    """nvcc on PATH or in the toolkit's default place, else None."""
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    return path


def _nvcc() -> str:
    path = nvcc_path()
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "strelka_tpu_torch build on a machine with the "
                           "CUDA toolkit")
    return path


def sources() -> list[str]:
    """Kernel names, one per csrc/*.cu."""
    return sorted(os.path.splitext(os.path.basename(p))[0]
                  for p in glob.glob(os.path.join(CSRC, "*.cu")))


def lib_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}.so")


def _stale(name: str) -> bool:
    out = lib_path(name)
    inputs = [os.path.join(CSRC, f"{name}.cu"),
              *glob.glob(os.path.join(CSRC, "*.cuh"))]
    return (not os.path.exists(out)
            or os.path.getmtime(out) < max(map(os.path.getmtime, inputs)))


def _start(name: str) -> tuple[subprocess.Popen, str]:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = lib_path(name) + f".{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
           os.path.join(CSRC, f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), tmp


def _finish(name: str, proc: subprocess.Popen, tmp: str) -> None:
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{out}")
    os.replace(tmp, lib_path(name))


def build_all() -> dict[str, float]:
    """Build every stale kernel library, one nvcc per source started
    together. Returns {name: seconds} for the ones built."""
    t0 = time.perf_counter()
    procs = {n: _start(n) for n in sources() if _stale(n)}
    took = {}
    for n, (proc, tmp) in procs.items():
        _finish(n, proc, tmp)
        took[n] = time.perf_counter() - t0
    return took


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if stale."""
    lib = _LIBS.get(name)
    if lib is None:
        if _stale(name):
            t0 = time.perf_counter()
            _finish(name, *_start(name))
            print(f"built lib{name}.so in {time.perf_counter() - t0:.1f} s",
                  file=sys.stderr)
        lib = ctypes.CDLL(lib_path(name))
        _LIBS[name] = lib
    return lib
