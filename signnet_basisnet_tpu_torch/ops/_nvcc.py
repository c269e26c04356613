"""Compiles and loads every CUDA kernel of the port: nvcc + ctypes.

`load(name, argtypes)` compiles ``csrc/<name>.cu`` with `NVCC_FLAGS` into a
shared library under ``_build/`` (gitignored), once per hash of source and
flags, loads it with ctypes, sets each entry's prototype from `argtypes`
({entry name: [ctypes types]}, every entry returning a C int, the
`cudaGetLastError()` after its launch) and returns the `ctypes.CDLL`.  The
library is built at first use, never when a module is imported.  The build
writes to a temporary file and renames it into place, so a build that dies
leaves nothing behind that a later one would load.  nvcc's `-Xptxas -v`
report is kept beside the library (``lib<name>_<tag>.ptxas``, written
first) and read back when the library is reused, so `build_info` holds it
on every run; a library without its report is built again.  There is no
fallback: a failed build raises.  `torch.utils.cpp_extension` is not used:
its builds include PyTorch's headers and take minutes.

`refuse_dtensor` is every kernel wrapper's guard against a DTensor, whose
storage is a rank's shard and never goes to a kernel through ctypes.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from typing import Dict, List

from ..graph.segment import is_dtensor

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_libs: Dict[str, ctypes.CDLL] = {}
# per kernel source, what its build did: seconds of nvcc (about 0 when the
# library was already built), nvcc's -Xptxas -v report (from the build or
# read back beside the library), the library's path
build_info: Dict[str, dict] = {}


def refuse_dtensor(kernel: str, *tensors) -> None:
    """TypeError if a tensor handed to the wrapper of `kernel` is a
    DTensor: a kernel runs on plain tensors only, under GSPMD on each
    rank's full operands (parallel/gspmd.py: `on_replicated`)."""
    if any(is_dtensor(t) for t in tensors):
        raise TypeError(
            f"{kernel}: handed a DTensor; the kernel takes plain tensors "
            "(under GSPMD run it through parallel.gspmd.on_replicated)")


def source_path(name: str) -> str:
    return os.path.join(CSRC_DIR, f"{name}.cu")


def _find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                            "bin", "nvcc")
        if os.path.exists(cand):
            nvcc = cand
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "signnet_basisnet_tpu_torch need the CUDA toolkit")
    return nvcc


def load(name: str, argtypes: Dict[str, List]) -> ctypes.CDLL:
    """Build csrc/<name>.cu (once per source and flags) and load it."""
    if name in _libs:
        return _libs[name]
    src_path = source_path(name)
    with open(src_path, "rb") as f:
        src = f.read()
    tag = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    path = os.path.join(BUILD_DIR, f"lib{name}_{tag}.so")
    report = os.path.join(BUILD_DIR, f"lib{name}_{tag}.ptxas")
    info = {"seconds": 0.0, "ptxas": "", "path": path}
    t0 = time.time()
    if not (os.path.exists(path) and os.path.exists(report)):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        proc = subprocess.run([_find_nvcc(), *NVCC_FLAGS, "-o", tmp,
                               src_path], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src_path}:\n{proc.stdout}"
                               f"{proc.stderr}")
        with open(f"{report}.{os.getpid()}.tmp", "w") as f:
            f.write((proc.stdout + proc.stderr).strip())
        os.replace(f"{report}.{os.getpid()}.tmp", report)
        os.replace(tmp, path)
    with open(report) as f:
        info["ptxas"] = f.read()
    info["seconds"] = time.time() - t0
    lib = ctypes.CDLL(path)
    for entry, types in argtypes.items():
        fn = getattr(lib, entry)
        fn.restype = ctypes.c_int
        fn.argtypes = types
    build_info[name] = info
    _libs[name] = lib
    return lib
