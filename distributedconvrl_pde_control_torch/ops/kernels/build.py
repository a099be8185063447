"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each source under ``distributedconvrl_pde_control_torch/csrc/`` exposes a
plain C interface and is compiled on its own into a shared library under
``build/kernels/`` at the root of the checkout (git-ignored), at first use.
The sources share the headers (``*.cuh``) beside them. The library's name
carries a hash of the source, the headers and the flags, so an edited source
or header is rebuilt and an unchanged one is loaded as it is.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "kernels"

NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas",
    "-v",
)

_LOADED: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH): "
                       "the port's CUDA kernels are built from source at first use")


def _target(source: str) -> Path:
    src = (CSRC_DIR / source).read_bytes()
    src += b"".join(h.read_bytes() for h in sorted(CSRC_DIR.glob("*.cuh")))
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{Path(source).stem}_{key}.so"


def build(source: str) -> str:
    """Build `source` unless its library is already built. Returns nvcc's
    output (the -Xptxas -v lines) of the build that made the library.

    Builds of different sources may run at the same time (one thread or
    process each): every source has its own library and log file, nvcc keeps
    its intermediates in per-process temporary files, and creating the build
    directory tolerates that it exists. Two builds of the SAME source at once
    are not supported."""
    target = _target(source)
    log_path = target.with_suffix(".log")
    if not target.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(target), str(CSRC_DIR / source)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            target.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed on {source} (exit {proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        log_path.write_text(proc.stdout + proc.stderr)
    return log_path.read_text() if log_path.exists() else ""


def load(source: str) -> ctypes.CDLL:
    """The loaded library of `source`, built at first use."""
    if source not in _LOADED:
        build(source)
        _LOADED[source] = ctypes.CDLL(str(_target(source)))
    return _LOADED[source]
