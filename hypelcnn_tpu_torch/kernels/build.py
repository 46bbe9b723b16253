"""Build the hand-written CUDA kernels with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled on its own
into ``_build/<name>-<hash>.so`` inside this package, where ``hash`` covers the
source and the compiler flags: a changed source builds anew, an unchanged one
is loaded from the earlier build. ptxas's report of each kernel's registers,
shared memory and spills (``-Xptxas -v``) is kept beside the library as
``<name>-<hash>.ptxas.txt``. Nothing is built when a module is imported; a
wrapper builds its library at its first launch.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict

PACKAGE_DIR = Path(__file__).resolve().parent.parent
SOURCE_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOADED: Dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the "
                           "CUDA toolkit is installed")
    return nvcc


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its current build exists; return the .so path.

    The library is written under a temporary name and renamed into place, so
    processes that build the same source at once never load a partial file.
    """
    source = SOURCE_DIR / f"{name}.cu"
    digest = hashlib.sha256(source.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    target = BUILD_DIR / f"{name}-{digest[:16]}.so"
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, str(source)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        lines = (proc.stdout + proc.stderr).splitlines()
        target.with_suffix(".ptxas.txt").write_text("".join(
            line.strip() + "\n" for line in lines if line.startswith("ptxas") or "spill" in line))
        os.replace(tmp, target)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return target


def ptxas_report(name: str) -> list:
    """The ptxas lines of the current build of ``csrc/<name>.cu``
    (its kernels' registers, shared memory and spills); builds it if needed."""
    return build(name).with_suffix(".ptxas.txt").read_text().splitlines()


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)))
        _LOADED[name] = lib
    return lib
