"""Build and load the port's CUDA kernels.

Each kernel library is one ``csrc/<name>.cu`` with a plain C entry point,
compiled by ``nvcc`` into ``_build/lib<name>.so`` inside the package and
loaded with ctypes. It is built at first use and rebuilt when a digest of
its source and flags changes (the idiom of the package's native.py).
Nothing is compiled when a module is imported, so the CPU tests import
every module on a machine with no CUDA toolkit.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess

_PKG = pathlib.Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD = _PKG / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found on PATH or under $CUDA_HOME/bin: "
                       "the CUDA kernels cannot be built")


def _digest(src: pathlib.Path) -> str:
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()


def build(name: str) -> pathlib.Path:
    """Compile csrc/<name>.cu unless an up-to-date build exists; return
    the library path. The compiler's output (ptxas register and shared
    memory use) is kept in _build/<name>.log."""
    src = CSRC / f"{name}.cu"
    lib = BUILD / f"lib{name}.so"
    stamp = BUILD / f"{name}.hash"
    digest = _digest(src)
    if lib.exists() and stamp.exists() and stamp.read_text() == digest:
        return lib
    BUILD.mkdir(exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                          capture_output=True, text=True)
    (BUILD / f"{name}.log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed to build {src.name} "
                           f"(exit {proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, lib)
    stamp.write_text(digest)
    return lib


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of kernel library `name`, built if needed."""
    return ctypes.CDLL(str(build(name)))
