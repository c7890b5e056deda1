"""Build the port's CUDA sources (``csrc/*.cu``) into shared libraries.

Route: ``nvcc`` straight to a ``.so`` with a plain C interface, loaded with
``ctypes`` -- seconds per source, where a build against PyTorch's headers
takes minutes.  Each library is built at first use into ``_build/`` beside
the package (listed in ``.gitignore``) and named by a hash of its source and
flags, so an edit rebuilds and an unchanged source is reused.  Sources
include the headers beside them (``csrc/*.cuh``) by a relative path.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PKG = Path(__file__).resolve().parents[1]
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    nvcc = Path(cuda_home) / "bin" / "nvcc"
    if not nvcc.exists():
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin); cannot build the CUDA kernels")
    return str(nvcc)


def library_path(source: str, directory: Path = CSRC) -> Path:
    """Where ``<directory>/<source>``'s library goes (``csrc/`` unless a
    record under ``scripts/`` is built): named by a hash of the source, the
    port's headers (``csrc/*.cuh``) and the flags."""
    src = directory / source
    text = src.read_bytes() + b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{src.stem}-{digest}.so"


def build(source: str, directory: Path = CSRC) -> float:
    """Compile ``<directory>/<source>`` unless its library exists; the
    seconds taken (0.0 when already built).

    The ptxas report (registers, shared memory, spills) lands beside the
    library as ``<name>.log``.  Raises with nvcc's output on failure.
    """
    out = library_path(source, directory)
    if out.exists():
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(directory / source)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    took = time.perf_counter() - t0
    out.with_suffix(".log").write_text(proc.stdout)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source} (exit {proc.returncode}):\n{proc.stdout}")
    os.replace(tmp, out)
    return took


@functools.cache
def load_library(source: str, directory: Path = CSRC) -> ctypes.CDLL:
    """The built library of ``<directory>/<source>``, building it first if
    needed."""
    build(source, directory)
    return ctypes.CDLL(str(library_path(source, directory)))
