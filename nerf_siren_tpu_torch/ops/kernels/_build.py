"""Build the hand-written CUDA kernels from the sources in this package.

Each `csrc/*.cu` file is compiled by `nvcc` into a shared library with a
plain C interface and loaded with `ctypes` (no PyTorch headers, so a build
takes seconds). Libraries go to `nerf_siren_tpu_torch/_build/`, named by a
hash of the source, the shared headers (`csrc/*.cuh`) and the flags, so an
edited source, header or flag rebuilds and an unchanged one is loaded as it
is. Nothing is built at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict

PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
_COUNT_LOCK = threading.Lock()


def count_launch(counts: Dict[str, int], key: str) -> None:
    """Add one to a wrapper's launch count: under a lock, since the slabs of
    a mesh launch from a host thread each."""
    with _COUNT_LOCK:
        counts[key] += 1


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").is_file():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return found


def build(name: str) -> Path:
    """Compile `csrc/<name>.cu` unless an up-to-date library exists; returns
    the library path. `nvcc -Xptxas -v` output (registers, shared memory,
    spills) is kept beside it as `<lib>.log`."""
    src = CSRC_DIR / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):   # shared device code
        h.update(header.name.encode() + header.read_bytes())
    digest = hashlib.sha256(h.digest() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"lib{name}_{digest}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(src)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}\n{proc.stderr}")
        Path(str(lib) + ".log").write_text(proc.stdout + proc.stderr)
        os.replace(tmp, lib)  # atomic: a concurrent build never loads a partial file
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load `csrc/<name>.cu`, once per process."""
    with _LOCK:
        if name not in _LIBS:
            _LIBS[name] = ctypes.CDLL(str(build(name)))
        return _LIBS[name]
