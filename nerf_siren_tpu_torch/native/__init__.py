"""The host library of ray generation (`raygen.cpp`), built with g++ at
first use and bound with ctypes.

Counterpart of `nerf_siren_tpu/native/__init__.py`: the same source, the
same flags (`-O3 -march=native -shared -fPIC`) and the same functions
(`ray_directions`, `world_rays`, `ndc_rays`, `blend_rgba_white`,
`pack_rays`, `available`). The library goes to `nerf_siren_tpu_torch/_build/`
(beside the CUDA kernels' libraries), named by a hash of the source, the
flags and the host's name: `-march=native` makes it a library of the
machine that built it, and that directory is never committed. Where no
compiler exists `available()` is False and `datasets/ray_utils.py`
computes the same rays in numpy; `build_error()` says why. Nothing is
built at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

import numpy as np

SRC = Path(__file__).resolve().parent / "raygen.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")

_lib: Optional[ctypes.CDLL] = None
_tried = False
_error: Optional[str] = None
_lock = threading.Lock()


def library_path() -> Path:
    """Where the library of the current source, flags and host lives."""
    key = SRC.read_bytes() + " ".join(FLAGS + (platform.node(),)).encode()
    digest = hashlib.sha256(key).hexdigest()[:16]
    return BUILD_DIR / f"raygen_{digest}.so"


def _build() -> Optional[Path]:
    global _error
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(["g++", *FLAGS, str(SRC), "-o", tmp],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, so)   # atomic: a concurrent build never loads a partial file
        return so
    except (OSError, subprocess.SubprocessError) as e:
        _error = f"{type(e).__name__}: {e}"
        return None
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        so = _build()
        if so is None:
            return None
        lib = ctypes.CDLL(str(so))
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        i64 = ctypes.c_int64
        lib.ray_directions.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_float, f32p]
        lib.world_rays.argtypes = [f32p, f32p, i64, f32p, f32p]
        lib.ndc_rays.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                                 ctypes.c_float, i64, f32p, f32p]
        lib.blend_rgba_white.argtypes = [u8p, i64, f32p]
        lib.pack_rays.argtypes = [f32p, f32p, ctypes.c_float, ctypes.c_float, i64, f32p]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def build_error() -> Optional[str]:
    """Why the library could not be built (None if it was, or was not tried)."""
    return _error


def ray_directions(H: int, W: int, focal: float) -> np.ndarray:
    lib = _load()
    out = np.empty((H, W, 3), np.float32)
    lib.ray_directions(H, W, float(focal), out)
    return out


def world_rays(dirs: np.ndarray, c2w: np.ndarray):
    lib = _load()
    dirs = np.ascontiguousarray(dirs.reshape(-1, 3), np.float32)
    c2w = np.ascontiguousarray(c2w, np.float32)
    n = dirs.shape[0]
    rays_o = np.empty((n, 3), np.float32)
    rays_d = np.empty((n, 3), np.float32)
    lib.world_rays(dirs, c2w, n, rays_o, rays_d)
    return rays_o, rays_d


def ndc_rays(H: int, W: int, focal: float, near: float,
             rays_o: np.ndarray, rays_d: np.ndarray):
    lib = _load()
    rays_o = np.ascontiguousarray(rays_o, np.float32).copy()
    rays_d = np.ascontiguousarray(rays_d, np.float32).copy()
    lib.ndc_rays(H, W, float(focal), float(near), rays_o.shape[0], rays_o, rays_d)
    return rays_o, rays_d


def blend_rgba_white(rgba: np.ndarray) -> np.ndarray:
    lib = _load()
    rgba = np.ascontiguousarray(rgba.reshape(-1, 4), np.uint8)
    out = np.empty((rgba.shape[0], 3), np.float32)
    lib.blend_rgba_white(rgba, rgba.shape[0], out)
    return out


def pack_rays(rays_o: np.ndarray, rays_d: np.ndarray,
              near: float, far: float) -> np.ndarray:
    lib = _load()
    rays_o = np.ascontiguousarray(rays_o, np.float32)
    rays_d = np.ascontiguousarray(rays_d, np.float32)
    out = np.empty((rays_o.shape[0], 8), np.float32)
    lib.pack_rays(rays_o, rays_d, float(near), float(far), rays_o.shape[0], out)
    return out
