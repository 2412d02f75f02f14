"""Native (C++) host-side components, loaded with ctypes (counterpart of
street_gaussians_ns_tpu/native/__init__.py).

`colmap_reader.cpp` parses COLMAP's points3D.bin in one buffered pass; the
per-record Python loop costs minutes at LiDAR scale. It is built with g++
at first use into `build/torch_native/` beside the package (listed in
.gitignore). As in the JAX package, a failed build or load leaves the
caller on the Python reader; unlike it, the failure is kept and can be
read back (`load_error`), and `data.colmap_io.POINTS3D_READERS` counts
which reader parsed each file.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import threading
from typing import Optional

import numpy as np

_SRC = pathlib.Path(__file__).resolve().parent / "colmap_reader.cpp"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "torch_native"
_lock = threading.Lock()
_lib = None
_error: Optional[str] = None


def _library_path() -> pathlib.Path:
    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"libsgnt_native-{digest}.so"


def _load() -> Optional[ctypes.CDLL]:
    """Build (once) and dlopen the native library; None on failure, with
    the reason kept for load_error()."""
    global _lib, _error
    with _lock:
        if _lib is not None or _error is not None:
            return _lib
        try:
            so = _library_path()
            if not so.exists():
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
                subprocess.run(
                    ["g++", "-O3", "-shared", "-fPIC", str(_SRC), "-o",
                     str(tmp)], check=True, capture_output=True, timeout=120)
                tmp.replace(so)
            lib = ctypes.CDLL(str(so))
        except (OSError, subprocess.SubprocessError) as e:
            detail = getattr(e, "stderr", b"") or b""
            _error = f"{type(e).__name__}: {e} {detail.decode(errors='replace')}"
            return None
        lib.sgnt_points3d_count.restype = ctypes.c_longlong
        lib.sgnt_points3d_count.argtypes = [ctypes.c_char_p]
        lib.sgnt_read_points3d.restype = ctypes.c_longlong
        lib.sgnt_read_points3d.argtypes = [
            ctypes.c_char_p, ctypes.c_longlong,
            ctypes.POINTER(ctypes.c_longlong),
            ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_ubyte),
            ctypes.POINTER(ctypes.c_double),
        ]
        _lib = lib
        return _lib


def load_error() -> Optional[str]:
    """Why the native library could not be built or loaded (None if it
    loaded or was never asked for)."""
    return _error


def read_points3d_binary(path) -> Optional[tuple]:
    """Native points3D.bin parse; None if the library is unavailable or
    the file cannot be parsed whole (the caller then uses the Python
    reader). Returns (xyz (N,3) f64, rgb (N,3) u8, error (N,) f64,
    ids (N,) i64)."""
    lib = _load()
    if lib is None:
        return None
    p = str(path).encode()
    n = lib.sgnt_points3d_count(p)
    if n < 0:
        return None
    ids = np.empty(n, np.int64)
    xyz = np.empty((n, 3), np.float64)
    rgb = np.empty((n, 3), np.uint8)
    err = np.empty(n, np.float64)
    got = lib.sgnt_read_points3d(
        p, n,
        ids.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
        xyz.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        rgb.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        err.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    if got != n:
        return None
    return xyz, rgb, err, ids
