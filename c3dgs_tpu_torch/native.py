"""The host codec (port of c3dgs_tpu/native/__init__.py): the COLMAP
points3D.bin parser and the Morton order in C++ (csrc/codec.cpp), bound
with ctypes.

The library is built with g++ at first use into build/c3dgs_tpu_torch/
under a name that carries a hash of the source and the flags
(kernels.compile_libraries: a concurrent build never reads a half-written
file), never beside the source. There is no fallback: a missing compiler
or a failed build or load raises, with the compiler's output. The numpy
versions, data/colmap.py::read_points3D_binary and
ops/morton.py::morton_order, give the same arrays; the tests hold the
codec against them.

Each bound function counts its calls in `calls`, as a kernel counts its
launches.
"""
from __future__ import annotations

import ctypes
import shutil
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np

from . import kernels

SOURCE = "codec.cpp"
CXX = "g++"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

calls: Dict[str, int] = {"colmap_points3d_parse": 0, "morton_order_f32": 0}
_lib: Optional[ctypes.CDLL] = None


def compiler() -> str:
    found = shutil.which(CXX)
    if found is None:
        raise RuntimeError(f"{CXX} not found: the host codec (csrc/{SOURCE}) needs a C++ compiler")
    return found


def library_path() -> Path:
    return kernels.library_path(SOURCE, CXX_FLAGS)


def get_lib() -> ctypes.CDLL:
    """The codec's library, built first if needed."""
    global _lib
    if _lib is None:
        kernels.compile_libraries([SOURCE], compiler, CXX_FLAGS, "host codec")
        lib = ctypes.CDLL(str(library_path()))
        lib.colmap_points3d_parse.restype = ctypes.c_longlong
        lib.colmap_points3d_parse.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_double),
            ctypes.c_longlong,
            ctypes.c_int,
        ]
        lib.morton_order_f32.restype = None
        lib.morton_order_f32.argtypes = [ctypes.POINTER(ctypes.c_float), ctypes.c_longlong,
                                         ctypes.POINTER(ctypes.c_int)]
        _lib = lib
    return _lib


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def read_points3d_binary(path) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """points3D.bin -> (xyz (N, 3) f64, rgb (N, 3) u8, error (N,) f64)."""
    lib = get_lib()
    name = str(path).encode()
    n = lib.colmap_points3d_parse(name, None, None, None, 0, 1)
    if n < 0:
        raise FileNotFoundError(path)
    xyz = np.empty((n, 3), np.float64)
    rgb = np.empty((n, 3), np.uint8)
    err = np.empty(n, np.float64)
    got = lib.colmap_points3d_parse(name, _ptr(xyz, ctypes.c_double), _ptr(rgb, ctypes.c_uint8),
                                    _ptr(err, ctypes.c_double), n, 0)
    calls["colmap_points3d_parse"] += 1
    if got != n:
        raise ValueError(f"{path}: parsed {got} of {n} points (a truncated file)")
    return xyz, rgb, err


def morton_order(xyz: np.ndarray) -> np.ndarray:
    """The Morton-order permutation (int64) of (N, 3) points, taken as f32."""
    lib = get_lib()
    xyz32 = np.ascontiguousarray(xyz, np.float32)
    perm = np.empty(len(xyz32), np.int32)
    lib.morton_order_f32(_ptr(xyz32, ctypes.c_float), len(xyz32), _ptr(perm, ctypes.c_int))
    calls["morton_order_f32"] += 1
    return perm.astype(np.int64)
