"""ctypes binding of the native terrain toolkit (native/terrain_gen.cpp,
built as native/libterrain_gen.so by ``make -C native``): the port's own
copy of the JAX package's ``envs/terrain_native.py``.

It binds the five sub-terrain generators and the heightfield -> trimesh
conversion with vertical-wall correction at steep slopes. Unlike the JAX
copy, which falls back to NumPy when the library is missing or does not
load, this one raises: a caller that asks for the native path gets it or
an error. The port's terrain (:mod:`.terrain`) builds its maps in NumPy
and does not need the library.
"""

from __future__ import annotations

import ctypes
import os
from typing import Tuple

import numpy as np

from .. import ROOT_DIR

LIB_PATH = os.path.join(ROOT_DIR, "native", "libterrain_gen.so")

_lib = None

c_i16p = np.ctypeslib.ndpointer(np.int16, flags="C_CONTIGUOUS")
c_f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
c_u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
i64, u64, f64 = ctypes.c_int64, ctypes.c_uint64, ctypes.c_double

# C argument types after (hf, width, length)
_GENERATORS = {
    "random_uniform_terrain": [f64] * 6 + [u64],
    "pyramid_sloped_terrain": [f64] * 4,
    "pyramid_stairs_terrain": [f64] * 5,
    "discrete_obstacles_terrain": [f64] * 3 + [i64] + [f64] * 3 + [u64],
    "stepping_stones_terrain": [f64] * 7 + [u64],
}


def load() -> ctypes.CDLL:
    """The library, loaded once; raises when it is missing or does not
    load."""
    global _lib
    if _lib is None:
        if not os.path.exists(LIB_PATH):
            raise FileNotFoundError(
                f"{LIB_PATH} is missing: build it with `make -C native`")
        lib = ctypes.CDLL(LIB_PATH)
        for name, args in _GENERATORS.items():
            getattr(lib, name).argtypes = [c_i16p, i64, i64] + args
            getattr(lib, name).restype = None
        lib.heightfield_to_trimesh.argtypes = [
            c_i16p, i64, i64, f64, f64, f64, c_f32p, c_u32p]
        lib.heightfield_to_trimesh.restype = None
        _lib = lib
    return _lib


def generate(name: str, hf: np.ndarray, *args) -> np.ndarray:
    """Run the native generator ``name`` (a key of the C toolkit's five)
    on the int16 height field ``hf`` [width, length] in place, with the C
    arguments that follow (width, length) in the C order; returns hf."""
    if name not in _GENERATORS:
        raise KeyError(f"no native generator {name!r}")
    if hf.dtype != np.int16 or not hf.flags["C_CONTIGUOUS"]:
        raise ValueError("hf must be a C-contiguous int16 array")
    getattr(load(), name)(hf, hf.shape[0], hf.shape[1], *args)
    return hf


def convert_heightfield_to_trimesh(
    height_field_raw: np.ndarray, horizontal_scale: float,
    vertical_scale: float, slope_threshold: float = 0.75,
) -> Tuple[np.ndarray, np.ndarray]:
    """Heightfield -> (vertices [V, 3] float32, triangles [T, 3] uint32)
    with vertical-wall correction at steep slopes."""
    hf = np.ascontiguousarray(height_field_raw, np.int16)
    rows, cols = hf.shape
    vertices = np.empty((rows * cols, 3), np.float32)
    triangles = np.empty((2 * (rows - 1) * (cols - 1), 3), np.uint32)
    load().heightfield_to_trimesh(hf, rows, cols, horizontal_scale,
                                  vertical_scale, slope_threshold, vertices,
                                  triangles)
    return vertices, triangles
