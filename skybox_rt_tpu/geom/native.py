"""ctypes bindings for the native C++ binning engine (native/binning.cpp).

The reference's host pipeline is native C++ (graphics::Binning runs inside
the draw3d host process); this module keeps that tier: the per-frame host
hot loop is compiled C++, with the numpy implementation as the behavioral
oracle and automatic fallback.  Built on demand with g++ (-O3
-ffp-contract=off so float32 results stay bit-identical to numpy).

Disable with SKYBOX_NATIVE=0.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_SRC = os.path.join(_REPO_ROOT, "native", "binning.cpp")
_LIB = os.path.join(_REPO_ROOT, "native", "libskybox_native.so")

_lock = threading.Lock()
_lib = None
_load_failed = False


class _SbBinned(ctypes.Structure):
    _fields_ = [
        ("num_prims", ctypes.c_int32),
        ("num_tiles", ctypes.c_int32),
        ("max_ppt", ctypes.c_int32),
        ("edges", ctypes.POINTER(ctypes.c_int32)),
        ("attribs", ctypes.POINTER(ctypes.c_int32)),
        ("tile_xy", ctypes.POINTER(ctypes.c_int32)),
        ("tile_pids", ctypes.POINTER(ctypes.c_int32)),
        ("tile_counts", ctypes.POINTER(ctypes.c_int32)),
    ]


def _build() -> bool:
    # build beside the target and rename: processes that build at the
    # same time never load a half-written library
    tmp = f"{_LIB}.{os.getpid()}.tmp"
    cmd = [
        "g++", "-O3", "-shared", "-fPIC", "-std=c++17",
        "-ffp-contract=off", "-fno-fast-math",
        "-o", tmp, _SRC,
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, _LIB)
        return True
    except (OSError, subprocess.SubprocessError):
        return False


def _load():
    global _lib, _load_failed
    with _lock:
        if _lib is not None or _load_failed:
            return _lib
        if os.environ.get("SKYBOX_NATIVE", "1") == "0":
            _load_failed = True
            return None
        stale = (not os.path.exists(_LIB)
                 or (os.path.exists(_SRC)
                     and os.path.getmtime(_SRC) > os.path.getmtime(_LIB)))
        if stale and not _build():
            _load_failed = True
            return None
        try:
            lib = ctypes.CDLL(_LIB)
        except OSError:
            _load_failed = True
            return None
        lib.sb_bin_drawcall.restype = ctypes.POINTER(_SbBinned)
        lib.sb_bin_drawcall.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.c_int32, ctypes.c_int32, ctypes.c_float, ctypes.c_float,
            ctypes.c_int32, ctypes.c_int32,
        ]
        lib.sb_free_binned.argtypes = [ctypes.POINTER(_SbBinned)]
        lib.sb_free_binned.restype = None
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def _as_array(ptr, shape):
    n = int(np.prod(shape))
    return np.ctypeslib.as_array(ptr, shape=(n,)).reshape(shape).copy()


def bin_drawcall_native(pos, indices, colors, texcoords, width, height,
                        near, far, tile_logsize, pad_multiple):
    """Native-path binning; returns the same field tuple the Python binner
    assembles, or None when no primitive survives / lib unavailable.

    Returns (edges (P,3,3), attribs (P,7,3), tile_xy (T,2), tile_pids (T,M),
    tile_counts (T,)) as int32 arrays, or None."""
    lib = _load()
    if lib is None:
        return None

    pos = np.ascontiguousarray(pos, np.float32)
    indices = np.ascontiguousarray(indices, np.int32)
    colors = np.ascontiguousarray(colors, np.float32)
    texcoords = np.ascontiguousarray(texcoords, np.float32)
    if indices.size == 0:
        return "empty"

    fp = ctypes.POINTER(ctypes.c_float)
    ip = ctypes.POINTER(ctypes.c_int32)
    res = lib.sb_bin_drawcall(
        pos.ctypes.data_as(fp), np.int32(pos.shape[0]),
        indices.ctypes.data_as(ip), np.int32(indices.shape[0]),
        colors.ctypes.data_as(fp), texcoords.ctypes.data_as(fp),
        np.int32(width), np.int32(height),
        np.float32(near), np.float32(far),
        np.int32(tile_logsize), np.int32(pad_multiple),
    )
    if not res:
        return "empty"
    try:
        b = res.contents
        P, T, M = b.num_prims, b.num_tiles, b.max_ppt
        return (
            _as_array(b.edges, (P, 3, 3)),
            _as_array(b.attribs, (P, 7, 3)),
            _as_array(b.tile_xy, (T, 2)),
            _as_array(b.tile_pids, (T, M)),
            _as_array(b.tile_counts, (T,)),
        )
    finally:
        lib.sb_free_binned(res)
