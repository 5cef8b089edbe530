"""ctypes loader for the native C++ BVH builder.

Compiled on first use from `bvh_builder.cpp` with g++ (plain C ABI +
ctypes) into `libdrt_bvh-<hash>.so` beside the source, where <hash> is a
digest of the source and the compile command: a checkout never loads a
library built from other source, and git ignores the build product.
Returns None when the toolchain is unavailable (`load_error()` says
why), in which case `accel.bvh` falls back to the numpy builder — both
produce the same flat SoA layout and are cross-checked in
tests/test_bvh.py.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_HERE = Path(__file__).parent
_SRC = _HERE / "bvh_builder.cpp"
# portable flags: the library may be loaded on another host of the same
# architecture than the one that built it
_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]
_lock = threading.Lock()
_lib = None
_tried = False
_error = None


def library_path() -> Path:
    """Where the library for the current source and flags lives."""
    key = hashlib.sha256(_SRC.read_bytes() + " ".join(_FLAGS).encode())
    return _HERE / f"libdrt_bvh-{key.hexdigest()[:16]}.so"


def load_error():
    """Why the native builder is unavailable (None if it loaded)."""
    return _error


def _load():
    global _lib, _tried, _error
    with _lock:
        if _tried:
            return _lib
        _tried = True
        try:
            so = library_path()
            if not so.exists():
                tmp = so.with_suffix(f".{os.getpid()}.tmp")
                subprocess.run(["g++", *_FLAGS, str(_SRC), "-o", str(tmp)],
                               check=True, capture_output=True, timeout=120)
                os.replace(tmp, so)  # atomic: concurrent builders agree
            lib = ctypes.CDLL(str(so))
            f32p = np.ctypeslib.ndpointer(np.float32, flags="C")
            i32p = np.ctypeslib.ndpointer(np.int32, flags="C")
            i64p = np.ctypeslib.ndpointer(np.int64, flags="C")
            lib.drt_build_bvh.restype = ctypes.c_int
            lib.drt_build_bvh.argtypes = [
                f32p, ctypes.c_int64,              # tri corner positions, N
                ctypes.c_int, ctypes.c_int,        # leaf_target, bins
                f32p, f32p, i32p, i32p, i32p, i32p,  # node arrays (cap M)
                i64p,                              # perm out
                ctypes.c_int64,                    # node capacity
                ctypes.POINTER(ctypes.c_int64),    # n_nodes out
                ctypes.POINTER(ctypes.c_int64),    # depth out
            ]
            _lib = lib
        except (OSError, subprocess.SubprocessError) as e:
            _error = f"{type(e).__name__}: {e}"
            _lib = None
        return _lib


def build_bvh_native(tri_pos: np.ndarray, leaf_target: int, bins: int):
    lib = _load()
    if lib is None:
        return None
    from dustraytracer.accel.bvh import BvhArrays

    n = tri_pos.shape[0]
    cap = max(2 * n + 8, 64)
    node_min = np.empty((cap, 3), np.float32)
    node_max = np.empty((cap, 3), np.float32)
    node_left = np.empty(cap, np.int32)
    node_right = np.empty(cap, np.int32)
    node_first = np.empty(cap, np.int32)
    node_count = np.empty(cap, np.int32)
    perm = np.empty(n, np.int64)
    n_nodes = ctypes.c_int64(0)
    depth = ctypes.c_int64(0)
    rc = lib.drt_build_bvh(
        np.ascontiguousarray(tri_pos, np.float32), n, leaf_target, bins,
        node_min, node_max, node_left, node_right, node_first, node_count,
        perm, cap, ctypes.byref(n_nodes), ctypes.byref(depth))
    if rc != 0:
        return None
    m = n_nodes.value
    pad = ((m + 7) // 8) * 8

    def _p(a, fill):
        out = np.full((pad,) + a.shape[1:], fill, a.dtype)
        out[:m] = a[:m]
        return out

    return BvhArrays(
        node_min=_p(node_min, np.inf), node_max=_p(node_max, -np.inf),
        node_left=_p(node_left, -1), node_right=_p(node_right, -1),
        node_first=_p(node_first, 0), node_count=_p(node_count, 0),
        node_skip=np.full(pad, -1, np.int32),  # filled by thread_bvh
        perm=perm, n_nodes=m, depth=depth.value)
