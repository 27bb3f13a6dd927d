"""Native (C++) host components, loaded with ctypes.

The counterpart of ``oppositerenderer_tpu/native``. Three sources, byte
for byte copies of the JAX package's:

* ``bvh_builder.cpp``: the binned-SAH binary BVH build that runs once per
  scene on the host (:func:`build_bvh_native`);
* ``kdtree_builder.cpp``: the left-balanced photon kd-tree build, once per
  PPM iteration with ``PhotonMapStructure.KD_TREE_CPU``
  (:func:`build_photon_kdtree_native`);
* ``text_scan.cpp``: the numeric token scanner for scene file payloads
  (:func:`scan_floats`, :func:`scan_ints`).

Each is compiled at first use with the JAX package's g++ flags into the
package's ``_build/`` directory, under a name that hashes the flags, the
source and the host CPU (``-march=native`` targets it, so a ``_build/``
carried to another CPU builds anew instead of loading foreign
instructions); the same source gives the same results in both packages.
Without a working g++ a loader returns None and the caller takes the
numpy or Python fallback instead, as the JAX package does.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import platform
import subprocess
import tempfile
from pathlib import Path

import numpy as np

_HERE = Path(__file__).resolve().parent
BUILD_DIR = _HERE.parent / "_build"
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")
STEMS = ("bvh_builder", "kdtree_builder", "text_scan")


def _cpu_identity() -> str:
    """The host CPU as ``-march=native`` sees it: the machine, and on
    Linux the model name and feature flags of the first processor."""
    ident = [platform.machine()]
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key = line.split(":", 1)[0].strip()
                if key in ("model name", "flags", "Features", "CPU part"):
                    ident.append(line.strip())
                elif not line.strip() and len(ident) > 1:
                    break   # the first processor's block is enough
    except OSError:
        ident.append(platform.processor())
    return "\n".join(ident)


def source(stem: str) -> Path:
    return _HERE / f"{stem}.cpp"


def library_path(stem: str) -> Path:
    digest = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    digest.update(_cpu_identity().encode())
    digest.update(source(stem).read_bytes())
    return BUILD_DIR / f"lib{stem}-{digest.hexdigest()[:16]}.so"


def _compile(stem: str, out: Path) -> bool:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build under a temporary name, then rename: concurrent builders never
    # load a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(["g++", *GXX_FLAGS, str(source(stem)), "-o", tmp],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, out)
        return True
    except (OSError, subprocess.SubprocessError):
        return False
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


@functools.cache
def load(stem: str) -> ctypes.CDLL | None:
    """ctypes handle to the library built from ``<stem>.cpp``, or None if
    it cannot be built or loaded."""
    path = library_path(stem)
    if not path.exists() and not _compile(stem, path):
        return None
    try:
        return ctypes.CDLL(str(path))
    except OSError:
        return None


_FP = ctypes.POINTER(ctypes.c_float)
_IP = ctypes.POINTER(ctypes.c_int)


@functools.cache
def get_lib() -> ctypes.CDLL | None:
    """ctypes handle to the native BVH builder, or None."""
    lib = load("bvh_builder")
    if lib is not None:
        lib.build_bvh.restype = ctypes.c_int
        lib.build_bvh.argtypes = [_FP, _FP, _FP, ctypes.c_int, ctypes.c_int,
                                  _FP, _FP, _IP, _IP, _IP, ctypes.c_int]
    return lib


def build_bvh_native(prim_min: np.ndarray, prim_max: np.ndarray,
                     centroid: np.ndarray, leaf_size: int):
    """Run the C++ builder. Returns (nodes_min, nodes_max, nodes_a, nodes_b,
    order) or None if the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    n = prim_min.shape[0]
    max_nodes = max(4 * n, 64)
    pmn = np.ascontiguousarray(prim_min, np.float32)
    pmx = np.ascontiguousarray(prim_max, np.float32)
    cen = np.ascontiguousarray(centroid, np.float32)
    nmn = np.empty((max_nodes, 3), np.float32)
    nmx = np.empty((max_nodes, 3), np.float32)
    na = np.empty((max_nodes,), np.int32)
    nb = np.empty((max_nodes,), np.int32)
    order = np.empty((n,), np.int32)
    count = lib.build_bvh(
        pmn.ctypes.data_as(_FP), pmx.ctypes.data_as(_FP),
        cen.ctypes.data_as(_FP), n, leaf_size,
        nmn.ctypes.data_as(_FP), nmx.ctypes.data_as(_FP),
        na.ctypes.data_as(_IP), nb.ctypes.data_as(_IP),
        order.ctypes.data_as(_IP), max_nodes)
    if count <= 0:
        return None
    return (nmn[:count], nmx[:count], na[:count], nb[:count], order)


# ---------------------------------------------------------------------------
# photon kd-tree builder (kdtree_builder.cpp)
# ---------------------------------------------------------------------------

KD_LEAF, KD_NULL = 3, 4


@functools.cache
def kdtree_lib() -> ctypes.CDLL | None:
    """ctypes handle to the native photon kd-tree builder, or None."""
    lib = load("kdtree_builder")
    if lib is not None:
        lib.build_photon_kdtree.restype = ctypes.c_int
        lib.build_photon_kdtree.argtypes = [_FP, ctypes.c_int, _IP, _IP,
                                            ctypes.c_int]
    return lib


def _left_subtree_size(n: int) -> int:
    if n <= 1:
        return 0
    h = 0
    while (1 << (h + 1)) - 1 < n:
        h += 1
    last = n - ((1 << h) - 1)
    return ((1 << (h - 1)) - 1) + min(last, 1 << (h - 1))


def _build_kdtree_numpy(pos: np.ndarray, perm: np.ndarray,
                        axis: np.ndarray) -> None:
    """Pure-numpy fallback mirroring kdtree_builder.cpp (np.argpartition
    as the nth_element), with an explicit stack instead of recursion."""
    stack = [(np.arange(pos.shape[0], dtype=np.int64), 0)]
    while stack:
        idx, slot = stack.pop()
        n = idx.shape[0]
        if n == 0 or slot >= perm.shape[0]:
            continue
        if n == 1:
            perm[slot] = idx[0]
            axis[slot] = KD_LEAF
            continue
        p = pos[idx]
        ax = int(np.argmax(p.max(axis=0) - p.min(axis=0)))
        med = _left_subtree_size(n)
        part = np.argpartition(p[:, ax], med)
        perm[slot] = idx[part[med]]
        axis[slot] = ax
        stack.append((idx[part[:med]], 2 * slot + 1))
        stack.append((idx[part[med + 1:]], 2 * slot + 2))


def build_photon_kdtree_native(pos: np.ndarray) -> tuple[np.ndarray,
                                                         np.ndarray]:
    """Left-balanced kd-tree over photon positions [n,3].

    Returns (perm [m], axis_flags [m]) with m the smallest complete-tree
    capacity >= n (children of slot i at 2i+1/2i+2; flags 0/1/2 = split
    axis, 3 = leaf, 4 = null). C++ when available, numpy otherwise.
    """
    n = int(pos.shape[0])
    m = 1
    while m < n:
        m = 2 * m + 1
    perm = np.full((m,), -1, np.int32)
    axis = np.full((m,), KD_NULL, np.int32)
    if n == 0:
        return perm, axis
    p = np.ascontiguousarray(pos, np.float32)
    lib = kdtree_lib()
    if lib is not None:
        count = lib.build_photon_kdtree(
            p.ctypes.data_as(_FP), n, perm.ctypes.data_as(_IP),
            axis.ctypes.data_as(_IP), m)
        if count == n:
            return perm, axis
    _build_kdtree_numpy(p, perm, axis)
    return perm, axis


# ---------------------------------------------------------------------------
# numeric token scanner for scene file payloads (text_scan.cpp)
# ---------------------------------------------------------------------------

@functools.cache
def text_scan_lib() -> ctypes.CDLL | None:
    """ctypes handle to the text scanner, or None."""
    lib = load("text_scan")
    if lib is not None:
        for name, outp in (("scan_floats", _FP),
                           ("scan_ints", ctypes.POINTER(ctypes.c_int64))):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int64
            fn.argtypes = [ctypes.c_char_p, ctypes.c_int64, outp,
                           ctypes.c_int64]
    return lib


def _scan(text, dtype, fn_name, ptr_t):
    lib = text_scan_lib()
    if lib is None:
        return None
    b = text.encode("ascii", "strict") if isinstance(text, str) else text
    n = len(b)
    # at most one token per 2 bytes ("1 1 1 ..."); the result is copied
    # down to the exact count
    cap = n // 2 + 1
    out = np.empty(cap, dtype)
    k = int(getattr(lib, fn_name)(b, n, out.ctypes.data_as(ptr_t), cap))
    if k < 0:        # malformed token: let the Python parser report it
        return None
    return out[:k].copy()


def scan_floats(text) -> np.ndarray | None:
    """Whitespace/comma-separated float32 tokens (Collada <float_array>
    payloads) at C speed. None when the native library is unavailable or
    the text has a token the strict scanner does not accept: callers then
    take the Python parser."""
    return _scan(text, np.float32, "scan_floats", _FP)


def scan_ints(text) -> np.ndarray | None:
    """Whitespace/comma-separated int64 tokens (Collada <p>/<vcount>
    payloads); the same None contract as :func:`scan_floats`."""
    return _scan(text, np.int64, "scan_ints",
                 ctypes.POINTER(ctypes.c_int64))
