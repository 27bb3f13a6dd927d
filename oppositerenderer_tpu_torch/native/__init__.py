"""Native (C++) host components, loaded with ctypes.

The counterpart of the BVH part of ``oppositerenderer_tpu/native``:
``bvh_builder.cpp`` (a copy of the JAX package's source) is the binned-SAH
binary BVH build that runs once per scene on the host. It is compiled at
first use with the JAX package's g++ flags into the package's ``_build/``
directory, under a name that hashes the flags, the source and the host
CPU (``-march=native`` targets it, so a ``_build/`` carried to another CPU
builds anew instead of loading foreign instructions); the same source
gives the same tree in both packages. Without a working g++ the
build returns None and the caller takes the numpy median split instead,
as the JAX package does.
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
SOURCE = _HERE / "bvh_builder.cpp"
BUILD_DIR = _HERE.parent / "_build"
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")


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


def _library_path() -> Path:
    digest = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    digest.update(_cpu_identity().encode())
    digest.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libbvh_builder-{digest.hexdigest()[:16]}.so"


def _compile(out: Path) -> bool:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build under a temporary name, then rename: concurrent builders never
    # load a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(["g++", *GXX_FLAGS, str(SOURCE), "-o", tmp],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, out)
        return True
    except (OSError, subprocess.SubprocessError):
        return False
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


@functools.cache
def get_lib() -> ctypes.CDLL | None:
    """ctypes handle to the native BVH builder, or None if it cannot be
    built or loaded."""
    path = _library_path()
    if not path.exists() and not _compile(path):
        return None
    try:
        lib = ctypes.CDLL(str(path))
    except OSError:
        return None
    fp, ip = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int)
    lib.build_bvh.restype = ctypes.c_int
    lib.build_bvh.argtypes = [fp, fp, fp, ctypes.c_int, ctypes.c_int,
                              fp, fp, ip, ip, ip, ctypes.c_int]
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
    fp = ctypes.POINTER(ctypes.c_float)
    ip = ctypes.POINTER(ctypes.c_int)
    count = lib.build_bvh(
        pmn.ctypes.data_as(fp), pmx.ctypes.data_as(fp),
        cen.ctypes.data_as(fp), n, leaf_size,
        nmn.ctypes.data_as(fp), nmx.ctypes.data_as(fp),
        na.ctypes.data_as(ip), nb.ctypes.data_as(ip),
        order.ctypes.data_as(ip), max_nodes)
    if count <= 0:
        return None
    return (nmn[:count], nmx[:count], na[:count], nb[:count], order)
