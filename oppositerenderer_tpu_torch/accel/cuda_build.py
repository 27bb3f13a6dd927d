"""Build and load the port's CUDA kernels into one library.

Every source of ``csrc/`` is compiled for ``sm_90a`` by its own ``nvcc``
call, all started together, and the objects are linked into a shared
library with a plain C interface, at first use, into ``_build/`` inside
the package, and loaded with ctypes. The library's
name carries a key that hashes the flags and every source, so an edit to
any kernel rebuilds it. The package imports without ``nvcc``; a CUDA call
without it raises. The wrappers (``intersect_kernels``,
``gather_kernels``, ``vm_kernels``, ``bvh_kernels``,
``packet_exp_kernels``, ``row_kernels``, ``rng_kernels``) take their
entry points from :func:`library`, as does the kd-tree's stream-ordered host build
(``csrc/kd_stage.cu``, ``photon_map.KdHostStage``).
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SOURCES = tuple(_PKG / "csrc" / name
                for name in ("intersect.cu", "gather.cu", "vm.cu",
                             "bvh.cu", "packet_exp.cu", "kd_stage.cu",
                             "rows.cu", "rng.cu"))
BUILD_DIR = _PKG / "_build"
# --fmad=false: no multiply-add contraction, so the kernels round as the
# plain versions do (the intersection kernels agree with theirs bit for bit)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xptxas", "-v", "-Xcompiler", "-fPIC")
LINK_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-shared")

_PTR, _I32, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
# entry point -> argument types; every entry point returns cudaError_t
# (packet_steps_cluster: a cluster size, or -cudaError_t; sum_rows_blocks:
# a block count)
ENTRY_POINTS = {
    "closest_hit_tris": [_PTR] * 5 + [_I32, _I32] + [_PTR] * 5,
    "occluded_tris": [_PTR] * 5 + [_I32, _I32] + [_PTR] * 2,
    "gather_photons_tiled": [_PTR] * 11 + [_I32] * 4 + [_PTR] * 3,
    "merge_vertices_tiled": [_PTR] * 10 + [_I32] * 3 + [_PTR] * 4,
    "bvh_closest": [_PTR] + [_I32] * 3 + [_PTR] * 4 + [_I32] + [_PTR] * 6,
    "bvh_any": [_PTR] + [_I32] * 3 + [_PTR] * 4 + [_I32] + [_PTR] * 2,
    "bvh_compact_live": [_PTR] * 2 + [_I32] + [_PTR] * 3,
    "packet_steps": [_PTR, _I32, _PTR, _PTR, _I32, _I32, _PTR, _PTR],
    "packet_steps_variant": [_PTR, _I32, _PTR, _PTR, _I32, _I32, _PTR, _I32,
                             _PTR],
    "packet_steps_cluster": [_I32],
    "kd_stage_enqueue": [_PTR] * 8 + [_I32, _I32] + [_PTR] * 3,
    "sum_rows": [_PTR, _PTR, _I64, _I32, _I32, _PTR, _PTR, _PTR],
    "sum_rows_blocks": [_I64],
    "threefry_draw": [_PTR, _I64] + [_PTR, _I64, _I32] * 2
                     + [_I64, _I32, _PTR, _PTR],
    "threefry_words": [_PTR, _I64, _I32] * 4 + [_I64, _PTR, _PTR],
    "threefry_uniform": [_PTR, _I64] * 2 + [_I64, _PTR, _PTR],
}


def cache_key() -> str:
    """Hash of the nvcc flags and every source: the library's name."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for src in SOURCES:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return digest.hexdigest()[:16]


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError(
            "CUDA tensors need the port's kernels, and no CUDA toolkit "
            "(nvcc) was found to build them: set CUDA_HOME")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def compile_sources(sources, out: Path) -> str:
    """Compile ``sources`` by one nvcc each, all started together, and link
    them into the shared library ``out``. Returns nvcc's output; raises if
    a compile or the link fails."""
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        objs = [str(Path(tmp) / f"{i}-{src.stem}.o")
                for i, src in enumerate(sources)]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", obj,
                                   str(src)], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for src, obj in zip(sources, objs)]
        logs = [proc.communicate()[0] for proc in procs]
        for src, proc, log in zip(sources, procs, logs):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src} "
                                   f"({proc.returncode}):\n{log}")
        link = subprocess.run([nvcc, *LINK_FLAGS, "-o", str(out), *objs],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc failed to link ({link.returncode}):\n"
                               f"{link.stdout}{link.stderr}")
    return "".join(logs) + link.stdout + link.stderr


def build_library() -> tuple[Path, float, str]:
    """Compile every source unless a library with the same cache key
    exists. Returns (path, build seconds, nvcc log)."""
    out = BUILD_DIR / f"kernels-{cache_key()}.so"
    if out.exists():
        return out, 0.0, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    # build under a temporary name, then rename: concurrent builders never
    # load a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        log = compile_sources(SOURCES, Path(tmp))
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out, time.perf_counter() - t0, log


@functools.cache
def library() -> ctypes.CDLL:
    """The built library with every entry point's argument types set."""
    path, _, _ = build_library()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in ENTRY_POINTS.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = _I32
    return lib


def launch(name: str, *args) -> None:
    """Call entry point ``name``; raise if the launch was refused."""
    err = getattr(library(), name)(*args)
    if err != 0:
        raise RuntimeError(f"CUDA launch of {name} failed with cudaError "
                           f"{err}")


def launch_on(device, name: str, *args) -> None:
    """Launch entry point ``name`` on ``device``'s current stream (inside a
    CUDA graph capture, the capturing stream): tensors in ``args`` pass as
    their data pointers, and the stream is appended as the last argument.
    Every render-path wrapper launches through here, so this is the one
    place that touches the CUDA runtime."""
    import torch
    with torch.cuda.device(device):
        launch(name, *(a.data_ptr() if isinstance(a, torch.Tensor) else a
                       for a in args),
               torch.cuda.current_stream().cuda_stream)
