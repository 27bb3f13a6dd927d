"""Dense ray-triangle kernels: the counterpart of
``oppositerenderer_tpu/accel/pallas_intersect_t.py``.

``closest_hit_tris`` keeps the JAX function's public contract and
layout (``tri9`` is ``[9, T]``: rows v0, e1, e2). ``occluded_tris`` takes
the occluder table of :func:`occluder_records` instead of ``tri9`` and an
occluder mask: only the triangles whose flag is set, each 12 floats (v0,
e1, e2, each padded to 16 bytes). An any-hit answer is a boolean, so
testing the occluders alone, in any order, answers as testing every
triangle with its flag. ``accel/intersect.dense_tables`` builds both
tables once per scene. For CUDA tensors the wrappers launch the
hand-written kernels of ``csrc/intersect.cu`` (built and loaded by
``cuda_build``; without ``nvcc`` a CUDA call raises). For CPU tensors
they run the plain PyTorch versions of the same function,
``closest_hit_tris_plain`` and ``occluded_tris_plain``. Each wrapper
counts its kernel launches in a ``launches`` attribute.
"""
from __future__ import annotations

import torch

from .cuda_build import launch

BIG = 1e30

# rays x triangles elements the plain versions materialise at once
CHUNK_ELEMENT_BUDGET = 1 << 25
OCC_RECORD = 12     # floats per occluder record: v0, e1, e2, each padded
# the [9, T] rows of an occluder table's columns
_OCC_TRI9_COLS = (0, 1, 2, 4, 5, 6, 8, 9, 10)


def _auto_chunk(n_prims: int) -> int:
    """Rays per chunk of the plain versions' [chunk, T] intermediates."""
    return int(min(16384, max(1024, CHUNK_ELEMENT_BUDGET // max(n_prims, 1))))


def _check_rays(o, d, tmin, tmax, table_name, table, table_shape):
    n = o.shape[0]
    for name, a, shape in (("o", o, (n, 3)), ("d", d, (n, 3)),
                           ("tmin", tmin, (n,)), ("tmax", tmax, (n,)),
                           (table_name, table, table_shape)):
        if a.device != o.device:
            raise ValueError(f"{name} is on {a.device}, o on {o.device}")
        if a.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {a.dtype}")
        if tuple(a.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got "
                             f"{tuple(a.shape)}")
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


# ---------------------------------------------------------------------------
# closest hit (B1)
# ---------------------------------------------------------------------------

def _mt_terms(o, d, tmin, tmax, tri9):
    """Moller-Trumbore for all (ray, triangle) pairs, written out in the TPU
    kernel's operation order (``_mt_terms``, pallas_intersect_t.py:39-52);
    ``csrc/intersect.cu`` repeats the same sequence. Returns (t, u, v,
    valid) each [N, T]."""
    ox, oy, oz = (o[:, k:k + 1] for k in range(3))
    dx, dy, dz = (d[:, k:k + 1] for k in range(3))
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = (tri9[k][None, :]
                                                    for k in range(9))
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    ok_det = torch.abs(det) > 1e-12
    inv_det = torch.where(ok_det, 1.0 / det, 0.0)
    tx = ox - v0x
    ty = oy - v0y
    tz = oz - v0z
    u = (tx * px + ty * py + tz * pz) * inv_det
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv_det
    t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    valid = (ok_det & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
             & (t > tmin[:, None]) & (t < tmax[:, None]))
    return t, u, v, valid


def _closest_chunk(o, d, tmin, tmax, tri9):
    t, u, v, valid = _mt_terms(o, d, tmin, tmax, tri9)
    t = torch.where(valid, t, BIG)
    t_best, best = torch.min(t, dim=1)    # first index among equal minima
    hit = t_best < BIG
    bu = torch.gather(u, 1, best[:, None])[:, 0]
    bv = torch.gather(v, 1, best[:, None])[:, 0]
    idx = torch.where(hit, best, -1).to(torch.int32)
    return (t_best, idx, torch.where(hit, bu, 0.0),
            torch.where(hit, bv, 0.0))


def closest_hit_tris_plain(o, d, tmin, tmax, tri9, chunk_size=None):
    """Plain PyTorch closest hit: (t, idx, u, v) per ray; idx = -1, t = BIG
    and u = v = 0 on a miss. Rays go in chunks that bound the [chunk, T]
    intermediates."""
    n = o.shape[0]
    if tri9.shape[1] == 0:
        return (torch.full((n,), BIG, device=o.device),
                torch.full((n,), -1, dtype=torch.int32, device=o.device),
                torch.zeros(n, device=o.device),
                torch.zeros(n, device=o.device))
    chunk = chunk_size or _auto_chunk(tri9.shape[1])
    parts = [_closest_chunk(o[s:s + chunk], d[s:s + chunk],
                            tmin[s:s + chunk], tmax[s:s + chunk], tri9)
             for s in range(0, n, chunk)]
    return tuple(torch.cat(p) for p in zip(*parts))


def closest_hit_tris(o, d, tmin, tmax, tri9, chunk_size=None):
    """Closest hit of every ray against every triangle: (t [N] f32,
    idx [N] int32, u [N], v [N]). The kernel for CUDA tensors, the plain
    version (chunked by ``chunk_size``) for CPU tensors."""
    if o.device.type == "cpu":
        return closest_hit_tris_plain(o, d, tmin, tmax, tri9, chunk_size)
    _check_rays(o, d, tmin, tmax, "tri9", tri9, (9, tri9.shape[-1]))
    n, n_tris = o.shape[0], tri9.shape[1]
    t = torch.empty(n, dtype=torch.float32, device=o.device)
    idx = torch.empty(n, dtype=torch.int32, device=o.device)
    u = torch.empty_like(t)
    v = torch.empty_like(t)
    if n == 0:
        return t, idx, u, v
    with torch.cuda.device(o.device):
        launch("closest_hit_tris", o.data_ptr(), d.data_ptr(),
               tmin.data_ptr(), tmax.data_ptr(), tri9.data_ptr(), n, n_tris,
               t.data_ptr(), idx.data_ptr(), u.data_ptr(), v.data_ptr(),
               torch.cuda.current_stream().cuda_stream)
    closest_hit_tris.launches += 1
    return t, idx, u, v


closest_hit_tris.launches = 0


# ---------------------------------------------------------------------------
# any hit (B2)
# ---------------------------------------------------------------------------

def occluder_records(tri9: torch.Tensor, occluder_mask: torch.Tensor
                     ) -> torch.Tensor:
    """[T_occ, OCC_RECORD] float32: the triangles of ``tri9`` [9, T] whose
    ``occluder_mask`` [T] is set, in index order, each as (v0, 0), (e1, 0),
    (e2, 0): three 16-byte groups, the layout in which B2's kernel stages
    a triangle with three float4 loads."""
    occ = torch.zeros((tri9.shape[1], OCC_RECORD), dtype=torch.float32,
                      device=tri9.device)
    occ[:, _OCC_TRI9_COLS] = tri9.T
    return occ[occluder_mask].contiguous()


def occluded_tris_plain(o, d, tmin, tmax, occ, chunk_size=None):
    """Plain PyTorch any hit: True where some triangle of the occluder
    table ``occ`` [T_occ, OCC_RECORD] is hit in (tmin, tmax)."""
    n = o.shape[0]
    if occ.shape[0] == 0:
        return torch.zeros(n, dtype=torch.bool, device=o.device)
    tri9 = occ[:, _OCC_TRI9_COLS].T.contiguous()
    chunk = chunk_size or _auto_chunk(tri9.shape[1])
    parts = []
    for s in range(0, n, chunk):
        *_, valid = _mt_terms(o[s:s + chunk], d[s:s + chunk],
                              tmin[s:s + chunk], tmax[s:s + chunk], tri9)
        parts.append(torch.any(valid, dim=1))
    return torch.cat(parts)


def occluded_tris(o, d, tmin, tmax, occ, chunk_size=None):
    """Any-hit shadow test [N] bool against the occluder table ``occ``
    [T_occ, OCC_RECORD] (:func:`occluder_records`). The kernel for CUDA
    tensors, the plain version for CPU tensors."""
    if o.device.type == "cpu":
        return occluded_tris_plain(o, d, tmin, tmax, occ, chunk_size)
    _check_rays(o, d, tmin, tmax, "occ", occ, (occ.shape[0], OCC_RECORD))
    if occ.data_ptr() % 16:
        raise ValueError("occ must be 16-byte aligned")
    out = torch.empty(o.shape[0], dtype=torch.bool, device=o.device)
    if o.shape[0] == 0:
        return out
    with torch.cuda.device(o.device):
        launch("occluded_tris", o.data_ptr(), d.data_ptr(),
               tmin.data_ptr(), tmax.data_ptr(), occ.data_ptr(), o.shape[0],
               occ.shape[0], out.data_ptr(),
               torch.cuda.current_stream().cuda_stream)
    occluded_tris.launches += 1
    return out


occluded_tris.launches = 0


def tri9_from_geometry(geom) -> torch.Tensor:
    """[9, T] component-row layout (v0, e1, e2) for the kernels."""
    return torch.cat([geom.tri_v0.T, geom.tri_e1.T, geom.tri_e2.T],
                     dim=0).contiguous()
