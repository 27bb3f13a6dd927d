"""Dense ray-triangle kernels: the counterpart of
``oppositerenderer_tpu/accel/pallas_intersect_t.py``.

Both kernels take a table of triangle records built by
:func:`triangle_records`: each triangle as 12 floats (v0, e1, e2, each
padded to 16 bytes), in index order, the layout in which the kernels
stage a triangle with three float4 loads. ``closest_hit_tris`` takes every
triangle of the scene (the JAX function's ``tri9`` [9, T] holds the same
columns; :func:`tri9_from_geometry` builds it for comparisons with JAX).
``occluded_tris`` takes only the occluders: an any-hit answer is a
boolean, so testing the occluders alone, in any order, answers as testing
every triangle with its flag. ``accel/intersect.dense_tables`` builds both
tables once per scene. For CUDA tensors the wrappers launch the
hand-written kernels of ``csrc/intersect.cu`` (built and loaded by
``cuda_build``; without ``nvcc`` a CUDA call raises). For CPU tensors
they run the plain PyTorch versions of the same function,
``closest_hit_tris_plain`` and ``occluded_tris_plain``. Each wrapper
counts its kernel launches in a ``launches`` attribute and, on both
devices, gives every input a zero gradient (``zero_grad``), as the JAX
package's ``custom_vjp``s do.
"""
from __future__ import annotations

import torch

from . import cuda_build
from .zero_grad import zero_gradient

BIG = 1e30

# rays x triangles elements the plain versions materialise at once
CHUNK_ELEMENT_BUDGET = 1 << 25
TRI_RECORD = 12     # floats per triangle record: v0, e1, e2, each padded
# a record's columns that hold the [9, T] rows v0, e1, e2
_TRI9_COLS = (0, 1, 2, 4, 5, 6, 8, 9, 10)


def _auto_chunk(n_prims: int) -> int:
    """Rays per chunk of the plain versions' [chunk, T] intermediates."""
    return int(min(16384, max(1024, CHUNK_ELEMENT_BUDGET // max(n_prims, 1))))


def _check_rays(o, d, tmin, tmax, table_name, table):
    n = o.shape[0]
    for name, a, shape in (("o", o, (n, 3)), ("d", d, (n, 3)),
                           ("tmin", tmin, (n,)), ("tmax", tmax, (n,)),
                           (table_name, table, (table.shape[0], TRI_RECORD))):
        if a.device != o.device:
            raise ValueError(f"{name} is on {a.device}, o on {o.device}")
        if a.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {a.dtype}")
        if tuple(a.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got "
                             f"{tuple(a.shape)}")
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if table.data_ptr() % 16:
        raise ValueError(f"{table_name} must be 16-byte aligned")


def triangle_records(tri9: torch.Tensor,
                     mask: torch.Tensor | None = None) -> torch.Tensor:
    """[T', TRI_RECORD] float32: the triangles of ``tri9`` [9, T] (only
    those whose ``mask`` [T] is set, if one is given), in index order,
    each as (v0, 0), (e1, 0), (e2, 0): three 16-byte groups, the layout in
    which the kernels stage a triangle with three float4 loads. B1 takes
    every triangle, B2 the occluders."""
    rec = torch.zeros((tri9.shape[1], TRI_RECORD), dtype=torch.float32,
                      device=tri9.device)
    rec[:, _TRI9_COLS] = tri9.T
    return rec if mask is None else rec[mask].contiguous()


def _mt_terms(o, d, tmin, tmax, tris):
    """Moller-Trumbore for all (ray, triangle) pairs of the record table
    ``tris`` [T, TRI_RECORD], written out in the TPU kernel's operation
    order (``_mt_terms``, pallas_intersect_t.py:39-52);
    ``csrc/intersect.cu`` repeats the same sequence. Returns (t, u, v,
    valid) each [N, T]."""
    ox, oy, oz = (o[:, k:k + 1] for k in range(3))
    dx, dy, dz = (d[:, k:k + 1] for k in range(3))
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = (tris[None, :, c]
                                                    for c in _TRI9_COLS)
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


# ---------------------------------------------------------------------------
# closest hit (B1)
# ---------------------------------------------------------------------------

def _closest_chunk(o, d, tmin, tmax, tris):
    t, u, v, valid = _mt_terms(o, d, tmin, tmax, tris)
    t = torch.where(valid, t, BIG)
    t_best, best = torch.min(t, dim=1)    # first index among equal minima
    hit = t_best < BIG
    bu = torch.gather(u, 1, best[:, None])[:, 0]
    bv = torch.gather(v, 1, best[:, None])[:, 0]
    idx = torch.where(hit, best, -1).to(torch.int32)
    return (t_best, idx, torch.where(hit, bu, 0.0),
            torch.where(hit, bv, 0.0))


def closest_hit_tris_plain(o, d, tmin, tmax, tris, chunk_size=None):
    """Plain PyTorch closest hit against the record table ``tris``
    [T, TRI_RECORD]: (t, idx, u, v) per ray; idx = -1, t = BIG and u = v =
    0 on a miss, the lowest index among equal t. Rays go in chunks that
    bound the [chunk, T] intermediates."""
    n = o.shape[0]
    if tris.shape[0] == 0:
        return (torch.full((n,), BIG, device=o.device),
                torch.full((n,), -1, dtype=torch.int32, device=o.device),
                torch.zeros(n, device=o.device),
                torch.zeros(n, device=o.device))
    chunk = chunk_size or _auto_chunk(tris.shape[0])
    parts = [_closest_chunk(o[s:s + chunk], d[s:s + chunk],
                            tmin[s:s + chunk], tmax[s:s + chunk], tris)
             for s in range(0, n, chunk)]
    return tuple(torch.cat(p) for p in zip(*parts))


@zero_gradient
def closest_hit_tris(o, d, tmin, tmax, tris, chunk_size=None):
    """Closest hit of every ray against every triangle of the record table
    ``tris`` [T, TRI_RECORD] (:func:`triangle_records`): (t [N] f32,
    idx [N] int32, u [N], v [N]). The kernel for CUDA tensors, the plain
    version (chunked by ``chunk_size``) for CPU tensors."""
    if o.device.type == "cpu":
        return closest_hit_tris_plain(o, d, tmin, tmax, tris, chunk_size)
    _check_rays(o, d, tmin, tmax, "tris", tris)
    n = o.shape[0]
    t = torch.empty(n, dtype=torch.float32, device=o.device)
    idx = torch.empty(n, dtype=torch.int32, device=o.device)
    u = torch.empty_like(t)
    v = torch.empty_like(t)
    if n == 0:
        return t, idx, u, v
    cuda_build.launch_on(o.device, "closest_hit_tris", o, d, tmin, tmax,
                         tris, n, tris.shape[0], t, idx, u, v)
    closest_hit_tris.launches += 1
    return t, idx, u, v


closest_hit_tris.launches = 0


# ---------------------------------------------------------------------------
# any hit (B2)
# ---------------------------------------------------------------------------

def occluded_tris_plain(o, d, tmin, tmax, occ, chunk_size=None):
    """Plain PyTorch any hit: True where some triangle of the occluder
    table ``occ`` [T_occ, TRI_RECORD] is hit in (tmin, tmax)."""
    n = o.shape[0]
    if occ.shape[0] == 0:
        return torch.zeros(n, dtype=torch.bool, device=o.device)
    chunk = chunk_size or _auto_chunk(occ.shape[0])
    parts = []
    for s in range(0, n, chunk):
        *_, valid = _mt_terms(o[s:s + chunk], d[s:s + chunk],
                              tmin[s:s + chunk], tmax[s:s + chunk], occ)
        parts.append(torch.any(valid, dim=1))
    return torch.cat(parts)


@zero_gradient
def occluded_tris(o, d, tmin, tmax, occ, chunk_size=None):
    """Any-hit shadow test [N] bool against the occluder table ``occ``
    [T_occ, TRI_RECORD] (:func:`triangle_records` with the occluder
    mask). The kernel for CUDA tensors, the plain version for CPU
    tensors."""
    if o.device.type == "cpu":
        return occluded_tris_plain(o, d, tmin, tmax, occ, chunk_size)
    _check_rays(o, d, tmin, tmax, "occ", occ)
    out = torch.empty(o.shape[0], dtype=torch.bool, device=o.device)
    if o.shape[0] == 0:
        return out
    cuda_build.launch_on(o.device, "occluded_tris", o, d, tmin, tmax, occ,
                         o.shape[0], occ.shape[0], out)
    occluded_tris.launches += 1
    return out


occluded_tris.launches = 0


def tri9_from_geometry(geom) -> torch.Tensor:
    """[9, T] component rows (v0, e1, e2): the JAX kernels' layout, from
    which :func:`triangle_records` packs the kernels' tables."""
    return torch.cat([geom.tri_v0.T, geom.tri_e1.T, geom.tri_e2.T],
                     dim=0).contiguous()
