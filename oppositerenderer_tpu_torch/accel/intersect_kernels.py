"""Dense ray-triangle kernels: the counterpart of
``oppositerenderer_tpu/accel/pallas_intersect_t.py``.

``closest_hit_tris`` and ``occluded_tris`` keep the JAX functions' public
contract and layout (``tri9`` is ``[9, T]``: rows v0, e1, e2). For CUDA
tensors they launch the hand-written kernels of ``csrc/intersect.cu``
(built and loaded by ``cuda_build``; without ``nvcc`` a CUDA call
raises). For CPU tensors they run the plain PyTorch versions of the same
function, ``closest_hit_tris_plain`` and ``occluded_tris_plain``. Each
wrapper counts its kernel launches in a ``launches`` attribute.
"""
from __future__ import annotations

import torch

from .cuda_build import launch

BIG = 1e30

# rays x triangles elements the plain versions materialise at once
CHUNK_ELEMENT_BUDGET = 1 << 25


def _auto_chunk(n_prims: int) -> int:
    """Rays per chunk of the plain versions' [chunk, T] intermediates."""
    return int(min(16384, max(1024, CHUNK_ELEMENT_BUDGET // max(n_prims, 1))))


def _check_rays(o, d, tmin, tmax, tri9):
    n = o.shape[0]
    for name, a, shape in (("o", o, (n, 3)), ("d", d, (n, 3)),
                           ("tmin", tmin, (n,)), ("tmax", tmax, (n,)),
                           ("tri9", tri9, (9, tri9.shape[-1]))):
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
    _check_rays(o, d, tmin, tmax, tri9)
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

def occluded_tris_plain(o, d, tmin, tmax, tri9, occluder_mask,
                        chunk_size=None):
    """Plain PyTorch any hit: True where some triangle with its occluder
    flag set is hit in (tmin, tmax)."""
    n = o.shape[0]
    if tri9.shape[1] == 0:
        return torch.zeros(n, dtype=torch.bool, device=o.device)
    chunk = chunk_size or _auto_chunk(tri9.shape[1])
    parts = []
    for s in range(0, n, chunk):
        *_, valid = _mt_terms(o[s:s + chunk], d[s:s + chunk],
                              tmin[s:s + chunk], tmax[s:s + chunk], tri9)
        parts.append(torch.any(valid & occluder_mask[None, :], dim=1))
    return torch.cat(parts)


def occluded_tris(o, d, tmin, tmax, tri9, occluder_mask, chunk_size=None):
    """Any-hit shadow test [N] bool against the triangles whose
    ``occluder_mask`` [T] bool is set. The kernel for CUDA tensors, the
    plain version for CPU tensors."""
    if o.device.type == "cpu":
        return occluded_tris_plain(o, d, tmin, tmax, tri9, occluder_mask,
                                   chunk_size)
    _check_rays(o, d, tmin, tmax, tri9)
    n, n_tris = o.shape[0], tri9.shape[1]
    if (occluder_mask.device != o.device or occluder_mask.dtype != torch.bool
            or tuple(occluder_mask.shape) != (n_tris,)
            or not occluder_mask.is_contiguous()):
        raise ValueError("occluder_mask must be a contiguous bool [T] tensor "
                         "on the rays' device")
    occ = torch.empty(n, dtype=torch.bool, device=o.device)
    if n == 0:
        return occ
    with torch.cuda.device(o.device):
        launch("occluded_tris", o.data_ptr(), d.data_ptr(),
               tmin.data_ptr(), tmax.data_ptr(), tri9.data_ptr(),
               occluder_mask.data_ptr(), n, n_tris, occ.data_ptr(),
               torch.cuda.current_stream().cuda_stream)
    occluded_tris.launches += 1
    return occ


occluded_tris.launches = 0


def tri9_from_geometry(geom) -> torch.Tensor:
    """[9, T] component-row layout (v0, e1, e2) for the kernels."""
    return torch.cat([geom.tri_v0.T, geom.tri_e1.T, geom.tri_e2.T],
                     dim=0).contiguous()
