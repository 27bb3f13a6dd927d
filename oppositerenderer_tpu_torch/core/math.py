"""Vector math on batched ``[..., 3]`` tensors.

The counterpart of ``oppositerenderer_tpu/core/math.py``: the same
functions with the same operation order, on torch tensors of any batch
shape.
"""
from __future__ import annotations

import dataclasses

import torch

Tensor = torch.Tensor

INV_PI = 0.3183098861837907
PI = 3.141592653589793


def dot(a: Tensor, b: Tensor) -> Tensor:
    """Batched dot product over the last axis; result keeps no vector axis."""
    return torch.sum(a * b, dim=-1)


def vdot(a: Tensor, b: Tensor) -> Tensor:
    """Batched dot product, keepdim (broadcastable against [...,3])."""
    return torch.sum(a * b, dim=-1, keepdim=True)


def cross(a: Tensor, b: Tensor) -> Tensor:
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def length(a: Tensor) -> Tensor:
    return torch.sqrt(torch.clamp_min(dot(a, a), 0.0))


def length_sq(a: Tensor) -> Tensor:
    return dot(a, a)


def normalize(a: Tensor, eps: float = 1e-20) -> Tensor:
    return a * torch.rsqrt(torch.clamp_min(length_sq(a), eps))[..., None]


def reflect(d: Tensor, n: Tensor) -> Tensor:
    """Mirror reflection of incident direction ``d`` about normal ``n``
    (optix::reflect convention: d points toward the surface)."""
    return d - 2.0 * vdot(d, n) * n


def refract(d: Tensor, n: Tensor, eta: Tensor) -> tuple[Tensor, Tensor]:
    """Refract ``d`` (toward surface) about unit normal ``n`` with relative
    IOR ``eta = n_i / n_t``. Returns ``(refracted_dir, tir_mask)``."""
    cos_i = -dot(d, n)
    sin2_t = torch.square(eta) * torch.clamp_min(1.0 - torch.square(cos_i),
                                                 0.0)
    tir = sin2_t > 1.0
    cos_t = torch.sqrt(torch.clamp_min(1.0 - sin2_t, 0.0))
    refr = eta[..., None] * d + (eta * cos_i - cos_t)[..., None] * n
    return normalize(refr), tir


def luminance(rgb: Tensor) -> Tensor:
    """Relative luminance (VCM BxDF pick probabilities, BSDF.h)."""
    return (0.212671 * rgb[..., 0] + 0.715160 * rgb[..., 1]
            + 0.072169 * rgb[..., 2])


def max3(rgb: Tensor) -> Tensor:
    return torch.amax(rgb, dim=-1)


# ---------------------------------------------------------------------------
# Orthonormal frame (reference math/DifferentialGeometry.h:13-76)
# ---------------------------------------------------------------------------

def build_onb(n: Tensor) -> tuple[Tensor, Tensor]:
    """Branchless orthonormal basis around unit normal ``n`` (Duff et al.
    2017). Returns tangent/bitangent ``(u, v)``; ``(u, v, n)`` is
    right-handed orthonormal."""
    z = n[..., 2]
    sign = torch.where(z >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + z)
    b = n[..., 0] * n[..., 1] * a
    u = torch.stack([1.0 + sign * n[..., 0] * n[..., 0] * a, sign * b,
                     -sign * n[..., 0]], dim=-1)
    v = torch.stack([b, sign + n[..., 1] * n[..., 1] * a, -n[..., 1]],
                    dim=-1)
    return u, v


@dataclasses.dataclass
class Frame:
    """Shading frame; local coordinates have the normal along +z."""

    u: Tensor  # tangent    [...,3]
    v: Tensor  # bitangent  [...,3]
    n: Tensor  # normal     [...,3]

    @classmethod
    def from_normal(cls, n: Tensor) -> "Frame":
        u, v = build_onb(n)
        return cls(u=u, v=v, n=n)

    def to_local(self, w: Tensor) -> Tensor:
        return torch.stack([dot(w, self.u), dot(w, self.v), dot(w, self.n)],
                           dim=-1)

    def to_world(self, w: Tensor) -> Tensor:
        return (w[..., 0:1] * self.u + w[..., 1:2] * self.v
                + w[..., 2:3] * self.n)


# local-frame helpers (reference renderer/reflection.h:16-46)
def local_reflect(w: Tensor) -> Tensor:
    """Reflect about the local +z normal."""
    return torch.stack([-w[..., 0], -w[..., 1], w[..., 2]], dim=-1)
