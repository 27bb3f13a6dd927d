"""Sampling library (reference ``renderer/helpers/samplers.h:22-171``).

The counterpart of ``oppositerenderer_tpu/core/sampling.py``. Every
sampler takes uniform samples in ``[0,1)`` with batch shape ``[...]``
(``u`` is ``[...,2]``) and returns directions ``[...,3]`` plus pdfs.
"""
from __future__ import annotations

import torch

from .math import INV_PI, PI, Tensor, build_onb, dot, normalize


def sample_unit_hemisphere_cos(normal: Tensor, u: Tensor,
                               bias_small_cosine: bool = False,
                               eps_cosine: float = 1e-6
                               ) -> tuple[Tensor, Tensor, Tensor]:
    """Cosine-weighted hemisphere around ``normal`` (samplers.h:22-42):
    cos(theta) = sqrt(u1), pdf_w = cos(theta)/pi. Returns (dir, pdf_w, cos).
    """
    cos_theta = torch.sqrt(u[..., 0])
    sin_theta = torch.sqrt(torch.clamp_min(1.0 - u[..., 0], 0.0))
    phi = 2.0 * PI * u[..., 1]
    xs = sin_theta * torch.cos(phi)
    zs = sin_theta * torch.sin(phi)
    ys = cos_theta
    if bias_small_cosine:
        ys = torch.clamp_min(ys, eps_cosine)
    pdf_w = ys * INV_PI
    U, V = build_onb(normal)
    d = normalize(xs[..., None] * U + ys[..., None] * normal
                  + zs[..., None] * V)
    return d, pdf_w, ys


def cos_hemisphere_pdf_w(normal: Tensor, direction: Tensor) -> Tensor:
    """samplers.h CosHemispherePdfW."""
    return torch.clamp_min(dot(normal, direction), 0.0) * INV_PI


def sample_unit_sphere(u: Tensor) -> tuple[Tensor, Tensor]:
    """Uniform sphere; pdf_w = 1/(4 pi). samplers.h:59-72."""
    z = 1.0 - 2.0 * u[..., 0]
    phi = 2.0 * PI * u[..., 1]
    r = torch.sqrt(torch.clamp_min(1.0 - z * z, 0.0))
    d = torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)
    return d, torch.full(u.shape[:-1], 0.25 * INV_PI, device=u.device)


def sample_unit_disc(u: Tensor) -> Tensor:
    """Uniform unit disc -> [...,2]. samplers.h:74-81."""
    r = torch.sqrt(u[..., 0])
    theta = 2.0 * PI * u[..., 1]
    return torch.stack([r * torch.cos(theta), r * torch.sin(theta)], dim=-1)


def sample_disc(u: Tensor, center: Tensor, radius: Tensor,
                normal: Tensor) -> Tensor:
    """Point on an oriented disc in 3D. samplers.h:84-90."""
    U, V = build_onb(normal)
    d2 = sample_unit_disc(u)
    return center + radius[..., None] * (d2[..., 0:1] * U + d2[..., 1:2] * V)


def sample_power_cos_hemisphere(u: Tensor, power: Tensor
                                ) -> tuple[Tensor, Tensor]:
    """Modified-Phong lobe sample in the LOCAL frame (+z axis). Returns
    (local_dir, pdf_w). samplers.h:105-122 (Lafortune)."""
    phi = 2.0 * PI * u[..., 0]
    z = torch.pow(u[..., 1], 1.0 / (power + 1.0))
    r = torch.sqrt(torch.clamp_min(1.0 - z * z, 0.0))
    d = torch.stack([torch.cos(phi) * r, torch.sin(phi) * r, z], dim=-1)
    pdf_w = (power + 1.0) * torch.pow(z, power) * (0.5 * INV_PI)
    return d, pdf_w


def power_cos_hemisphere_pdf_w(normal: Tensor, direction: Tensor,
                               power: Tensor) -> Tensor:
    """samplers.h:98-103."""
    cos_theta = torch.clamp_min(dot(normal, direction), 0.0)
    return (power + 1.0) * torch.pow(cos_theta, power) * (0.5 * INV_PI)


def sample_cone(u: Tensor, theta_rad: Tensor, normal: Tensor
                ) -> tuple[Tensor, Tensor]:
    """Uniform direction in a cone of half-angle theta around ``normal``;
    pdf_w = 1/solid angle. samplers.h:127-152."""
    cos_theta = torch.cos(theta_rad)
    z = cos_theta + (1.0 - cos_theta) * u[..., 0]
    phi = 2.0 * PI * u[..., 1]
    r = torch.sqrt(torch.clamp_min(1.0 - z * z, 0.0))
    U, V = build_onb(normal)
    d = normalize(r[..., None] * torch.cos(phi)[..., None] * U
                  + z[..., None] * normal
                  + r[..., None] * torch.sin(phi)[..., None] * V)
    pdf_w = 1.0 / (2.0 * PI * (1.0 - cos_theta))
    return d, pdf_w


def cone_pdf_w(theta_rad: Tensor) -> Tensor:
    return 1.0 / (2.0 * PI * (1.0 - torch.cos(theta_rad)))


# pdf measure conversions (samplers.h:160-171). Denominators are floored:
# masked lanes routinely carry dist=0 / cos=0, and a 0/0 NaN there poisons
# gradients even where a later where() discards it.
def pdf_w_to_a(pdf_w: Tensor, dist: Tensor, cos_there: Tensor) -> Tensor:
    return pdf_w * torch.abs(cos_there) / torch.clamp_min(torch.square(dist),
                                                          1e-30)


def pdf_a_to_w(pdf_a: Tensor, dist: Tensor, cos_there: Tensor) -> Tensor:
    return pdf_a * torch.square(dist) / torch.clamp_min(torch.abs(cos_there),
                                                        1e-20)
