"""Fresnel terms (reference ``renderer/reflection.h:48-174``, pbrt-derived).

The counterpart of ``oppositerenderer_tpu/bsdf/fresnel.py``: the
FresnelNoOp/FresnelDielectric dispatch becomes a boolean blend.
"""
from __future__ import annotations

import torch

from ..core.math import Tensor


def fresnel_dielectric(cos_i: Tensor, eta_i: Tensor, eta_t: Tensor) -> Tensor:
    """Exact dielectric Fresnel reflectance. ``cos_i`` is the signed cosine
    against the surface normal; negative means the ray exits the medium and
    the etas swap (FresnelDielectric::evaluate, reflection.h:137-169).
    Returns 1 on total internal reflection."""
    cos_i = torch.clamp(cos_i, -1.0, 1.0)
    entering = cos_i > 0.0
    ei = torch.where(entering, eta_i, eta_t)
    et = torch.where(entering, eta_t, eta_i)
    sin_t = ei / et * torch.sqrt(torch.clamp_min(1.0 - cos_i * cos_i, 0.0))
    tir = sin_t >= 1.0
    aci = torch.abs(cos_i)
    cos_t = torch.sqrt(torch.clamp_min(1.0 - sin_t * sin_t, 0.0))
    # floored denominators: masked non-dielectric lanes carry ior=0 (0/0)
    r_parl = (et * aci - ei * cos_t) / torch.clamp_min(
        et * aci + ei * cos_t, 1e-20)
    r_perp = (ei * aci - et * cos_t) / torch.clamp_min(
        ei * aci + et * cos_t, 1e-20)
    r = 0.5 * (r_parl * r_parl + r_perp * r_perp)
    return torch.where(tir, 1.0, r)


def fresnel(cos_i: Tensor, eta_i: Tensor, eta_t: Tensor,
            use_dielectric: Tensor) -> Tensor:
    """Blend of FresnelDielectric and FresnelNoOp (always 1)."""
    return torch.where(use_dielectric,
                       fresnel_dielectric(cos_i, eta_i, eta_t), 1.0)
