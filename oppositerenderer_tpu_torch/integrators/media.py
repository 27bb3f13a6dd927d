"""Participating media for the PPM integrator.

The counterpart of ``oppositerenderer_tpu/integrators/media.py``. The
reference (flag-gated, default off, ``config.h:29``) renders a
homogeneous medium with per-segment transmittance ``exp(-sigma_t d)``
(ParticipatingMedium.cu:66-93), photon scatter events that deposit
volumetric photons into a buffer of their own
(ParticipatingMedium.cu:110-201), and a beam gather over a BVH of photon
spheres (VolumetricPhotonSphere.cu, VolumetricPhotonSphereRadiance.cu).

The JAX package's redesign, kept here:

* the beam query becomes a distance-sampled point gather: an eye segment
  samples one point inside its in-medium overlap (pdf 1/len) and runs the
  sorted-grid photon gather there, normalised by the sphere's volume;
* scattering is isotropic (phase 1/(4 pi));
* each photon path deposits at most ``media_max_deposits_per_photon``
  volumetric photons.
"""
from __future__ import annotations

import torch

from ..core.math import Tensor, ray_aabb
from ..scene.types import Medium

INV_4PI = 0.07957747154594767


def segment_overlap(medium: Medium, o: Tensor, d: Tensor, t_hit: Tensor
                    ) -> tuple[Tensor, Tensor]:
    """(t_enter, overlap_len), both [N]: where [0, t_hit] enters the
    medium's box and how much of it lies inside (0 when it misses)."""
    inv_d = 1.0 / torch.where(torch.abs(d) < 1e-12, 1e-12, d)
    t0, t1 = ray_aabb(o, inv_d, medium.aabb_min, medium.aabb_max,
                      torch.zeros_like(t_hit), t_hit)
    return t0, torch.clamp_min(t1 - t0, 0.0)


def transmittance(medium: Medium, overlap_len: Tensor) -> Tensor:
    """exp(-sigma_t * distance in the medium) (ParticipatingMedium.cu:75)."""
    return torch.exp(-medium.sigma_t * overlap_len)


def sample_scatter_distance(medium: Medium, u: Tensor
                            ) -> tuple[Tensor, Tensor]:
    """Free-flight sampling t ~ Exp(sigma_t): (t, pdf(t))."""
    sigma_t = torch.clamp_min(medium.sigma_t, 1e-12)
    t = -torch.log(torch.clamp_min(1.0 - u, 1e-12)) / sigma_t
    return t, sigma_t * torch.exp(-sigma_t * t)


def volumetric_radiance_estimate(medium: Medium, accum_power: Tensor,
                                 radius: Tensor, seg_len: Tensor,
                                 t_in_medium: Tensor, n_emitted: int,
                                 weight: Tensor | None = None) -> Tensor:
    """One sample of the in-scattered radiance along a segment [N,3]:

        L = T(t) * sigma_s * phase * density / pdf(t),

    density = power / (4/3 pi r^3) / n_emitted / sigma_t, pdf(t) =
    1/seg_len. ``accum_power`` is the kernel-weighted photon power gathered
    at the sampled point (the photon gather without the normal test).
    ``weight`` [N,3] is the path attenuation up to the segment times the
    inverse probability of picking the segment (``ppm.trace_eye_pass``);
    without it, 1.

    The 1/sigma_t: photons are deposited at scatter events, whose density
    per unit volume is sigma_t times the fluence, so the gathered power
    over-counts the fluence by sigma_t (the JAX package's slab quadrature
    test found it, ``tests/test_media.py``).
    """
    volume = (4.0 / 3.0) * torch.pi * radius ** 3
    t_trans = torch.exp(-medium.sigma_t * t_in_medium)
    fluence = accum_power / (volume * n_emitted
                             * torch.clamp_min(medium.sigma_t, 1e-12))
    out = (t_trans * medium.sigma_s * INV_4PI * seg_len)[..., None] \
        * fluence
    if weight is not None:
        out = out * weight
    return out
