"""Composite BSDF, vectorised over lanes.

The counterpart of ``oppositerenderer_tpu/bsdf/bsdf.py``. Every lane
carries dense coefficients for all four BxDF kinds — Lambertian(kd),
Phong(ks, exponent), SpecularReflection(kr, fresnel),
SpecularTransmission(kt, ior) — and all four are evaluated without
branches; absent components have zero coefficients and zero pick
probability. Semantics follow VcmBSDF (``renderer/BSDF.h:80-645``) with
the JAX package's two documented fixes: each component's own pick
probability scales its pdf, and Phong samples below the shading horizon
are rejected. Sampling densities are ``detach()``-ed, as the JAX package
stops their gradients.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..core.math import (INV_PI, PI, Frame, Tensor, dot, local_reflect,
                         luminance, max3, normalize)
from ..core.sampling import (power_cos_hemisphere_pdf_w,
                             sample_power_cos_hemisphere)
from .fresnel import fresnel, fresnel_dielectric

EPS_COSINE = 1e-6   # reference config.h:42
EPS_PHONG = 1e-3    # reference BxDF.h:265

# component indices
LAMBERTIAN, PHONG, SPEC_REFL, SPEC_TRANS = 0, 1, 2, 3
N_COMPONENTS = 4


@dataclasses.dataclass
class BSDF:
    """Per-lane composite BSDF bound to a hit point (VcmBSDF equivalent).
    ``local_dir_fix`` is the stored incident direction in the shading
    frame ("fix" vs "gen", SmallVCM convention — BSDF.h:310-312)."""

    frame: Frame
    ng: Tensor                # geometric normal [...,3]
    kd: Tensor                # [...,3] Lambertian reflectance
    ks: Tensor                # [...,3] Phong reflectance
    phong_exp: Tensor         # [...]
    kr: Tensor                # [...,3] specular reflection reflectance
    kt: Tensor                # [...,3] specular transmission transmittance
    ior: Tensor               # [...] eta_t (eta_i = 1)
    kr_is_dielectric: Tensor  # [...] bool: kr fresnel dielectric vs no-op
    local_dir_fix: Tensor     # [...,3]

    @classmethod
    def make(cls, shading_normal: Tensor, geometric_normal: Tensor,
             incident_dir_world: Tensor, kd: Tensor, ks: Tensor,
             phong_exp: Tensor, kr: Tensor, kt: Tensor, ior: Tensor,
             kr_is_dielectric: Tensor) -> "BSDF":
        """``incident_dir_world`` points away from the surface (toward the
        previous path vertex), like VcmBSDF's aIncidentDir."""
        frame = Frame.from_normal(shading_normal)
        return cls(frame=frame, ng=geometric_normal, kd=kd, ks=ks,
                   phong_exp=phong_exp, kr=kr, kt=kt, ior=ior,
                   kr_is_dielectric=kr_is_dielectric,
                   local_dir_fix=frame.to_local(incident_dir_world))

    # -- derived quantities ------------------------------------------------
    def is_valid(self) -> Tensor:
        """VcmBSDF::isValid — incident dir above the shading horizon."""
        return self.local_dir_fix[..., 2] > EPS_COSINE

    def world_dir_fix(self) -> Tensor:
        return self.frame.to_world(self.local_dir_fix)

    def _fresnel_refl(self) -> Tensor:
        """Fresnel reflectance for the kr component at the fixed dir."""
        return fresnel(self.local_dir_fix[..., 2], torch.ones_like(self.ior),
                       self.ior, self.kr_is_dielectric)

    def _fresnel_trans(self) -> Tensor:
        """(1-R) dielectric factor for the kt component."""
        return 1.0 - fresnel_dielectric(self.local_dir_fix[..., 2],
                                        torch.ones_like(self.ior), self.ior)

    def pick_probs(self) -> Tensor:
        """Unnormalised component pick probabilities [...,4]
        (VcmBSDF::AddBxDF albedo = luminance, Fresnel-scaled speculars)."""
        r = self._fresnel_refl()
        t = self._fresnel_trans()
        return torch.stack([luminance(self.kd), luminance(self.ks),
                            r * luminance(self.kr), t * luminance(self.kt)],
                           dim=-1)

    def continuation_prob(self) -> Tensor:
        """RR continuation probability (VcmBSDF::AddBxDF accumulation,
        clamped to 1). A sampling probability: detached."""
        r = self._fresnel_refl()
        has_kt = max3(self.kt) > 0.0
        total = (max3(self.kd) + max3(self.ks) + r * max3(self.kr)
                 + torch.where(has_kt, self._fresnel_trans(), 0.0))
        return torch.clamp_max(total, 1.0).detach()

    def is_specular(self) -> Tensor:
        """True when only specular components are present."""
        return (luminance(self.kd) + luminance(self.ks)) <= 0.0

    def _matched_mask(self, world_dir_gen: Tensor) -> Tensor:
        """Side selection by geometric normal (BSDF.h:180-184): same side ->
        reflection components; opposite side -> transmission. [...,4]."""
        same = (dot(self.ng, world_dir_gen)
                * dot(self.ng, self.world_dir_fix())) >= 0.0
        return torch.stack([same, same, same, ~same], dim=-1)

    # -- per-component math (local frame) ---------------------------------
    def _lambertian_f_pdf(self, local_gen: Tensor):
        """vcmF semantics (BxDF.h:247-262): zero unless both dirs are above
        the shading horizon; the reverse pdf swaps the cosines."""
        fix_z = self.local_dir_fix[..., 2]
        gen_z = local_gen[..., 2]
        ok = (fix_z >= EPS_COSINE) & (gen_z >= EPS_COSINE)
        f = torch.where(ok[..., None], self.kd * INV_PI, 0.0)
        dpdf = torch.where(ok, torch.clamp_min(gen_z, 0.0) * INV_PI, 0.0)
        rpdf = torch.where(ok, torch.clamp_min(fix_z, 0.0) * INV_PI, 0.0)
        return f, dpdf, rpdf

    def _phong_f_pdf(self, local_gen: Tensor):
        """Modified Phong about the mirror of dir_fix (BxDF.h:283-333);
        direct and reverse pdfs coincide (BxDF.h:387-396)."""
        fix_z = self.local_dir_fix[..., 2]
        gen_z = local_gen[..., 2]
        refl = local_reflect(self.local_dir_fix)
        dot_r = dot(refl, local_gen)
        ok = ((fix_z >= EPS_COSINE) & (gen_z >= EPS_COSINE)
              & (dot_r > EPS_PHONG))
        rho = self.ks * ((self.phong_exp + 2.0) * 0.5 * INV_PI)[..., None]
        f = torch.where(ok[..., None],
                        rho * torch.pow(torch.clamp_min(dot_r, EPS_PHONG),
                                        self.phong_exp)[..., None], 0.0)
        pdf = torch.where(ok, power_cos_hemisphere_pdf_w(
            refl, local_gen, self.phong_exp), 0.0)
        return f, pdf, pdf

    # -- public evaluation -------------------------------------------------
    def f(self, world_dir_gen: Tensor):
        """VcmBSDF::vcmF (BSDF.h:577-639).

        Returns ``(f, cos_gen, direct_pdf_w, reverse_pdf_w)``; pdfs are
        pick-probability weighted over side-matched components.
        """
        local_gen = self.frame.to_local(world_dir_gen)
        matched = self._matched_mask(world_dir_gen)
        pick = self.pick_probs() * matched
        pick_sum = torch.sum(pick, dim=-1)
        safe_sum = torch.where(pick_sum > 0.0, pick_sum, 1.0)
        w = pick / safe_sum[..., None]

        f_l, d_l, r_l = self._lambertian_f_pdf(local_gen)
        f_p, d_p, r_p = self._phong_f_pdf(local_gen)

        ml = matched[..., LAMBERTIAN]
        mp = matched[..., PHONG]
        f = (torch.where(ml[..., None], f_l, 0.0)
             + torch.where(mp[..., None], f_p, 0.0))
        dpdf = w[..., LAMBERTIAN] * torch.where(ml, d_l, 0.0) \
            + w[..., PHONG] * torch.where(mp, d_p, 0.0)
        rpdf = w[..., LAMBERTIAN] * torch.where(ml, r_l, 0.0) \
            + w[..., PHONG] * torch.where(mp, r_p, 0.0)

        ok = pick_sum > 0.0
        f = torch.where(ok[..., None], f, 0.0)
        cos_gen = local_gen[..., 2]
        # sampling densities: detached (they enter weights and MIS only)
        dpdf = torch.where(ok, dpdf, 0.0).detach()
        rpdf = torch.where(ok, rpdf, 0.0).detach()
        return f, cos_gen, dpdf, rpdf

    def pdf(self, world_dir_gen: Tensor, reverse: bool = False) -> Tensor:
        """VcmBSDF::pdf (BSDF.h:414-435)."""
        _, _, dpdf, rpdf = self.f(world_dir_gen)
        return rpdf if reverse else dpdf

    def sample(self, u3: Tensor, adjoint: bool = False):
        """VcmBSDF::vcmSampleF (BSDF.h:463-567): pick a component by albedo
        probability, sample it, combine pdfs/f over matched components.

        ``u3``: [...,3] uniforms. ``adjoint``: True on light subpaths
        (importance transport flips the eta^2 factor in transmission).
        """
        fix = self.local_dir_fix
        fix_z = fix[..., 2]
        pick = self.pick_probs()           # sampling uses aSampleType=All
        pick_sum = torch.sum(pick, dim=-1)
        safe_sum = torch.where(pick_sum > 0.0, pick_sum, 1.0)
        cdf = torch.cumsum(pick / safe_sum[..., None], dim=-1)
        u0 = u3[..., 0]
        idx = torch.sum((u0[..., None] >= cdf[..., :-1]).to(torch.int32),
                        dim=-1)
        u2 = u3[..., 1:3]

        # --- candidate: Lambertian (cosine hemisphere, local frame) ------
        cos_l = torch.sqrt(u2[..., 0])
        sin_l = torch.sqrt(torch.clamp_min(1.0 - u2[..., 0], 0.0))
        phi_l = 2.0 * PI * u2[..., 1]
        dir_lamb = torch.stack([sin_l * torch.cos(phi_l),
                                sin_l * torch.sin(phi_l), cos_l], dim=-1)

        # --- candidate: Phong lobe about localReflect(fix) ---------------
        lobe, _ = sample_power_cos_hemisphere(u2, self.phong_exp)
        refl_fix = local_reflect(fix)
        dir_phong = Frame.from_normal(refl_fix).to_world(lobe)

        # --- candidate: specular reflection ------------------------------
        dir_srefl = local_reflect(fix)
        r_refl = self._fresnel_refl()
        f_srefl = (r_refl[..., None] * self.kr
                   / torch.clamp_min(torch.abs(fix_z), EPS_COSINE)[..., None])

        # --- candidate: specular transmission (BxDF.h:524-571) -----------
        entering = fix_z > 0.0
        ei = torch.where(entering, 1.0, self.ior)
        et = torch.where(entering, self.ior, 1.0)
        eta = ei / et
        sin2_t = eta * eta * torch.clamp_min(1.0 - fix_z * fix_z, 0.0)
        tir = sin2_t >= 1.0
        cos_t = torch.sqrt(torch.clamp_min(1.0 - sin2_t, 0.0))
        cos_t = torch.where(entering, -cos_t, cos_t)
        dir_strans = torch.stack([-eta * fix[..., 0], -eta * fix[..., 1],
                                  cos_t], dim=-1)
        t_frac = 1.0 - fresnel_dielectric(fix_z, torch.ones_like(self.ior),
                                          self.ior)
        # radiance transport compresses by eta^2; adjoint transport does
        # not [Veach 5.2; BxDF.h:559-571]
        weight = t_frac if adjoint else t_frac * eta * eta
        f_strans = (weight[..., None] * self.kt
                    / torch.clamp_min(torch.abs(cos_t), EPS_COSINE)[..., None])
        f_strans = torch.where(tir[..., None], 0.0, f_strans)

        # --- select the sampled direction --------------------------------
        local_gen = torch.where(
            (idx == LAMBERTIAN)[..., None], dir_lamb,
            torch.where((idx == PHONG)[..., None], dir_phong,
                        torch.where((idx == SPEC_REFL)[..., None], dir_srefl,
                                    dir_strans)))
        local_gen = normalize(local_gen)
        world_gen = self.frame.to_world(local_gen)
        is_spec = idx >= SPEC_REFL

        # --- combined pdf and f over matched components ------------------
        matched = self._matched_mask(world_gen)
        w = pick / safe_sum[..., None]

        f_l, d_l, _ = self._lambertian_f_pdf(local_gen)
        f_p, d_p, _ = self._phong_f_pdf(local_gen)

        sel_l = idx == LAMBERTIAN
        sel_p = idx == PHONG
        sel_sr = idx == SPEC_REFL
        sel_st = idx == SPEC_TRANS

        # specular picks: pdf = pick weight, f = precomputed dirac weight
        pdf = torch.where(sel_sr, w[..., SPEC_REFL],
                          torch.where(sel_st, w[..., SPEC_TRANS], 0.0))
        f = torch.where(sel_sr[..., None], f_srefl, 0.0) \
            + torch.where(sel_st[..., None], f_strans, 0.0)

        # non-specular picks: sum the matched non-specular components
        nonspec_pick = ~is_spec
        ml = matched[..., LAMBERTIAN] & nonspec_pick
        mp = matched[..., PHONG] & nonspec_pick
        pdf = pdf + torch.where(ml, w[..., LAMBERTIAN] * d_l, 0.0) \
            + torch.where(mp, w[..., PHONG] * d_p, 0.0)
        f = f + torch.where(ml[..., None], f_l, 0.0) \
            + torch.where(mp[..., None], f_p, 0.0)

        # rejections: zero total pick prob, sampled component with zero pdf
        comp_ok = torch.where(
            sel_l, d_l > 0.0,
            torch.where(sel_p, d_p > 0.0,
                        torch.where(sel_st, ~tir, torch.ones_like(tir))))
        ok = (pick_sum > 0.0) & comp_ok & (pdf > 0.0)
        f = torch.where(ok[..., None], f, 0.0)
        pdf = torch.where(ok, pdf, 0.0).detach()
        cos_out = torch.abs(local_gen[..., 2])
        return SampleResult(f=f, world_dir=world_gen, pdf_w=pdf,
                            cos_theta=cos_out, is_specular=is_spec, valid=ok)


class SampleResult(NamedTuple):
    f: Tensor            # [...,3] BSDF value (speculars pre-divided by |cos|)
    world_dir: Tensor    # [...,3] sampled direction
    pdf_w: Tensor        # [...] solid-angle pdf (x dirac weight, speculars)
    cos_theta: Tensor    # [...] |cos| of sampled dir to shading normal
    is_specular: Tensor  # [...] bool
    valid: Tensor        # [...] bool: sample accepted
