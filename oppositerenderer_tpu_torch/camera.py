"""Pinhole + thin-lens camera.

The counterpart of ``oppositerenderer_tpu/camera.py``: the reference's
``Camera::setup`` semantics (Camera.cpp:333-345: ``lookdir`` is not
normalised — its length is the focal distance; ``camera_u/v`` span the
half extents of the image plane in world units) and the DoF ray
modification of helpers/camera.h:11-28, and the VCM camera pdf and
projection machinery (VCMCameraPass.cu:108-145, vcm.h connectCameraT1).
"""
from __future__ import annotations

import dataclasses
import math as pymath

import numpy as np
import torch

from .core.math import Tensor, dot, length, normalize
from .core.sampling import sample_unit_disc
from .devices import resolve_device


@dataclasses.dataclass
class Camera:
    eye: Tensor        # [3]
    lookdir: Tensor    # [3], |lookdir| = focal distance
    up: Tensor         # [3], normalised
    camera_u: Tensor   # [3], length = half image-plane width (world)
    camera_v: Tensor   # [3], length = half image-plane height (world)
    aperture: Tensor   # [] thin-lens aperture radius (0 = pinhole)
    hfov: float = 60.0
    vfov: float = 60.0

    @classmethod
    def make(cls, eye, lookat, up=(0.0, 1.0, 0.0), hfov: float = 60.0,
             vfov: float = 60.0, aperture: float = 0.0,
             device: torch.device | str | None = None) -> "Camera":
        """Camera::setup (Camera.cpp:333-345), computed in float64 on the
        host and stored as float32, as the JAX package does, on ``device``
        (None: the CUDA card)."""
        device = resolve_device(device)
        eye = np.asarray(eye, np.float64)
        lookat = np.asarray(lookat, np.float64)
        up = np.asarray(up, np.float64)
        up = up / max(np.linalg.norm(up), 1e-20)
        lookdir = lookat - eye
        lookdir_len = float(np.linalg.norm(lookdir))
        cu = np.cross(lookdir, up)
        cu /= max(np.linalg.norm(cu), 1e-20)
        cv = np.cross(cu, lookdir)
        cv /= max(np.linalg.norm(cv), 1e-20)
        ulen = lookdir_len * pymath.tan(pymath.radians(hfov * 0.5))
        vlen = lookdir_len * pymath.tan(pymath.radians(vfov * 0.5))

        def f32(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=device)

        return cls(eye=f32(eye), lookdir=f32(lookdir), up=f32(up),
                   camera_u=f32(cu * ulen), camera_v=f32(cv * vlen),
                   aperture=f32(aperture), hfov=hfov, vfov=vfov)

    @property
    def lookat(self) -> Tensor:
        return self.eye + self.lookdir

    def generate_rays(self, px: Tensor, py: Tensor, jitter: Tensor,
                      width: int, height: int,
                      dof_u: Tensor | None = None) -> tuple[Tensor, Tensor]:
        """Primary rays for integer pixel coords ``px, py`` [N] with
        per-pixel jitter [N,2] (RayGeneratorPT.cu:55-61):
        d = (pixel + jitter)/screen*2 - 1; dir = d.x*u + d.y*v + lookdir.
        With ``aperture > 0`` applies the thin-lens modification of
        helpers/camera.h:11-28 using the DoF samples ``dof_u`` [N,2]."""
        dx = (px.to(torch.float32) + jitter[..., 0]) / width * 2.0 - 1.0
        dy = (py.to(torch.float32) + jitter[..., 1]) / height * 2.0 - 1.0
        origin = self.eye.expand(dx.shape + (3,))
        direction = normalize(dx[..., None] * self.camera_u
                              + dy[..., None] * self.camera_v + self.lookdir)
        if dof_u is None:
            return origin, direction

        look_n = normalize(self.lookdir)
        focal_center = self.eye + self.lookdir
        t_focal = (dot(look_n, focal_center) - dot(look_n, self.eye)) \
            / dot(look_n, direction)
        look_at = origin + t_focal[..., None] * direction
        disc = sample_unit_disc(dof_u)
        o2 = origin + (disc[..., 0:1] * self.camera_u
                       + disc[..., 1:2] * self.camera_v) * self.aperture
        d2 = normalize(look_at - o2)
        # a tensor condition, not a Python branch: no device sync per call
        use = self.aperture > 0.0
        return torch.where(use, o2, origin), torch.where(use, d2, direction)

    # ------------------------------------------------- VCM t=1 machinery
    @property
    def image_plane_size(self) -> Tensor:
        """2*(ulen, vlen) in world units (Camera.cpp:344)."""
        return 2.0 * torch.stack([length(self.camera_u),
                                  length(self.camera_v)])

    def pdf_quantities(self, direction: Tensor, width: int, height: int
                       ) -> tuple[Tensor, Tensor]:
        """(cameraPdfW, cos_at_camera) for ray directions [...,3]
        (VCMCameraPass.cu:131-144): cameraPdfW = imageToSolidAngleFactor /
        pixelArea with imageToSolidAngleFactor = (distToImagePlane/cos)^2 /
        cos, the pixel area taken as x*y (the reference's x*x is a typo)."""
        look_n = normalize(self.lookdir)
        cos_at_camera = dot(look_n, direction)
        dist_image = length(self.lookdir)
        img_to_solid = torch.square(dist_image / cos_at_camera) \
            / cos_at_camera
        ips = self.image_plane_size
        pixel_area = (ips[0] / width) * (ips[1] / height)
        return img_to_solid / pixel_area, cos_at_camera

    def world_to_raster(self, point: Tensor, width: int, height: int
                        ) -> tuple[Tensor, Tensor, Tensor, Tensor]:
        """Project world points [...,3] to raster coordinates for the
        light-tracing splats (vcm.h connectCameraT1). Returns (px, py,
        in_frustum, unit direction from the eye)."""
        to_p = point - self.eye
        dist = length(to_p)
        d = to_p / torch.clamp_min(dist, 1e-20)[..., None]
        look_n = normalize(self.lookdir)
        cos_cam = dot(look_n, d)
        focal = length(self.lookdir)
        behind = cos_cam <= 1e-6
        # the ray's crossing of the image plane at distance focal
        t = focal / torch.clamp_min(cos_cam, 1e-6)
        on_plane = self.eye + t[..., None] * d
        rel = on_plane - (self.eye + self.lookdir)
        ulen2 = dot(self.camera_u, self.camera_u)
        vlen2 = dot(self.camera_v, self.camera_v)
        ndc_x = dot(rel, self.camera_u) / ulen2   # [-1, 1] in the frustum
        ndc_y = dot(rel, self.camera_v) / vlen2
        px = (ndc_x + 1.0) * 0.5 * width
        py = (ndc_y + 1.0) * 0.5 * height
        inside = ((~behind) & (px >= 0) & (px < width)
                  & (py >= 0) & (py < height))
        return px, py, inside, d

    # ----------------------------------------------------- interactive ops
    def _remake(self, eye, lookat) -> "Camera":
        return Camera.make(eye.cpu().numpy(), lookat.cpu().numpy(),
                           self.up.cpu().numpy(), self.hfov, self.vfov,
                           float(self.aperture), device=self.eye.device)

    def translate(self, x: float, y: float) -> "Camera":
        """Camera::translate: pan in the image plane (Camera.cpp:362-368)."""
        trans = self.camera_u * x + self.camera_v * y
        return self._remake(self.eye + trans, self.lookat + trans)

    def dolly(self, scale: float) -> "Camera":
        """Camera::dolly (Camera.cpp:374-382)."""
        return self._remake(self.eye + self.lookdir * scale, self.lookat)
