"""Participating media on the port: the statistical checks of
``tests/test_media.py`` (:76 attenuation and in-scatter, :102 energy,
:240 the single-scatter slab against an independent quadrature), in the
same configurations and with the same bounds. Port-only and long, so
they are marked slow."""
import dataclasses

import numpy as np
import pytest
import torch

from oppositerenderer_tpu_torch.camera import Camera
from oppositerenderer_tpu_torch.config import RenderConfig, RenderMethod
from oppositerenderer_tpu_torch.lights import make_point_light
from oppositerenderer_tpu_torch.renderer import Renderer
from oppositerenderer_tpu_torch.scene import (Medium, SceneBuilder,
                                              get_scene_by_name)

torch.set_num_threads(2)

CFG = RenderConfig(width=32, height=32,
                   render_method=RenderMethod.PROGRESSIVE_PHOTON_MAPPING,
                   photons_per_iteration=1 << 13, photon_grid_resolution=16)


def cornell(ss=None, sa=None):
    """CornellSmall, in JAX's test medium box [0, 2.5]^3 when ss is set."""
    scene, cam = get_scene_by_name("CornellSmall", "cpu")
    if ss is not None:
        scene = dataclasses.replace(scene, medium=Medium(
            sigma_s=torch.tensor(ss), sigma_a=torch.tensor(sa),
            aabb_min=torch.zeros(3), aabb_max=torch.full((3,), 2.5)))
    return scene, cam


def render(scene, cam, seed, iters):
    img = Renderer(scene, cam, CFG, seed=seed).render(iters).mean_radiance()
    return img.numpy()


@pytest.fixture(scope="module")
def clear():
    """The clear scene's images, rendered once: (seed 4, 3 iterations) and
    (seed 5, 4 iterations), as the two tests take them."""
    scene, cam = cornell()
    return {4: render(scene, cam, 4, 3), 5: render(scene, cam, 5, 4)}


@pytest.mark.slow
def test_medium_attenuates_and_adds_inscatter(clear):
    """A pure absorber darkens the lit surfaces by more than 15%; a
    scattering medium puts some of the light back as in-scatter."""
    base = clear[4]
    absorbed = render(*cornell(0.0, 0.4), 4, 3)
    mask = base.sum(-1) > 0.05
    assert absorbed[mask].mean() < base[mask].mean() * 0.85
    scat = render(*cornell(0.3, 0.0), 4, 3)
    assert np.isfinite(scat).all()
    assert scat.mean() > absorbed.mean()


@pytest.mark.slow
def test_medium_energy_sanity(clear):
    """A purely scattering medium keeps the image's energy within
    [50%, 110%] of the clear scene's."""
    base = float(clear[5].mean())
    scat = float(render(*cornell(0.1, 0.0), 5, 4).mean())
    assert 0.5 * base < scat < 1.1 * base, (scat, base)


@pytest.mark.slow
def test_slab_single_scatter_matches_quadrature():
    """A point light in a homogeneous box, black walls, the camera ray
    crossing the medium: the converged volumetric estimate against a
    quadrature of the single-scatter integral

        L = int T(0,t) sigma_s phase T(t, light) Phi / (4 pi d(t)^2) dt.

    The low albedo (1/6) keeps multiple scattering near 2%."""
    sigma_s, sigma_a = 0.05, 0.25
    sigma_t = sigma_s + sigma_a
    phi = 50.0
    light_pos = np.array([1.45, 1.0, 1.0])

    b = SceneBuilder("slab")
    black = b.add_diffuse((0.0, 0.0, 0.0))
    S = 3.0
    b.add_parallelogram((-S, -S, 2.5), (2 * S, 0, 0), (0, 2 * S, 0), black)
    b.add_light(make_point_light((phi, phi, phi), tuple(light_pos)))
    b.set_medium(sigma_s, sigma_a, aabb_min=(-1.0, -1.0, 0.0),
                 aabb_max=(3.0, 3.0, 2.0))
    scene = b.build(device="cpu")
    cam = Camera.make(eye=(1.0, 1.0, -1.0), lookat=(1.0, 1.0, 2.0),
                      hfov=10, vfov=10, device="cpu")
    cfg = RenderConfig(width=16, height=16,
                       render_method=RenderMethod.PROGRESSIVE_PHOTON_MAPPING,
                       photons_per_iteration=1 << 14,
                       photon_grid_resolution=24, iterations_per_dispatch=4)
    r = Renderer(scene, cam, cfg, seed=6, ppm_initial_radius=0.12)
    img = r.render(24).mean_radiance().numpy()
    center = img[6:10, 6:10].mean()

    # the centre ray o = (1, 1, -1), d = +z is in the medium for t in [1, 3]
    ts = np.linspace(1.0, 3.0, 4001)
    pts = np.array([1.0, 1.0, -1.0]) + ts[:, None] * np.array([0, 0, 1.0])
    dlight = np.linalg.norm(pts - light_pos, axis=1)
    integrand = (np.exp(-sigma_t * (ts - 1.0)) * sigma_s / (4 * np.pi)
                 * np.exp(-sigma_t * dlight) * phi
                 / (4 * np.pi * np.maximum(dlight, 1e-9) ** 2))
    L_quad = np.trapezoid(integrand, ts)
    assert center == pytest.approx(L_quad, rel=0.15), (center, L_quad)
