"""Analytic radiance parity of the port (``tests/test_analytic.py``'s four
tests, at its tolerances and its 16^2 floor scenes): a diffuse floor under
a rectangular area light, whose per-pixel radiance is rho / pi * E(x) with
E the exact polygon-luminaire irradiance (Lambert's formula, Arvo eq.
1.1), for PT, PPM and VCM; and the same floor under a point light, E =
Phi cos(theta) / (4 pi d^2), for PT. The VCM case is in
``test_torch_analytic_vcm.py``: its 96 iterations take ~45 s on the CPU,
and a file of its own runs beside this one.
"""
import numpy as np
import pytest
import torch

from oppositerenderer_tpu_torch.camera import Camera
from oppositerenderer_tpu_torch.config import RenderConfig, RenderMethod
from oppositerenderer_tpu_torch.integrators.common import pixel_coords
from oppositerenderer_tpu_torch.lights import make_area_light, \
    make_point_light
from oppositerenderer_tpu_torch.renderer import Renderer
from oppositerenderer_tpu_torch.scene.builder import SceneBuilder

RHO = 0.6
W = H = 16


def polygon_irradiance(x, n, corners, L):
    """Exact irradiance at x (normal n) from a polygon of constant
    radiance L (one-sided): Lambert's / Arvo's formula."""
    k = len(corners)
    r = [c - x for c in corners]
    r = [v / np.linalg.norm(v) for v in r]
    acc = 0.0
    for i in range(k):
        a, b = r[i], r[(i + 1) % k]
        gamma = np.arccos(np.clip(np.dot(a, b), -1.0, 1.0))
        c = np.cross(a, b)
        cn = np.linalg.norm(c)
        if cn > 1e-12:
            acc += gamma * np.dot(c / cn, n)
    return np.abs(acc) * 0.5 * L


def floor_scene(light):
    b = SceneBuilder("analytic")
    floor = b.add_diffuse((RHO, RHO, RHO))
    b.add_parallelogram((-20, 0, -20), (0, 0, 40), (40, 0, 0), floor)
    if light["kind"] == 0:
        anchor = (-0.5, 2.0, -0.5)
        em = b.add_emitter(light["power"], kd=(1, 1, 1), light=light)
        b.add_parallelogram(anchor, (1, 0, 0), (0, 0, 1), em)
    else:
        b.add_light(light)
    scene = b.build(aabb_padding=0.1, device="cpu")
    cam = Camera.make(eye=(0.0, 1.2, -2.5), lookat=(0.0, 0.0, 0.0),
                      hfov=30.0, vfov=30.0, device="cpu")
    return scene, cam


def pixel_floor_points(cam):
    """The pixel-centre rays' crossings of the y = 0 plane (host math)."""
    px, py = pixel_coords(W, H, "cpu")
    o, d = cam.generate_rays(px, py, torch.full((W * H, 2), 0.5), W, H)
    o, d = o.numpy().astype(np.float64), d.numpy().astype(np.float64)
    t = -o[:, 1] / d[:, 1]
    return o + t[:, None] * d


def run(scene, cam, method, iters, seed, **kw):
    cfg = RenderConfig(width=W, height=H, render_method=method, **kw)
    r = Renderer(scene, cam, cfg, seed=seed)
    r.render(iters)
    return r.film.mean_radiance().numpy().reshape(H * W, 3)


def assert_matches(img, truth, med_tol, mean_tol):
    lum = img.mean(axis=1)
    rel = np.abs(lum - truth) / np.maximum(truth, 1e-9)
    assert np.median(rel) < med_tol, (np.median(rel), lum[:4], truth[:4])
    assert abs(lum.mean() - truth.mean()) / truth.mean() < mean_tol, (
        lum.mean(), truth.mean())


@pytest.fixture(scope="module")
def area_setup():
    power = np.array((3.0, 3.0, 3.0), np.float32)
    light = make_area_light(power, (-0.5, 2.0, -0.5), (1, 0, 0), (0, 0, 1))
    scene, cam = floor_scene(light)
    pts = pixel_floor_points(cam)
    L = float(power[0] / (1.0 * np.pi))  # area = 1
    corners = [np.array(c, np.float64) for c in
               [(-0.5, 2, -0.5), (0.5, 2, -0.5), (0.5, 2, 0.5),
                (-0.5, 2, 0.5)]]
    n = np.array([0.0, 1.0, 0.0])
    E = np.array([polygon_irradiance(p, n, corners, L) for p in pts])
    truth = RHO / np.pi * E
    return scene, cam, truth


def test_pt_matches_polygon_formula(area_setup):
    scene, cam, truth = area_setup
    img = run(scene, cam, RenderMethod.PATH_TRACING, 96, seed=7)
    assert_matches(img, truth, med_tol=0.05, mean_tol=0.03)


def test_ppm_matches_polygon_formula(area_setup):
    # the photon map contributes nothing here (no second diffuse bounce
    # exists), so the PPM radiance is its direct estimate, which must hit
    # the same closed form
    scene, cam, truth = area_setup
    img = run(scene, cam, RenderMethod.PROGRESSIVE_PHOTON_MAPPING, 48,
              seed=8, photons_per_iteration=1 << 10)
    assert_matches(img, truth, med_tol=0.05, mean_tol=0.03)


def test_pt_matches_point_light_formula():
    power = np.array((5.0, 5.0, 5.0), np.float32)
    lpos = np.array((0.3, 1.5, 0.2), np.float64)
    scene, cam = floor_scene(make_point_light(power, tuple(lpos)))
    pts = pixel_floor_points(cam)
    d = lpos[None, :] - pts
    dist2 = (d * d).sum(axis=1)
    cos = d[:, 1] / np.sqrt(dist2)
    E = float(power[0]) * cos / (4.0 * np.pi * dist2)
    truth = RHO / np.pi * E
    img = run(scene, cam, RenderMethod.PATH_TRACING, 64, seed=10)
    assert_matches(img, truth, med_tol=0.05, mean_tol=0.03)
