"""The port's participating media against the JAX package's, function by
function, pass by pass and for one whole PPM iteration.

Both packages draw the same per-lane random streams, and the medium
branches draw theirs in the JAX package's order, so the eye and photon
passes agree lane by lane to float tolerance (positions within 1e-4 of
the scene's diagonal, ROADMAP queue C). The whole iteration runs JAX's
tile gather in interpret mode and must agree on at least 99% of the
pixels at rtol 1e-3, with the image mean within 1e-3. Without a medium
the port draws what it drew before media were ported: its PPM images
are pinned bit for bit.
"""
import dataclasses
import hashlib
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import _torch_cases  # noqa: E402
from oppositerenderer_tpu.camera import Camera as JCamera
from oppositerenderer_tpu.config import RenderConfig as JConfig
from oppositerenderer_tpu.core import math as jmath
from oppositerenderer_tpu.core import rng as jrng
from oppositerenderer_tpu.integrators import common as jcommon
from oppositerenderer_tpu.integrators import media as jmedia
from oppositerenderer_tpu.integrators import ppm as jppm
from oppositerenderer_tpu.lights import make_area_light as jarea_light
from oppositerenderer_tpu.photon_map import build_photon_grid as jgrid
from oppositerenderer_tpu.photon_map import gather_photons as jgather
from oppositerenderer_tpu.photon_map import min_cell_size_for_window as jmcs
from oppositerenderer_tpu.scene import SceneBuilder as JBuilder
from oppositerenderer_tpu.scene import get_scene_by_name as jax_scene
from oppositerenderer_tpu.scene.types import Medium as JMedium
from oppositerenderer_tpu_torch import interop
from oppositerenderer_tpu_torch.camera import Camera
from oppositerenderer_tpu_torch.config import RenderConfig, RenderMethod
from oppositerenderer_tpu_torch.core import math as tmath
from oppositerenderer_tpu_torch.core.rng import iteration_key, make_root_key
from oppositerenderer_tpu_torch.integrators import media, ppm
from oppositerenderer_tpu_torch.integrators.common import (pixel_coords,
                                                           scene_epsilon)
from oppositerenderer_tpu_torch.lights import make_area_light
from oppositerenderer_tpu_torch.renderer import Renderer
from oppositerenderer_tpu_torch.scene import (Medium, SceneBuilder,
                                              get_scene_by_name)

torch.set_num_threads(2)

PPM = RenderMethod.PROGRESSIVE_PHOTON_MAPPING
SEED = 7
SIZE = 32
CFG = dict(width=SIZE, height=SIZE, photons_per_iteration=1 << 12,
           photon_grid_resolution=16)
# JAX's test medium (tests/test_media.py:51-56): covers all of CornellSmall
SIGMA_S, SIGMA_A, BOX = 0.15, 0.02, 2.5
PIXEL_RTOL = 1e-3
MIN_AGREEING = 0.99
MEAN_RTOL = 1e-3
POS_ATOL_OF_EXTENT = 1e-4
FN_RTOL = 1e-5


def jax_cfg(**kw):
    return JConfig(**{**CFG, "render_method": PPM, **kw})


def port_cfg(**kw):
    return RenderConfig(**{**CFG, "render_method": PPM, **kw})


def jax_medium(ss=SIGMA_S, sa=SIGMA_A, lo=(0.0,) * 3, hi=(BOX,) * 3):
    return JMedium(sigma_s=jnp.float32(ss), sigma_a=jnp.float32(sa),
                   aabb_min=jnp.asarray(lo, jnp.float32),
                   aabb_max=jnp.asarray(hi, jnp.float32))


def port_medium(ss=SIGMA_S, sa=SIGMA_A, lo=(0.0,) * 3, hi=(BOX,) * 3):
    return Medium(sigma_s=torch.tensor(ss), sigma_a=torch.tensor(sa),
                  aabb_min=torch.tensor(lo), aabb_max=torch.tensor(hi))


def cornell_pair(name="CornellSmall"):
    """The same scene with JAX's test medium in both packages."""
    js, jc = jax_scene(name)
    ts, tc = get_scene_by_name(name, "cpu")
    return (js.replace(medium=jax_medium()), jc,
            dataclasses.replace(ts, medium=port_medium()), tc)


def glass_slab(sigma_a, port: bool):
    """JAX's glass-slab scene (tests/test_media.py:123-147), built by
    either package: camera at z=-2, a glass slab over z in [0.5, 1.5], a
    white wall at z=3, the medium over z in [0, 3]. A straight eye path
    spends 2.0 units in the medium outside the glass, 1.0 inside it."""
    b = SceneBuilder("glass-slab") if port else JBuilder("glass-slab")
    light = (make_area_light if port else jarea_light)(
        (30, 30, 30), (-4.0, -1.0, 1.0), (0.5, 0, 0), (0, 0.5, 0))
    glass = b.add_glass(1.5)
    wall = b.add_diffuse((0.7, 0.7, 0.7))
    em = b.add_emitter((30, 30, 30), light=light)
    S = 4.0
    b.add_parallelogram((-S, -S, 0.5), (2 * S, 0, 0), (0, 2 * S, 0), glass)
    b.add_parallelogram((-S, -S, 1.5), (2 * S, 0, 0), (0, 2 * S, 0), glass)
    b.add_parallelogram((-S, -S, 3.0), (2 * S, 0, 0), (0, 2 * S, 0), wall)
    b.add_parallelogram((-4.0, -1.0, 1.0), (0.5, 0, 0), (0, 0.5, 0), em)
    b.set_medium(0.0, sigma_a, aabb_min=(-S, -S, 0.0), aabb_max=(S, S, 3.0))
    cam = dict(eye=(0, 0, -2), lookat=(0, 0, 3), hfov=2, vfov=2)
    if port:
        return b.build(device="cpu"), Camera.make(**cam, device="cpu")
    return b.build(), JCamera.make(**cam)


def _extent(scene):
    return float(torch.linalg.norm(scene.aabb_max - scene.aabb_min))


def _rays(n, seed):
    """Rays in and around the medium's box; a quarter run parallel to an
    axis (two direction components exactly 0)."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-1.0, 3.5, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3))
    d[: n // 4] = np.eye(3)[rng.integers(0, 3, n // 4)] * rng.choice(
        [-1.0, 1.0], (n // 4, 1))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    t_hit = rng.uniform(0.0, 12.0, n).astype(np.float32)
    return o, d, t_hit


# ---------------------------------------------------------------------------
# functions
# ---------------------------------------------------------------------------

def test_segment_overlap_matches_jax():
    o, d, t_hit = _rays(4000, 0)
    jt0, jov = jmedia.segment_overlap(jax_medium(), jnp.asarray(o),
                                      jnp.asarray(d), jnp.asarray(t_hit))
    t0, ov = media.segment_overlap(port_medium(), torch.as_tensor(o),
                                   torch.as_tensor(d), torch.as_tensor(t_hit))
    assert bool(torch.isfinite(t0).all()) and bool(torch.isfinite(ov).all())
    np.testing.assert_allclose(ov.numpy(), np.asarray(jov), rtol=0,
                               atol=1e-5)
    inside = np.asarray(jov) > 0
    assert 0.1 < inside.mean() < 0.9
    np.testing.assert_allclose(t0.numpy()[inside], np.asarray(jt0)[inside],
                               rtol=1e-6, atol=1e-5)
    # JAX's own cases (tests/test_media.py:20-32)
    o = torch.tensor([[1.25, 1.25, -2.0], [1.25, 1.25, 1.0], [5.0, 5.0, 5.0]])
    d = torch.tensor([[0.0, 0.0, 1.0]] * 3)
    t0, ov = media.segment_overlap(port_medium(), o, d, torch.full((3,), 10.))
    np.testing.assert_allclose(ov.numpy(), [2.5, 1.5, 0.0], atol=1e-5)
    assert float(t0[0]) == pytest.approx(2.0)
    _, ov = media.segment_overlap(port_medium(), o, d,
                                  torch.tensor([3.0, 0.5, 1.0]))
    np.testing.assert_allclose(ov.numpy(), [1.0, 0.5, 0.0], atol=1e-5)


def test_ray_aabb_on_axis_parallel_rays():
    """Rays along +z inside, beside and on the faces of the box: with
    segment_overlap's clamp of |d| < 1e-12 every slab is finite and equals
    JAX's; without it, 0 * inf is NaN on a face, in both packages alike."""
    xs = np.array([-1.0, 0.0, 1.25, 2.5, 3.0], np.float32)
    o = np.stack(np.meshgrid(xs, xs, [-1.0], indexing="ij"),
                 -1).reshape(-1, 3).astype(np.float32)
    d = np.tile(np.float32([0, 0, 1]), (o.shape[0], 1))
    lo, hi = np.zeros(3, np.float32), np.full(3, BOX, np.float32)
    tmin = np.zeros(o.shape[0], np.float32)
    tmax = np.full(o.shape[0], 10.0, np.float32)
    for clamp in (True, False):
        with np.errstate(divide="ignore"):
            inv_d = 1.0 / (np.where(np.abs(d) < 1e-12, 1e-12, d) if clamp
                           else d)
        want = jmath.ray_aabb(*(jnp.asarray(a) for a in (o, inv_d, lo, hi,
                                                         tmin, tmax)))
        got = tmath.ray_aabb(*(torch.as_tensor(a) for a in (o, inv_d, lo,
                                                            hi, tmin, tmax)))
        for g, w in zip(got, want):
            g, w = g.numpy(), np.asarray(w)
            np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
            np.testing.assert_array_equal(g[~np.isnan(g)], w[~np.isnan(w)])
            assert np.isfinite(g).all() == clamp
    box = tmath.AABB.from_points(torch.as_tensor(o))
    c, r = box.bounding_sphere()
    assert c.tolist() == [1.0, 1.0, -1.0] and float(r) == pytest.approx(
        float(np.sqrt(8.0)))


def test_transmittance_and_scatter_distance_match_jax():
    rng = np.random.default_rng(1)
    dist = rng.uniform(0.0, 20.0, 5000).astype(np.float32)
    u = np.concatenate([rng.random(5000), [0.0, 0.5, 1 - 2 ** -24]]
                       ).astype(np.float32)
    for ss, sa in ((0.3, 0.2), (0.15, 0.02), (0.0, 0.4)):
        jm, tm = jax_medium(ss, sa), port_medium(ss, sa)
        np.testing.assert_allclose(
            media.transmittance(tm, torch.as_tensor(dist)).numpy(),
            np.asarray(jmedia.transmittance(jm, jnp.asarray(dist))),
            rtol=FN_RTOL)
        got = media.sample_scatter_distance(tm, torch.as_tensor(u))
        want = jmedia.sample_scatter_distance(jm, jnp.asarray(u))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                       rtol=FN_RTOL)
    # Beer-Lambert and the mean free path (tests/test_media.py:35-52)
    tr = media.transmittance(port_medium(0.3, 0.2), torch.tensor([0., 1., 2.]))
    np.testing.assert_allclose(tr.numpy(), np.exp(-0.5 * np.arange(3)),
                               rtol=FN_RTOL)
    t, pdf = media.sample_scatter_distance(port_medium(0.5, 0.5),
                                           torch.as_tensor(u[:5000]))
    assert float(t.mean()) == pytest.approx(1.0, rel=0.05)
    np.testing.assert_allclose(pdf.numpy(), np.exp(-t.numpy()), rtol=1e-4)


@pytest.mark.parametrize("weighted", [False, True])
def test_volumetric_radiance_estimate_matches_jax(weighted):
    rng = np.random.default_rng(2)
    n = 3000
    power = rng.uniform(0.0, 50.0, (n, 3)).astype(np.float32)
    seg = rng.uniform(0.0, 3.0, n).astype(np.float32)
    t_in = (seg * rng.random(n)).astype(np.float32)
    w = rng.uniform(0.0, 4.0, (n, 3)).astype(np.float32)
    r = np.float32(0.0417)
    want = jmedia.volumetric_radiance_estimate(
        jax_medium(), jnp.asarray(power), jnp.asarray(r), jnp.asarray(seg),
        jnp.asarray(t_in), 1 << 12, jnp.asarray(w) if weighted else None)
    got = media.volumetric_radiance_estimate(
        port_medium(), torch.as_tensor(power), torch.as_tensor(r),
        torch.as_tensor(seg), torch.as_tensor(t_in), 1 << 12,
        torch.as_tensor(w) if weighted else None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=FN_RTOL)
    assert media.INV_4PI == jmedia.INV_4PI


def test_chip_smoke_renders_jax_test_medium():
    """The card tests' medium is tests/test_media.py's."""
    got, want = _torch_cases.scene_medium("cpu"), port_medium()
    for f in ("sigma_s", "sigma_a", "aabb_min", "aabb_max"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f


def test_set_medium_matches_jax():
    """An explicit box (the glass slab) and the default, the scene's box."""
    for port_scene, jax_scene_ in ((glass_slab(0.4, True)[0],
                                    glass_slab(0.4, False)[0]),
                                   (None, None)):
        if port_scene is None:
            built = []
            for b in (SceneBuilder(), JBuilder()):
                wall = b.add_diffuse((0.5, 0.5, 0.5))
                b.add_parallelogram((-1, 0, 2), (3, 0, 0), (0, 2, 1), wall)
                b.add_light((make_area_light if isinstance(b, SceneBuilder)
                             else jarea_light)((5, 5, 5), (0, 1, 0),
                                               (0.5, 0, 0), (0, 0, 0.5)))
                b.set_medium(0.1, 0.2)
                built.append(b.build(device="cpu")
                             if isinstance(b, SceneBuilder) else b.build())
            port_scene, jax_scene_ = built
        for f in ("sigma_s", "sigma_a", "aabb_min", "aabb_max", "sigma_t"):
            got = getattr(port_scene.medium, f)
            assert got.dtype == torch.float32, f
            np.testing.assert_array_equal(
                got.numpy(), np.asarray(getattr(jax_scene_.medium, f)),
                err_msg=f)
    np.testing.assert_array_equal(port_scene.medium.aabb_min.numpy(),
                                  port_scene.aabb_min.numpy())


# ---------------------------------------------------------------------------
# passes
# ---------------------------------------------------------------------------

def _eye_passes(js, jc, ts, tc, size, key_seed):
    n = size * size
    jpx, jpy = jcommon.pixel_coords(size, size)
    jkey = jrng.iteration_key(jrng.make_root_key(key_seed), 0,
                              ppm.PASS_PPM_EYE)
    want = jax.jit(lambda s, c, k: jppm.trace_eye_pass(
        s, c, jax_cfg(width=size, height=size), k,
        jcommon.scene_epsilon(s), jpx, jpy,
        jnp.arange(n, dtype=jnp.int32)))(js, jc, jkey)
    px, py = pixel_coords(size, size, "cpu")
    got = ppm.trace_eye_pass(
        ts, tc, port_cfg(width=size, height=size),
        iteration_key(make_root_key(key_seed), 0, ppm.PASS_PPM_EYE),
        scene_epsilon(ts), px, py, torch.arange(n))
    return got, want


@pytest.mark.parametrize("case", ["CornellSmall", "glass-slab"])
def test_eye_pass_vol_fields_match_jax(case):
    if case == "glass-slab":
        (ts, tc), (js, jc) = glass_slab(0.4, True), glass_slab(0.4, False)
        size = 16
    else:
        js, jc, ts, tc = cornell_pair()
        size = SIZE
    got, want = _eye_passes(js, jc, ts, tc, size, SEED)
    for f in ("found", "hit_emitter", "specular_chain", "mat"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)
    atol = POS_ATOL_OF_EXTENT * _extent(ts)
    for f in ("position", "vol_point"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=0,
                                   atol=atol, err_msg=f)
    for f in ("vol_t", "vol_len"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=1e-4,
                                   atol=atol, err_msg=f)
    for f in ("attenuation", "radiance", "vol_atten", "vol_w", "vol_wsum"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=1e-4,
                                   atol=1e-6, err_msg=f)
    took = np.asarray(want.vol_w) > 0
    assert took.mean() > 0.5
    np.testing.assert_array_equal(got.vol_w.numpy() > 0, took)


def test_glass_interior_skips_medium():
    """tests/test_media.py:149 on the port: a dielectric's interior skips
    the medium, so the attenuation ratio between a sigma_a medium and a
    clear one is exp(-2 sigma_a) (the path outside the glass), not
    exp(-3 sigma_a) (the whole path)."""
    sigma = 0.4
    attens, founds = {}, {}
    for s in (0.0, sigma):
        scene, cam = glass_slab(s, True)
        cfg = port_cfg(width=16, height=16)
        px, py = pixel_coords(16, 16, "cpu")
        hp = ppm.trace_eye_pass(scene, cam, cfg, make_root_key(9),
                                scene_epsilon(scene), px, py,
                                torch.arange(256))
        attens[s], founds[s] = hp.attenuation.numpy(), hp.found.numpy()
    mask = founds[0.0] & founds[sigma]
    assert mask.sum() > 50, mask.sum()
    ratio = attens[sigma][mask].mean(-1) / attens[0.0][mask].mean(-1)
    med = float(np.median(ratio))
    assert med == pytest.approx(np.exp(-2.0 * sigma), rel=0.02)
    assert abs(med - np.exp(-2.0 * sigma)) < abs(med - np.exp(-3.0 * sigma))


def test_inscatter_beyond_primary_segment():
    """tests/test_media.py:173 on the port: a mirror-reflected segment
    that crosses the medium carries the in-scatter sample."""
    b = SceneBuilder("mirror-medium")
    mirror = b.add_mirror((0.95, 0.95, 0.95))
    wall = b.add_diffuse((0.6, 0.6, 0.6))
    em = b.add_emitter((20, 20, 20), light=make_area_light(
        (20, 20, 20), (-3.0, 0.2, 0.0), (0.4, 0, 0), (0, 0.4, 0)))
    b.add_parallelogram((-2.0, -2.0, 0.0), (4.0, 0, 0), (0, 4.0, 4.0),
                        mirror)
    b.add_parallelogram((-3.0, 4.0, -1.0), (6.0, 0, 0), (0, 0, 6.0), wall)
    b.add_parallelogram((-3.0, 0.2, 0.0), (0.4, 0, 0), (0, 0.4, 0), em)
    b.set_medium(0.2, 0.05, aabb_min=(-3.0, 1.0, -1.0),
                 aabb_max=(3.0, 4.0, 5.0))
    scene = b.build(device="cpu")
    cam = Camera.make(eye=(0, 0, -1), lookat=(0, 0, 2), hfov=25, vfov=25,
                      device="cpu")
    px, py = pixel_coords(16, 16, "cpu")
    hp = ppm.trace_eye_pass(scene, cam, port_cfg(width=16, height=16),
                            make_root_key(4), scene_epsilon(scene), px, py,
                            torch.arange(256))
    m = (hp.found & hp.specular_chain).numpy()
    assert m.sum() > 50, m.sum()
    assert (hp.vol_len.numpy()[m] > 0.5).mean() > 0.9
    assert hp.vol_w.numpy()[m].min() > 0.0
    assert np.isclose(hp.vol_atten.numpy()[m].max(), 0.95, atol=0.06)


def test_photon_pass_volumetric_deposits_match_jax():
    js, _, ts, _ = cornell_pair("CornellSmallLargeSphere")
    n = 4096
    jkey = jrng.iteration_key(jrng.make_root_key(SEED), 0,
                              ppm.PASS_PPM_PHOTON)
    want, wvol, wst = jax.jit(lambda s, k: jppm.trace_photon_pass(
        s, jax_cfg(), k, jcommon.scene_epsilon(s),
        jnp.arange(n, dtype=jnp.int32)))(js, jkey)
    got, vol, gst = ppm.trace_photon_pass(
        ts, port_cfg(), iteration_key(make_root_key(SEED), 0,
                                      ppm.PASS_PPM_PHOTON),
        scene_epsilon(ts), torch.arange(n))
    assert set(gst) == set(wst)
    for k in ("photons_stored", "volumetric_photons_stored"):
        assert int(gst[k]) == int(wst[k]) > 0, k
    cap = port_cfg().media_max_deposits_per_photon
    assert int(gst["volumetric_photons_stored"]) <= cap * n
    for g, w in ((got, want), (vol, wvol)):
        valid = np.asarray(w.valid)
        np.testing.assert_array_equal(g.valid.numpy(), valid)
        np.testing.assert_allclose(
            g.position.numpy()[valid], np.asarray(w.position)[valid], rtol=0,
            atol=POS_ATOL_OF_EXTENT * _extent(ts))
        for f in ("power", "direction"):
            np.testing.assert_allclose(getattr(g, f).numpy()[valid],
                                       np.asarray(getattr(w, f))[valid],
                                       rtol=1e-4, atol=5e-4, err_msg=f)


def leaves(obj):
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def test_volume_estimate_on_jax_records_matches_jax():
    """JAX's eye-pass records and volumetric photons, handed over through
    interop, through the port's volume gather and estimate: against the
    same steps of JAX's render_iteration (ppm.py:514-536)."""
    js, jc, ts, _ = cornell_pair()
    n = SIZE * SIZE
    cfg = jax_cfg()
    key = jrng.make_root_key(SEED)
    eye_key, photon_key, est_key = (jrng.iteration_key(key, 0, p) for p in (
        ppm.PASS_PPM_EYE, ppm.PASS_PPM_PHOTON, ppm.PASS_PPM_ESTIMATE))
    lanes = jnp.arange(n, dtype=jnp.int32)
    radius = jnp.float32(0.1)

    @jax.jit
    def reference(s, c):
        eps = jcommon.scene_epsilon(s)
        hp = jppm.trace_eye_pass(s, c, cfg, eye_key, eps,
                                 *jcommon.pixel_coords(SIZE, SIZE), lanes)
        _, vol, _ = jppm.trace_photon_pass(
            s, cfg, photon_key, eps,
            jnp.arange(cfg.photons_per_iteration, dtype=jnp.int32))
        vr = radius * 3.0
        vgrid = jgrid(vol, cfg.photon_grid_resolution,
                      min_cell_size=jmcs(vr, 4))
        u = jrng.LaneSampler(jax.random.fold_in(est_key, 56), lanes).next1()
        vpow, _ = jgather(vgrid, hp.vol_point, hp.ns, vr,
                          max_cells_per_axis=4,
                          budget_total=cfg.gather_photon_budget,
                          check_normal=False, u_stride=u)
        ok = hp.vol_w > 0.0
        inv_pick = jnp.where(ok, hp.vol_wsum / jnp.maximum(hp.vol_w, 1e-30),
                             0.0)
        est = jmedia.volumetric_radiance_estimate(
            s.medium, vpow, vr, hp.vol_len, hp.vol_t,
            cfg.photons_per_iteration, weight=hp.vol_atten * inv_pick[:, None])
        return hp, vol, jnp.where(ok[:, None], est, 0.0)

    jhp, jvol, want = reference(js, jc)
    hp = interop.hitpoint_from_numpy(leaves(jhp), "cpu")
    vol = interop.photon_batch_from_numpy(leaves(jvol), "cpu")
    got = ppm._volumetric(ts.medium, port_cfg(), hp, vol,
                          torch.tensor(0.1), interop.key_from_numpy(
                              jax.random.key_data(est_key)),
                          torch.arange(n))
    want = np.asarray(want)
    assert (want > 0).any(axis=-1).mean() > 0.5
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                               atol=1e-6 * np.abs(want).max())


# ---------------------------------------------------------------------------
# whole iterations
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def iteration_pair():
    """One PPM iteration of CornellSmall in JAX's test medium through both
    packages at the same seed and radius; JAX takes its tile gather
    (interpret mode), jitted."""
    js, jc, ts, tc = cornell_pair()
    r2 = Renderer(ts, tc, port_cfg(), seed=SEED).ppm_initial_radius ** 2
    cfg = jax_cfg(use_pallas_gather=True)
    want, wst = jax.jit(lambda s, c, k, r: jppm.render_iteration(
        s, c, cfg, jnp.int32(0), k, r))(js, jc, jrng.make_root_key(SEED),
                                        jnp.float32(r2))
    got, gst = ppm.render_iteration(ts, tc, port_cfg(), 0,
                                    make_root_key(SEED), r2)
    return (got.numpy(), {k: float(v) for k, v in gst.items()},
            np.asarray(want), {k: float(v) for k, v in wst.items()})


def test_one_iteration_matches_jax_tiled_gather(iteration_pair):
    got, gst, want, wst = iteration_pair
    assert got.shape == want.shape == (SIZE, SIZE, 3)
    assert np.isfinite(got).all()
    agree = np.isclose(got, want, rtol=PIXEL_RTOL, atol=0.0).all(axis=-1)
    assert agree.mean() >= MIN_AGREEING, agree.mean()
    assert got.mean() == pytest.approx(want.mean(), rel=MEAN_RTOL)
    assert gst.keys() == wst.keys()
    for k in wst:
        assert gst[k] == pytest.approx(wst[k], rel=1e-3), k
    assert gst["volumetric_photons_stored"] > 0


def test_ppm_with_medium_renders():
    """tests/test_media.py:64 on the port, through the Renderer."""
    scene, cam = get_scene_by_name("CornellSmall", "cpu")
    scene.medium = port_medium()
    r = Renderer(scene, cam, port_cfg(photons_per_iteration=1 << 13),
                 seed=3)
    m = r.render_next_iteration()
    img = r.film.mean_radiance().numpy()
    assert np.isfinite(img).all() and img.max() > 0.5
    assert m["volumetric_photons_stored"] > 0


# sha256 prefixes of one PPM iteration's float32 bytes (seed 7, iteration
# 1, r^2 = 0.003) from the port before media were ported; a tile-gather
# image (32^2) and a budgeted-gather one (24^2, no 16x16 blocks)
NO_MEDIUM_PINS = {("CornellSmall", 32): "d2605cf16101a250",
                  ("CornellSmallLargeSphere", 24): "074381d0219256ef"}


@pytest.mark.parametrize("name,size", sorted(NO_MEDIUM_PINS))
def test_no_medium_iteration_is_bit_identical(name, size):
    scene, cam = get_scene_by_name(name, "cpu")
    img, stats = ppm.render_iteration(
        scene, cam, port_cfg(width=size, height=size), 1,
        make_root_key(SEED), 0.003)
    assert "volumetric_photons_stored" not in stats
    digest = hashlib.sha256(img.numpy().tobytes()).hexdigest()[:16]
    assert digest == NO_MEDIUM_PINS[(name, size)]


def test_pt_and_vcm_ignore_the_medium():
    """Only PPM renders the medium, as in the JAX package (ROADMAP queue
    C): PT and VCM images in it keep their bits."""
    scene, cam = get_scene_by_name("CornellSmall", "cpu")
    foggy = dataclasses.replace(scene, medium=port_medium())
    pt_cfg = RenderConfig(width=16, height=16)
    vcm_cfg = RenderConfig(width=16, height=16, vcm_max_path_length=4,
                           render_method=RenderMethod.
                           VCM_BIDIRECTIONAL_PATH_TRACING)
    imgs = [[Renderer(s, cam, c, seed=SEED).render(1).mean_radiance()
             for s in (scene, foggy)] for c in (pt_cfg, vcm_cfg)]
    for clear, fog in imgs:
        assert torch.equal(clear, fog)
