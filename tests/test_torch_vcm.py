"""The port's VCM slice (vertex connection) against the JAX package's: the
VCM light sampling, the camera's pdfs and projection, the light pass, one
whole iteration, uniform vertex sampling, an ablation, and the ``*__vcm``
goldens, plus the renderer and the CLI.

Both packages draw the same per-lane random streams, so their images
agree pixel by pixel to float tolerance: one iteration must agree on at
least 99% of the pixels at rtol 1e-3, with the image mean within 1e-3
(last-ulp differences of XLA's rsqrt and contracted multiply-adds flip a
rare path; ROADMAP queue C). The light sampling is held at rtol 1e-5.
"""
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "scripts"))

import bench  # noqa: E402
import chip_smoke  # noqa: E402
from make_goldens import ITERS, SEED as GOLDEN_SEED, golden_config  # noqa
from oppositerenderer_tpu import lights as jlights  # noqa: E402
from oppositerenderer_tpu.config import RenderConfig as JConfig  # noqa: E402
from oppositerenderer_tpu.core import rng as jrng  # noqa: E402
from oppositerenderer_tpu.integrators import common as jcommon  # noqa: E402
from oppositerenderer_tpu.integrators import vcm as jvcm  # noqa: E402
from oppositerenderer_tpu.scene import \
    get_scene_by_name as jax_scene  # noqa: E402
from oppositerenderer_tpu_torch import cli, lights  # noqa: E402
from oppositerenderer_tpu_torch.config import (RenderConfig,  # noqa: E402
                                               RenderMethod)
from oppositerenderer_tpu_torch.core.rng import (iteration_key,  # noqa: E402
                                                 make_root_key)
from oppositerenderer_tpu_torch.integrators import vcm  # noqa: E402
from oppositerenderer_tpu_torch.integrators.common import \
    scene_epsilon  # noqa: E402
from oppositerenderer_tpu_torch.renderer import Renderer  # noqa: E402
from oppositerenderer_tpu_torch.scene import (SCENE_NAMES,  # noqa: E402
                                              get_scene_by_name)

torch.set_num_threads(2)

VCM = RenderMethod.VCM_BIDIRECTIONAL_PATH_TRACING
SEED = 7
SIZE = 32
CFG = dict(width=SIZE, height=SIZE, vcm_max_path_length=4,
           photon_grid_resolution=16)
PIXEL_RTOL = 1e-3
MIN_AGREEING = 0.99
MEAN_RTOL = 1e-3
LIGHT_RTOL = 1e-5
# positions after specular bounces: last-ulp noise grows through glass
POS_ATOL_OF_EXTENT = 1e-4


def jax_cfg(**kw):
    return JConfig(**{**CFG, "render_method": VCM, **kw})


def port_cfg(**kw):
    return RenderConfig(**{**CFG, "render_method": VCM, **kw})


def radius_sq():
    scene, cam = get_scene_by_name("CornellSmall", "cpu")
    return Renderer(scene, cam, port_cfg(), seed=SEED).ppm_initial_radius ** 2


def render_pair(name="CornellSmall", **kw):
    """One VCM iteration through both packages at the same seed and merge
    radius; JAX's jitted (one compile costs less than its eager call)."""
    js, jc = jax_scene(name)
    ts, tc = get_scene_by_name(name, "cpu")
    r2 = radius_sq()
    jcfg = jax_cfg(**kw)
    want, wst = jax.jit(lambda s, c, k, r: jvcm.render_iteration(
        s, c, jcfg, jnp.int32(0), k, r))(js, jc, jrng.make_root_key(SEED),
                                         jnp.float32(r2))
    got, gst = vcm.render_iteration(ts, tc, port_cfg(**kw), 0,
                                    make_root_key(SEED), r2)
    return (got.numpy(), {k: float(v) for k, v in gst.items()},
            np.asarray(want), {k: float(v) for k, v in wst.items()})


def assert_images_agree(got, want):
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    agree = np.isclose(got, want, rtol=PIXEL_RTOL, atol=0.0).all(axis=-1)
    assert agree.mean() >= MIN_AGREEING, agree.mean()
    assert got.mean() == pytest.approx(want.mean(), rel=MEAN_RTOL)


@pytest.fixture(scope="module")
def iteration_pair():
    return render_pair()


def test_one_iteration_matches_jax(iteration_pair):
    got, gst, want, wst = iteration_pair
    assert got.shape == (SIZE, SIZE, 3)
    assert_images_agree(got, want)
    assert gst.keys() == wst.keys() == {"light_vertices_stored",
                                        "avg_light_path_verts"}
    assert gst["light_vertices_stored"] == pytest.approx(
        wst["light_vertices_stored"], rel=5e-3)
    assert gst["light_vertices_stored"] > 0


def _light_inputs(name, n=2048, seed=3):
    js, _ = jax_scene(name)
    ts, _ = get_scene_by_name(name, "cpu")
    rng = np.random.default_rng(seed)
    li = rng.integers(0, ts.lights.n_lights, n)
    u = rng.uniform(size=(3, n, 2)).astype(np.float32)
    lo, hi = ts.aabb_min.numpy(), ts.aabb_max.numpy()
    recv = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    return js, ts, li, u, recv


def _assert_all_close(got, want, names):
    for label, a, b in zip(names, got, want):
        b = np.asarray(b)
        a = a.numpy()
        assert a.shape == b.shape, label
        np.testing.assert_allclose(a, b, rtol=LIGHT_RTOL, atol=1e-6,
                                   err_msg=label)


@pytest.mark.parametrize("name", SCENE_NAMES)
def test_light_emit_matches_jax(name):
    """Area, point, spot and (CornellSmallPointDistant) the distant point
    light's cone toward the bounding sphere."""
    js, ts, li, u, _ = _light_inputs(name)
    jc, jr = js.bounding_sphere
    want = jlights.light_emit(js.lights.row(jnp.asarray(li)),
                              jnp.asarray(u[0]), jnp.asarray(u[1]), jc, jr)
    tc, tr = ts.bounding_sphere
    got = lights.light_emit(ts.lights.row(torch.as_tensor(li)),
                            torch.as_tensor(u[0]), torch.as_tensor(u[1]),
                            tc, tr)
    _assert_all_close(got, want, ("radiance", "position", "direction",
                                  "emission_pdf_w", "direct_pdf_a", "cos"))


@pytest.mark.parametrize("name", SCENE_NAMES)
def test_light_illuminate_matches_jax(name):
    js, ts, li, u, recv = _light_inputs(name, seed=4)
    jc, jr = js.bounding_sphere
    want = jlights.light_illuminate(js.lights.row(jnp.asarray(li)),
                                    jnp.asarray(u[2]), jnp.asarray(recv),
                                    jc, jr)
    tc, tr = ts.bounding_sphere
    got = lights.light_illuminate(ts.lights.row(torch.as_tensor(li)),
                                  torch.as_tensor(u[2]),
                                  torch.as_tensor(recv), tc, tr)
    _assert_all_close(got, want, ("radiance", "dir_to_light", "dist",
                                  "direct_pdf_w", "emission_pdf_w", "cos"))


def test_distant_point_light_emits_into_the_cone():
    js, ts, li, u, _ = _light_inputs("CornellSmallPointDistant")
    center, rad = ts.bounding_sphere
    lt = ts.lights.row(torch.as_tensor(li))
    _, pos, d, pdf, direct, _ = lights.light_emit(
        lt, torch.as_tensor(u[0]), torch.as_tensor(u[1]), center, rad)
    is_point = lt.kind == lights.POINT
    assert bool(is_point.any())
    to_c = center - pos[is_point]
    axis = to_c / torch.linalg.norm(to_c, dim=-1, keepdim=True)
    sin_t = rad / torch.linalg.norm(to_c, dim=-1)
    cos_min = torch.sqrt(1.0 - sin_t * sin_t)
    assert bool(((d[is_point] * axis).sum(-1) >= cos_min - 1e-5).all())
    assert bool((pdf[is_point] > 0.25 / np.pi).all())
    assert bool((direct[is_point] == 1.0).all())


@pytest.mark.parametrize("name", ["CornellSmall", "Cornell"])
def test_camera_pdf_quantities_and_world_to_raster_match_jax(name):
    W, H = 48, 32
    _, jcam = jax_scene(name)
    scene, cam = get_scene_by_name(name, "cpu")
    rng = np.random.default_rng(5)
    d = rng.normal(size=(4096, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[::2] = np.abs(d[::2]) * np.sign(cam.lookdir.numpy())  # toward view
    lo, hi = scene.aabb_min.numpy(), scene.aabb_max.numpy()
    pts = rng.uniform(lo, hi, (4096, 3)).astype(np.float32)
    want = jcam.pdf_quantities(jnp.asarray(d), W, H)
    got = cam.pdf_quantities(torch.as_tensor(d), W, H)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-6)
    want = jcam.world_to_raster(jnp.asarray(pts), W, H)
    got = cam.world_to_raster(torch.as_tensor(pts), W, H)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert 0.1 < float(got[2].float().mean()) < 1.0
    inside = got[2].numpy()
    for a, b in (got[0], want[0]), (got[1], want[1]), (got[3], want[3]):
        np.testing.assert_allclose(a.numpy()[inside], np.asarray(b)[inside],
                                   rtol=1e-5, atol=1e-4)


def test_light_pass_matches_jax():
    """Store masks, depths, materials and counts equal; positions and
    directions to the eye-pass tolerances of the PPM slice, the MIS
    quantities at rtol 2e-3 (ROADMAP queue C); the t=1 splat image pixel
    by pixel."""
    name = "CornellSmallLargeSphere"
    js, jc = jax_scene(name)
    ts, tc = get_scene_by_name(name, "cpu")
    n = SIZE * SIZE
    cfg = dict(vcm_max_path_length=6)
    mis_vc_w, mis_vm_w = 0.3, 0.002
    want, wsplat, wst = jax.jit(lambda s, c, k: jvcm.trace_light_pass(
        s, c, jax_cfg(**cfg), k, jcommon.scene_epsilon(s),
        jnp.float32(mis_vc_w), jnp.float32(mis_vm_w),
        jnp.arange(n, dtype=jnp.int32), n))(
            js, jc, jrng.iteration_key(jrng.make_root_key(SEED), 0,
                                       vcm.PASS_VCM_LIGHT))
    got, gsplat, gst = vcm.trace_light_pass(
        ts, tc, port_cfg(**cfg),
        iteration_key(make_root_key(SEED), 0, vcm.PASS_VCM_LIGHT),
        scene_epsilon(ts), torch.tensor(mis_vc_w), torch.tensor(mis_vm_w),
        torch.arange(n), n)
    valid = np.asarray(want.valid)
    assert got.valid.shape == (n, 5) and valid.any()
    for f in ("valid", "depth"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)
    np.testing.assert_array_equal(got.mat.numpy()[valid],
                                  np.asarray(want.mat)[valid])
    assert int(gst["light_vertices_stored"]) == int(
        wst["light_vertices_stored"]) == int(valid.sum())
    extent = float(torch.linalg.norm(ts.aabb_max - ts.aabb_min))
    np.testing.assert_allclose(got.position.numpy()[valid],
                               np.asarray(want.position)[valid], rtol=0,
                               atol=POS_ATOL_OF_EXTENT * extent)
    for f in ("throughput", "ns", "ng", "wo"):
        np.testing.assert_allclose(getattr(got, f).numpy()[valid],
                                   np.asarray(getattr(want, f))[valid],
                                   rtol=1e-4, atol=1e-4, err_msg=f)
    # the MIS quantities divide by cosines and pdfs, which multiply the
    # last-ulp noise of a grazing or refracted segment: up to 7.9e-4
    # relative measured on one of 1,847 vertices
    for f in ("dVCM", "dVC", "dVM"):
        np.testing.assert_allclose(getattr(got, f).numpy()[valid],
                                   np.asarray(getattr(want, f))[valid],
                                   rtol=2e-3, atol=1e-4, err_msg=f)
    assert float(gsplat.sum()) > 0.0
    assert_images_agree(gsplat.numpy(), np.asarray(wsplat))


@pytest.mark.parametrize("name", SCENE_NAMES)
def test_matches_vcm_golden(name):
    """``tests/test_goldens.py``'s tolerance on every pixel, except on
    Cornell, whose area light lies within two float32 ulps of its ceiling:
    up to ``VCM_GOLDEN_MAX_FLIPPED`` pixels may hold a path that went the
    other way there (18 of 4096 measured), the image mean within
    ``GOLDEN_MEAN_RTOL``."""
    scene, cam = get_scene_by_name(name, "cpu")
    r = Renderer(scene, cam, chip_smoke.golden_vcm_config(),
                 seed=chip_smoke.GOLDEN_SEED)
    img = r.render(chip_smoke.GOLDEN_VCM_ITERS).mean_radiance().numpy()
    assert np.isfinite(img).all()
    want = np.load(chip_smoke.GOLDENS)[f"{name}__vcm"].astype(np.float32)
    bad, worst, mean_err = chip_smoke.golden_agreement(img, want)
    assert bad <= (chip_smoke.VCM_GOLDEN_MAX_FLIPPED if name == "Cornell"
                   else 0), (bad, worst)
    assert mean_err <= chip_smoke.GOLDEN_MEAN_RTOL


@pytest.mark.parametrize("flags", [
    dict(vcm_uniform_vertex_sampling=True, vcm_uniform_connections=3),
    dict(vcm_connect_light_s1=False, vcm_connect_camera_t1=False,
         vcm_force_continuation_prob=0.75)],
    ids=["uniform_vertex_sampling", "no_s1_no_t1_forced_rr"])
def test_variants_match_jax(flags):
    """Uniform vertex sampling (a stable valid-first sort and n_conn draws
    per bounce) and an ablation that skips the s=1 draws: the streams stay
    aligned with JAX's."""
    got, gst, want, wst = render_pair(**flags)
    assert_images_agree(got, want)
    assert gst["light_vertices_stored"] == pytest.approx(
        wst["light_vertices_stored"], rel=5e-3)


@pytest.mark.parametrize("uniform", [False, True],
                         ids=["one_to_one", "uniform_vertex_sampling"])
def test_batched_shadow_rays_equal_per_technique_occlusion(uniform,
                                                           monkeypatch):
    """A camera bounce traces the shadow rays of s=1 and of every vertex
    connection in one batch. One iteration is bit-identical to tracing
    each technique's rays alone and adding its contribution in turn, as
    the JAX package does; the batch takes (L-1) + L shadow-ray calls an
    iteration where that took (L-1) + L + L x connections."""
    ts, tc = get_scene_by_name("CornellSmall", "cpu")
    cfg = port_cfg(vcm_uniform_vertex_sampling=uniform, vcm_use_vm=uniform)
    occluded = vcm.occluded
    calls = []

    def counted(*args):
        calls.append(args[1].shape[0])
        return occluded(*args)

    def per_technique(scene, color, origin, tmin, terms):
        for d, tmax, contrib, ok in terms:
            blocked = vcm.occluded(scene, origin, d, tmin, tmax)
            color = color + torch.where((ok & ~blocked)[:, None], contrib,
                                        0.0)
        return color

    monkeypatch.setattr(vcm, "occluded", counted)
    images = []
    for add in (vcm._add_unoccluded, per_technique):
        monkeypatch.setattr(vcm, "_add_unoccluded", add)
        calls.clear()
        img, _ = vcm.render_iteration(ts, tc, cfg, 0, make_root_key(SEED),
                                      radius_sq())
        images.append(img)
        L, n = cfg.vcm_max_path_length, SIZE * SIZE
        conn = cfg.vcm_uniform_connections if uniform else L - 1
        if add is per_technique:
            assert calls == [n] * ((L - 1) + L * (1 + conn))
        else:
            assert sorted(calls) == [n] * (L - 1) + [(1 + conn) * n] * L
    assert float(images[0].mean()) > 0.0
    assert torch.equal(images[0], images[1])


def test_ablation_is_a_part_of_the_total(iteration_pair):
    """The techniques partition the estimator: without t=1 and s=1 the
    image loses energy, never gains."""
    total = iteration_pair[0]
    ts, tc = get_scene_by_name("CornellSmall", "cpu")
    part, _ = vcm.render_iteration(
        ts, tc, port_cfg(vcm_connect_light_s1=False,
                         vcm_connect_camera_t1=False), 0,
        make_root_key(SEED), radius_sq())
    assert 0.0 < float(part.mean()) < total.mean()


def test_mis_factors_are_float32_jax_ones():
    r2 = torch.tensor(radius_sq(), dtype=torch.float32)
    for kw in (dict(), dict(vcm_use_vm=True),
               dict(vcm_uniform_vertex_sampling=True, vcm_use_vm=True),
               dict(vcm_use_vc=False)):
        vm_w, vc_w = vcm.mis_factors(port_cfg(**kw), r2)
        cfg = jax_cfg(**kw)
        n = cfg.width * cfg.height
        n_vc = n if cfg.vcm_uniform_vertex_sampling else 1
        eta = (float(n) / n_vc) * jnp.pi * jnp.float32(float(r2))
        assert vm_w.dtype == vc_w.dtype == torch.float32
        assert float(vm_w) == float(eta if cfg.vcm_use_vm else 0.0)
        assert float(vc_w) == float(1.0 / eta if cfg.vcm_use_vc else 0.0)


def test_renderer_renders_vcm_with_its_stats():
    scene, cam = get_scene_by_name("CornellSmallSmallSpheres", "cpu")
    r = Renderer(scene, cam, RenderConfig(width=24, height=16,
                                          render_method=VCM), seed=3)
    img = r.render(2).mean_radiance()
    assert img.shape == (16, 24, 3) and bool(torch.isfinite(img).all())
    assert float(img.mean()) > 0.0
    assert r.metrics["light_vertices_stored"] > 0
    m = r.render_next_iteration()
    assert {"light_vertices_stored", "avg_light_path_verts"} <= m.keys()


def test_vm_on_an_image_without_tiles_takes_the_budget_merge():
    scene, cam = get_scene_by_name("CornellSmall", "cpu")
    r = Renderer(scene, cam, RenderConfig(
        width=20, height=12, render_method=VCM, vcm_use_vm=True,
        vcm_max_path_length=4), seed=3)
    img = r.render(1).mean_radiance()
    assert img.shape == (12, 20, 3) and bool(torch.isfinite(img).all())


def test_cli_renders_vcm_by_default(tmp_path, capsys):
    assert cli.build_parser().parse_args([]).method == "vcm"
    out = tmp_path / "vcm.png"
    assert cli.main(["--cpu", "--size", "16", "-n", "1", "-o",
                     str(out)]) == 0
    assert out.exists()
    assert "light_vertices_stored=" in capsys.readouterr().out
    out = tmp_path / "vcm_vm.png"
    assert cli.main(["--cpu", "--method", "vcm", "--vm", "--size", "16",
                     "-n", "1", "-q", "-o", str(out)]) == 0
    assert out.exists()


def test_chip_smoke_configs_are_the_jax_ones():
    """vcm-goldens renders the JAX golden VCM configuration; vcm-main and
    vcm-vm-main the JAX bench's VCM cases (bench.py:236-243) at 512^2, with
    its ray accounting."""
    want = golden_config("vcm")
    got = chip_smoke.golden_vcm_config()
    for f in RenderConfig.__dataclass_fields__:
        assert getattr(got, f) == getattr(want, f), f
    assert (chip_smoke.GOLDEN_SEED, chip_smoke.GOLDEN_VCM_ITERS) == (
        GOLDEN_SEED, ITERS["vcm"])
    for use_vm in (False, True):
        main = chip_smoke.vcm_main_config(use_vm)
        ref = JConfig(width=512, height=512, render_method=VCM,
                      vcm_use_vm=use_vm)
        for f in RenderConfig.__dataclass_fields__:
            assert getattr(main, f) == getattr(ref, f), f
        assert chip_smoke.vcm_rays_per_iteration(main) == \
            bench.vcm_rays_per_iteration(ref)


@pytest.mark.slow
def test_vcm_agrees_with_pt():
    """Port-only statistics (``test_vcm.py:35``): every MIS weight, since
    wrong weights double-count or lose energy against PT."""
    scene, cam = get_scene_by_name("CornellSmall", "cpu")
    rv = Renderer(scene, cam, RenderConfig(width=48, height=48,
                                           render_method=VCM), seed=2)
    vcm_img = rv.render(24).mean_radiance().numpy()
    rt = Renderer(scene, cam, RenderConfig(width=48, height=48), seed=3)
    pt_img = rt.render(80).mean_radiance().numpy()
    assert vcm_img.mean() == pytest.approx(pt_img.mean(), rel=0.04)
    a = vcm_img.reshape(8, 6, 8, 6, 3).mean(axis=(1, 3, 4))
    b = pt_img.reshape(8, 6, 8, 6, 3).mean(axis=(1, 3, 4))
    mask = b > 0.02
    assert np.median(np.abs(a - b)[mask] / b[mask]) < 0.12
