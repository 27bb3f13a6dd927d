"""The port's PPM slice against the JAX package's, pass by pass and for one
whole iteration, plus its renderer and CLI.

Both packages draw the same per-lane random streams, so their passes
agree lane by lane, to float tolerance: last-ulp differences (XLA's rsqrt
and contracted multiply-adds, see ROADMAP queue C) grow through glass
refractions to ~5e-5 of the scene's extent in a deposit's position, and
can flip a rare path. The whole iteration runs JAX's tile gather in
interpret mode, as its own tests do, and must agree on at least 99% of
the pixels at rtol 1e-3, with the image mean within 1e-3.
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

import chip_smoke  # noqa: E402
from make_goldens import ITERS, SEED as GOLDEN_SEED, golden_config  # noqa

from oppositerenderer_tpu.config import RenderConfig as JConfig  # noqa: E402
from oppositerenderer_tpu.core import rng as jrng  # noqa: E402
from oppositerenderer_tpu.integrators import common as jcommon  # noqa: E402
from oppositerenderer_tpu.integrators import ppm as jppm  # noqa: E402
from oppositerenderer_tpu.scene import \
    get_scene_by_name as jax_scene  # noqa: E402
from oppositerenderer_tpu_torch import cli, renderer  # noqa: E402
from oppositerenderer_tpu_torch.config import (PhotonMapStructure,  # noqa
                                               RenderConfig, RenderMethod)
from oppositerenderer_tpu_torch.core.rng import (LaneSampler,  # noqa: E402
                                                 iteration_key,
                                                 make_root_key)
from oppositerenderer_tpu_torch.integrators import ppm  # noqa: E402
from oppositerenderer_tpu_torch.integrators.common import (  # noqa: E402
    pixel_coords, scene_epsilon)
from oppositerenderer_tpu_torch.renderer import Renderer  # noqa: E402
from oppositerenderer_tpu_torch.scene import Medium  # noqa: E402
from oppositerenderer_tpu_torch.scene import get_scene_by_name  # noqa: E402

torch.set_num_threads(2)

PPM = RenderMethod.PROGRESSIVE_PHOTON_MAPPING
SEED = 7
SIZE = 32                   # 4 tiles of 16x16
CFG = dict(width=SIZE, height=SIZE, photons_per_iteration=1 << 12,
           photon_grid_resolution=16)
PIXEL_RTOL = 1e-3
MIN_AGREEING = 0.99
MEAN_RTOL = 1e-3
# positions after specular bounces: last-ulp noise grows through glass
POS_ATOL_OF_EXTENT = 1e-4


def jax_cfg(**kw):
    return JConfig(**{**CFG, "render_method": PPM, **kw})


def port_cfg(**kw):
    return RenderConfig(**{**CFG, "render_method": PPM, **kw})


@pytest.fixture(scope="module")
def iteration_pair():
    """One PPM iteration of CornellSmall through both packages at the same
    seed and radius; JAX takes its tile gather (interpret mode), jitted:
    one compile costs half of the eager call's."""
    js, jc = jax_scene("CornellSmall")
    r2 = Renderer(*get_scene_by_name("CornellSmall", "cpu"), port_cfg(),
                  seed=SEED).ppm_initial_radius ** 2
    cfg = jax_cfg(use_pallas_gather=True)
    want, wst = jax.jit(lambda s, c, k, r: jppm.render_iteration(
        s, c, cfg, jnp.int32(0), k, r))(js, jc, jrng.make_root_key(SEED),
                                        jnp.float32(r2))
    ts, tc = get_scene_by_name("CornellSmall", "cpu")
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
    assert gst["photons_stored"] > 0 and gst["photons_visited"] > 0


@pytest.mark.parametrize("name", ["CornellSmall", "CornellSmallPointDistant",
                                  "CornellSmallPointTest"])
def test_emit_photons_matches_jax(name):
    """Area light; distant point light (disc mode); point light inside."""
    js, _ = jax_scene(name)
    ts, _ = get_scene_by_name(name, "cpu")
    key = jrng.iteration_key(jrng.make_root_key(SEED), 0, ppm.PASS_PPM_PHOTON)
    want = jppm.emit_photons(js, jrng.LaneSampler(
        key, jnp.arange(4096, dtype=jnp.int32)))
    got = ppm.emit_photons(ts, LaneSampler(
        iteration_key(make_root_key(SEED), 0, ppm.PASS_PPM_PHOTON),
        torch.arange(4096)))
    for label, a, b in zip(("origin", "direction", "power"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=2e-7, err_msg=label)


def _extent(scene):
    return float(torch.linalg.norm(scene.aabb_max - scene.aabb_min))


@pytest.mark.parametrize("name", ["CornellSmall", "CornellSmallLargeSphere"])
def test_trace_eye_pass_matches_jax(name):
    js, jc = jax_scene(name)
    ts, tc = get_scene_by_name(name, "cpu")
    n = SIZE * SIZE
    jpx, jpy = jcommon.pixel_coords(SIZE, SIZE)
    want = jax.jit(lambda s, c, k: jppm.trace_eye_pass(
        s, c, jax_cfg(), k, jcommon.scene_epsilon(s), jpx, jpy,
        jnp.arange(n, dtype=jnp.int32)))(
            js, jc, jrng.iteration_key(jrng.make_root_key(SEED), 0,
                                       ppm.PASS_PPM_EYE))
    px, py = pixel_coords(SIZE, SIZE, "cpu")
    got = ppm.trace_eye_pass(
        ts, tc, port_cfg(), iteration_key(make_root_key(SEED), 0,
                                          ppm.PASS_PPM_EYE),
        scene_epsilon(ts), px, py, torch.arange(n))
    for f in ("found", "hit_emitter", "specular_chain", "mat"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)
    assert got.found.float().mean() > 0.5
    atol = POS_ATOL_OF_EXTENT * _extent(ts)
    np.testing.assert_allclose(got.position.numpy(),
                               np.asarray(want.position), rtol=0, atol=atol)
    for f in ("wo", "attenuation", "radiance", "kd", "ns", "ng"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=1e-4,
                                   atol=1e-4, err_msg=f)


def test_trace_photon_pass_matches_jax():
    """Deposit rows come out depth-major and agree row by row."""
    name = "CornellSmallLargeSphere"
    js, _ = jax_scene(name)
    ts, _ = get_scene_by_name(name, "cpu")
    n = 4096
    want, _, wst = jax.jit(lambda s, k: jppm.trace_photon_pass(
        s, jax_cfg(), k, jcommon.scene_epsilon(s),
        jnp.arange(n, dtype=jnp.int32)))(
            js, jrng.iteration_key(jrng.make_root_key(SEED), 0,
                                   ppm.PASS_PPM_PHOTON))
    got, _, gst = ppm.trace_photon_pass(
        ts, port_cfg(), iteration_key(make_root_key(SEED), 0,
                                      ppm.PASS_PPM_PHOTON),
        scene_epsilon(ts), torch.arange(n))
    assert got.valid.shape == (n * port_cfg().max_photon_trace_depth,)
    valid = np.asarray(want.valid)
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    assert int(gst["photons_stored"]) == int(wst["photons_stored"]) > 0
    assert float(gst["avg_photon_path_length"]) == pytest.approx(
        float(wst["avg_photon_path_length"]), rel=1e-6)
    np.testing.assert_allclose(got.position.numpy()[valid],
                               np.asarray(want.position)[valid], rtol=0,
                               atol=POS_ATOL_OF_EXTENT * _extent(ts))
    # a refraction's direction carries the ulp noise of its normal: up to
    # 1.1e-4 measured on one of ~23k deposit rows
    for f in ("power", "direction"):
        np.testing.assert_allclose(getattr(got, f).numpy()[valid],
                                   np.asarray(getattr(want, f))[valid],
                                   rtol=1e-4, atol=5e-4, err_msg=f)


def small_renderer(**kw):
    scene, cam = get_scene_by_name("CornellSmall", "cpu")
    cfg = RenderConfig(width=16, height=16, render_method=PPM,
                       photons_per_iteration=1 << 10,
                       photon_grid_resolution=8, **kw)
    return Renderer(scene, cam, cfg, seed=3)


def test_renderer_restart_determinism_and_radius_rules():
    """Renderer.render takes the float32 closed-form radius per iteration
    and compute_iteration the schedule from scratch, as the JAX package's
    fused loop and compute_iteration do."""
    r = small_renderer(iterations_per_dispatch=2)
    a = r.render(3).accum.clone()
    assert r.iteration == 3 and r.metrics["photons_stored"] > 0
    r.restart()
    assert torch.equal(r.render(3).accum, a)
    acc = torch.zeros_like(a)
    for it in range(3):
        rad, _ = ppm.render_iteration(
            r.scene, r.camera, r.cfg, it, r.root_key,
            renderer.ppm_radius_sq_traced(r.ppm_initial_radius,
                                          r.cfg.ppm_alpha, it))
        acc = acc + rad
    # summed in chunks of iterations_per_dispatch, as the film does
    assert torch.allclose(a, acc, rtol=1e-6, atol=0.0)
    rad, stats = r.compute_iteration(2)
    want, _ = ppm.render_iteration(
        r.scene, r.camera, r.cfg, 2, r.root_key,
        renderer.ppm_radius_sq_at_iteration(r.ppm_initial_radius,
                                            r.cfg.ppm_alpha, 2))
    assert torch.equal(rad, want)
    assert set(stats) == {"photons_stored", "avg_photon_path_length",
                          "photons_visited", "photon_subsampled"}
    m = r.render_next_iteration()
    assert m["ppm_radius_sq"] == renderer.ppm_radius_sq_at_iteration(
        r.ppm_initial_radius, r.cfg.ppm_alpha, 3)


def test_budget_gather_when_the_image_has_no_16x16_blocks():
    r = small_renderer()
    r.restart(cfg=r.cfg.replace(width=20, height=12))
    img = r.render(1).mean_radiance()
    assert img.shape == (12, 20, 3) and bool(torch.isfinite(img).all())
    assert r.metrics["photons_visited"] > 0


def test_later_slices_raise():
    r = small_renderer(
        photon_map_structure=PhotonMapStructure.STOCHASTIC_HASH)
    with pytest.raises(NotImplementedError, match="later slice"):
        r.render(1)
    # a medium no longer raises (tests/test_torch_media.py)
    r = small_renderer()
    r.scene.medium = Medium(sigma_s=torch.tensor(0.15),
                            sigma_a=torch.tensor(0.02),
                            aabb_min=torch.zeros(3),
                            aabb_max=torch.full((3,), 2.5))
    assert bool(torch.isfinite(r.render(1).mean_radiance()).all())
    assert r.metrics["volumetric_photons_stored"] > 0


def test_chip_smoke_configs_are_the_jax_ones():
    """ppm-goldens renders the JAX golden PPM configuration; ppm-main the
    JAX bench's PPM case (bench.py:232-235) at 512^2."""
    want = golden_config("ppm")
    got = chip_smoke.golden_ppm_config()
    for f in RenderConfig.__dataclass_fields__:
        assert getattr(got, f) == getattr(want, f), f
    assert (chip_smoke.GOLDEN_SEED, chip_smoke.GOLDEN_PPM_ITERS) == (
        GOLDEN_SEED, ITERS["ppm"])
    main = chip_smoke.ppm_main_config()
    bench = JConfig(width=512, height=512, render_method=PPM,
                    photons_per_iteration=1 << 20)
    for f in RenderConfig.__dataclass_fields__:
        assert getattr(main, f) == getattr(bench, f), f
    assert chip_smoke.ppm_rays_per_iteration(main) == (
        512 * 512 * (9 + 4) + (1 << 20) * 7)


def test_cli_renders_ppm(tmp_path, capsys):
    out = tmp_path / "ppm.png"
    assert cli.main(["--cpu", "--method", "ppm", "--size", "16", "-n", "2",
                     "--photons", "1024", "-o", str(out)]) == 0
    assert out.exists()
    assert "photons_stored=" in capsys.readouterr().out
