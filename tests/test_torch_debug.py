"""The port's debug machinery (``debug.py``): ``tests/test_debug.py``'s four
tests, the per-pixel trace and the photon histogram against the JAX
package's on the same seed, and the non-finite check naming the pass a
NaN comes from. The random streams are bit-identical, so the traces agree
at PT's tolerances (ROADMAP queue C: rtol 1e-4, atol 1e-6) and the
histograms exactly."""
import numpy as np
import pytest
import torch

from oppositerenderer_tpu import debug as jdebug
from oppositerenderer_tpu.config import RenderConfig as JConfig
from oppositerenderer_tpu.lights import make_point_light as jpoint_light
from oppositerenderer_tpu.scene import SceneBuilder as JBuilder
from oppositerenderer_tpu.scene import make_cornell_small as jcornell
from oppositerenderer_tpu_torch import debug, diff
from oppositerenderer_tpu_torch.config import RenderConfig, RenderMethod
from oppositerenderer_tpu_torch.lights import make_point_light
from oppositerenderer_tpu_torch.scene import SceneBuilder, get_scene_by_name

CHECK_CFG = dict(width=16, height=16, photons_per_iteration=1024,
                 photon_grid_resolution=8, gather_photon_budget=32,
                 max_photon_trace_depth=3, vcm_max_path_length=4)


@pytest.fixture(scope="module")
def cornell():
    return get_scene_by_name("CornellSmall", "cpu")


def facing_planes(builder, point_light, **build):
    """Two huge facing diffuse planes 1 unit apart, a point light between
    them (``test_debug.py:80``)."""
    b = builder()
    mat = b.add_diffuse((0.7, 0.7, 0.7))
    s = 500.0
    b.add_triangle((-s, 0, -s), (s, 0, s), (s, 0, -s), mat)
    b.add_triangle((-s, 0, -s), (-s, 0, s), (s, 0, s), mat)
    b.add_triangle((-s, 1, -s), (s, 1, -s), (s, 1, s), mat)
    b.add_triangle((-s, 1, -s), (s, 1, s), (-s, 1, s), mat)
    b.add_light(point_light((10.0,) * 3, (0.0, 0.5, 0.0)))
    return b.build(**build)


def test_trace_debug_pixel_records_path(cornell):
    scene, cam = cornell
    cfg = RenderConfig(width=32, height=32)
    recs = debug.trace_debug_pixel(scene, cam, cfg, 16, 16)
    assert len(recs) >= 1
    assert recs[0]["hit"]
    # records carry finite positions/throughputs and a sampled direction
    for r in recs:
        assert np.isfinite(r["position"]).all()
        assert np.isfinite(r["throughput"]).all()
    assert "sampled_dir" in recs[0] or recs[0]["is_emitter"]
    # throughput only decreases along a diffuse chain
    if len(recs) >= 2:
        assert recs[1]["throughput"].max() <= recs[0]["throughput"].max() + 1e-6


def test_check_iteration_clean_scene(cornell):
    scene, cam = cornell
    cfg = RenderConfig(**CHECK_CFG)
    for method in (RenderMethod.PATH_TRACING,
                   RenderMethod.PROGRESSIVE_PHOTON_MAPPING,
                   RenderMethod.VCM_BIDIRECTIONAL_PATH_TRACING):
        msg, radiance = debug.check_iteration(
            scene, cam, cfg.replace(render_method=method))
        assert np.isfinite(radiance.numpy()).all()
        # the estimators guard their divisions; a clean scene must not
        # trip the check
        assert msg is None, (method, msg)


def test_photon_depth_histogram(cornell):
    scene, cam = cornell
    cfg = RenderConfig(photons_per_iteration=2048,
                       max_photon_trace_depth=4)
    out = debug.photon_depth_histogram(scene, cfg)
    hist = out["deposits_histogram"]
    assert hist.sum() == 2048
    assert out["photons_stored"] > 0
    # stored count must equal the histogram's weighted sum
    weighted = int((np.arange(hist.shape[0]) * hist).sum())
    assert weighted == out["photons_stored"]


def test_photon_depth_histogram_known_geometry():
    """Deposits start at the second diffuse hit (the map is indirect only,
    Diffuse.cu:98), so between the planes with a depth cap of 3 and no
    Russian roulette nearly every photon deposits exactly at depths 1 and
    2. A depth-major/lane-major reshape mixup smears this spike over
    {0..3}; the totals in the test above survive any permutation, this
    distribution does not."""
    scene = facing_planes(SceneBuilder, make_point_light, device="cpu")
    n = 2048
    cfg = RenderConfig(photons_per_iteration=n, max_photon_trace_depth=3,
                       photon_rr_start_depth=9)
    out = debug.photon_depth_histogram(scene, cfg)
    hist = out["deposits_histogram"]
    assert hist.sum() == n
    weighted = int((np.arange(hist.shape[0]) * hist).sum())
    assert weighted == out["photons_stored"]
    # the spike: >90% of paths deposit exactly twice (tiny edge leakage)
    assert hist[2] > 0.9 * n, hist


@pytest.mark.parametrize("x,y,iteration", [(16, 16, 0), (3, 29, 2),
                                           (25, 8, 5)])
def test_trace_debug_pixel_matches_jax(cornell, x, y, iteration):
    scene, cam = cornell
    jscene, jcam = jcornell()
    recs = debug.trace_debug_pixel(scene, cam, RenderConfig(width=32,
                                                            height=32),
                                   x, y, iteration)
    want = jdebug.trace_debug_pixel(jscene, jcam, JConfig(width=32,
                                                          height=32),
                                    x, y, iteration)
    assert len(recs) == len(want)
    for got, ref in zip(recs, want):
        assert got.keys() == ref.keys()
        for k, v in ref.items():
            if isinstance(v, (bool, int)):
                assert got[k] == v, (got["depth"], k)
            else:
                np.testing.assert_allclose(got[k], np.asarray(v), rtol=1e-4,
                                           atol=1e-6,
                                           err_msg=f"depth {got['depth']} {k}")


@pytest.mark.parametrize("planes", [False, True])
def test_photon_depth_histogram_matches_jax(cornell, planes):
    """Equal on the facing planes. On CornellSmall a path may end
    elsewhere: one of these 4096 (lane 852) grazes the left wall, whose
    hit lies 1.8e-7 behind the wall in JAX and 2.4e-7 in the port (the
    last-ulp deviation of ROADMAP queue C), re-hits it at the next bounce
    in the port and stops one deposit short. So there the histograms may
    differ by one count moved between two bins for at most 0.1% of the
    paths."""
    if planes:
        scene = facing_planes(SceneBuilder, make_point_light, device="cpu")
        jscene = facing_planes(JBuilder, jpoint_light)
        kw = dict(photons_per_iteration=2048, max_photon_trace_depth=3,
                  photon_rr_start_depth=9)
    else:
        scene, jscene = cornell[0], jcornell()[0]
        kw = dict(photons_per_iteration=4096, max_photon_trace_depth=4)
    got = debug.photon_depth_histogram(scene, RenderConfig(**kw), seed=3,
                                       iteration=1)
    want = jdebug.photon_depth_histogram(jscene, JConfig(**kw), seed=3,
                                         iteration=1)
    hist, ref = got["deposits_histogram"], want["deposits_histogram"]
    n = kw["photons_per_iteration"]
    assert hist.sum() == ref.sum() == n
    moved = int(np.abs(hist.astype(np.int64) - ref).sum()) // 2
    stored = abs(got["photons_stored"] - want["photons_stored"])
    if planes:
        assert moved == stored == 0
        assert got["avg_photon_path_length"] == pytest.approx(
            want["avg_photon_path_length"], rel=1e-6)
    else:
        assert moved <= n // 1000 and stored <= moved * \
            kw["max_photon_trace_depth"]


@pytest.mark.parametrize("method,first_pass", [
    (RenderMethod.PATH_TRACING, "pt_raytrace_pass"),
    (RenderMethod.PROGRESSIVE_PHOTON_MAPPING, "ppm_eye_pass"),
    (RenderMethod.VCM_BIDIRECTIONAL_PATH_TRACING, "vcm_light_pass")])
def test_check_iteration_names_the_pass_of_a_nan(cornell, method,
                                                 first_pass):
    scene, cam = cornell
    bad = diff.scale_emission(scene, float("nan"))   # a NaN emission
    msg, radiance = debug.check_iteration(
        bad, cam, RenderConfig(**CHECK_CFG).replace(render_method=method))
    assert msg is not None and msg.startswith(f"pass {first_pass}:"), msg
    assert not bool(torch.isfinite(radiance).all())
