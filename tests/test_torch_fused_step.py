"""The step's device operands and the fused multi-iteration loop.

On the card a Renderer replays one captured iteration whose operands are
device tensors (``renderer.CapturedStep``): the iteration, the root key's
words and the squared radius. Here, on the CPU:

* the eager body with tensor operands equals its int/float form bit for
  bit (the same keys, streams and float32 radius), for PT, PPM on the
  grid, the hash and in a medium, and VCM+VM;
* the captured body itself (``CapturedStep._body``, run eagerly), n times
  after ``prepare``, equals the eager fused loop bit for bit, in the
  closed-form radius mode and in the host-schedule mode;
* ``Renderer.compute_iterations(start, n, stride)`` matches the JAX
  package's (its ``_multi_step_fn``: a ``fori_loop`` over the iterations,
  the float32 closed-form radius on the device) at ROADMAP queue C's bars:
  PT on 99.9% of the pixels at rtol 1e-4, PPM and VCM (L = 4) on 99% at
  rtol 1e-3, each image mean within 1e-3. PPM renders 24^2, which does
  not split into 16x16 blocks, so both packages take the budgeted gather
  (JAX's tile gather in interpret mode would triple the file's time; the
  tile gather's fused loop is held on the card). Each JAX reference
  renders once, in a module fixture.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oppositerenderer_tpu import renderer as jrenderer
from oppositerenderer_tpu.config import RenderConfig as JConfig
from oppositerenderer_tpu.config import RenderMethod as JMethod
from oppositerenderer_tpu.scene import get_scene_by_name as jax_scene
from oppositerenderer_tpu_torch.config import (PhotonMapStructure,
                                               RenderConfig, RenderMethod)
from oppositerenderer_tpu_torch.core.rng import device_key
from oppositerenderer_tpu_torch.renderer import (CapturedStep, Renderer,
                                                 ppm_radius_sq_at_iteration)
from oppositerenderer_tpu_torch.scene import Medium, get_scene_by_name

torch.set_num_threads(2)

SEED = 5
PPM = RenderMethod.PROGRESSIVE_PHOTON_MAPPING
VCM = RenderMethod.VCM_BIDIRECTIONAL_PATH_TRACING
PPM_KW = dict(photons_per_iteration=1 << 12, photon_grid_resolution=16)
START, N, STRIDE = 3, 2, 4      # iterations 3 and 7


def medium(scene):
    return dataclasses.replace(scene, medium=Medium(
        sigma_s=torch.tensor(0.15), sigma_a=torch.tensor(0.02),
        aabb_min=torch.zeros(3), aabb_max=torch.full((3,), 2.5)))


# name -> (size, RenderConfig fields, scene transform)
STEPS = {
    "pt": (64, dict(), None),
    "ppm_grid": (32, dict(render_method=PPM, **PPM_KW), None),
    "ppm_hash": (32, dict(render_method=PPM, **PPM_KW,
                          photon_map_structure=PhotonMapStructure
                          .STOCHASTIC_HASH), None),
    "ppm_medium": (32, dict(render_method=PPM, **PPM_KW), medium),
    "vcm_vm": (32, dict(render_method=VCM, vcm_max_path_length=4,
                        photon_grid_resolution=16, vcm_use_vm=True), None),
}


def renderer(name):
    size, fields, transform = STEPS[name]
    scene, cam = get_scene_by_name("CornellSmall", "cpu")
    if transform is not None:
        scene = transform(scene)
    return Renderer(scene, cam, RenderConfig(width=size, height=size,
                                             **fields), seed=SEED)


def assert_bits_equal(got, want):
    rad, stats = got
    wrad, wstats = want
    assert torch.equal(rad.view(torch.int32), wrad.view(torch.int32))
    assert stats.keys() == wstats.keys()
    for k in stats:
        assert torch.equal(stats[k], wstats[k]), k


@pytest.mark.parametrize("name", sorted(STEPS))
def test_tensor_operands_equal_the_int_form_bit_for_bit(name):
    r = renderer(name)
    it = 6
    r2 = ppm_radius_sq_at_iteration(r.ppm_initial_radius, r.cfg.ppm_alpha, it)
    step = r._raw_step()
    want = step(r.camera, it, r.root_key, r2)
    got = step(r.camera, torch.tensor(it), device_key(r.root_key, "cpu"),
               torch.tensor(r2, dtype=torch.float32))
    assert_bits_equal(got, want)
    assert float(want[0].mean()) > 0


@pytest.mark.parametrize("name", ["ppm_grid", "vcm_vm"])
def test_captured_body_equals_the_eager_loop(name):
    """The body a graph holds, run eagerly on the CPU: n calls after
    ``prepare`` sum the iterations start, start + stride, ... at the
    closed-form radius, as the eager fused loop does; one call at a given
    radius renders that iteration, as ``compute_iteration`` does."""
    r = renderer(name)
    H, W = r.cfg.height, r.cfg.width
    step = CapturedStep(r._raw_step(), r.camera, r.ppm_initial_radius,
                        r.cfg.ppm_alpha, H, W, r.device)
    want_acc, want_stats = r._build_fused()(r.camera, START, r.root_key, N,
                                            STRIDE)
    step.prepare(r.camera, r.root_key, START, STRIDE, None)
    for _ in range(N):
        step._body()
    assert torch.equal(step.acc.view(torch.int32),
                       want_acc.view(torch.int32))
    assert step.stats_acc.keys() == want_stats.keys()
    for k, v in want_stats.items():
        assert torch.equal(step.stats_acc[k], v), k
    assert int(step.count) == N

    r2 = r._radius_sq(START)
    step.prepare(r.camera, r.root_key, START, 0, r2)
    rad, stats = step._body()
    want_rad, want_stats = r._iteration(START, r2)
    assert_bits_equal((rad, stats),
                      (want_rad, {k: torch.sum(v)
                                  for k, v in want_stats.items()}))


# ---------------------------------------------------------------------------
# compute_iterations against the JAX package's fused loop
# ---------------------------------------------------------------------------

# name -> (size, port fields, JAX fields, pixel rtol, share of pixels)
FUSED = {
    "pt": (32, dict(), dict(use_pallas=False), 1e-4, 0.999),
    "ppm": (24, dict(render_method=PPM, **PPM_KW),
            dict(render_method=JMethod.PROGRESSIVE_PHOTON_MAPPING, **PPM_KW,
                 use_pallas=False, use_pallas_gather=False,
                 photon_grid_sort="argsort"), 1e-3, 0.99),
    "vcm": (32, dict(render_method=VCM, vcm_max_path_length=4),
            dict(render_method=JMethod.VCM_BIDIRECTIONAL_PATH_TRACING,
                 vcm_max_path_length=4, use_pallas=False), 1e-3, 0.99),
}


@pytest.fixture(scope="module")
def jax_fused():
    """Each case's JAX ``compute_iterations`` (one fused dispatch)."""
    out = {}
    for name, (size, _, jfields, _, _) in FUSED.items():
        js, jc = jax_scene("CornellSmall")
        jr = jrenderer.Renderer(js, jc, JConfig(width=size, height=size,
                                                **jfields), seed=SEED)
        acc, stats = jr.compute_iterations(START, N, STRIDE)
        out[name] = (np.asarray(acc), {k: float(v) for k, v in
                                       stats.items()}, jr.ppm_initial_radius)
    return out


@pytest.mark.parametrize("name", sorted(FUSED))
def test_compute_iterations_matches_jax_fused_loop(name, jax_fused):
    size, fields, _, rtol, share = FUSED[name]
    want, wstats, jr0 = jax_fused[name]
    scene, cam = get_scene_by_name("CornellSmall", "cpu")
    r = Renderer(scene, cam, RenderConfig(width=size, height=size, **fields),
                 seed=SEED)
    assert r.ppm_initial_radius == pytest.approx(jr0, rel=1e-6)
    got, stats = r.compute_iterations(START, N, STRIDE)
    got = got.numpy()
    assert got.shape == want.shape == (size, size, 3)
    assert np.isfinite(got).all() and got.mean() > 0
    agree = np.isclose(got, want, rtol=rtol, atol=0.0).all(axis=-1)
    assert agree.mean() >= share, agree.mean()
    assert got.mean() == pytest.approx(want.mean(), rel=1e-3)
    assert stats.keys() == wstats.keys()
    for k in wstats:
        assert stats[k] == pytest.approx(wstats[k], rel=1e-3), k


def test_jax_closed_form_radius_is_the_ports():
    """The fused loop's radius: the port's float32 closed form against
    the JAX package's, on the CPU, for the iterations of these tests."""
    its = np.arange(0, 40)
    want = np.asarray(jrenderer.ppm_radius_sq_traced(
        0.03, 2.0 / 3.0, jnp.asarray(its, jnp.int32)))
    from oppositerenderer_tpu_torch.renderer import ppm_radius_sq_traced
    got = ppm_radius_sq_traced(0.03, 2.0 / 3.0, torch.as_tensor(its)).numpy()
    # lgamma differs in the last bits between the libraries: the PPM
    # radius bar of ROADMAP queue C
    np.testing.assert_allclose(got, want, rtol=5e-4, atol=0)
