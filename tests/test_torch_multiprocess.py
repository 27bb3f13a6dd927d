"""Iteration-sharded rendering in two real processes over gloo
(``test_multiprocess.py:48``'s port), strided and through the scheduler.

Two worker processes render 8 iterations of CornellSmall PT at 32^2, and
4 of CornellSmall PPM at 64^2 (its tile gather's plain version takes ~4 s
an iteration on the CPU), through ``MultiHostRenderer.run`` and merge by
one all-reduce; the merged film must equal one process's film of the
same iterations at rtol 2e-5, atol 1e-6 (the sums add in another order).
For PPM every packet, strided or leased, is an arithmetic progression of
iterations, which takes the float32 closed-form radius that one process
takes for all of them.
"""
import numpy as np
import pytest
import torch

from oppositerenderer_tpu_torch.config import RenderConfig
from oppositerenderer_tpu_torch.parallel.distributed import MultiHostRenderer
from oppositerenderer_tpu_torch.parallel.worker import (config_from,
                                                        spawn_ranks)
from oppositerenderer_tpu_torch.renderer import (Renderer,
                                                 ppm_radius_sq_at_iteration,
                                                 ppm_radius_sq_traced)
from oppositerenderer_tpu_torch.scene import get_scene_by_name

torch.set_num_threads(2)

ITERS = 8
SIZE = 32
SEED = 5
CFG = dict(width=SIZE, height=SIZE, photons_per_iteration=1 << 12,
           photon_grid_resolution=16, gather_photon_budget=64)
PPM_SIZE = 64
PPM_ITERS = 4
PPM_CFG = dict(CFG, width=PPM_SIZE, height=PPM_SIZE,
               render_method="PROGRESSIVE_PHOTON_MAPPING")
CASES = [dict(name="strided", kind="multihost", cfg=CFG, iterations=ITERS,
              seed=SEED),
         dict(name="leased", kind="multihost", cfg=CFG, iterations=ITERS,
              seed=SEED, schedule="leased", packet_size=2),
         dict(name="ppm_strided", kind="multihost", cfg=PPM_CFG,
              iterations=PPM_ITERS, seed=SEED),
         dict(name="ppm_leased", kind="multihost", cfg=PPM_CFG,
              iterations=PPM_ITERS, seed=SEED, schedule="leased",
              packet_size=2)]


@pytest.fixture(scope="module")
def merged(tmp_path_factory):
    out = tmp_path_factory.mktemp("mp") / "merged.npz"
    spawn_ranks(2, CASES, out, device="cpu", backend="gloo", threads=2,
                timeout=300)
    return dict(np.load(out))


def single_process(cfg: RenderConfig, iterations: int):
    scene, cam = get_scene_by_name("CornellSmall", "cpu")
    return MultiHostRenderer(scene, cam, cfg, seed=SEED).run(iterations)


@pytest.fixture(scope="module")
def single():
    return single_process(RenderConfig(**CFG), ITERS)


@pytest.fixture(scope="module")
def single_ppm():
    return single_process(config_from(PPM_CFG), PPM_ITERS)


@pytest.mark.parametrize("schedule", ["strided", "leased"])
def test_two_process_render_matches_single(merged, single, schedule):
    assert int(merged[f"{schedule}.iterations"]) == ITERS
    # both processes rendered a share of the iterations
    rendered = merged[f"{schedule}.rendered"]
    assert rendered.sum() == ITERS and (rendered > 0).all()
    np.testing.assert_allclose(merged[f"{schedule}.accum"],
                               single.accum.numpy(), rtol=2e-5, atol=1e-6)
    assert float(merged[f"{schedule}.merge_ms"]) > 0.0


@pytest.mark.parametrize("schedule", ["strided", "leased"])
def test_two_process_ppm_render_matches_single(merged, single_ppm,
                                               schedule):
    name = f"ppm_{schedule}"
    assert int(merged[f"{name}.iterations"]) == PPM_ITERS
    rendered = merged[f"{name}.rendered"]
    assert rendered.sum() == PPM_ITERS and (rendered > 0).all()
    assert int(merged[f"{name}.launches.gather_photons_tiled"]) == 0
    assert single_ppm.accum.shape == (PPM_SIZE, PPM_SIZE, 3)
    np.testing.assert_allclose(merged[f"{name}.accum"],
                               single_ppm.accum.numpy(), rtol=2e-5,
                               atol=1e-6)


def test_ppm_iteration_under_either_radius_agrees_at_the_bar():
    """A one-iteration packet takes the scheduled radius
    (``compute_iteration``), a longer one the float32 closed form
    (``compute_iterations``): they differ by up to ~15 ulps over the first
    10 iterations, and a PPM iteration under either, at the iteration
    where they differ most, agrees at the merged-film bar."""
    cfg = config_from(dict(PPM_CFG, width=32, height=32))
    scene, cam = get_scene_by_name("CornellSmall", "cpu")
    r = Renderer(scene, cam, cfg, seed=SEED)
    ulps = [abs(int(np.float32(ppm_radius_sq_at_iteration(
        r.ppm_initial_radius, cfg.ppm_alpha, it)).view(np.int32))
        - int(ppm_radius_sq_traced(r.ppm_initial_radius, cfg.ppm_alpha,
                                   it).numpy().view(np.int32)))
        for it in range(10)]
    assert max(ulps) > 0, ulps
    it = int(np.argmax(ulps))
    scheduled, _ = r.compute_iteration(it)
    closed, _ = r.compute_iterations(it, 1)
    np.testing.assert_allclose(scheduled.numpy(), closed.numpy(), rtol=2e-5,
                               atol=1e-6)
