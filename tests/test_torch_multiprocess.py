"""Iteration-sharded rendering in two real processes over gloo
(``test_multiprocess.py:48``'s port), strided and through the scheduler.

Two worker processes render 8 iterations of CornellSmall PT at 32^2
through ``MultiHostRenderer.run`` and merge by one all-reduce; the merged
film must equal one process's film of the same iterations at rtol 2e-5,
atol 1e-6 (the sums add in another order).
"""
import numpy as np
import pytest
import torch

from oppositerenderer_tpu_torch.config import RenderConfig
from oppositerenderer_tpu_torch.parallel.distributed import MultiHostRenderer
from oppositerenderer_tpu_torch.parallel.worker import spawn_ranks
from oppositerenderer_tpu_torch.scene import get_scene_by_name

torch.set_num_threads(2)

ITERS = 8
SIZE = 32
SEED = 5
CFG = dict(width=SIZE, height=SIZE, photons_per_iteration=1 << 12,
           photon_grid_resolution=16, gather_photon_budget=64)
CASES = [dict(name="strided", kind="multihost", cfg=CFG, iterations=ITERS,
              seed=SEED),
         dict(name="leased", kind="multihost", cfg=CFG, iterations=ITERS,
              seed=SEED, schedule="leased", packet_size=2)]


@pytest.fixture(scope="module")
def merged(tmp_path_factory):
    out = tmp_path_factory.mktemp("mp") / "merged.npz"
    spawn_ranks(2, CASES, out, device="cpu", backend="gloo", threads=2,
                timeout=300)
    return dict(np.load(out))


@pytest.fixture(scope="module")
def single():
    scene, cam = get_scene_by_name("CornellSmall", "cpu")
    return MultiHostRenderer(scene, cam, RenderConfig(**CFG),
                             seed=SEED).run(ITERS)


@pytest.mark.parametrize("schedule", ["strided", "leased"])
def test_two_process_render_matches_single(merged, single, schedule):
    assert int(merged[f"{schedule}.iterations"]) == ITERS
    # both processes rendered a share of the iterations
    rendered = merged[f"{schedule}.rendered"]
    assert rendered.sum() == ITERS and (rendered > 0).all()
    np.testing.assert_allclose(merged[f"{schedule}.accum"],
                               single.accum.numpy(), rtol=2e-5, atol=1e-6)
    assert float(merged[f"{schedule}.merge_ms"]) > 0.0
