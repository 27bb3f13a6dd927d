"""Conference on the port: PT and VCM agree in the image mean, the
statistical cross-check of ``tests/test_conference.py:24`` (the same
configuration: Conference:0.15 at 48^2, PT 20 iterations, VCM 10, seed 3,
means within 12%). Port-only and long, so it is marked slow."""
import numpy as np
import pytest
import torch

from oppositerenderer_tpu_torch.config import RenderConfig, RenderMethod
from oppositerenderer_tpu_torch.renderer import Renderer
from oppositerenderer_tpu_torch.scene import get_scene_by_name

torch.set_num_threads(2)


@pytest.mark.slow
def test_pt_vcm_agree_on_conference():
    scene, cam = get_scene_by_name("Conference:0.15")
    assert scene.bvh is not None and int(scene.lights.n_lights) == 3
    means = {}
    for m, iters in ((RenderMethod.PATH_TRACING, 20),
                     (RenderMethod.VCM_BIDIRECTIONAL_PATH_TRACING, 10)):
        r = Renderer(scene, cam, RenderConfig(width=48, height=48,
                                              render_method=m), seed=3)
        img = r.render(iters).mean_radiance().numpy()
        assert np.isfinite(img).all()
        means[m] = float(img.mean())
    a = means[RenderMethod.PATH_TRACING]
    b = means[RenderMethod.VCM_BIDIRECTIONAL_PATH_TRACING]
    assert a > 0.05
    assert b == pytest.approx(a, rel=0.12), (a, b)
