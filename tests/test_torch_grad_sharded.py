"""Gradients through the port's sharded render over two gloo ranks
(``test_grad_sharded.py:38,70``'s port).

``diff.make_sharded_loss_and_grad`` renders each rank's band, back-
propagates through the collectives and sums the gradients over ranks. It
must equal the port's unsharded gradient (rel 5e-3) and, for PT, central
finite differences (rel 0.02). PPM runs at 24^2, where the image has no
16x16 blocks and both sides take the budgeted, differentiable gather:
emission is linear, so its gradient equals the loss. At 16^2 the tile
gather (B3's zero gradient) drops the photon terms, on both packages:
that case is held against JAX's sharded gradient with its tile gather.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oppositerenderer_tpu import diff as jdiff
from oppositerenderer_tpu.config import RenderConfig as JConfig
from oppositerenderer_tpu.config import RenderMethod as JMethod
from oppositerenderer_tpu.core.rng import make_root_key as jax_key
from oppositerenderer_tpu.parallel import make_mesh as jax_mesh
from oppositerenderer_tpu.scene import make_cornell_small
from oppositerenderer_tpu_torch import diff
from oppositerenderer_tpu_torch.core.rng import make_root_key
from oppositerenderer_tpu_torch.integrators import ppm, pt
from oppositerenderer_tpu_torch.parallel.worker import (config_from,
                                                        spawn_ranks)
from oppositerenderer_tpu_torch.scene import get_scene_by_name

torch.set_num_threads(2)

SEED = 12
R2 = 0.002
PT_CFG = dict(width=24, height=24, pt_max_segments_nee=3,
              path_rr_start_depth=9)
PPM_CFG = dict(render_method="PROGRESSIVE_PHOTON_MAPPING",
               photons_per_iteration=1 << 12, photon_grid_resolution=16,
               max_photon_trace_depth=3, photon_rr_start_depth=9,
               gather_photon_budget=4096)
EMISSION = [["emission_scale", -1]]
CASES = [
    dict(name="pt", kind="grad", cfg=PT_CFG, wrt=[["kd", 0]], seed=SEED),
    dict(name="ppm", kind="grad", cfg=dict(PPM_CFG, width=24, height=24),
         wrt=EMISSION, seed=SEED, radius_sq=R2),
    dict(name="ppm_tiled", kind="grad", cfg=dict(PPM_CFG, width=16,
                                                 height=16),
         wrt=EMISSION, seed=SEED, radius_sq=R2),
]


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    out = tmp_path_factory.mktemp("grad") / "grads.npz"
    spawn_ranks(2, CASES, out, device="cpu", backend="gloo", threads=2,
                timeout=300)
    return dict(np.load(out))


@pytest.fixture(scope="module")
def cornell():
    return get_scene_by_name("CornellSmall", "cpu")


def unsharded_loss(scene, cam, cfg, edit, x):
    s = edit(scene, x)
    key = make_root_key(SEED)
    if cfg.render_method == 0:
        return torch.mean(pt.render_iteration(s, cam, cfg, 0, key))
    return torch.mean(ppm.render_iteration(s, cam, cfg, 0, key, R2)[0])


def value_and_grad(fn, x0=1.0):
    x = torch.tensor(x0, requires_grad=True)
    loss = fn(x)
    g, = torch.autograd.grad(loss, x)
    return float(loss.detach()), float(g)


def kd_scaled(scene, x):
    return diff.set_material_param(scene, "kd", 0, scene.materials.kd[0] * x)


def test_sharded_pt_grad_matches_unsharded_and_fd(sharded, cornell):
    scene, cam = cornell
    cfg = config_from(PT_CFG)
    # chain rule: d/d(scale) at 1 = grad(kd) . kd
    g_sharded = float((torch.as_tensor(sharded["pt.grad.kd.0"])
                       * scene.materials.kd[0]).sum())
    loss, g_ref = value_and_grad(
        lambda x: unsharded_loss(scene, cam, cfg, kd_scaled, x))
    assert float(sharded["pt.loss"]) == pytest.approx(loss, rel=2e-3)
    assert g_sharded == pytest.approx(g_ref, rel=5e-3)
    with torch.no_grad():
        fd = float((unsharded_loss(scene, cam, cfg, kd_scaled, 1.001)
                    - unsharded_loss(scene, cam, cfg, kd_scaled, 0.999))
                   / 0.002)
    assert g_sharded == pytest.approx(fd, rel=0.02)
    assert g_sharded > 0


def test_sharded_ppm_grad_matches_unsharded(sharded, cornell):
    """Through the all-to-all exchange and the budgeted gather over the
    partial grids: all linear in the photon power."""
    scene, cam = cornell
    cfg = config_from(dict(PPM_CFG, width=24, height=24))
    g_sharded = float(sharded["ppm.grad.emission_scale.-1"])
    _, g_ref = value_and_grad(
        lambda x: unsharded_loss(scene, cam, cfg, diff.scale_emission, x))
    assert np.isfinite(g_sharded)
    assert g_sharded == pytest.approx(g_ref, rel=5e-3)
    # emission is linear in its scale: the gradient at 1 is the loss
    assert g_sharded == pytest.approx(float(sharded["ppm.loss"]), rel=5e-3)


def test_sharded_tiled_ppm_grad_matches_jax_sharded(sharded, cornell):
    """At 16^2 both packages gather over each rank's partial grid with the
    tile gather, whose zero gradient keeps only the terms outside it."""
    scene, cam = cornell
    fields = dict(PPM_CFG, width=16, height=16)
    jcfg = JConfig(**{k: v for k, v in fields.items()
                      if k != "render_method"},
                   render_method=JMethod.PROGRESSIVE_PHOTON_MAPPING,
                   use_pallas_gather=True)
    js, jc = make_cornell_small()
    jloss, jgrads = jdiff.make_sharded_loss_and_grad(
        js, jc, jcfg, jax_mesh(2),
        {("emission_scale", -1): jnp.float32(1.0)})(
        iteration=0, key=jax_key(SEED), radius_sq=R2)
    g_jax = float(jgrads[("emission_scale", -1)])
    g_port = float(sharded["ppm_tiled.grad.emission_scale.-1"])
    assert float(sharded["ppm_tiled.loss"]) == pytest.approx(float(jloss),
                                                            rel=5e-3)
    assert g_port == pytest.approx(g_jax, rel=5e-3)
    # the photon terms are dropped: the gradient is below the loss
    assert 0.0 < g_port < float(sharded["ppm_tiled.loss"])
    # and the port's unsharded gradient agrees
    _, g_ref = value_and_grad(lambda x: unsharded_loss(
        scene, cam, config_from(fields), diff.scale_emission, x))
    assert g_port == pytest.approx(g_ref, rel=5e-3)
    assert jax.devices()[0].platform == "cpu"
