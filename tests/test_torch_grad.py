"""Gradients of the port against finite differences and against JAX's
``jax.grad`` for the same seed: the eight cases of ``tests/test_grad.py``
(its two PPM cases in ``test_torch_grad_ppm.py``, which shares these
helpers), and the kernels' zero-gradient contract.

Fixed random streams make a render piecewise smooth in the parameters,
so central differences match the detached-sampling gradient wherever no
discrete decision flips (JAX's tolerances: rel 0.02 for PT kd, 0.03 for
PPM and VCM kd, 1e-3 for the linear emission, 0.15 for the glossy
lobe). Both packages trace the same paths, so their gradients agree to
float tolerance: rel 1e-3 for PT, 5e-3 for PPM and VCM, whose longer
sums of last-ulp differences (ROADMAP queue C) go through the gather and
the MIS weights. PPM at 32^2 takes the tile gather, whose sums have a
zero gradient on every device, as JAX's tile kernel; it is held against
JAX's ``use_pallas_gather=True`` gradient and JAX's bracket
0.25 g_ref < g < g_ref against its budgeted gather.
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

import chip_smoke  # noqa: E402
from oppositerenderer_tpu import diff as jdiff
from oppositerenderer_tpu.config import RenderConfig as JConfig
from oppositerenderer_tpu.core.rng import make_root_key as jkey
from oppositerenderer_tpu.integrators import ppm as jppm
from oppositerenderer_tpu.integrators import pt as jpt
from oppositerenderer_tpu.integrators import vcm as jvcm
from oppositerenderer_tpu.scene import get_scene_by_name as jax_scene
from oppositerenderer_tpu_torch import diff
from oppositerenderer_tpu_torch.accel import bvh_kernels as bk
from oppositerenderer_tpu_torch.accel import gather_kernels as gk
from oppositerenderer_tpu_torch.accel import intersect_kernels as ik
from oppositerenderer_tpu_torch.accel.intersect import dense_tables
from oppositerenderer_tpu_torch.config import RenderConfig, RenderMethod
from oppositerenderer_tpu_torch.core.rng import make_root_key
from oppositerenderer_tpu_torch.integrators import ppm, pt, vcm
from oppositerenderer_tpu_torch.photon_map import (PhotonBatch,
                                                   build_photon_grid,
                                                   gather_photons)
from oppositerenderer_tpu_torch.scene import GLOSSY, get_scene_by_name

torch.set_num_threads(2)

PT, PPM = RenderMethod.PATH_TRACING, RenderMethod.PROGRESSIVE_PHOTON_MAPPING
VCM = RenderMethod.VCM_BIDIRECTIONAL_PATH_TRACING
SEED = 12
H = 1e-3          # central-difference step
JAX_RTOL = {"pt": 1e-3, "ppm": 5e-3, "vcm": 5e-3}
R2 = 0.003


def configs(method, jax_kw=None, **kw):
    """The same configuration for both packages; ``jax_kw`` sets JAX-only
    fields (its gather's backend switch)."""
    kw["render_method"] = method
    return JConfig(**kw, **(jax_kw or {})), RenderConfig(**kw)


def pt_kw(**kw):
    # no RR dependence on the materials: RR starts beyond the path length
    return dict(dict(width=24, height=24, pt_max_segments_nee=3,
                     path_rr_start_depth=9), **kw)


PPM_KW = dict(photons_per_iteration=1 << 12, photon_grid_resolution=16,
              photon_rr_start_depth=9, max_photon_trace_depth=4)
# RR continuation pinned to 1: live RR makes differences heavy-tailed
VCM_KW = dict(width=32, height=32, vcm_max_path_length=4,
              vcm_force_continuation_prob=1.0)


def render_mean(method, scene, cam, cfg, iters, port: bool):
    """Mean over ``iters`` iterations of one package's image mean."""
    acc = 0.0
    for i in range(iters):
        if port:
            key = make_root_key(SEED)
            img = (pt.render_iteration(scene, cam, cfg, i, key)
                   if method == PT else
                   (ppm if method == PPM else vcm).render_iteration(
                       scene, cam, cfg, i, key, R2)[0])
            acc = acc + torch.mean(img)
        else:
            key, it = jkey(SEED), jnp.int32(i)
            img = (jpt.render_iteration(scene, cam, cfg, it, key)
                   if method == PT else
                   (jppm if method == PPM else jvcm).render_iteration(
                       scene, cam, cfg, it, key, jnp.float32(R2))[0])
            acc = acc + jnp.mean(img)
    return acc / iters


def kd_scaled(d, scene, scale, idx=0):
    return d.set_material_param(scene, "kd", idx,
                                scene.materials.kd[idx] * scale)


def emission_scaled(d, scene, scale):
    return d.scale_emission(scene, scale)


def port_value_grad(loss, x0=1.0):
    x = torch.tensor(x0, requires_grad=True)
    value = loss(x)
    (g,) = torch.autograd.grad(value, x)
    return float(value.detach()), float(g)


def finite_diff(loss, x0=1.0, h=H):
    with torch.no_grad():
        return (float(loss(torch.tensor(x0 + h)))
                - float(loss(torch.tensor(x0 - h)))) / (2 * h)


def case(method, edit, name, iters, kw, x0=1.0, jax_kw=None):
    """(port value, port gradient, port central difference, JAX value,
    JAX gradient) of mean image(edit(scene, x)) at x0."""
    jcfg, cfg = configs(method, jax_kw, **kw)
    js, jc = jax_scene(name)
    ts, tc = get_scene_by_name(name, "cpu")

    def port_loss(x):
        return render_mean(method, edit(diff, ts, x), tc, cfg, iters, True)

    value, g = port_value_grad(port_loss, x0)
    fd = finite_diff(port_loss, x0)
    jv, jg = jax.jit(jax.value_and_grad(lambda x: render_mean(
        method, edit(jdiff, js, x), jc, jcfg, iters, False)))(
            jnp.float32(x0))
    return value, g, fd, float(jv), float(jg)


def test_pt_grad_kd_matches_fd_and_jax():
    value, g, fd, jv, jg = case(PT, kd_scaled, "CornellSmall", 2, pt_kw())
    assert g > 0  # brighter walls, brighter image
    assert g == pytest.approx(fd, rel=0.02)
    assert value == pytest.approx(jv, rel=JAX_RTOL["pt"])
    assert g == pytest.approx(jg, rel=JAX_RTOL["pt"])


def test_pt_grad_emission_matches_fd_and_jax():
    value, g, fd, jv, jg = case(PT, emission_scaled, "CornellSmall", 2,
                                pt_kw())
    # emission is linear: the gradient is the loss at scale 1
    assert g == pytest.approx(value, rel=1e-4)
    assert g == pytest.approx(fd, rel=1e-3)
    assert g == pytest.approx(jg, rel=JAX_RTOL["pt"])


def test_grad_wrt_glossy_params():
    """Gradients flow through the Phong lobe (ks of the glossy floor)."""
    ts, _ = get_scene_by_name("CornellSmallLargeSphere", "cpu")
    gidx = int(torch.argmax((ts.materials.kind == GLOSSY).to(torch.int32)))

    def edit(d, scene, x):
        ks = (torch.ones(3) if d is diff else jnp.ones(3)) * x
        return d.set_material_param(scene, "ks", gidx, ks)

    value, g, fd, jv, jg = case(PT, edit, "CornellSmallLargeSphere", 1,
                                pt_kw(width=16, height=16), x0=0.7)
    assert np.isfinite(g)
    assert g == pytest.approx(fd, rel=0.15)
    assert g == pytest.approx(jg, rel=JAX_RTOL["pt"])


def test_vcm_grad_kd_matches_fd_and_jax():
    value, g, fd, jv, jg = case(VCM, kd_scaled, "CornellSmall", 2, VCM_KW)
    assert g > 0
    assert g == pytest.approx(fd, rel=0.03)
    assert value == pytest.approx(jv, rel=JAX_RTOL["vcm"])
    assert g == pytest.approx(jg, rel=JAX_RTOL["vcm"])


def test_vcm_grad_emission_linear():
    value, g, fd, jv, jg = case(
        VCM, emission_scaled, "CornellSmall", 1,
        dict(width=16, height=16, vcm_max_path_length=4))
    assert g == pytest.approx(value, rel=1e-3)
    assert g == pytest.approx(jg, rel=JAX_RTOL["vcm"])


def test_render_loss_and_grad_helper():
    jcfg, cfg = configs(PT, **pt_kw(width=16, height=16))
    ts, tc = get_scene_by_name("CornellSmall", "cpu")
    js, jc = jax_scene("CornellSmall")
    loss, grads = diff.render_loss_and_grad(
        lambda s: pt.render_iteration(s, tc, cfg, 0, make_root_key(SEED)),
        ts, {("kd", 0): ts.materials.kd[0],
             ("emission_scale", 0): 1.0})
    assert np.isfinite(float(loss))
    g = grads[("kd", 0)].numpy()
    assert g.shape == (3,) and np.isfinite(g).all() and (g > 0).all()
    assert float(grads[("emission_scale", 0)]) == pytest.approx(
        float(loss), rel=1e-4)
    _, jgrads = jdiff.render_loss_and_grad(
        lambda s: jpt.render_iteration(s, jc, jcfg, jnp.int32(0),
                                       jkey(SEED)),
        js, {("kd", 0): js.materials.kd[0]})
    np.testing.assert_allclose(g, np.asarray(jgrads[("kd", 0)]),
                               rtol=JAX_RTOL["pt"])


def test_material_edits_keep_the_scene_and_its_tables():
    """The edits leave the scene alone; the triangle tables, geometry and
    emitter flags, carry over unless the material kinds change."""
    scene, _ = get_scene_by_name("CornellSmall", "cpu")
    tables = dense_tables(scene)
    kd0 = scene.materials.kd.clone()
    s = diff.set_material_param(scene, "kd", 2, torch.tensor([0.1, .2, .3]))
    assert torch.equal(scene.materials.kd, kd0)
    assert s.materials.kd[2].tolist() == pytest.approx([0.1, 0.2, 0.3])
    assert torch.equal(s.materials.kd[:2], kd0[:2])
    assert torch.equal(s.materials.kd[3:], kd0[3:])
    assert all(a is b for a, b in zip(dense_tables(s), tables))
    e = diff.scale_emission(s, 2.0)
    assert torch.equal(e.lights.power, 2.0 * scene.lights.power)
    assert torch.equal(e.materials.emission, 2.0 * scene.materials.emission)
    assert all(a is b for a, b in zip(dense_tables(e), tables))
    k = diff.set_material_param(scene, "kind", 0, torch.tensor(0))
    assert k.dense_cache is None
    assert all(torch.equal(a, b) for a, b in zip(dense_tables(k), tables))


# ---------------------------------------------------------------------------
# the kernels' zero-gradient contract
# ---------------------------------------------------------------------------

def _grad(out, x):
    (g,) = torch.autograd.grad(out, x, retain_graph=True,
                               materialize_grads=True, allow_unused=True)
    return g


def test_intersection_kernels_give_zero_gradients():
    """B1, B2 (dense) and B5 (BVH) on the CPU: the plain versions' bits,
    float outputs in the graph with a zero gradient, the integer and
    boolean outputs outside it."""
    scene, _ = get_scene_by_name("CornellSmall", "cpu")
    tris, occ = dense_tables(scene)
    o, d, tmin, tmax = chip_smoke._rays(2048, 3, scene.aabb_min.tolist(),
                                        scene.aabb_max.tolist(), "cpu")
    og, dg = o.clone().requires_grad_(), d.clone().requires_grad_()
    out = ik.closest_hit_tris(og, dg, tmin, tmax, tris)
    want = ik.closest_hit_tris_plain(o, d, tmin, tmax, tris)
    for a, b in zip(out, want):
        assert torch.equal(a, b)
    t, idx, u, v = out
    assert t.requires_grad and u.requires_grad and not idx.requires_grad
    assert (t < ik.BIG).float().mean() > 0.5
    assert not _grad((t + u + v).sum(), og).any()
    assert not _grad(t.sum(), dg).any()
    hit = ik.occluded_tris(og, dg, tmin, tmax, occ)
    assert not hit.requires_grad and hit.any()
    assert torch.equal(hit, ik.occluded_tris_plain(o, d, tmin, tmax, occ))

    bscene, _ = get_scene_by_name("Atrium:0.1", "cpu")
    o, d, tmin, tmax = chip_smoke._rays(512, 4, bscene.aabb_min.tolist(),
                                        bscene.aabb_max.tolist(), "cpu")
    og = o.clone().requires_grad_()
    t, prim, u, v, found = bk.traverse(bscene.bvh, og, d, tmin, tmax)
    assert torch.equal(t, bk.traverse_plain(bscene.bvh, o, d, tmin, tmax)[0])
    assert t.requires_grad and not (prim.requires_grad or found.requires_grad)
    assert found.any() and not _grad((t + u).sum(), og).any()
    assert not bk.traverse_any(bscene.bvh, og, d, tmin, tmax).requires_grad


def test_tile_gather_gives_zero_gradient_and_budgeted_gather_full():
    """B3's sums (the plain version on the CPU) have a zero gradient in the
    photon powers and the query positions; the budgeted gather on the
    same photons and queries carries both."""
    rng = np.random.default_rng(5)
    P, n = 4096, 256
    pos = torch.as_tensor(rng.uniform(0.0, 1.0, (P, 3)), dtype=torch.float32)
    power = torch.as_tensor(rng.uniform(0.1, 1.0, (P, 3)),
                            dtype=torch.float32).requires_grad_()
    dirs = torch.zeros((P, 3))
    dirs[:, 2] = -1.0
    batch = PhotonBatch(position=pos, power=power, direction=dirs,
                        valid=torch.ones(P, dtype=torch.bool))
    radius = torch.tensor(0.08)
    grid = build_photon_grid(batch, 8, min_cell_size=2 * radius / 3)
    q = torch.as_tensor(rng.uniform(0.2, 0.8, (n, 3)),
                        dtype=torch.float32).requires_grad_()
    qn = torch.zeros((n, 3))
    qn[:, 2] = 1.0
    tiled, _ = gk.gather_photons_tiled(grid, q, qn, radius,
                                       u_rows=torch.zeros((1, gk.ROWS + 2)))
    budget, _ = gather_photons(grid, q, qn, radius, budget_total=4096)
    # nothing is subsampled: the two estimates agree
    torch.testing.assert_close(tiled, budget, rtol=1e-4, atol=1e-6)
    assert float(tiled.detach().sum()) > 0
    assert not _grad(tiled.sum(), power).any()
    assert not _grad(tiled.sum(), q).any()
    assert _grad(budget.sum(), power).abs().sum() > 0
    assert _grad(budget.sum(), q).abs().sum() > 0


def _rows(obj, n):
    """A record's (nested dataclasses of) per-lane tensors cut to n lanes."""
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{
            f.name: _rows(getattr(obj, f.name), n)
            for f in dataclasses.fields(obj)})
    return obj[:n]


def test_tile_merge_gives_zero_gradient_and_budgeted_merge_full():
    """B4's merged sums (kd/pi out1 + rho out2, the plain version on the
    CPU) have a zero gradient in the camera BSDF's kd; the camera
    throughput outside keeps its gradient. The budgeted merge, which a
    round takes when its vertices do not tile by 256, carries both."""
    scene, cfg, k = chip_smoke.vm_case("cpu")
    n = k["cam_pos"].shape[0]
    assert n % gk.TILE == 0
    grads = {}
    for label, m in (("tile", n), ("budget", n - 16)):
        kw = {key: (_rows(v, m) if key in ("cam_bsdf", "cam_pos", "cam_thr",
                                           "cam_dVCM", "cam_dVM", "active",
                                           "u_stride") else v)
              for key, v in k.items()}
        kd = kw["cam_bsdf"].kd.clone().requires_grad_()
        thr = kw["cam_thr"].clone().requires_grad_()
        kw["cam_bsdf"] = dataclasses.replace(kw["cam_bsdf"], kd=kd)
        kw["cam_thr"] = thr
        out = vcm._merge_vertices(scene, cfg, **kw)
        assert float(out.detach().sum()) > 0
        grads[label] = (_grad(out.sum(), kd), _grad(out.sum(), thr))
    assert not grads["tile"][0].any()
    assert grads["tile"][1].abs().sum() > 0
    assert grads["budget"][0].abs().sum() > 0
    assert grads["budget"][1].abs().sum() > 0


# sha256 prefixes of one iteration's float32 bytes (seed 7, iteration 1,
# 16^2, r^2 = 0.003) from the port before the kernels' zero-gradient
# Functions: images without gradients keep their bits
PINS = {"pt": "01908d3864e444f2", "vcm": "ad295b2d121322fe",
        "vcm_vm": "fea7bd74d61da4cf", "atrium_pt": "9b2460d65f9a78ed"}


@pytest.mark.parametrize("label", sorted(PINS))
def test_images_without_gradients_keep_their_bits(label):
    name = "Atrium:0.1" if label == "atrium_pt" else "CornellSmall"
    scene, cam = get_scene_by_name(name, "cpu")
    key = make_root_key(7)
    if label.endswith("pt"):
        img = pt.render_iteration(scene, cam,
                                  RenderConfig(width=16, height=16), 1, key)
    else:
        cfg = RenderConfig(width=16, height=16, render_method=VCM,
                           vcm_max_path_length=4,
                           vcm_use_vm=label == "vcm_vm")
        img, _ = vcm.render_iteration(scene, cam, cfg, 1, key, R2)
    assert not img.requires_grad
    assert hashlib.sha256(img.numpy().tobytes()).hexdigest()[:16] == \
        PINS[label]
