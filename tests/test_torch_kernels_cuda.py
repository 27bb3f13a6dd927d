"""The port's CUDA kernels on the card: each against its plain version.

These tests need an NVIDIA GPU (sm_90a) and nvcc; without them they skip.
Run them on such a machine with

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

(``--noconftest``: the suite's conftest imports JAX, which these tests do
not need.)
The library is built with --fmad=false, so the intersection kernels (B1,
B2) and the BVH traversal (B5) and their plain versions must agree bit
for bit. The gather kernel (B3) and
the vertex-merge kernel (B4) sum the same terms as their plain versions in
another order: rtol 1e-4 plus atol 1e-6 * max|ref|, with equal stats and
tables.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402
from oppositerenderer_tpu_torch.accel import gather_kernels as gk  # noqa
from oppositerenderer_tpu_torch.accel import intersect_kernels as ik
from oppositerenderer_tpu_torch.accel import vm_kernels as vk  # noqa: E402
from oppositerenderer_tpu_torch.accel.intersect import \
    occluder_mask  # noqa: E402
from oppositerenderer_tpu_torch.config import (RenderConfig,  # noqa: E402
                                               RenderMethod)
from oppositerenderer_tpu_torch.renderer import Renderer  # noqa: E402
from oppositerenderer_tpu_torch.scene import get_scene_by_name  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False   # plain gather: fp32
    return torch.device("cuda", 0)


def rays(n, seed, dev):
    rng = np.random.default_rng(seed)
    o = rng.uniform(0.2, 2.3, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmin = np.full(n, 1e-4, np.float32)
    tmax = rng.uniform(0.05, 3.0, n).astype(np.float32)
    tmax[::7] = 1e30
    tmax[::11] = 0.0           # dead lanes
    return [torch.as_tensor(a, device=dev) for a in (o, d, tmin, tmax)]


@pytest.mark.parametrize("n", [131, 4096, 262144])
@pytest.mark.parametrize("name", ["CornellSmall", "CornellSmallLargeSphere"])
def test_kernels_equal_plain_versions(cuda, name, n):
    scene, _ = get_scene_by_name(name, cuda)
    g = scene.geometry
    tri9 = ik.tri9_from_geometry(g)
    mask = occluder_mask(scene, g.tri_mat)
    args = rays(n, n, cuda)
    before = ik.closest_hit_tris.launches
    got = ik.closest_hit_tris(*args, tri9)
    assert ik.closest_hit_tris.launches == before + 1
    want = ik.closest_hit_tris_plain(*args, tri9)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert not bool((got[1][::11] >= 0).any())
    assert torch.equal(ik.occluded_tris(*args, tri9, mask),
                       ik.occluded_tris_plain(*args, tri9, mask))


def test_wrapper_rejects_bad_inputs(cuda):
    scene, _ = get_scene_by_name("CornellSmall", cuda)
    tri9 = ik.tri9_from_geometry(scene.geometry)
    o, d, tmin, tmax = rays(64, 0, cuda)
    with pytest.raises(ValueError, match="float32"):
        ik.closest_hit_tris(o.double(), d, tmin, tmax, tri9)
    with pytest.raises(ValueError, match="contiguous"):
        ik.closest_hit_tris(o, d, tmin, tmax, tri9.T.contiguous().T)


def test_render_on_the_card_matches_the_cpu_render(cuda):
    cfg = RenderConfig(width=32, height=32)
    imgs = []
    for dev in ("cpu", cuda):
        scene, cam = get_scene_by_name("CornellSmall", dev)
        imgs.append(Renderer(scene, cam, cfg, seed=1).render(
            2).mean_radiance().cpu().numpy())
    assert np.isfinite(imgs[1]).all()
    assert imgs[1].mean() == pytest.approx(imgs[0].mean(), rel=1e-3)


@pytest.mark.parametrize("case", ["synthetic", "no_normal", "clustered"])
def test_gather_kernel_matches_plain_version(cuda, case):
    cluster = case == "clustered"
    grid, q, qn, r = chip_smoke.gather_case(
        cuda, n_photons=8192 if cluster else 4096, cluster=cluster,
        radius=0.2 if cluster else 0.12)
    u = torch.rand((2, gk.ROWS + 2), generator=torch.Generator().manual_seed(
        5)).to(cuda) if cluster else torch.zeros((2, gk.ROWS + 2),
                                                  device=cuda)
    before = gk.gather_photons_tiled.launches
    got, gst = gk.gather_photons_tiled(grid, q, qn, r, u_rows=u,
                                       check_normal=case != "no_normal")
    assert gk.gather_photons_tiled.launches == before + 1
    cpu = chip_smoke._to(grid, "cpu")
    want, wst = gk.gather_photons_tiled(cpu, q.cpu(), qn.cpu(), r,
                                        u_rows=u.cpu(),
                                        check_normal=case != "no_normal")
    for k in wst:
        assert torch.equal(gst[k].cpu(), wst[k])
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(),
                               rtol=chip_smoke.GATHER_RTOL,
                               atol=chip_smoke.GATHER_ATOL_REL
                               * float(want.abs().max()))
    assert (int(gst["photon_subsampled"].sum()) > 0) == cluster


def test_ppm_launch_counts_and_cpu_agreement(cuda):
    cfg = RenderConfig(width=32, height=32, photons_per_iteration=1 << 12,
                       photon_grid_resolution=16,
                       render_method=RenderMethod.PROGRESSIVE_PHOTON_MAPPING)
    imgs = []
    for dev in ("cpu", cuda):
        scene, cam = get_scene_by_name("CornellSmall", dev)
        r = Renderer(scene, cam, cfg, seed=1)
        counts = [ik.closest_hit_tris.launches, ik.occluded_tris.launches,
                  gk.gather_photons_tiled.launches]
        imgs.append(r.render(2).mean_radiance().cpu().numpy())
        counts = [w.launches - c for w, c in zip(
            (ik.closest_hit_tris, ik.occluded_tris,
             gk.gather_photons_tiled), counts)]
        if dev == "cpu":
            assert counts == [0, 0, 0]
    assert counts == [2 * (cfg.max_radiance_trace_depth
                           + cfg.max_photon_trace_depth),
                      2 * cfg.ppm_direct_shadow_samples, 2]
    assert np.isfinite(imgs[1]).all()
    assert imgs[1].mean() == pytest.approx(imgs[0].mean(), rel=1e-3)


@pytest.mark.parametrize("cluster", [False, True])
def test_vm_kernel_matches_plain_version(cuda, cluster):
    scene, cfg, k = chip_smoke.vm_case(cuda, 0, cluster)
    n = k["cam_pos"].shape[0]
    u_rows = k["u_stride"].reshape(n // vk.TILE, vk.TILE)[:, :vk.ROWS + 2]
    _, args, _, _ = vk.merge_tables(
        k["vgrid"], cfg, k["cam_bsdf"], k["cam_pos"], k["cam_dVCM"],
        k["cam_dVM"], k["active"], k["radius_sq"], k["mis_vc_w"], u_rows,
        k["depth1"])
    before = vk.merge_vertices_tiled.launches
    got = vk.merge_vertices_tiled_kernel(*args)
    assert vk.merge_vertices_tiled.launches == before + 1
    want = vk.merge_vertices_tiled_plain(*args)
    for g, w in zip(got, want):
        np.testing.assert_allclose(
            g.cpu().numpy(), w.cpu().numpy(), rtol=chip_smoke.VM_RTOL,
            atol=chip_smoke.VM_ATOL_REL * float(w.abs().max()))
    assert float(want[0].abs().max()) > 0.0
    # the whole merge round on the card against the CPU's
    merged = vcm_merge(scene, cfg, k)
    cpu = vcm_merge(*(chip_smoke._to(x, "cpu") for x in (scene, cfg, k)))
    np.testing.assert_allclose(merged.cpu().numpy(), cpu.numpy(),
                               rtol=chip_smoke.VM_RTOL,
                               atol=chip_smoke.VM_ATOL_REL
                               * float(cpu.abs().max()))


def vcm_merge(scene, cfg, k):
    from oppositerenderer_tpu_torch.integrators import vcm
    return vcm._merge_vertices(
        scene, cfg, k["cam_bsdf"], k["cam_pos"], k["cam_thr"],
        k["cam_dVCM"], k["cam_dVM"], k["active"], k["vgrid"],
        k["radius_sq"], k["mis_vc_w"], k["n_light_paths"], k["u_stride"],
        k["depth1"])


def test_vcm_launch_counts_and_cpu_agreement(cuda):
    """Per VCM+VM iteration at path length L: B1 (L-1) + L times, B2
    (L-1) + L + L (L-1) times, B4 L times; none on the CPU."""
    L = 4
    cfg = RenderConfig(
        width=32, height=32, vcm_max_path_length=L, photon_grid_resolution=16,
        vcm_use_vm=True,
        render_method=RenderMethod.VCM_BIDIRECTIONAL_PATH_TRACING)
    wrappers = (ik.closest_hit_tris, ik.occluded_tris,
                vk.merge_vertices_tiled)
    imgs = []
    for dev in ("cpu", cuda):
        scene, cam = get_scene_by_name("CornellSmall", dev)
        r = Renderer(scene, cam, cfg, seed=1)
        counts = [w.launches for w in wrappers]
        imgs.append(r.render(2).mean_radiance().cpu().numpy())
        counts = [w.launches - c for w, c in zip(wrappers, counts)]
        if dev == "cpu":
            assert counts == [0, 0, 0]
    assert counts == [2 * (2 * L - 1), 2 * ((L - 1) + L + L * (L - 1)),
                      2 * L]
    assert np.isfinite(imgs[1]).all()
    assert imgs[1].mean() == pytest.approx(imgs[0].mean(), rel=1e-3)


@pytest.mark.parametrize("name", ["Atrium:0.25", "Conference:0.15"])
@pytest.mark.parametrize("n", [131, 65536])
def test_bvh_kernels_equal_plain_versions(cuda, name, n):
    from oppositerenderer_tpu_torch.accel import bvh_kernels as bk
    scene, _ = get_scene_by_name(name, cuda)
    o, d, tmin, tmax = chip_smoke._rays(n, n + 7, scene.aabb_min.tolist(),
                                        scene.aabb_max.tolist(), cuda)
    before = bk.traverse.launches
    got = bk.traverse(scene.bvh, o, d, tmin, tmax)
    assert bk.traverse.launches == before + 1
    want = bk.traverse_plain(scene.bvh, o, d, tmin, tmax)
    for a, b in zip(got, want):
        assert chip_smoke._bits_differ(a, b) == 0
    dead = ~(tmax > tmin)
    assert not bool(got[4][dead].any()) and bool(got[4].any())
    assert torch.equal(bk.traverse_any(scene.bvh, o, d, tmin, tmax),
                       bk.traverse_any_plain(scene.bvh, o, d, tmin, tmax))


def test_bvh_wrapper_rejects_bad_inputs(cuda):
    import dataclasses
    from oppositerenderer_tpu_torch.accel import bvh_kernels as bk
    scene, _ = get_scene_by_name("Atrium:0.1", cuda)
    o, d, tmin, tmax = rays(64, 0, cuda)
    with pytest.raises(ValueError, match="float32"):
        bk.traverse(scene.bvh, o.double(), d, tmin, tmax)
    deep = dataclasses.replace(scene.bvh,
                               max_stack=bk.KERNEL_MAX_STACK + 1)
    with pytest.raises(ValueError, match="stack"):
        bk.traverse_any(deep, o, d, tmin, tmax)


def test_bvh_render_on_the_card_matches_the_cpu_render(cuda):
    """PT on a BVH scene: B5 on the card, its plain version on the CPU;
    textured materials on both."""
    from oppositerenderer_tpu_torch.accel import bvh_kernels as bk
    cfg = RenderConfig(width=32, height=32)
    imgs = []
    for dev in ("cpu", cuda):
        scene, cam = get_scene_by_name("Atrium:0.1", dev)
        counts = (bk.traverse.launches, bk.traverse_any.launches,
                  ik.closest_hit_tris.launches)
        imgs.append(Renderer(scene, cam, cfg, seed=1).render(
            2).mean_radiance().cpu().numpy())
        counts = [w.launches - c for w, c in zip(
            (bk.traverse, bk.traverse_any, ik.closest_hit_tris), counts)]
    assert counts == [2 * cfg.pt_max_segments,
                      2 * cfg.pt_max_segments * cfg.pt_shadow_samples, 0]
    assert np.isfinite(imgs[1]).all()
    agree = np.isclose(imgs[1], imgs[0], rtol=1e-3, atol=0).all(axis=-1)
    assert agree.mean() >= 0.99
    assert imgs[1].mean() == pytest.approx(imgs[0].mean(), rel=1e-3)
