"""The port's CUDA kernels on the card: each against its plain version.

These tests need an NVIDIA GPU (sm_90a) and nvcc; without them they skip.
Run them on such a machine with

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

(``--noconftest``: the suite's conftest imports JAX, which these tests do
not need.)
The library is built with --fmad=false, so the intersection kernels (B1,
B2) and the BVH traversal (B5) and their plain versions must agree bit
for bit, B1, B2 and B5 also on inputs whose lanes are all dead or all
live, B1 on equal t too (the lower index wins),
and B5's live-lane compaction must find the lanes torch.nonzero finds.
The gather kernel (B3) and the vertex-merge kernel (B4) sum the same terms
as their plain versions in another order (a tile's slots in groups):
rtol 1e-4 plus atol 1e-6 * max|ref|, with equal stats and tables.
Through their zero-gradient Functions every kernel keeps these outputs
and gives zero gradients; the PT and PPM gradients and a PPM iteration in
a medium agree with the CPU port's.
"""
import dataclasses
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
    dense_tables  # noqa: E402
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
    tris, occ = dense_tables(scene)
    args = rays(n, n, cuda)
    before = ik.closest_hit_tris.launches
    got = ik.closest_hit_tris(*args, tris)
    assert ik.closest_hit_tris.launches == before + 1
    want = ik.closest_hit_tris_plain(*args, tris)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert not bool((got[1][::11] >= 0).any())
    before = ik.occluded_tris.launches
    assert torch.equal(ik.occluded_tris(*args, occ),
                       ik.occluded_tris_plain(*args, occ))
    assert ik.occluded_tris.launches == before + 1


def soup(T, seed, dev):
    """[9, T]: T random triangles in a 10-unit box (chip_smoke's soup)."""
    rng = np.random.default_rng(seed)
    return torch.as_tensor(np.concatenate([
        rng.uniform(0.0, 10.0, (T, 3)).T, rng.normal(0.0, 0.5, (T, 3)).T,
        rng.normal(0.0, 0.5, (T, 3)).T]).astype(np.float32), device=dev)


def lane_rays(n, seed, kind, dev):
    """chip_smoke's random rays in the soup's box: mixed, all dead or all
    live lanes."""
    rays = chip_smoke._rays(n, seed, [0.0] * 3, [10.0] * 3, dev)
    return rays if kind == "mixed" else chip_smoke.dead_or_live(
        rays, kind == "all live")


@pytest.mark.parametrize("kind", ["mixed", "all dead", "all live"])
@pytest.mark.parametrize("T", [0, 1, 32, 600, 4096])
def test_closest_kernel_on_dead_live_and_mixed_lanes(cuda, T, kind):
    """B1 bit for bit against its plain version on tables of 0 to 4096
    triangles (600 and 4096: more than one staged chunk), with every lane
    dead, every lane live, or a mix; dead lanes get (1e30, -1, 0, 0)."""
    tris = ik.triangle_records(soup(T, T, cuda))
    o, d, tmin, tmax = lane_rays(70001, T + 1, kind, cuda)
    got = ik.closest_hit_tris(o, d, tmin, tmax, tris)
    want = ik.closest_hit_tris_plain(o, d, tmin, tmax, tris)
    for a, b in zip(got, want):
        assert chip_smoke._bits_differ(a, b) == 0
    dead = ~(tmax > tmin)
    assert bool((got[0][dead] == ik.BIG).all())
    assert bool((got[1][dead] == -1).all())
    assert not bool(got[2][dead].any()) and not bool(got[3][dead].any())
    if T >= 32 and kind != "all dead":
        assert bool((got[1] >= 0).any())


@pytest.mark.parametrize("i,j,T", [(0, 1, 32), (5, 31, 32), (3, 600, 700),
                                   (511, 512, 1024)])
def test_closest_kernel_gives_equal_t_to_the_lower_index(cuda, i, j, T):
    """Triangle j a copy of triangle i, within a staged chunk and across
    chunks: the kernel equals its plain version bit for bit, every ray
    that hits the pair gets index i, and none gets j."""
    tri9 = soup(T, 17, cuda)
    tri9[:, j] = tri9[:, i]
    n = 65536
    rng = np.random.default_rng(i + j)
    o = torch.as_tensor(rng.uniform(0.0, 10.0, (n, 3)).astype(np.float32),
                        device=cuda)
    a, b = (torch.as_tensor(x.astype(np.float32), device=cuda)
            for x in rng.uniform(0.05, 0.45, (2, n)))
    target = (tri9[0:3, i] + a[:, None] * tri9[3:6, i]
              + b[:, None] * tri9[6:9, i])
    d = target - o
    d = (d / torch.linalg.norm(d, dim=1, keepdim=True)).contiguous()
    tmin = torch.full((n,), 1e-4, device=cuda)
    tmax = torch.full((n,), 1e30, device=cuda)
    tris = ik.triangle_records(tri9)
    got = ik.closest_hit_tris(o, d, tmin, tmax, tris)
    want = ik.closest_hit_tris_plain(o, d, tmin, tmax, tris)
    for x, y in zip(got, want):
        assert chip_smoke._bits_differ(x, y) == 0
    assert int((got[1] == i).sum()) > 1000
    assert not bool((got[1] == j).any())


@pytest.mark.parametrize("kind", ["mixed", "all dead", "all live"])
@pytest.mark.parametrize("T", [0, 1, 32, 4096])
def test_occluded_kernel_on_dead_live_and_mixed_lanes(cuda, T, kind):
    """B2 bit for bit against its plain version on occluder tables of 0 to
    4096 triangles (more than one staged chunk), with every lane dead,
    every lane live, or a mix."""
    occ = ik.triangle_records(soup(T, T, cuda))
    o, d, tmin, tmax = lane_rays(70001, T + 1, kind, cuda)
    got = ik.occluded_tris(o, d, tmin, tmax, occ)
    assert torch.equal(got, ik.occluded_tris_plain(o, d, tmin, tmax, occ))
    if T == 0 or kind == "all dead":
        assert not bool(got.any())
    elif T >= 32:
        assert bool(got.any())
    assert not bool(got[~(tmax > tmin)].any())


def test_wrapper_rejects_bad_inputs(cuda):
    scene, _ = get_scene_by_name("CornellSmall", cuda)
    tris, occ = dense_tables(scene)
    o, d, tmin, tmax = rays(64, 0, cuda)
    with pytest.raises(ValueError, match="float32"):
        ik.closest_hit_tris(o.double(), d, tmin, tmax, tris)
    with pytest.raises(ValueError, match="contiguous"):
        ik.closest_hit_tris(o, d, tmin, tmax, tris.T.contiguous().T)
    with pytest.raises(ValueError, match="shape"):
        ik.closest_hit_tris(o, d, tmin, tmax, ik.tri9_from_geometry(
            scene.geometry))
    for table, fn in ((tris, ik.closest_hit_tris), (occ, ik.occluded_tris)):
        shifted = torch.zeros(table.numel() + 1, device=cuda)[1:].reshape(
            table.shape)
        with pytest.raises(ValueError, match="aligned"):
            fn(o, d, tmin, tmax, shifted)
    with pytest.raises(ValueError, match="shape"):
        ik.occluded_tris(o, d, tmin, tmax, occ[:, :9].contiguous())


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


@pytest.mark.parametrize("check_normal", [True, False])
def test_gather_kernel_on_the_ppm_main_shape(cuda, check_normal):
    """B3, its slots in SLOT_GROUPS groups, against its plain version on the
    grid and hitpoints of one CornellSmall 512^2 PPM iteration."""
    grid, q, qn, r, u, valid = chip_smoke.ppm_gather_inputs(cuda)
    starts, lens, weights, _, _, rows = gk._tile_tables(grid, q, r, u, valid)
    args = (starts, lens, weights, rows,
            torch.square(torch.as_tensor(r, dtype=torch.float32,
                                         device=cuda)), q, qn, grid,
            check_normal)
    got = gk.gather_photons_tiled_kernel(*args)
    want = gk.gather_photons_tiled_plain(*args)
    assert float(want.abs().max()) > 0.0
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=chip_smoke.GATHER_RTOL,
                               atol=chip_smoke.GATHER_ATOL_REL
                               * float(want.abs().max()))


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
    (L-1) + L times (one launch per light bounce, one per camera bounce
    for its s=1 and vertex-connection shadow rays together), B4 L times;
    none on the CPU."""
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
    assert counts == [2 * (2 * L - 1), 2 * ((L - 1) + L), 2 * L]
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


@pytest.mark.parametrize("kind", ["all dead", "all live"])
def test_bvh_kernels_on_all_dead_and_all_live_lanes(cuda, kind):
    from oppositerenderer_tpu_torch.accel import bvh_kernels as bk
    scene, _ = get_scene_by_name("Atrium:0.25", cuda)
    o, d, tmin, tmax = chip_smoke._rays(65536, 11, scene.aabb_min.tolist(),
                                        scene.aabb_max.tolist(), cuda)
    if kind == "all dead":
        tmax = torch.where(torch.arange(tmax.shape[0], device=cuda) % 2 == 0,
                           tmin, tmin - 1.0)
    else:
        tmax = torch.where(tmax > tmin, tmax, 1e30)
    got = bk.traverse(scene.bvh, o, d, tmin, tmax)
    want = bk.traverse_plain(scene.bvh, o, d, tmin, tmax)
    for a, b in zip(got, want):
        assert chip_smoke._bits_differ(a, b) == 0
    assert bool(got[4].any()) == (kind == "all live")
    assert torch.equal(bk.traverse_any(scene.bvh, o, d, tmin, tmax),
                       bk.traverse_any_plain(scene.bvh, o, d, tmin, tmax))


@pytest.mark.parametrize("p_live", [0.0, 0.2, 1.0])
def test_live_lane_compaction_matches_nonzero(cuda, p_live):
    from oppositerenderer_tpu_torch.accel import bvh_kernels as bk
    rng = np.random.default_rng(3)
    n = 100_003
    tmax = np.where(rng.uniform(size=n) < p_live, 1.0, -1.0)
    tmin = torch.zeros(n, device=cuda)
    tmax = torch.as_tensor(tmax.astype(np.float32), device=cuda)
    live, counts = bk.compact_live(tmin, tmax)
    plain = bk.compact_live_plain(tmin, tmax)
    assert torch.equal(live, plain[0]) and torch.equal(counts, plain[1])
    want = torch.nonzero(tmax > tmin)[:, 0].to(torch.int32)
    assert torch.equal(live[live >= 0], want)


def test_entry_points_default_to_the_card(cuda):
    """Without a device the scene, camera, film and tables land on cuda."""
    from oppositerenderer_tpu_torch.film import Film
    scene, cam = get_scene_by_name("CornellSmall")
    assert scene.device.type == "cuda" and cam.eye.device.type == "cuda"
    assert scene.lights.kind.device.type == "cuda"
    assert Film.create(4, 4).accum.device.type == "cuda"


def _zero_grad(out, x):
    (g,) = torch.autograd.grad(out, x, retain_graph=True,
                               materialize_grads=True, allow_unused=True)
    return not bool(g.any())


def test_kernel_functions_keep_their_bits_and_give_zero_gradients(cuda):
    """Every kernel through its zero-gradient Function on the card, with
    inputs that require grad: the launch counts, the outputs of the
    kernel (bit for bit for B1, B2 and B5, B3 and B4 at their rtol
    against the plain versions) and zero gradients."""
    from oppositerenderer_tpu_torch.accel import bvh_kernels as bk
    scene, _ = get_scene_by_name("CornellSmall", cuda)
    tris, occ = dense_tables(scene)
    o, d, tmin, tmax = rays(4096, 1, cuda)
    og = o.clone().requires_grad_()
    before = (ik.closest_hit_tris.launches, ik.occluded_tris.launches)
    got = ik.closest_hit_tris(og, d, tmin, tmax, tris)
    hit = ik.occluded_tris(og, d, tmin, tmax, occ)
    assert (ik.closest_hit_tris.launches,
            ik.occluded_tris.launches) == (before[0] + 1, before[1] + 1)
    for a, b in zip(got, ik.closest_hit_tris_plain(o, d, tmin, tmax, tris)):
        assert torch.equal(a, b)
    assert torch.equal(hit, ik.occluded_tris_plain(o, d, tmin, tmax, occ))
    assert got[0].requires_grad and not hit.requires_grad
    assert _zero_grad((got[0] + got[2]).sum(), og)

    bscene, _ = get_scene_by_name("Atrium:0.1", cuda)
    o, d, tmin, tmax = chip_smoke._rays(4096, 2, bscene.aabb_min.tolist(),
                                        bscene.aabb_max.tolist(), cuda)
    og = o.clone().requires_grad_()
    got = bk.traverse(bscene.bvh, og, d, tmin, tmax)
    for a, b in zip(got, bk.traverse_plain(bscene.bvh, o, d, tmin, tmax)):
        assert torch.equal(a, b)
    assert torch.equal(bk.traverse_any(bscene.bvh, og, d, tmin, tmax),
                       bk.traverse_any_plain(bscene.bvh, o, d, tmin, tmax))
    assert _zero_grad(got[0].sum(), og)

    grid, q, qn, r = chip_smoke.gather_case(cuda)
    qg = q.clone().requires_grad_()
    u = torch.zeros((2, gk.ROWS + 2), device=cuda)
    before = gk.gather_photons_tiled.launches
    acc, _ = gk.gather_photons_tiled(grid, qg, qn, r, u_rows=u)
    assert gk.gather_photons_tiled.launches == before + 1
    want, _ = gk.gather_photons_tiled(chip_smoke._to(grid, "cpu"), q.cpu(),
                                      qn.cpu(), r, u_rows=u.cpu())
    np.testing.assert_allclose(acc.detach().cpu().numpy(), want.numpy(),
                               rtol=chip_smoke.GATHER_RTOL,
                               atol=chip_smoke.GATHER_ATOL_REL
                               * float(want.abs().max()))
    assert acc.requires_grad and _zero_grad(acc.sum(), qg)

    scene, cfg, k = chip_smoke.vm_case(cuda)
    kd = k["cam_bsdf"].kd.clone().requires_grad_()
    k = dict(k, cam_bsdf=dataclasses.replace(k["cam_bsdf"], kd=kd))
    before = vk.merge_vertices_tiled.launches
    merged = vcm_merge(scene, cfg, k)
    assert vk.merge_vertices_tiled.launches == before + 1
    want = vcm_merge(*(chip_smoke._to(x, "cpu") for x in (
        scene, cfg, dict(k, cam_bsdf=dataclasses.replace(
            k["cam_bsdf"], kd=kd.detach())))))
    np.testing.assert_allclose(merged.detach().cpu().numpy(), want.numpy(),
                               rtol=chip_smoke.VM_RTOL,
                               atol=chip_smoke.VM_ATOL_REL
                               * float(want.abs().max()))
    assert float(merged.detach().sum()) > 0
    assert _zero_grad(merged.sum(), kd)


@pytest.mark.parametrize("method,rel", [
    (RenderMethod.PATH_TRACING, 1e-3),
    (RenderMethod.PROGRESSIVE_PHOTON_MAPPING, 5e-3)])
def test_gradients_on_the_card_match_the_cpu(cuda, method, rel):
    """The kd gradient of one 32^2 iteration (PPM: the tile gather, B3's
    zero gradient) on the card and on the CPU."""
    from oppositerenderer_tpu_torch import diff
    cfg = RenderConfig(width=32, height=32, render_method=method,
                       photons_per_iteration=1 << 12,
                       photon_grid_resolution=16)
    grads = []
    for dev in ("cpu", cuda):
        scene, cam = get_scene_by_name("CornellSmall", dev)
        _, g = diff.render_loss_and_grad(
            lambda s: Renderer(s, cam, cfg, seed=1)._iteration(0, 0.003)[0],
            scene, {("kd", 0): scene.materials.kd[0]})
        grads.append(g[("kd", 0)].cpu().numpy())
    assert (grads[0] > 0).all()
    np.testing.assert_allclose(grads[1], grads[0], rtol=rel)


def test_ppm_with_a_medium_on_the_card_matches_the_cpu(cuda):
    from oppositerenderer_tpu_torch.scene import Medium
    cfg = RenderConfig(width=32, height=32, photons_per_iteration=1 << 12,
                       photon_grid_resolution=16,
                       render_method=RenderMethod.PROGRESSIVE_PHOTON_MAPPING)
    imgs, vols = [], []
    for dev in ("cpu", cuda):
        scene, cam = get_scene_by_name("CornellSmall", dev)
        scene.medium = Medium(
            sigma_s=torch.tensor(0.15, device=dev),
            sigma_a=torch.tensor(0.02, device=dev),
            aabb_min=torch.zeros(3, device=dev),
            aabb_max=torch.full((3,), 2.5, device=dev))
        r = Renderer(scene, cam, cfg, seed=7)
        imgs.append(r.render(1).mean_radiance().cpu().numpy())
        vols.append(r.metrics["volumetric_photons_stored"])
    share, mean_err = chip_smoke.image_agreement(imgs[1], imgs[0])
    assert share >= chip_smoke.PPM_MIN_AGREEING
    assert mean_err <= chip_smoke.PPM_MEAN_RTOL
    assert vols[1] == pytest.approx(vols[0], rel=1e-3) and vols[0] > 0


@pytest.mark.parametrize("structure,min_share", [
    ("STOCHASTIC_HASH", 0.98), ("KD_TREE_CPU", chip_smoke.PPM_MIN_AGREEING)])
def test_photon_maps_on_the_card_match_the_cpu(cuda, structure, min_share):
    """One 32^2 PPM iteration with the stochastic hash or the kd-tree on
    the card against the CPU port: PPM's bar, the hash's share of pixels
    at tests/test_torch_photon_maps.py's (its cells turn last-ulp
    differences of the photons into other slots); neither launches B3."""
    from oppositerenderer_tpu_torch.config import PhotonMapStructure
    cfg = RenderConfig(width=32, height=32, photons_per_iteration=1 << 12,
                       photon_grid_resolution=16,
                       render_method=RenderMethod.PROGRESSIVE_PHOTON_MAPPING,
                       photon_map_structure=PhotonMapStructure[structure])
    imgs = []
    for dev in ("cpu", cuda):
        scene, cam = get_scene_by_name("CornellSmall", dev)
        before = gk.gather_photons_tiled.launches
        imgs.append(Renderer(scene, cam, cfg, seed=7).render(
            1).mean_radiance().cpu().numpy())
        assert gk.gather_photons_tiled.launches == before
    share, mean_err = chip_smoke.image_agreement(imgs[1], imgs[0])
    assert np.isfinite(imgs[1]).all() and imgs[1].mean() > 0
    assert share >= min_share and mean_err <= chip_smoke.PPM_MEAN_RTOL


def test_photon_map_tables_on_the_card_equal_the_cpu_tables(cuda):
    """On the same photons the card's hash table and kd-tree are the CPU's
    bit for bit: each slot's winner is found by a max-reduction, not by
    the order of a racing scatter."""
    from oppositerenderer_tpu_torch import interop
    from oppositerenderer_tpu_torch import photon_map as pm
    from oppositerenderer_tpu_torch.core.rng import make_root_key
    rng = np.random.default_rng(3)
    n = 200_000
    pos = rng.uniform(0.0, 2.0, (n, 3)).astype(np.float32)
    pos[: n // 2] = (1.0 + 0.01 * rng.standard_normal((n // 2, 3))
                     ).astype(np.float32)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    leaves = dict(position=pos, direction=d / np.linalg.norm(
        d, axis=1, keepdims=True), power=rng.uniform(
        size=(n, 3)).astype(np.float32), valid=rng.uniform(size=n) < 0.8)
    tables = []
    for dev in ("cpu", cuda):
        batch = interop.photon_batch_from_numpy(leaves, dev)
        h = pm.build_stochastic_hash(batch, torch.tensor(0.02, device=dev),
                                     16, make_root_key(9))
        t = pm.build_photon_kdtree(batch)
        tables.append([x.cpu() for x in (h.position, h.power, h.direction,
                                         h.count, t.position, t.axis)])
    for a, b in zip(*tables):
        assert torch.equal(a, b)


def test_loaders_put_every_tensor_on_the_card(cuda, tmp_path):
    """Without a device a .dae or .obj scene and its camera land on cuda
    (the BVH's binary node arrays stay on the host by design)."""
    scenes = Path(__file__).resolve().parent.parent / "scenes"
    obj = tmp_path / "quad.obj"
    obj.write_text("v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nf 1 2 3 4\n")

    def tensors(x, path=""):
        if dataclasses.is_dataclass(x):
            for f in dataclasses.fields(x):
                yield from tensors(getattr(x, f.name), f"{path}{f.name}.")
        elif torch.is_tensor(x):
            yield path.rstrip("."), x

    for path in (scenes / "atrium_lite.dae", obj):
        scene, cam = get_scene_by_name(str(path))
        found = dict(tensors(scene)) | dict(tensors(cam, "camera."))
        off = [k for k, v in found.items() if v.device.type != "cuda"
               and not k.startswith("bvh.nodes_")]
        assert not off and len(found) > 20, off
