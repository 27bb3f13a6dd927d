"""The port on the card: each CUDA kernel against its plain version, and
each render path against the goldens, the CPU port and its own eager
route.

These tests need an NVIDIA GPU (sm_90a) and nvcc; without them they skip.
Run them on such a machine with

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

(``--noconftest``: the suite's conftest imports JAX, which these tests do
not need.)
The library is built with --fmad=false, so the intersection kernels (B1,
B2) and the BVH traversal (B5) and their plain versions must agree bit
for bit, as the packet node-step microbenchmark (B6) must, B1, B2 and B5
also on inputs whose lanes are all dead or all
live, B1 on equal t too (the lower index wins),
and B5's live-lane compaction must find the lanes torch.nonzero finds.
The gather kernel (B3) and the vertex-merge kernel (B4) sum the same terms
as their plain versions in another order (a tile's slots in groups):
rtol 1e-4 plus atol 1e-6 * max|ref|, with equal stats and tables.
Through their zero-gradient Functions every kernel keeps these outputs
and gives zero gradients; BSDF.sample picks the CPU's lobes.

The paths: PT (also with a BVH), PPM and VCM renders against the goldens;
PPM (also in a medium and on the other photon maps), VCM+VM, Atrium and
imported scenes against the CPU port; each path's kernel launches per
iteration; gradients against the CPU's, eager and captured, and a descent
that lowers its loss; the captured iteration, sharded step and gradient
against their eager routes, over the rank-less mesh and one NCCL rank;
worker processes sharing the card over gloo; the tooling and the viewer.
The bars and inputs are those of ``tests/_torch_cases.py``, which
``chip_smoke.py``'s kernel table shares.
"""
import dataclasses
import io
import json
import sys
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import _torch_cases  # noqa: E402
from _torch_cases import (GATHER_ATOL_REL, GATHER_RTOL,  # noqa: E402
                          PPM_MEAN_RTOL, PPM_MIN_AGREEING, VM_ATOL_REL,
                          VM_RTOL, _bits_differ, _rays, _to, dead_or_live,
                          image_agreement)
from oppositerenderer_tpu_torch.accel import bvh_kernels as bk  # noqa: E402
from oppositerenderer_tpu_torch.accel import gather_kernels as gk  # noqa
from oppositerenderer_tpu_torch.accel import intersect_kernels as ik
from oppositerenderer_tpu_torch.accel import vm_kernels as vk  # noqa: E402
from oppositerenderer_tpu_torch.accel.intersect import \
    dense_tables  # noqa: E402
from oppositerenderer_tpu_torch.config import (RenderConfig,  # noqa: E402
                                               RenderMethod)
from oppositerenderer_tpu_torch.renderer import Renderer  # noqa: E402
from oppositerenderer_tpu_torch.scene import (SCENE_NAMES,  # noqa: E402
                                             get_scene_by_name)

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
    """[9, T]: T random triangles in a 10-unit box (the kernel table's
    soup)."""
    rng = np.random.default_rng(seed)
    return torch.as_tensor(np.concatenate([
        rng.uniform(0.0, 10.0, (T, 3)).T, rng.normal(0.0, 0.5, (T, 3)).T,
        rng.normal(0.0, 0.5, (T, 3)).T]).astype(np.float32), device=dev)


def lane_rays(n, seed, kind, dev):
    """The kernel table's random rays in the soup's box: mixed, all dead or
    all live lanes."""
    rays = _rays(n, seed, [0.0] * 3, [10.0] * 3, dev)
    return rays if kind == "mixed" else dead_or_live(rays, kind == "all live")


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
        assert _bits_differ(a, b) == 0
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
        assert _bits_differ(x, y) == 0
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


def test_bsdf_sample_on_the_card_matches_the_cpu(cuda):
    """At a PT bounce's 262,144 lanes of random materials (each lobe kind
    present on half the lanes, glass hit from either side), the card picks
    the CPU's component in every lane, with the same specularity and
    validity; f and pdf_w agree at the render tests' rtol 1e-3."""
    from oppositerenderer_tpu_torch.bsdf import BSDF
    from oppositerenderer_tpu_torch.bsdf import bsdf as tbsdf
    n = 262144
    rng = np.random.default_rng(24)
    dirs = rng.normal(size=(2, n, 3)).astype(np.float32)
    nrm, wi = dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)
    grey = rng.random((n, 4), dtype=np.float32)
    grey *= rng.random((n, 4)) < 0.5
    kd, ks, kr, kt = (np.repeat(grey[:, i:i + 1], 3, axis=1)
                      for i in range(4))
    args = [nrm, nrm.copy(), wi, kd, ks,
            rng.uniform(1.0, 100.0, n).astype(np.float32), kr, kt,
            rng.uniform(0.6, 1.7, n).astype(np.float32), rng.random(n) < 0.5]
    u3 = rng.random((n, 3), dtype=np.float32)
    pick_lobe, got = tbsdf.pick_lobe, []
    for dev in ("cpu", cuda):
        picks = []

        def spy(w, u0):
            picks.append(pick_lobe(w, u0))
            return picks[-1]

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(tbsdf, "pick_lobe", spy)
            out = BSDF.make(*[torch.as_tensor(a, device=dev)
                              for a in args]).sample(
                torch.as_tensor(u3, device=dev))
        (idx,) = picks
        got.append({"idx": idx, **out._asdict()})
    cpu, card = ({k: v.cpu().numpy() for k, v in g.items()} for g in got)
    assert card["valid"].any() and card["is_specular"].any()
    assert len(np.unique(card["idx"])) == 4
    for k in ("idx", "is_specular", "valid"):
        np.testing.assert_array_equal(card[k], cpu[k], err_msg=k)
    for k in ("f", "pdf_w"):
        assert np.isfinite(card[k]).all()
        agree = np.isclose(card[k], cpu[k], rtol=1e-3, atol=0)
        assert agree.reshape(n, -1).all(axis=-1).mean() >= 0.99, k


@pytest.mark.parametrize("case", ["synthetic", "no_normal", "clustered"])
def test_gather_kernel_matches_plain_version(cuda, case):
    cluster = case == "clustered"
    grid, q, qn, r = _torch_cases.gather_case(
        cuda, n_photons=8192 if cluster else 4096, cluster=cluster,
        radius=0.2 if cluster else 0.12)
    u = torch.rand((2, gk.ROWS + 2), generator=torch.Generator().manual_seed(
        5)).to(cuda) if cluster else torch.zeros((2, gk.ROWS + 2),
                                                  device=cuda)
    before = gk.gather_photons_tiled.launches
    got, gst = gk.gather_photons_tiled(grid, q, qn, r, u_rows=u,
                                       check_normal=case != "no_normal")
    assert gk.gather_photons_tiled.launches == before + 1
    cpu = _to(grid, "cpu")
    want, wst = gk.gather_photons_tiled(cpu, q.cpu(), qn.cpu(), r,
                                        u_rows=u.cpu(),
                                        check_normal=case != "no_normal")
    for k in wst:
        assert torch.equal(gst[k].cpu(), wst[k])
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(),
                               rtol=GATHER_RTOL,
                               atol=GATHER_ATOL_REL
                               * float(want.abs().max()))
    assert (int(gst["photon_subsampled"].sum()) > 0) == cluster


@pytest.mark.parametrize("check_normal", [True, False])
@pytest.mark.parametrize("grid_of", ["surface", "medium", "partial"])
def test_gather_kernel_on_the_ppm_main_shape(cuda, grid_of, check_normal):
    """B3, its slots in SLOT_GROUPS groups, against its plain version on the
    grid and hitpoints of one CornellSmall 512^2 PPM iteration, in the JAX
    package's test medium (the path's surface gather), and on the partial
    grids of a 2-way exchange of its photons, whose sums add up to the
    whole grid's (the summed power within 1%: a row over 256 photons takes
    another block in a partial grid)."""
    grid, q, qn, r, u, valid = _torch_cases.ppm_gather_inputs(
        cuda, medium=grid_of == "medium")
    r2 = torch.square(torch.as_tensor(r, dtype=torch.float32, device=cuda))
    total = 0.0
    parts = _torch_cases.partial_grids(grid) if grid_of == "partial" else [
        grid]
    for part in parts:
        starts, lens, weights, _, _, rows = gk._tile_tables(part, q, r, u,
                                                            valid)
        args = (starts, lens, weights, rows, r2, q, qn, part, check_normal)
        got = gk.gather_photons_tiled_kernel(*args)
        want = gk.gather_photons_tiled_plain(*args)
        assert float(want.abs().max()) > 0.0
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   rtol=GATHER_RTOL,
                                   atol=GATHER_ATOL_REL
                                   * float(want.abs().max()))
        total = total + got.double().sum()
    if grid_of == "partial" and check_normal:
        whole = gk.gather_photons_tiled(grid, q, qn, r, u_rows=u,
                                        valid=valid)[0]
        assert float(total) == pytest.approx(float(whole.double().sum()),
                                             rel=0.01)


def render_counting(r, iterations, wrappers):
    """(film, launches per wrapper) of ``r.render(iterations)``: the
    wrappers' own counts (eager iterations: the first of a capture) plus
    the renderer's graph replays (capture counts x replays)."""
    def counts():
        graph = r.kernel_launches()
        return [w.launches + graph.get(w.__name__, 0) for w in wrappers]

    before = counts()
    film = r.render(iterations)
    return film, [a - b for a, b in zip(counts(), before)]


RENDER_WRAPPERS = (ik.closest_hit_tris, ik.occluded_tris,
                   gk.gather_photons_tiled, vk.merge_vertices_tiled,
                   bk.traverse, bk.traverse_any)


def launches_per_iteration(cfg, bvh: bool = False) -> list:
    """RENDER_WRAPPERS' launches in one iteration of ``cfg``: a closest hit
    per PT segment, per PPM eye and photon bounce, per VCM light and
    camera bounce; an any hit per PT shadow sample, per PPM direct shadow
    sample, per VCM light bounce (its t=1 splats) and camera bounce (its
    s=1 sample and vertex connections together); one gather on PPM's grid;
    a merge per camera bounce with vertex merging. On a scene with a BVH,
    B5 takes B1's and B2's calls."""
    from oppositerenderer_tpu_torch.config import PhotonMapStructure
    gather = merge = 0
    if cfg.render_method == RenderMethod.PATH_TRACING:
        closest = cfg.pt_max_segments
        shadow = closest * cfg.pt_shadow_samples
    elif cfg.render_method == RenderMethod.PROGRESSIVE_PHOTON_MAPPING:
        closest = cfg.max_radiance_trace_depth + cfg.max_photon_trace_depth
        shadow = cfg.ppm_direct_shadow_samples
        gather = int(cfg.photon_map_structure
                     == PhotonMapStructure.SORTED_UNIFORM_GRID)
    else:
        L = cfg.vcm_max_path_length
        closest, shadow = 2 * L - 1, (L - 1) + L
        merge = L if cfg.vcm_use_vm else 0
    dense, walked = ((0, 0), (closest, shadow)) if bvh else (
        (closest, shadow), (0, 0))
    return [*dense, gather, merge, *walked]


SMALL = dict(width=32, height=32)
CPU_RUNS = {   # case: (scene, configuration, seed, iterations, pixel bar)
    "pt": ("CornellSmall", lambda: RenderConfig(**SMALL), 1, 2, False),
    "ppm": ("CornellSmall", lambda: RenderConfig(
        **SMALL, photons_per_iteration=1 << 12, photon_grid_resolution=16,
        render_method=RenderMethod.PROGRESSIVE_PHOTON_MAPPING), 1, 2, False),
    "vcm_vm": ("CornellSmall", lambda: RenderConfig(
        **SMALL, vcm_max_path_length=4, photon_grid_resolution=16,
        vcm_use_vm=True,
        render_method=RenderMethod.VCM_BIDIRECTIONAL_PATH_TRACING), 1, 2,
        False),
    "pt_bvh": ("Atrium:0.1", lambda: RenderConfig(**SMALL), 1, 2, True),
    "ppm_golden": ("CornellSmall", _torch_cases.golden_ppm_config,
                   _torch_cases.GOLDEN_SEED, 1, True),
    "vcm_vm_golden": ("CornellSmall",
                      lambda: _torch_cases.golden_vcm_config().replace(
                          vcm_use_vm=True), _torch_cases.GOLDEN_SEED, 1, True),
    "atrium": ("Atrium", lambda: RenderConfig(width=64, height=64),
               _torch_cases.GOLDEN_SEED, 1, True),
}


@pytest.mark.parametrize("case", sorted(CPU_RUNS))
def test_render_on_the_card_matches_the_cpu_render(cuda, case):
    """A render on the card and on the CPU (the plain versions): PT, PPM and
    VCM+VM at 32^2 (L = 4), PT on Atrium at a tenth of its detail (a BVH),
    one 64^2 iteration of PPM and VCM+VM at their golden configurations and
    of PT on full Atrium (253,508 triangles). Each kernel's launches per
    iteration on the card, none on the CPU; the image means within 1e-3
    and, where the case holds the pixel bar, PPM's: 99% of the pixels
    within rtol 1e-3 (the same streams on two devices, up to float
    rounding and the order of atomic adds)."""
    name, make_cfg, seed, iters, pixels = CPU_RUNS[case]
    cfg = make_cfg()
    imgs, launched = [], {}
    for dev in (cuda, "cpu"):
        scene, cam = get_scene_by_name(name, dev)
        film, launched[str(dev)] = render_counting(
            Renderer(scene, cam, cfg, seed=seed), iters, RENDER_WRAPPERS)
        imgs.append(film.mean_radiance().cpu().numpy())
    assert not any(launched["cpu"])
    assert launched[str(cuda)] == [iters * n for n in launches_per_iteration(
        cfg, bvh=scene.bvh is not None)]
    share, mean_err = image_agreement(*imgs)
    assert np.isfinite(imgs[0]).all() and float(imgs[1].mean()) > 0.0
    assert mean_err <= PPM_MEAN_RTOL
    if pixels:
        assert share >= PPM_MIN_AGREEING


@pytest.mark.parametrize("cluster", [False, True])
def test_vm_kernel_matches_plain_version(cuda, cluster):
    scene, cfg, k = _torch_cases.vm_case(cuda, 0, cluster)
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
            g.cpu().numpy(), w.cpu().numpy(), rtol=VM_RTOL,
            atol=VM_ATOL_REL * float(w.abs().max()))
    assert float(want[0].abs().max()) > 0.0
    # the whole merge round on the card against the CPU's
    merged = vcm_merge(scene, cfg, k)
    cpu = vcm_merge(*(_to(x, "cpu") for x in (scene, cfg, k)))
    np.testing.assert_allclose(merged.cpu().numpy(), cpu.numpy(),
                               rtol=VM_RTOL,
                               atol=VM_ATOL_REL
                               * float(cpu.abs().max()))


def vcm_merge(scene, cfg, k):
    from oppositerenderer_tpu_torch.integrators import vcm
    return vcm._merge_vertices(
        scene, cfg, k["cam_bsdf"], k["cam_pos"], k["cam_thr"],
        k["cam_dVCM"], k["cam_dVM"], k["active"], k["vgrid"],
        k["radius_sq"], k["mis_vc_w"], k["n_light_paths"], k["u_stride"],
        k["depth1"])


@pytest.mark.parametrize("name", ["Atrium:0.25", "Conference:0.15"])
@pytest.mark.parametrize("n", [131, 65536])
def test_bvh_kernels_equal_plain_versions(cuda, name, n):
    scene, _ = get_scene_by_name(name, cuda)
    o, d, tmin, tmax = _rays(n, n + 7, scene.aabb_min.tolist(),
                                        scene.aabb_max.tolist(), cuda)
    before = bk.traverse.launches
    got = bk.traverse(scene.bvh, o, d, tmin, tmax)
    assert bk.traverse.launches == before + 1
    want = bk.traverse_plain(scene.bvh, o, d, tmin, tmax)
    for a, b in zip(got, want):
        assert _bits_differ(a, b) == 0
    dead = ~(tmax > tmin)
    assert not bool(got[4][dead].any()) and bool(got[4].any())
    assert torch.equal(bk.traverse_any(scene.bvh, o, d, tmin, tmax),
                       bk.traverse_any_plain(scene.bvh, o, d, tmin, tmax))


def test_bvh_wrapper_rejects_bad_inputs(cuda):
    scene, _ = get_scene_by_name("Atrium:0.1", cuda)
    o, d, tmin, tmax = rays(64, 0, cuda)
    with pytest.raises(ValueError, match="float32"):
        bk.traverse(scene.bvh, o.double(), d, tmin, tmax)
    deep = dataclasses.replace(scene.bvh,
                               max_stack=bk.KERNEL_MAX_STACK + 1)
    with pytest.raises(ValueError, match="stack"):
        bk.traverse_any(deep, o, d, tmin, tmax)


@pytest.mark.parametrize("kind", ["all dead", "all live"])
def test_bvh_kernels_on_all_dead_and_all_live_lanes(cuda, kind):
    scene, _ = get_scene_by_name("Atrium:0.25", cuda)
    o, d, tmin, tmax = _rays(65536, 11, scene.aabb_min.tolist(),
                                        scene.aabb_max.tolist(), cuda)
    if kind == "all dead":
        tmax = torch.where(torch.arange(tmax.shape[0], device=cuda) % 2 == 0,
                           tmin, tmin - 1.0)
    else:
        tmax = torch.where(tmax > tmin, tmax, 1e30)
    got = bk.traverse(scene.bvh, o, d, tmin, tmax)
    want = bk.traverse_plain(scene.bvh, o, d, tmin, tmax)
    for a, b in zip(got, want):
        assert _bits_differ(a, b) == 0
    assert bool(got[4].any()) == (kind == "all live")
    assert torch.equal(bk.traverse_any(scene.bvh, o, d, tmin, tmax),
                       bk.traverse_any_plain(scene.bvh, o, d, tmin, tmax))


@pytest.mark.parametrize("p_live", [0.0, 0.2, 1.0])
def test_live_lane_compaction_matches_nonzero(cuda, p_live):
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
    o, d, tmin, tmax = _rays(4096, 2, bscene.aabb_min.tolist(),
                                        bscene.aabb_max.tolist(), cuda)
    og = o.clone().requires_grad_()
    got = bk.traverse(bscene.bvh, og, d, tmin, tmax)
    for a, b in zip(got, bk.traverse_plain(bscene.bvh, o, d, tmin, tmax)):
        assert torch.equal(a, b)
    assert torch.equal(bk.traverse_any(bscene.bvh, og, d, tmin, tmax),
                       bk.traverse_any_plain(bscene.bvh, o, d, tmin, tmax))
    assert _zero_grad(got[0].sum(), og)

    grid, q, qn, r = _torch_cases.gather_case(cuda)
    qg = q.clone().requires_grad_()
    u = torch.zeros((2, gk.ROWS + 2), device=cuda)
    before = gk.gather_photons_tiled.launches
    acc, _ = gk.gather_photons_tiled(grid, qg, qn, r, u_rows=u)
    assert gk.gather_photons_tiled.launches == before + 1
    want, _ = gk.gather_photons_tiled(_to(grid, "cpu"), q.cpu(),
                                      qn.cpu(), r, u_rows=u.cpu())
    np.testing.assert_allclose(acc.detach().cpu().numpy(), want.numpy(),
                               rtol=GATHER_RTOL,
                               atol=GATHER_ATOL_REL
                               * float(want.abs().max()))
    assert acc.requires_grad and _zero_grad(acc.sum(), qg)

    scene, cfg, k = _torch_cases.vm_case(cuda)
    kd = k["cam_bsdf"].kd.clone().requires_grad_()
    k = dict(k, cam_bsdf=dataclasses.replace(k["cam_bsdf"], kd=kd))
    before = vk.merge_vertices_tiled.launches
    merged = vcm_merge(scene, cfg, k)
    assert vk.merge_vertices_tiled.launches == before + 1
    want = vcm_merge(*(_to(x, "cpu") for x in (
        scene, cfg, dict(k, cam_bsdf=dataclasses.replace(
            k["cam_bsdf"], kd=kd.detach())))))
    np.testing.assert_allclose(merged.detach().cpu().numpy(), want.numpy(),
                               rtol=VM_RTOL,
                               atol=VM_ATOL_REL
                               * float(want.abs().max()))
    assert float(merged.detach().sum()) > 0
    assert _zero_grad(merged.sum(), kd)


def grad_config(method: str) -> RenderConfig:
    """32^2 configurations of the gradient's paths: PT, PPM (the tile
    gather: B3's zero gradient; also with 1<<12 photons on a 16^3 grid), VCM at L = 4 with the continuation pinned
    to 1, and VCM+VM (the tile merge: B4's zero gradient)."""
    base = dict(width=32, height=32)
    vcm = dict(base, vcm_max_path_length=4,
               render_method=RenderMethod.VCM_BIDIRECTIONAL_PATH_TRACING)
    return {"pt": lambda: RenderConfig(**base),
            "ppm": lambda: RenderConfig(
                **base, photons_per_iteration=1 << 14,
                render_method=RenderMethod.PROGRESSIVE_PHOTON_MAPPING),
            "ppm_grid16": lambda: RenderConfig(
                **base, photons_per_iteration=1 << 12,
                photon_grid_resolution=16,
                render_method=RenderMethod.PROGRESSIVE_PHOTON_MAPPING),
            "vcm": lambda: RenderConfig(**vcm,
                                        vcm_force_continuation_prob=1.0),
            "vcm_vm": lambda: RenderConfig(**vcm, vcm_use_vm=True)}[method]()


@pytest.mark.parametrize("method,param,seed", [
    ("pt", "kd", 0), ("pt", "emission_scale", 0), ("ppm", "kd", 0),
    ("vcm", "kd", 0), ("vcm_vm", "emission_scale", 0), ("pt", "kd", 1),
    ("ppm_grid16", "kd", 1)])
def test_gradients_on_the_card_match_the_cpu(cuda, method, param, seed):
    """The gradient of one 32^2 iteration's mean image (seed 0; PT's and
    the 16^3 grid's kd also at seed 1) with respect to kd of material 0 (a
    wall) or the emission scale on the card against the CPU's (rel 1e-3 for PT, 5e-3 else): through the eager
    ``diff.render_loss_and_grad`` and through the captured
    ``diff.make_sharded_loss_and_grad`` over the rank-less mesh, a replay
    of the graph of forward and backward."""
    from oppositerenderer_tpu_torch import diff
    from oppositerenderer_tpu_torch.core.rng import make_root_key
    from oppositerenderer_tpu_torch.parallel import make_mesh
    cfg = grad_config(method)
    rel = _torch_cases.GRAD_RTOL[method.split("_")[0]]
    scene, cam = get_scene_by_name("CornellSmall", "cpu")
    _, want = _torch_cases.loss_and_grad(scene, cam, cfg, param, seed)
    scene, cam = get_scene_by_name("CornellSmall", cuda)
    _, eager = _torch_cases.loss_and_grad(scene, cam, cfg, param, seed)
    start = scene.materials.kd[0] if param == "kd" else 1.0
    fn = diff.make_sharded_loss_and_grad(scene, cam, cfg,
                                         make_mesh(1, device=cuda),
                                         {(param, 0): start})
    args = dict(iteration=0, key=make_root_key(seed),
                radius_sq=_torch_cases.GRAD_R2)
    fn(**args)                                   # eager, then the capture
    _, grads = fn(**args)                        # a replay
    assert fn.captured.replays == 1
    assert bool((want > 0).all())
    for got in (eager, grads[(param, 0)].detach().cpu().double()):
        assert bool(torch.isfinite(got).all())
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=rel)


def test_gradient_descent_on_the_card_lowers_the_loss(cuda):
    """Three steps of gradient descent (the Polyak step: the loss's
    minimum is 0) on the wall's kd toward a target rendered at 0.8 kd with
    the same seed, PT 64^2, eager: the loss falls at every step."""
    from oppositerenderer_tpu_torch import diff
    scene, cam = get_scene_by_name("CornellSmall", cuda)
    cfg = RenderConfig(width=64, height=64)
    kd = scene.materials.kd[0].clone()

    def render(s):
        return Renderer(s, cam, cfg, seed=0)._iteration(
            0, _torch_cases.GRAD_R2)[0]

    with torch.no_grad():
        target = render(diff.set_material_param(scene, "kd", 0, kd * 0.8))
    losses = []
    for step in range(4):
        x = kd.clone().requires_grad_(True)
        loss = torch.mean(torch.square(
            render(diff.set_material_param(scene, "kd", 0, x)) - target))
        (g,) = torch.autograd.grad(loss, x)
        losses.append(float(loss.detach()))
        kd = kd - (loss.detach() / torch.sum(g * g)) * g
    assert all(b < a for a, b in zip(losses, losses[1:])), losses


def test_ppm_with_a_medium_on_the_card_matches_the_cpu(cuda):
    """One PPM iteration in the JAX package's test medium on the card and
    on the CPU: PPM's pixel bar, the volumetric photons stored within
    0.1%, and the launches of PPM without a medium (the volume gather is
    the budgeted gather in torch: no kernel)."""
    cfg = RenderConfig(width=32, height=32, photons_per_iteration=1 << 12,
                       photon_grid_resolution=16,
                       render_method=RenderMethod.PROGRESSIVE_PHOTON_MAPPING)
    imgs, vols = [], []
    for dev in ("cpu", cuda):
        scene, cam = get_scene_by_name("CornellSmall", dev)
        scene.medium = _torch_cases.scene_medium(dev)
        r = Renderer(scene, cam, cfg, seed=7)
        film, counts = render_counting(r, 1, RENDER_WRAPPERS)
        imgs.append(film.mean_radiance().cpu().numpy())
        vols.append(r.metrics["volumetric_photons_stored"])
    assert counts == launches_per_iteration(cfg)
    share, mean_err = image_agreement(imgs[1], imgs[0])
    assert share >= PPM_MIN_AGREEING
    assert mean_err <= PPM_MEAN_RTOL
    assert vols[1] == pytest.approx(
        vols[0], rel=_torch_cases.MEDIA_STORED_RTOL) and vols[0] > 0


@pytest.mark.parametrize("structure,min_share", [
    ("STOCHASTIC_HASH", 0.98), ("KD_TREE_CPU", PPM_MIN_AGREEING)])
def test_photon_maps_on_the_card_match_the_cpu(cuda, structure, min_share):
    """One 32^2 PPM iteration with the stochastic hash or the kd-tree on
    the card against the CPU port: PPM's bar, the hash's share of pixels
    at tests/test_torch_photon_maps.py's (its cells turn last-ulp
    differences of the photons into other slots); each iteration launches
    B1 and B2 as on the grid, and neither B3."""
    from oppositerenderer_tpu_torch.config import PhotonMapStructure
    cfg = RenderConfig(width=32, height=32, photons_per_iteration=1 << 12,
                       photon_grid_resolution=16,
                       render_method=RenderMethod.PROGRESSIVE_PHOTON_MAPPING,
                       photon_map_structure=PhotonMapStructure[structure])
    imgs = []
    for dev in ("cpu", cuda):
        scene, cam = get_scene_by_name("CornellSmall", dev)
        film, counts = render_counting(Renderer(scene, cam, cfg, seed=7), 1,
                                       RENDER_WRAPPERS)
        imgs.append(film.mean_radiance().cpu().numpy())
    assert counts == launches_per_iteration(cfg)
    share, mean_err = image_agreement(imgs[1], imgs[0])
    assert np.isfinite(imgs[1]).all() and imgs[1].mean() > 0
    assert share >= min_share and mean_err <= PPM_MEAN_RTOL


def test_photon_map_tables_on_the_card_equal_the_cpu_tables(cuda):
    """On the same photons the card's hash table and kd-tree are the CPU's
    bit for bit: each slot's winner is found by a max-reduction, not by
    the order of a racing scatter; the kd-tree's host stage (copies and a
    host function in stream order) gives the CPU builder's permutation,
    eagerly and replayed from a CUDA graph on other photons."""
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
    # the stage alone, eager and captured, against the CPU builder
    pos_d = torch.as_tensor(pos, device=cuda)
    valid_d = torch.as_tensor(leaves["valid"], device=cuda)
    stage = pm.kd_host_stage(cuda, n)
    perm, axis = stage.enqueue(pos_d, valid_d)
    want = pm._host_build(torch.as_tensor(pos),
                          torch.as_tensor(leaves["valid"]))
    assert torch.equal(perm.cpu(), want[0])
    assert torch.equal(axis.cpu(), want[1])
    assert stage.fields.n_valid == int(leaves["valid"].sum())
    assert stage.build_seconds > 0.0
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        gperm, gaxis = stage.enqueue(pos_d, valid_d)
        got = (gperm.clone(), gaxis.clone())
    moved = pos[::-1].copy()
    pos_d.copy_(torch.as_tensor(moved))
    valid_d.copy_(torch.as_tensor(leaves["valid"][::-1].copy()))
    graph.replay()
    torch.cuda.synchronize()
    want = pm._host_build(torch.as_tensor(moved),
                          torch.as_tensor(leaves["valid"][::-1].copy()))
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])


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


def exchange_draws(cfg, scene, device_keys: bool) -> dict:
    """The RNG launches a sharded step makes beyond the unsharded
    iteration's: PPM's all-to-all exchange draws its subsampling offset,
    ``rng.uniform`` of a fold of the estimate key (``parallel/render.py``;
    a second for the volume photons in a medium), the fold a launch too
    where the keys are device tensors."""
    from oppositerenderer_tpu_torch.config import PhotonExchange
    n = 0
    if cfg.render_method == RenderMethod.PROGRESSIVE_PHOTON_MAPPING and \
            cfg.photon_exchange == PhotonExchange.ALL_TO_ALL:
        n = 1 if scene.medium is None else 2
    return {"threefry_uniform": n, "threefry_words": n if device_keys else 0}


@pytest.mark.parametrize("name", ["ppm_all_to_all", "vcm_vm"])
def test_sharded_step_over_a_gloo_rank_on_the_card(cuda, name):
    """The sharded step over a one-rank gloo group with the scene on the
    card: every collective carries its CUDA tensors through explicit host
    copies, B3 runs on the exchange's partial grid and B4 on the whole
    image's tiles, with the unsharded launches and the exchange's draw
    (``exchange_draws``), and the band equals the
    unsharded iteration (PPM bit for bit; VCM+VM within rtol 1e-5 + 1e-6
    max|ref|: its t=1 splats add atomically)."""
    import datetime

    import torch.distributed as dist

    from oppositerenderer_tpu_torch.core.rng import make_root_key
    from oppositerenderer_tpu_torch.parallel import (make_mesh,
                                                     make_sharded_render_fn)
    from oppositerenderer_tpu_torch.parallel.worker import (
        case_scene, config_from, free_port, kernel_wrappers,
        render_unsharded, sharding_cases)
    case = next(c for c in sharding_cases(64) if c["name"] == name)
    dist.init_process_group("gloo", init_method="tcp://127.0.0.1:"
                            f"{free_port()}", world_size=1, rank=0,
                            timeout=datetime.timedelta(seconds=120))
    try:
        mesh = make_mesh(device=cuda)
        assert (mesh.backend, mesh.group is not None) == ("gloo", True)
        scene, cam = case_scene(case, cuda)
        step = make_sharded_render_fn(scene, cam, config_from(case["cfg"]),
                                      mesh)
        counts = []
        for fn in (lambda: step(case["iteration"],
                                make_root_key(case["seed"]),
                                case["radius_sq"])[0],
                   lambda: render_unsharded(case, cuda)[0]):
            for w in kernel_wrappers():
                w.launches = 0
            counts.append((fn(), [w.launches for w in kernel_wrappers()]))
    finally:
        dist.destroy_process_group()
    (band, sharded), (want, unsharded) = counts
    extra = exchange_draws(config_from(case["cfg"]), scene, False)
    assert sharded == [u + extra.get(w.__name__, 0) for w, u in
                       zip(kernel_wrappers(), unsharded)]
    assert sharded[2 if name.startswith("ppm") else 3] > 0
    if name.startswith("ppm"):
        assert torch.equal(band, want)
    else:
        torch.testing.assert_close(band, want, rtol=1e-5,
                                   atol=1e-6 * float(want.abs().max()))


@pytest.mark.parametrize("steps,tiles,rows", [(64, 64, 48 * 1024),
                                              (16, 528, 48 * 1024),
                                              (9, 3, 97)])
def test_packet_steps_kernel_equals_plain_version(cuda, steps, tiles, rows):
    from oppositerenderer_tpu_torch.accel import packet_exp_kernels as pk
    from oppositerenderer_tpu_torch.scripts.packet_kernel_exp import \
        make_inputs
    table, o, d = make_inputs(rows, tiles, cuda)
    d[0, 0, 0, :] = -1e-13          # clamped to +1e-12 by both
    for variant in pk.VARIANTS:
        before = pk.packet_steps.launches
        got = pk.packet_steps(table, o, d, steps, variant)
        torch.cuda.synchronize()
        assert pk.packet_steps.launches == before + 1
        want = pk.plain_packet_steps(table, o, d, steps, variant)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32)), \
            variant


def test_packet_steps_cluster_rule_and_refusals(cuda):
    from oppositerenderer_tpu_torch.accel import packet_exp_kernels as pk
    from oppositerenderer_tpu_torch.scripts.packet_kernel_exp import \
        make_inputs
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for tiles in (1, sms // 2, sms // 2 + 1, 528):
        assert pk.cluster_size(tiles, cuda) == (2 if 2 * tiles <= sms else 1)
    table, o, d = make_inputs(64, 2, cuda)
    with pytest.raises(ValueError, match="unknown variant"):
        pk.packet_steps(table, o, d, 1, "fixed_row")
    shifted = torch.empty(64 * 128 + 1, device=cuda)[1:].view(64, 128)
    shifted.copy_(table)
    with pytest.raises(ValueError, match="16-byte"):
        pk.packet_steps(shifted, o, d, 1)

# ---------------------------------------------------------------------------
# the captured iteration (renderer.CapturedStep): one CUDA graph a Renderer
# replays, held against the eager body it captured
# ---------------------------------------------------------------------------

GRAPH_SIZE = 64
# methods whose renders add atomically (VCM's t=1 splats): two renders of
# one image agree at the SHARD_* bar of tests/_torch_cases.py, not bits
ATOMIC = ("vcm", "vcm_vm")


def graph_config(method: str) -> RenderConfig:
    """64^2 configurations of the render paths: PT (also on a BVH scene),
    PPM main on the grid (also in a medium and with the all-gather
    exchange), the hash and the kd-tree, VCM main and VCM+VM main; and
    "ppm_main", PPM main at its own 512^2."""
    from oppositerenderer_tpu_torch.config import (PhotonExchange,
                                                   PhotonMapStructure)
    ppm = _torch_cases.ppm_main_config()
    if method == "ppm_main":
        return ppm
    cfg = {"ppm": ppm, "medium": ppm,
           "hash": ppm.replace(
               photon_map_structure=PhotonMapStructure.STOCHASTIC_HASH),
           "kd": ppm.replace(
               photon_map_structure=PhotonMapStructure.KD_TREE_CPU),
           "ppm_all_gather": ppm.replace(
               photon_exchange=PhotonExchange.ALL_GATHER),
           "vcm": _torch_cases.vcm_main_config(),
           "vcm_vm": _torch_cases.vcm_main_config(True)}.get(
        method, RenderConfig())
    return cfg.replace(width=GRAPH_SIZE, height=GRAPH_SIZE)


def graph_scene(method: str, dev):
    """(scene, camera) of ``graph_config(method)``: CornellSmall, in the
    JAX package's test medium for "medium", and Atrium at a tenth of its
    detail (4,102 triangles behind a BVH) for "bvh"."""
    scene, cam = get_scene_by_name("Atrium:0.1" if method == "bvh"
                                   else "CornellSmall", dev)
    if method == "medium":
        scene = dataclasses.replace(scene,
                                    medium=_torch_cases.scene_medium(dev))
    return scene, cam


def assert_films_agree(got, want, bits: bool):
    """Bit for bit, or (renders that add atomically) at the SHARD_* bar."""
    if bits:
        assert torch.equal(got, want)
        return
    g, w = got.double(), want.double()
    agree = float(torch.isclose(g, w, rtol=_torch_cases.SHARD_PIXEL_RTOL,
                                atol=0.0).all(dim=-1).double().mean())
    assert agree >= _torch_cases.SHARD_MIN_AGREEING
    assert float(g.mean() / w.mean()) == pytest.approx(
        1.0, abs=_torch_cases.SHARD_MEAN_RTOL)


@pytest.mark.parametrize("method", ["pt", "ppm", "kd", "hash", "medium",
                                    "vcm", "vcm_vm", "bvh"])
def test_graph_film_equals_the_eager_film(cuda, method):
    """Each render path at 64^2 (PPM main on the kd-tree: its host build a
    host node of the graph): an eager step with device operands reads
    nothing back (but the kd-tree's, whose eager gather reads a live-lane
    flag by design); the capture launches what an eager iteration on
    device operands launches, and an eager iteration on a host key the
    same but for the key folds, which it makes on the host; the film of
    replays equals the eager body's sums bit for bit (VCM at the SHARD_*
    bar), and the wrappers' counters stay still while the replays render
    (the graph launches the kernels)."""
    from oppositerenderer_tpu_torch.accel import kernel_wrappers
    from oppositerenderer_tpu_torch.core.rng import device_key
    from oppositerenderer_tpu_torch.renderer import ppm_radius_sq_traced
    bits = method not in ATOMIC
    scene, cam = graph_scene(method, cuda)
    cfg = graph_config(method)
    r = Renderer(scene, cam, cfg, seed=0)
    assert r.uses_graph()
    eager = r._build_fused(eager=True)

    def launched(fn):
        counts = [w.launches for w in kernel_wrappers()]
        fn()
        torch.cuda.synchronize()
        return {w.__name__: w.launches - c
                for w, c in zip(kernel_wrappers(), counts)}

    host = launched(lambda: eager(r.camera, 0, r.root_key, 1, 1))
    it = torch.full((), 1, dtype=torch.int64, device=cuda)
    torch.cuda.set_sync_debug_mode(0 if method == "kd" else "error")
    try:
        one = launched(lambda: r._raw_step()(
            r.camera, it, device_key(r.root_key, cuda),
            ppm_radius_sq_traced(r.ppm_initial_radius, cfg.ppm_alpha, it)))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert one["threefry_words"] > host["threefry_words"]
    assert {k: v for k, v in one.items() if k != "threefry_words"} == \
        {k: v for k, v in host.items() if k != "threefry_words"}
    film = r.render(3)
    step = r.captured_step
    assert step.graph is not None and step.replays == 2
    assert step.capture_launches == one
    want, _ = eager(r.camera, 0, r.root_key, 3, 1)
    assert_films_agree(film.accum, want, bits)
    counts = [w.launches for w in kernel_wrappers()]
    film = r.render(2)
    assert [w.launches for w in kernel_wrappers()] == counts
    assert step.replays == 4 and r.captured_step is step
    more, _ = eager(r.camera, 3, r.root_key, 2, 1)
    assert_films_agree(film.accum, want + more, bits)
    assert sum(step.capture_launches.values()) > 0
    # compute_iteration: a replay at the host-scheduled radius
    got, stats = r.compute_iteration(6)
    rad, wstats = r._iteration(6, r._radius_sq(6))
    assert_films_agree(got, rad, bits)
    for k, v in wstats.items():
        assert float(stats[k]) == pytest.approx(float(torch.sum(v)),
                                                rel=0 if bits else 1e-6), k


def test_camera_restart_replays_without_recapture(cuda):
    """A restart with another camera copies it into the captured step's
    buffers and replays the same graph; another size captures anew."""
    scene, cam = get_scene_by_name("CornellSmall", cuda)
    r = Renderer(scene, cam, graph_config("pt"), seed=0)
    r.render(2)
    step, graph = r.captured_step, r.captured_step.graph
    orbited = cam.orbit(*_torch_cases.GRAPH_ORBIT)
    r.restart(camera=orbited)
    film = r.render(2)
    assert r.captured_step is step and step.graph is graph
    assert step.replays == 3
    want, _ = r._build_fused(eager=True)(orbited, 0, r.root_key, 2, 1)
    assert torch.equal(film.accum, want)
    r.restart(cfg=r.cfg.replace(width=32, height=32))
    assert r.render(1).accum.shape == (32, 32, 3)
    assert r.captured_step is not step


def _grads_match(got, want, bits: bool):
    (loss, grads), (wloss, wgrads) = got, want
    pairs = [(loss, wloss)] + [(grads[k], v) for k, v in wgrads.items()]
    for a, b in pairs:
        if bits:
            assert torch.equal(a, b)
        else:
            torch.testing.assert_close(a, b, rtol=1e-5, atol=0.0)


@pytest.mark.parametrize("method", ["pt", "ppm", "vcm"])
def test_captured_gradient_equals_the_eager_one(cuda, method):
    """The sharded loss and gradient over the rank-less mesh at 64^2: the
    replays of the captured forward and backward equal its eager route,
    bit for bit where two eager calls are (else rtol 1e-5), with the
    launches of an eager call on device operands (on a host key the same
    but for the key folds, made on the host) and the wrappers' counters
    still; gradients of earlier calls are not rewritten."""
    from oppositerenderer_tpu_torch import diff
    from oppositerenderer_tpu_torch.accel import kernel_wrappers
    from oppositerenderer_tpu_torch.core.rng import device_key, make_root_key
    from oppositerenderer_tpu_torch.parallel import make_mesh
    scene, cam = get_scene_by_name("CornellSmall", cuda)
    wrt = {("kd", 0): scene.materials.kd[0], ("emission_scale", 0): 1.0}
    fn = diff.make_sharded_loss_and_grad(scene, cam, graph_config(method),
                                         make_mesh(1, device=cuda), wrt)
    args = dict(iteration=2, key=make_root_key(0), radius_sq=0.003)
    first = fn(**args)
    assert fn.captured.graph is not None
    counts = [w.launches for w in kernel_wrappers()]
    e1, e2 = fn.eager(**args), fn.eager(**args)
    eager = {w.__name__: (w.launches - c) // 2
             for w, c in zip(kernel_wrappers(), counts)}
    counts = [w.launches for w in kernel_wrappers()]
    fn.eager(iteration=torch.full((), 2, dtype=torch.int64, device=cuda),
             key=device_key(make_root_key(0), cuda),
             radius_sq=torch.full((), 0.003, device=cuda))
    on_card = {w.__name__: w.launches - c
               for w, c in zip(kernel_wrappers(), counts)}
    assert fn.captured.capture_launches == on_card
    assert on_card["threefry_words"] > eager["threefry_words"]
    assert {k: v for k, v in on_card.items() if k != "threefry_words"} == \
        {k: v for k, v in eager.items() if k != "threefry_words"}
    counts = [w.launches for w in kernel_wrappers()]
    replayed = fn(**args)
    kept = first[1][("kd", 0)].clone()
    moved = fn([wrt[("kd", 0)] * 0.5, 2.0], **args)
    assert [w.launches for w in kernel_wrappers()] == counts
    assert fn.captured.replays == 2
    bits = all(torch.equal(a, b) for a, b in
               [(e1[0], e2[0])] + [(e1[1][k], e2[1][k]) for k in wrt])
    _grads_match(replayed, e1, bits)
    _grads_match(first, e1, bits)
    assert torch.equal(first[1][("kd", 0)], kept)
    _grads_match(moved, fn.eager([wrt[("kd", 0)] * 0.5, 2.0], **args),
                 False)
    assert float(moved[0]) > float(first[0])


@pytest.fixture
def nccl_mesh(cuda):
    """A one-rank NCCL process group in this process and its mesh: the
    collectives run through NCCL, and a capture holds them."""
    import datetime

    import torch.distributed as dist

    from oppositerenderer_tpu_torch.parallel import make_mesh
    from oppositerenderer_tpu_torch.parallel.worker import free_port
    dist.init_process_group(
        "nccl", init_method=f"tcp://127.0.0.1:{free_port()}", world_size=1,
        rank=0, timeout=datetime.timedelta(seconds=300))
    try:
        yield make_mesh(device=cuda)
    finally:
        dist.destroy_process_group()


def one_rank_mesh(request, ranks: str, dev):
    from oppositerenderer_tpu_torch.parallel import make_mesh
    if ranks == "nccl":
        mesh = request.getfixturevalue("nccl_mesh")
        assert mesh.backend == "nccl"
        return mesh
    return make_mesh(1, device=dev)


@pytest.mark.parametrize("method", ["pt", "ppm", "ppm_all_gather",
                                    "vcm_vm", "bvh", "ppm_main"])
@pytest.mark.parametrize("ranks", ["rankless", "nccl"])
def test_captured_sharded_step_equals_the_unsharded_replay(cuda, request,
                                                           ranks, method):
    """The sharded step at 64^2 over the rank-less mesh or one NCCL rank
    (PPM with each exchange; PPM main also at its full 512^2), replayed from its graph and through its
    eager route, equals the unsharded Renderer iteration (itself a
    replay) bit for bit (VCM+VM at the SHARD_* bar), and its stats, which
    the step sums over ranks in float64, within rel 1e-6; the capture
    launches what the unsharded iteration launches and the exchange's
    draw (``exchange_draws``), and the replays call no wrapper."""
    from oppositerenderer_tpu_torch.accel import kernel_wrappers
    from oppositerenderer_tpu_torch.parallel import make_sharded_render_fn
    mesh = one_rank_mesh(request, ranks, cuda)
    bits = method not in ATOMIC
    scene, cam = graph_scene(method, cuda)
    cfg = graph_config(method)
    r = Renderer(scene, cam, cfg, seed=0)
    step = make_sharded_render_fn(scene, cam, cfg, mesh)
    for it in (1, 2):
        step(it, r.root_key, r._radius_sq(it))
        counts = [w.launches for w in kernel_wrappers()]
        band, stats = step(it, r.root_key, r._radius_sq(it))
        assert [w.launches for w in kernel_wrappers()] == counts
        want, wstats = r.compute_iteration(it)
        eager, _ = step.eager(it, r.root_key, r._radius_sq(it))
        for got in (band, eager):
            assert_films_agree(torch.where(torch.isfinite(got), got, 0.0)
                               .reshape(want.shape), want, bits)
        for k in stats.keys() & wstats.keys():   # summed in float64
            assert float(stats[k]) == pytest.approx(float(wstats[k]),
                                                    rel=1e-6), k
    assert step.captured.replays == 3
    assert sum(step.captured.capture_launches.values()) > 0
    extra = exchange_draws(cfg, scene, True)
    assert step.captured.capture_launches == {
        k: v + extra.get(k, 0)
        for k, v in r.captured_step.capture_launches.items()}


@pytest.mark.parametrize("method,param", [("pt", "kd"),
                                          ("ppm", "emission_scale")])
def test_captured_sharded_gradient_over_an_nccl_rank(cuda, nccl_mesh, method,
                                                     param):
    """The sharded loss and gradient over one NCCL rank at 64^2 (PT d/dkd
    of material 0, PPM main with the all-to-all exchange d/demission
    scale: the collectives' backward in the graph), replayed and through
    its eager route, against the unsharded gradient (rel 5e-3)."""
    from oppositerenderer_tpu_torch import diff
    from oppositerenderer_tpu_torch.core.rng import make_root_key
    from oppositerenderer_tpu_torch.integrators import ppm, pt
    scene, cam = get_scene_by_name("CornellSmall", cuda)
    cfg = graph_config(method)
    key = make_root_key(0)
    wrt = {(param, 0): scene.materials.kd[0] if param == "kd" else 1.0}
    fn = diff.make_sharded_loss_and_grad(scene, cam, cfg, nccl_mesh, wrt)
    args = dict(iteration=0, key=key, radius_sq=_torch_cases.GRAD_R2)
    fn(**args)                                   # eager, then the capture
    got = [fn(**args), fn.eager(**args)]
    assert fn.captured.replays == 1

    def render(s):
        if method == "pt":
            return pt.render_iteration(s, cam, cfg, 0, key)
        return ppm.render_iteration(s, cam, cfg, 0, key,
                                    _torch_cases.GRAD_R2)[0]

    _, want = diff.render_loss_and_grad(render, scene, wrt)
    want = want[(param, 0)].double().cpu()
    assert bool((want > 0).all())
    for _, grads in got:
        np.testing.assert_allclose(grads[(param, 0)].double().cpu().numpy(),
                                   want.numpy(), rtol=5e-3)


def test_a_capture_that_reads_a_host_value_raises(cuda):
    """No fallback: a step that reads a value back to the host renders its
    eager first iteration, and its capture raises."""
    scene, cam = get_scene_by_name("CornellSmall", cuda)
    r = Renderer(scene, cam, RenderConfig(width=32, height=32), seed=0)
    raw = r._raw_step()

    def reads_the_host(camera, iteration, key, radius_sq):
        rad, stats = raw(camera, iteration, key, radius_sq)
        if float(rad.sum()) < 0.0:
            rad = -rad
        return rad, stats

    r._raw_step = lambda: reads_the_host
    with pytest.raises(RuntimeError):
        r.render(2)
    assert r.captured_step.graph is None
    torch.cuda.synchronize()
    assert float(torch.ones(4, device=cuda).sum()) == 4.0


# ---------------------------------------------------------------------------
# the row sums (csrc/rows.cu): the backward of the table-row gather
# ---------------------------------------------------------------------------

ROW_LANES = 262144


def row_lanes(pattern, m, seed=3):
    """[ROW_LANES] int64 rows: all on one row, a few rows in skewed shares
    (some as negative indices), or uniform over the m rows."""
    rng = np.random.default_rng(seed)
    if pattern == "one row":
        idx = np.full(ROW_LANES, m // 2)
    elif pattern == "skewed":
        few = rng.choice(m, size=min(m, 4), replace=False)
        share = np.array([0.6, 0.25, 0.1, 0.05])[:few.size]
        idx = rng.choice(few, size=ROW_LANES, p=share / share.sum())
        idx[::101] -= m
    else:
        idx = rng.integers(0, m, ROW_LANES)
    return torch.as_tensor(idx.astype(np.int64))


@pytest.mark.parametrize("pattern", ["one row", "skewed", "uniform"])
@pytest.mark.parametrize("m", [1, 6, 64, 1000])
@pytest.mark.parametrize("c", [1, 3])
def test_row_kernel_matches_plain_version(cuda, c, m, pattern):
    """At the PT gradient's 262,144 lanes: within rtol 1e-5 of the plain
    version (the sums run in another order), which sums in float64 here:
    in float32 its serial sums over a row's lanes are themselves up to
    1.3e-5 off the exact sums at these shapes; rows no lane holds exactly
    zero; two calls equal bit for bit, one launch each."""
    from oppositerenderer_tpu_torch.accel import row_kernels as rk
    idx = row_lanes(pattern, m)
    rng = np.random.default_rng(m + c)
    g = torch.as_tensor(rng.uniform(0.5, 1.5, (ROW_LANES, c))
                        .astype(np.float32)).reshape((ROW_LANES,)
                                                     + (c,) * (c > 1))
    gd, idxd = g.to(cuda), idx.to(cuda)
    before = rk.sum_rows.launches
    got = rk.sum_rows(idxd, gd, m)
    again = rk.sum_rows(idxd, gd, m)
    assert rk.sum_rows.launches == before + 2
    assert got.shape == (m,) + g.shape[1:] and torch.equal(got, again)
    want = rk.sum_rows_plain(idxd, gd.double(), m)
    torch.testing.assert_close(got.double(), want, rtol=1e-5, atol=0.0)
    assert not got[want == 0].any()


def test_row_kernel_at_and_above_its_shared_memory(cuda):
    """The largest table the warps' copies fit (past the default 48 KB of
    shared memory) against its plain version; one row more, or five
    values a row, raises and launches nothing."""
    from oppositerenderer_tpu_torch.accel import row_kernels as rk
    m = rk.MAX_TABLE_FLOATS // 3
    idx = row_lanes("uniform", m).to(cuda)
    g = torch.as_tensor(np.random.default_rng(7).random((ROW_LANES, 3),
                                                        np.float32),
                        device=cuda)
    torch.testing.assert_close(rk.sum_rows(idx, g, m).double(),
                               rk.sum_rows_plain(idx, g.double(), m),
                               rtol=1e-5, atol=0.0)
    before = rk.sum_rows.launches
    with pytest.raises(ValueError, match="shared memory"):
        rk.sum_rows(idx, g, m + 1)
    with pytest.raises(ValueError, match="1 to 4"):
        rk.sum_rows(idx, torch.ones((ROW_LANES, 5), device=cuda), 6)
    assert rk.sum_rows.launches == before


def test_pt_gradient_launches_one_row_sum_a_grad_gather(cuda, monkeypatch):
    """One 64^2 PT gradient (kd and the emission scale): on the card one
    row-sum launch for each backward of a gather of a field that requires
    grad (a gather whose rows reach the loss), as many as the CPU's plain
    row sums, and no plain row sum."""
    from oppositerenderer_tpu_torch import diff
    from oppositerenderer_tpu_torch.accel import row_kernels as rk
    from oppositerenderer_tpu_torch.core import rows
    gathers, plain = [], []
    apply, sum_plain = rows.GatherRows.apply, rk.sum_rows_plain
    monkeypatch.setattr(rows.GatherRows, "apply",
                        lambda *a: gathers.append(1) or apply(*a))
    monkeypatch.setattr(rk, "sum_rows_plain",
                        lambda *a: plain.append(1) or sum_plain(*a))
    counts = {}
    for dev in ("cpu", cuda):
        scene, cam = get_scene_by_name("CornellSmall", dev)
        gathers.clear(), plain.clear()
        before = rk.sum_rows.launches
        _, grads = diff.render_loss_and_grad(
            lambda s: Renderer(s, cam, RenderConfig(width=64, height=64),
                               seed=1)._iteration(0, 0.003)[0],
            scene, {("kd", 0): scene.materials.kd[0],
                    ("emission_scale", 0): 1.0})
        assert float(grads[("emission_scale", 0)]) > 0
        counts[str(dev)] = (len(gathers), len(plain),
                            rk.sum_rows.launches - before)
    n_gathers, n_plain, none = counts["cpu"]
    assert none == 0 and 10 <= n_plain <= n_gathers
    assert counts[str(cuda)] == (n_gathers, 0, n_plain)


# ---------------------------------------------------------------------------
# the render paths against the goldens and against the CPU port
# ---------------------------------------------------------------------------

GOLDEN_RUNS = {   # method: (configuration, iterations, the golden's key)
    "pt": (_torch_cases.golden_pt_config, _torch_cases.GOLDEN_ITERS, "pt"),
    "pt_bvh": (_torch_cases.golden_pt_config, _torch_cases.GOLDEN_ITERS,
               "pt"),
    "ppm": (_torch_cases.golden_ppm_config, _torch_cases.GOLDEN_PPM_ITERS,
            "ppm"),
    "vcm": (_torch_cases.golden_vcm_config, _torch_cases.GOLDEN_VCM_ITERS,
            "vcm"),
}


@pytest.mark.parametrize("name", SCENE_NAMES)
@pytest.mark.parametrize("method", sorted(GOLDEN_RUNS))
def test_goldens_on_the_card(cuda, method, name):
    """Each scene at its golden configuration on the card, with each
    kernel's launches per iteration. PT (also with a BVH attached: B5
    instead of B1 and B2) and VCM (whose goldens come from JAX's VC
    without merging) against the golden at its tolerance on all but a few
    pixels (``golden_agreement``: GOLDEN_MAX_FLIPPED, VCM's Cornell
    VCM_GOLDEN_MAX_FLIPPED, else none) and its mean within 1e-3; PPM,
    whose goldens come from JAX's budgeted gather where the port takes the
    tile gather, statistically: the mean within 12% and the pixel
    correlation at least 0.97 (or JAX's own tile gather's less 0.01)."""
    from oppositerenderer_tpu_torch.accel.bvh import build_scene_bvh
    make_cfg, iters, key = GOLDEN_RUNS[method]
    scene, cam = get_scene_by_name(name, cuda)
    if method == "pt_bvh":
        scene_b, bvh = build_scene_bvh(scene)
        scene = dataclasses.replace(scene_b, bvh=bvh)
    cfg = make_cfg()
    film, counts = render_counting(
        Renderer(scene, cam, cfg, seed=_torch_cases.GOLDEN_SEED), iters,
        RENDER_WRAPPERS)
    assert counts == [iters * n for n in launches_per_iteration(
        cfg, bvh=method == "pt_bvh")]
    img = film.mean_radiance().cpu().numpy()
    assert np.isfinite(img).all()
    want = np.load(_torch_cases.GOLDENS)[f"{name}__{key}"].astype(np.float32)
    if method == "ppm":
        corr = float(np.corrcoef(img.ravel(), want.ravel())[0, 1])
        assert corr >= min(_torch_cases.PPM_GOLDEN_MIN_CORR,
                           _torch_cases.JAX_TILED_GOLDEN_CORR.get(name, 1.0)
                           - 0.01)
        assert float(img.mean()) == pytest.approx(
            float(want.mean()), rel=_torch_cases.PPM_GOLDEN_MEAN_RTOL)
        return
    bad, worst, mean_err = _torch_cases.golden_agreement(img, want)
    allowed = _torch_cases.GOLDEN_MAX_FLIPPED
    if method == "vcm":
        allowed = (_torch_cases.VCM_GOLDEN_MAX_FLIPPED if name == "Cornell"
                   else 0)
    assert bad <= allowed, (bad, worst)
    assert mean_err <= _torch_cases.GOLDEN_MEAN_RTOL


def record_differences(a, b, path: str = "") -> list:
    """Fields of two records (dataclasses of tensors, nested) that differ:
    tensors compared on the host bit for bit (float32 through its int32
    bits, so NaN-coded BVH rows compare too), other values by equality."""
    if dataclasses.is_dataclass(a):
        return [d for f in dataclasses.fields(a) for d in record_differences(
            getattr(a, f.name), getattr(b, f.name), f"{path}{f.name}.")]
    if torch.is_tensor(a):
        a, b = a.cpu(), b.cpu()
        if a.dtype == torch.float32 and b.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        same = a.shape == b.shape and a.dtype == b.dtype and torch.equal(a, b)
        return [] if same else [path.rstrip(".")]
    return [] if a == b else [path.rstrip(".")]


@pytest.mark.parametrize("case", ["atrium_lite", "small_dae"])
def test_imported_scene_on_the_card_equals_the_cpu_import(cuda, tmp_path,
                                                          case):
    """The three host libraries load; the loader on the card equals the
    loader on the CPU, array for array, for ``scenes/atrium_lite.dae``
    (8,098 triangles, above the BVH threshold) and tests/test_import.py's
    DAE (5 triangles); one 64^2 PT iteration of each, card against CPU, at
    PPM's pixel bar: the first launches B5 only, the second B1 and B2
    only."""
    from oppositerenderer_tpu_torch import native
    from oppositerenderer_tpu_torch.camera import Camera
    assert all(native.load(stem) is not None for stem in native.STEMS)
    if case == "atrium_lite":
        path = _torch_cases.ATRIUM_LITE

        def camera(dev):
            return get_scene_by_name("Atrium:0.1", dev)[1]
    else:
        path = tmp_path / "test.dae"
        path.write_text(_torch_cases.SMALL_DAE)

        def camera(dev):
            eye, lookat, fov = _torch_cases.SMALL_DAE_CAMERA
            return Camera.make(eye, lookat, hfov=fov, vfov=fov, device=dev)

    cfg = RenderConfig(width=64, height=64)
    loaded, imgs = [], []
    for dev in (cuda, torch.device("cpu")):
        scene, cam = get_scene_by_name(str(path), dev)
        loaded.append((scene, cam))
        film, counts = render_counting(
            Renderer(scene, camera(dev), cfg, seed=_torch_cases.GOLDEN_SEED),
            1, RENDER_WRAPPERS)
        imgs.append(film.mean_radiance().cpu().numpy())
        if dev == cuda:
            ran = counts
    (gs, gcam), (cs, ccam) = loaded
    assert gs.device == cuda and gcam.eye.device == cuda
    assert not record_differences(gs, cs) + record_differences(gcam, ccam)
    assert ran == launches_per_iteration(cfg, bvh=gs.bvh is not None)
    assert (gs.bvh is not None) == (case == "atrium_lite")
    share, mean_err = image_agreement(*imgs)
    assert np.isfinite(imgs[0]).all() and float(imgs[1].mean()) > 0.0
    assert share >= PPM_MIN_AGREEING and mean_err <= PPM_MEAN_RTOL


@pytest.mark.parametrize("method", ["ppm", "vcm"])
def test_bvh_scene_iteration_kernels_on_the_card(cuda, method):
    """PPM and VCM (no merging) at 64^2 on the imported
    ``scenes/atrium_lite.dae`` (a BVH scene): each kernel's launches in one
    iteration (B5 in place of B1 and B2; B3 once on PPM's grid); B5 on
    every traversal call of one iteration against its plain version bit
    for bit, and B3 on the PPM iteration's gather within its rtol."""
    scene, cam = get_scene_by_name(str(_torch_cases.ATRIUM_LITE), cuda)
    assert scene.bvh is not None and scene.bvh.builder == "native"
    cfg = RenderConfig(width=64, height=64, render_method={
                           "ppm": RenderMethod.PROGRESSIVE_PHOTON_MAPPING,
                           "vcm": RenderMethod.VCM_BIDIRECTIONAL_PATH_TRACING
                       }[method])
    _, counts = render_counting(Renderer(scene, cam, cfg, seed=0), 1,
                                RENDER_WRAPPERS)
    assert counts == launches_per_iteration(cfg, bvh=True)
    calls = _torch_cases.iteration_calls(scene, cam, cfg,
                                         ("traverse", "traverse_any"))
    assert [len(calls[k]) for k in ("traverse", "traverse_any")] == \
        counts[4:]
    for k, ks in calls.items():
        plain = bk.traverse_any_plain if k == "traverse_any" else \
            bk.traverse_plain
        for bvh, o, d, tmin, tmax in ks:
            got, want = getattr(bk, k)(bvh, o, d, tmin, tmax), plain(
                bvh, o, d, tmin, tmax)
            if k == "traverse_any":
                got, want = (got,), (want,)
            assert sum(_bits_differ(a, b) for a, b in zip(got, want)) == 0
    if method == "ppm":
        grid, q, qn, r, u, valid = _torch_cases.ppm_gather_inputs(
            cuda, scene=scene, cam=cam, cfg=cfg)
        starts, lens, weights, _, _, rows = gk._tile_tables(grid, q, r, u,
                                                            valid)
        args = (starts, lens, weights, rows, torch.square(torch.as_tensor(
            r, dtype=torch.float32, device=cuda)), q, qn, grid, True)
        want = gk.gather_photons_tiled_plain(*args)
        assert float(want.abs().max()) > 0.0
        np.testing.assert_allclose(
            gk.gather_photons_tiled_kernel(*args).cpu().numpy(),
            want.cpu().numpy(), rtol=GATHER_RTOL,
            atol=GATHER_ATOL_REL * float(want.abs().max()))


# ---------------------------------------------------------------------------
# worker processes sharing the card, the tooling and the viewer
# ---------------------------------------------------------------------------

RANKS, RANKS_SIZE, MULTIHOST_ITERS = 2, 64, 8


def test_worker_ranks_on_the_card_match_the_unsharded_render(cuda,
                                                             tmp_path):
    """Two worker processes (``parallel.worker``, spawned) share the card
    over gloo: tests/test_torch_sharding.py's seven cases at 64^2 against
    the unsharded card render (PT and the all-gather bit for bit, else
    rtol 1e-5 + 1e-6 max|ref|; the stats equal); PPM main's 2-rank
    exchange at 512^2 (every photon and its summed power within 1e-5 in
    the partial grids) and step (the image mean within 1%, the photons
    stored equal); PT 512^2 over 8 iterations, strided and leased through
    the scheduler, merged against one process's film (rtol 2e-5, atol
    1e-6); a 64^2 PT gradient against the unsharded one (rel 5e-3)."""
    from oppositerenderer_tpu_torch import diff
    from oppositerenderer_tpu_torch.core.rng import make_root_key
    from oppositerenderer_tpu_torch.integrators import pt
    from oppositerenderer_tpu_torch.parallel.distributed import \
        MultiHostRenderer
    from oppositerenderer_tpu_torch.parallel.worker import (
        config_from, render_unsharded, sharding_cases, spawn_ranks)
    size = _torch_cases.MAIN_SIZE
    ppm = dict(width=size, height=size,
               render_method="PROGRESSIVE_PHOTON_MAPPING",
               photons_per_iteration=_torch_cases.PPM_MAIN_PHOTONS)
    mh = dict(kind="multihost", cfg=dict(width=size, height=size),
              iterations=MULTIHOST_ITERS, seed=0)
    cases = sharding_cases(RANKS_SIZE) + [
        dict(name="ppm_main", kind="render", cfg=ppm, seed=0, iteration=1,
             reps=2),
        dict(name="ppm_main_exchange", kind="exchange", cfg=ppm, seed=0,
             iteration=1),
        dict(mh, name="multihost_strided"),
        dict(mh, name="multihost_leased", schedule="leased", packet_size=2),
        dict(name="grad_pt", kind="grad", wrt=[["kd", 0]], seed=0,
             cfg=dict(width=RANKS_SIZE, height=RANKS_SIZE))]
    torch.cuda.empty_cache()
    out = tmp_path / "ranks.npz"
    spawn_ranks(RANKS, cases, out, device="cuda", backend="gloo",
                timeout=600)
    z = dict(np.load(out))
    for c in sharding_cases(RANKS_SIZE):
        name = c["name"]
        got = z[f"{name}.image"]
        want, stats = render_unsharded(c, cuda)
        want = want.cpu().numpy()
        assert np.isfinite(got).all(), name
        if name in ("pt", "ppm_all_gather"):
            np.testing.assert_array_equal(got, want, err_msg=name)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5,
                                       atol=1e-6 * np.abs(want).max(),
                                       err_msg=name)
        for k, v in stats.items():
            if not k.startswith("avg_"):
                assert float(z[f"{name}.stat.{k}"]) == float(v), (name, k)
    # PPM main over the ranks' partial grids
    c = next(c for c in cases if c["name"] == "ppm_main")
    got = z["ppm_main.image"].astype(np.float64)
    want, stats = render_unsharded(c, cuda)
    assert np.isfinite(got).all()
    assert got.mean() == pytest.approx(float(want.double().mean()), rel=0.01)
    assert float(z["ppm_main.stat.photons_stored"]) == float(
        stats["photons_stored"])
    x = {k: float(z[f"ppm_main_exchange.{k}"]) for k in (
        "photon_power", "grid_power", "photons", "grid_photons", "overflow")}
    assert x["overflow"] == 0 and x["grid_photons"] == x["photons"]
    assert x["grid_power"] == pytest.approx(x["photon_power"], rel=1e-5)
    # the merged films against one process's
    scene, cam = get_scene_by_name("CornellSmall", cuda)
    single = MultiHostRenderer(scene, cam, config_from(mh["cfg"]),
                               seed=0).run(MULTIHOST_ITERS)
    want = single.accum.cpu().numpy()
    for name in ("multihost_strided", "multihost_leased"):
        np.testing.assert_allclose(z[f"{name}.accum"], want, rtol=2e-5,
                                   atol=1e-6, err_msg=name)
        assert int(z[f"{name}.iterations"]) == MULTIHOST_ITERS
        assert (z[f"{name}.rendered"] > 0).all()
    # the 2-rank gradient against the unsharded one
    cfg = RenderConfig(width=RANKS_SIZE, height=RANKS_SIZE)
    key = make_root_key(0)
    _, grads = diff.render_loss_and_grad(
        lambda s: pt.render_iteration(s, cam, cfg, 0, key), scene,
        {("kd", 0): scene.materials.kd[0]})
    np.testing.assert_allclose(z["grad_pt.grad.kd.0"].astype(np.float64),
                               grads[("kd", 0)].double().cpu().numpy(),
                               rtol=5e-3)


@pytest.mark.parametrize("method", ["pt", "ppm", "vcm"])
def test_check_iteration_on_the_card_finds_no_nan(cuda, method):
    """``debug.check_iteration`` at the main configurations (at 64^2):
    no pass output holds a NaN or an infinity."""
    from oppositerenderer_tpu_torch import debug
    scene, cam = get_scene_by_name("CornellSmall", cuda)
    msg, radiance = debug.check_iteration(scene, cam, graph_config(method))
    assert msg is None
    assert bool(torch.isfinite(radiance).all())


def test_photon_histogram_on_the_card_matches_the_cpu(cuda):
    """The photon depth histogram of 2^16 photons on the card against the
    CPU's: every photon counted, at most 0.1% of the paths one deposit
    apart (a last-ulp difference can end a path one bounce earlier)."""
    from oppositerenderer_tpu_torch import debug
    n = 1 << 16
    cfg = RenderConfig(photons_per_iteration=n)
    hist, ref = (debug.photon_depth_histogram(
        get_scene_by_name("CornellSmall", dev)[0], cfg)["deposits_histogram"]
        for dev in (cuda, "cpu"))
    assert hist.sum() == n
    assert int(np.abs(hist.astype(np.int64) - ref).sum()) // 2 <= 1e-3 * n


def test_profiler_trace_and_device_table_on_the_card(cuda, tmp_path):
    """``core.profiling.trace`` of a replayed PT iteration and an eager one
    holds a CUDA kernel and the pt_raytrace_pass range (a replay runs no
    Python); the device table lists the card and the CPU."""
    from oppositerenderer_tpu_torch.core.profiling import TRACE_FILE, trace
    from oppositerenderer_tpu_torch.devices import ComputeDeviceRepository
    scene, cam = get_scene_by_name("CornellSmall", cuda)
    r = Renderer(scene, cam, graph_config("pt"), seed=0)
    r.render_next_iteration()
    with trace(tmp_path):
        r.render_next_iteration()
        r._iteration(r.iteration, r._radius_sq(r.iteration))
    events = json.loads((tmp_path / TRACE_FILE).read_text())["traceEvents"]
    assert any(e.get("cat") == "kernel" for e in events)
    assert any(e.get("name") == "pt_raytrace_pass" for e in events)
    table = ComputeDeviceRepository.enumerate().table()
    assert torch.cuda.get_device_name(cuda) in table and "cpu" in table


def test_viewer_serves_frames_from_the_card(cuda):
    """The live viewer on the card: ``RenderService`` at 64^2 PT behind
    ``make_server(port=0)`` serves frames and stats over HTTP until 4
    iterations; a switch to PPM and then VCM restarts each and serves a
    decodable, finite, non-black frame; a gamma change restarts nothing and
    changes the frame; both threads stop; the renders launched B1, B2 and
    B3."""
    from PIL import Image

    from oppositerenderer_tpu_torch.viewer import RenderService, make_server
    scene, cam = get_scene_by_name("CornellSmall", cuda)
    svc = RenderService(scene, cam, graph_config("pt"), seed=0)
    server = make_server(svc, port=0)
    serving = threading.Thread(target=server.serve_forever, daemon=True)
    base = f"http://127.0.0.1:{server.server_address[1]}"

    def get(path):
        with urllib.request.urlopen(base + path, timeout=60) as resp:
            return resp.read(), dict(resp.headers)

    def stats():
        return json.loads(get("/stats")[0])

    def wait_for(pred):
        deadline = time.monotonic() + 300
        while not pred():
            assert time.monotonic() < deadline, stats()
            time.sleep(0.05)

    def frame():
        png, headers = get("/frame.png")
        img = np.asarray(Image.open(io.BytesIO(png)), np.float64)
        assert img.shape == (GRAPH_SIZE, GRAPH_SIZE, 3)
        assert 0.0 < float(img.mean()) < 255.0
        return png, float(img.mean())

    before = [w.launches for w in RENDER_WRAPPERS[:3]]
    serving.start()
    svc.start()
    try:
        wait_for(lambda: stats()["iterations"] >= 4)
        frame()
        for method in ("ppm", "vcm"):
            seq0 = stats()["sequence_number"]
            get(f"/set?method={method}")
            wait_for(lambda: (stats()["render_method"] == method
                              and stats()["sequence_number"] == seq0 + 1
                              and stats()["iterations"] >= 1))
            wait_for(lambda: int(get("/frame.png")[1]["X-Iteration"]) >= 1)
            frame()
        seq0 = stats()["sequence_number"]
        png1, mean1 = frame()
        get("/set?gamma=1.0")
        png2, mean2 = frame()
        assert stats()["sequence_number"] == seq0
        assert png2 != png1 and mean2 < mean1
    finally:
        svc.stop()
        server.shutdown()
        server.server_close()
        serving.join(timeout=60)
    assert not serving.is_alive() and not svc._thread.is_alive()
    graph = svc.renderer.kernel_launches()
    assert all(w.launches - b + graph.get(w.__name__, 0) > 0
               for w, b in zip(RENDER_WRAPPERS[:3], before))

# ---------------------------------------------------------------------------
# the threefry RNG (csrc/rng.cu): each tensor call of core/rng.py one
# launch, bit for bit the int64 chain of its plain version
# ---------------------------------------------------------------------------

RNG_WRAPPER_NAMES = ("threefry_draw", "threefry_words", "threefry_uniform")


def rng_launches():
    from oppositerenderer_tpu_torch.accel import rng_kernels as nk
    return sum(getattr(nk, name).launches for name in RNG_WRAPPER_NAMES)


def rng_key(dev, form: str, n: int):
    """A key of ``form``: "host" (two ints), "device" (0-d tensors,
    derived on the card from a device root and iteration) or "per_lane"
    (``lane_key_words`` of G = 3 folds of it, cut to ``n`` lanes)."""
    from oppositerenderer_tpu_torch.core import rng as trng
    host = trng.iteration_key(trng.make_root_key(2**31 + 11), 5, 1)
    if form == "host":
        return host
    key = trng.iteration_key(trng.device_key(trng.make_root_key(2**31 + 11),
                                             dev),
                             torch.full((), 5, dtype=torch.int64,
                                        device=dev), 1)
    assert tuple(int(w) for w in key) == host
    if form == "device":
        return key
    per = -(-n // 3)
    k0, k1 = trng.lane_key_words([trng.fold_in(key, g) for g in range(3)],
                                 per, dev)
    return k0[:n], k1[:n]


@pytest.mark.parametrize("counter", [0, 7])
@pytest.mark.parametrize("n", [262144, 1 << 20])
@pytest.mark.parametrize("form", ["device", "per_lane", "host"])
def test_rng_draws_equal_the_int64_chain(cuda, form, n, counter):
    """next1, next2 and next3 of a LaneSampler on CUDA lanes (ids up to
    2^32 - 1) from column counter 0 and 7: one kernel launch each, equal
    bit for bit to the plain version on the same CUDA tensors and on the
    CPU."""
    from oppositerenderer_tpu_torch.core import rng as trng
    gen = torch.Generator().manual_seed(n + counter)
    lanes = torch.randint(0, 2**32, (n,), generator=gen, dtype=torch.int64)
    lanes[:2] = torch.tensor([0, 2**32 - 1])
    key = rng_key(cuda, form, n)
    s = trng.LaneSampler(key, lanes.to(cuda))
    s._n = counter
    at = counter
    for draw, cols in (("next1", 1), ("next2", 2), ("next3", 3),
                       ("next3", 3), ("next1", 1)):
        before = rng_launches()
        got = getattr(s, draw)()
        assert rng_launches() == before + 1
        want = trng.lane_uniform_plain(*key, s._lanes, at, cols)
        cpu_key = tuple(w.cpu() if torch.is_tensor(w) else w for w in key)
        on_cpu = trng.lane_uniform_plain(*cpu_key, lanes, at, cols)
        want = want[:, 0] if cols == 1 else want
        on_cpu = on_cpu[:, 0] if cols == 1 else on_cpu
        assert got.dtype == torch.float32 and got.shape == want.shape
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
        assert torch.equal(got.cpu().view(torch.int32),
                           on_cpu.view(torch.int32)), draw
        at += (cols + 1) // 2
    assert s._n == at


def test_rng_words_equal_the_int64_chain_on_random_words(cuda):
    """threefry2x32 on 1-d words drawn at random, with 0 and 0xFFFFFFFF in
    every operand, and on every mix of ints, 0-d and 1-d words: one launch
    a call, the plain version's words (int64 in [0, 2^32)) bit for bit."""
    from oppositerenderer_tpu_torch.core import rng as trng
    rng = np.random.default_rng(26)
    words = rng.integers(0, 2**32, (4, 4099), dtype=np.int64)
    words[:, :4] = [[0, 0xFFFFFFFF, 0, 0xFFFFFFFF]] * 4
    words[:, 4] = 0xFFFFFFFF
    k0, k1, x0, x1 = (torch.as_tensor(w, device=cuda) for w in words)
    cases = [(k0, k1, x0, x1), (k0[7], k1[7], x0, x1), (0xFFFFFFFF, 0, x0, x1),
             (k0[3], k1[3], 0, x1[5]), (k0, 17, 0, 2**32 - 1),
             (1, 2, x0[1], 9)]
    for case in cases:
        before = rng_launches()
        got = trng.threefry2x32(*case)
        assert rng_launches() == before + 1
        want = trng.threefry2x32_plain(*case)
        on_cpu = trng.threefry2x32_plain(*(w.cpu() if torch.is_tensor(w)
                                           else w for w in case))
        for g, w, c in zip(got, want, on_cpu):
            assert g.dtype == torch.int64 and g.shape == w.shape
            assert torch.equal(g, w) and torch.equal(g.cpu(), c)
            assert int(g.min()) >= 0 and int(g.max()) < 2**32


def test_rng_key_folds_from_device_keys(cuda):
    """fold_in (an int and a tensor datum), fold_in_range and
    iteration_key on device keys: the host derivation's words, one launch
    a fold (iteration_key two, fold_in_range one)."""
    from oppositerenderer_tpu_torch.core import rng as trng
    for seed in (0, 7, 2**31 - 1, 2**32 - 1, -3):
        host = trng.make_root_key(seed)
        dev = trng.device_key(host, cuda)
        for data in (0, 5, 2**31, 2**32 - 1):
            before = rng_launches()
            got = trng.fold_in(dev, data)
            got_t = trng.fold_in(host, torch.full((), data,
                                                  dtype=torch.int64,
                                                  device=cuda))
            assert rng_launches() == before + 2
            want = trng.fold_in(host, data)
            assert tuple(int(w) for w in got) == want
            assert tuple(int(w) for w in got_t) == want
        for iteration, pass_id in ((0, 0), (17, 3), (2**31 + 3, 2)):
            before = rng_launches()
            got = trng.iteration_key(dev, torch.full(
                (), iteration, dtype=torch.int64, device=cuda), pass_id)
            assert rng_launches() == before + 2
            assert tuple(int(w) for w in got) == trng.iteration_key(
                host, iteration, pass_id)
        before = rng_launches()
        got = trng.fold_in_range(dev, 3001, 9)
        assert rng_launches() == before + 1
        assert [tuple(int(w) for w in k) for k in got] == \
            trng.fold_in_range(host, 3001, 9)


@pytest.mark.parametrize("shape", [(), (1,), (7,), (3, 5), (4097,),
                                   (262143,)])
def test_rng_uniform_equals_the_int64_chain(cuda, shape):
    """rng.uniform on the card at odd sizes, from a device key and a host
    key: one launch each, the plain version's floats bit for bit (on the
    card and on the CPU)."""
    import math

    from oppositerenderer_tpu_torch.core import rng as trng
    host = trng.iteration_key(trng.make_root_key(-3), 6, 2)
    want = trng.uniform_plain(host, math.prod(shape), "cpu").reshape(shape)
    for key in (host, trng.device_key(host, cuda)):
        before = rng_launches()
        got = trng.uniform(key, shape, cuda)
        assert rng_launches() == before + 1
        assert got.shape == shape and got.device.type == "cuda"
        on_card = trng.uniform_plain(key, math.prod(shape), cuda)
        assert torch.equal(got.reshape(-1).view(torch.int32),
                           on_card.view(torch.int32))
        assert torch.equal(got.cpu().view(torch.int32),
                           want.view(torch.int32))


def test_rng_wrappers_reject_bad_inputs(cuda):
    """Operands on the card and on the CPU at once raise before any
    launch (what one device's operands are refused for is checked on the
    CPU, ``test_torch_rng_kernels.py``)."""
    from oppositerenderer_tpu_torch.accel import rng_kernels as nk
    lanes = torch.arange(12, dtype=torch.int64, device=cuda)
    bad = [lambda: nk.threefry_draw(lanes, lanes.cpu(), 2, 0, 3),
           lambda: nk.threefry_draw(lanes, 1, lanes[0].cpu(), 0, 3),
           lambda: nk.threefry_words(lanes, 1, 0, lanes.cpu()),
           lambda: nk.threefry_uniform(lanes[0], 1, 4, "cpu")]
    before = rng_launches()
    for fn in bad:
        with pytest.raises(ValueError):
            fn()
    assert rng_launches() == before


@pytest.mark.parametrize("method", ["pt", "ppm", "vcm"])
def test_rng_kernel_renders_the_int64_chains_film(cuda, monkeypatch, method):
    """One captured 64^2 iteration of PT, PPM main and VCM main, and a
    replay: the film with the kernel equals the film with the plain
    version on the card (core.rng's dispatch patched off) bit for bit (VCM
    at the SHARD_* bar). The eager iteration before the capture launches
    the kernel once for each call the plain version makes on CUDA
    tensors (draws and folds alike), the capture holds those launches,
    and the plain version launches nothing."""
    from oppositerenderer_tpu_torch.core import rng as trng

    def render():
        r = Renderer(*graph_scene(method, cuda), graph_config(method),
                     seed=0)
        before = rng_launches()
        film = r.render(2)   # eager, then the capture; then a replay
        torch.cuda.synchronize()
        captured = sum(r.captured_step.capture_launches[k]
                       for k in RNG_WRAPPER_NAMES)
        return film.accum.clone(), rng_launches() - before, captured

    got, launched, captured = render()
    calls = []
    plain = trng.threefry2x32_plain

    def counted(*words):
        if any(torch.is_tensor(w) and w.is_cuda for w in words):
            calls.append(len(words))
        return plain(*words)

    monkeypatch.setattr(trng, "_on_card", lambda *xs: False)
    monkeypatch.setattr(trng, "threefry2x32_plain", counted)
    want, none, captured_plain = render()
    assert none == 0 and captured_plain == 0
    assert launched == captured > 0
    assert len(calls) == 2 * launched   # the eager body and the capture
    assert_films_agree(got, want, method not in ATOMIC)
