"""The port's vertex merging (VCM's VM half) against the JAX package's: the
vertex grid, the query table, the budgeted merge, B4's plain version, and
one VCM+VM iteration.

The merge inputs come from numpy (``chip_smoke.vm_case_arrays``: the
synthetic setup of ``tests/test_vcm_vm.py`` and a clustered variant that
subsamples rows and chunks) and go into both packages; JAX's vertex grid
reaches the port through ``interop``, so both merge the same vertices.
The grid is held bit for bit. B4's plain version sums the same terms as
JAX's interpret-mode tile kernel in another order: rtol 1e-4 plus atol
1e-6 * max|ref|. Where nothing is subsampled the tile merge equals JAX's
budgeted XLA merge at rtol 2e-4 (``test_vcm_vm.py:189``).
"""
import dataclasses
import functools
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402
from oppositerenderer_tpu.accel import pallas_vm as jpv  # noqa: E402
from oppositerenderer_tpu.bsdf import BSDF as JBSDF  # noqa: E402
from oppositerenderer_tpu.config import RenderConfig as JConfig  # noqa: E402
from oppositerenderer_tpu.core import rng as jrng  # noqa: E402
from oppositerenderer_tpu.integrators import common as jcommon  # noqa: E402
from oppositerenderer_tpu.integrators import vcm as jvcm  # noqa: E402
from oppositerenderer_tpu.scene import \
    get_scene_by_name as jax_scene  # noqa: E402
from oppositerenderer_tpu_torch import interop  # noqa: E402
from oppositerenderer_tpu_torch.accel import vm_kernels as vk  # noqa: E402
from oppositerenderer_tpu_torch.config import (RenderConfig,  # noqa: E402
                                               RenderMethod)
from oppositerenderer_tpu_torch.core.rng import (iteration_key,  # noqa: E402
                                                 make_root_key)
from oppositerenderer_tpu_torch.integrators import vcm  # noqa: E402
from oppositerenderer_tpu_torch.integrators.common import \
    scene_epsilon  # noqa: E402
from oppositerenderer_tpu_torch.renderer import Renderer  # noqa: E402
from oppositerenderer_tpu_torch.scene import get_scene_by_name  # noqa: E402

torch.set_num_threads(2)

VCM = RenderMethod.VCM_BIDIRECTIONAL_PATH_TRACING
SEED = 7
RTOL = 1e-4
ATOL_REL = 1e-6
SIZE = 32
ITER_CFG = dict(width=SIZE, height=SIZE, vcm_max_path_length=4,
                photon_grid_resolution=16, vcm_use_vm=True)


def assert_close(got, want, rtol=RTOL):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=ATOL_REL * np.abs(want).max())


def jax_cfg(**kw):
    return JConfig(**{"width": 48, "height": 48, "vcm_use_vm": True,
                      "vcm_vm_budget": 4096, "render_method": VCM, **kw})


def jax_case(seed, cluster, **cfg_kw):
    """The JAX side of ``chip_smoke.vm_case``: the same numpy arrays as a
    JAX light-vertex store and grid and a JAX camera BSDF; the grid does
    not depend on ``cfg_kw``."""
    return (jax_cfg(**cfg_kw),) + _jax_case(seed, cluster)


@functools.cache
def _jax_case(seed, cluster):
    a = chip_smoke.vm_case_arrays(seed, cluster)
    scene, _ = jax_scene("CornellSmall")
    mat = int(np.asarray(jnp.argmax(scene.materials.kd.sum(axis=-1))))
    st = a["store"]
    store = jvcm.LightVertexStore(
        mat=jnp.full(st["valid"].shape, mat, jnp.int32),
        **{k: jnp.asarray(v) for k, v in st.items()})
    n = a["qpos"].shape[0]
    kd, ks, expn, kr, kt, ior, diel = scene.materials.bsdf_coefficients(
        jnp.full((n,), mat, jnp.int32))
    glossy = jnp.asarray(a["cam"]["glossy"])
    ks = jnp.where(glossy[:, None], 0.3, ks)
    expn = jnp.where(glossy, 20.0, expn)
    qn = jnp.zeros((n, 3), jnp.float32).at[:, 2].set(1.0)
    cam_bsdf = JBSDF.make(qn, qn, jnp.asarray(a["wfix"]), kd, ks, expn, kr,
                          kt, ior, diel)
    r2 = jnp.float32(a["radius_sq"])
    vgrid = jvcm.build_vertex_grid(scene, jax_cfg(), store, jnp.sqrt(r2))
    cam = a["cam"]
    return a, store, vgrid, dict(
        cam_bsdf=cam_bsdf, cam_pos=jnp.asarray(a["qpos"]),
        cam_thr=jnp.asarray(cam["thr"]), cam_dVCM=jnp.asarray(cam["dVCM"]),
        cam_dVM=jnp.asarray(cam["dVM"]), active=jnp.asarray(cam["active"]),
        radius_sq=r2, mis_vc_w=jnp.float32(a["mis_vc_w"]),
        n_light_paths=a["n_light_paths"], u_stride=jnp.asarray(a["u"]),
        depth1=a["depth1"])


def grid_leaves(g) -> dict:
    return {**{k: np.asarray(getattr(g, k))
               for k in interop.VERTEX_GRID_ARRAYS},
            "resolution": g.resolution}


def jax_tiled(cfg, vgrid, k, interpret=True):
    n = k["cam_pos"].shape[0]
    u_rows = k["u_stride"].reshape(n // vk.TILE, vk.TILE)[:, :vk.ROWS + 2]
    return jax.jit(functools.partial(jpv.merge_vertices_tiled, cfg=cfg,
                           n_light_paths=k["n_light_paths"],
                           depth1=k["depth1"], interpret=interpret))(
        vgrid, cam_bsdf=k["cam_bsdf"], cam_pos=k["cam_pos"],
        cam_thr=k["cam_thr"], cam_dVCM=k["cam_dVCM"], cam_dVM=k["cam_dVM"],
        active=k["active"], radius_sq=k["radius_sq"],
        mis_vc_w=k["mis_vc_w"], u_rows=u_rows)


def port_merge(cluster, seed=0, vgrid=None, n=None, **cfg_kw):
    scene, cfg, k = chip_smoke.vm_case("cpu", seed, cluster)
    cfg = cfg.replace(**cfg_kw)
    if vgrid is not None:
        k["vgrid"] = vgrid
    if n is not None:   # the first n queries
        for name in ("cam_pos", "cam_thr", "cam_dVCM", "cam_dVM", "active",
                     "u_stride"):
            k[name] = k[name][:n]
        k["cam_bsdf"] = vcm._map_bsdf(k["cam_bsdf"], lambda a: a[:n])
    return vcm._merge_vertices(
        scene, cfg, k["cam_bsdf"], k["cam_pos"], k["cam_thr"],
        k["cam_dVCM"], k["cam_dVM"], k["active"], k["vgrid"],
        k["radius_sq"], k["mis_vc_w"], k["n_light_paths"], k["u_stride"],
        k["depth1"])


@pytest.fixture(scope="module")
def light_store():
    """A JAX light pass of CornellSmall at 32^2, L = 4: its store and the
    grid JAX builds over it."""
    js, jc = jax_scene("CornellSmall")
    cfg = JConfig(**ITER_CFG, render_method=VCM)
    n = SIZE * SIZE
    r2 = jnp.float32(0.05 ** 2)
    store, _, _ = jax.jit(lambda s, c, k: jvcm.trace_light_pass(
        s, c, cfg, k, jcommon.scene_epsilon(s), jnp.float32(0.3),
        jnp.float32(0.0), jnp.arange(n, dtype=jnp.int32), n))(
            js, jc, jrng.make_root_key(SEED))
    return store, jvcm.build_vertex_grid(js, cfg, store, jnp.sqrt(r2))


def test_constants_match_jax():
    assert (vk.EPS_COSINE, vk.EPS_PHONG, vk.QCOLS) == (
        jpv.EPS_COSINE, jpv.EPS_PHONG, jpv._QCOLS)


def test_build_vertex_grid_is_bit_identical(light_store):
    store, want = light_store
    port_store = interop.light_vertex_store_from_numpy(
        {f: np.asarray(getattr(store, f))
         for f in interop.LIGHT_VERTEX_FIELDS}, "cpu")
    cfg = RenderConfig(**ITER_CFG, render_method=VCM)
    scene = get_scene_by_name("CornellSmall", "cpu")[0]
    got = vcm.build_vertex_grid(scene, cfg, port_store, torch.tensor(0.05))
    assert got.resolution == want.resolution
    assert int(np.asarray(want.offsets)[-1]) > 0
    for f in interop.VERTEX_GRID_ARRAYS:
        w = np.asarray(getattr(want, f))
        g = getattr(got, f).numpy()
        assert g.dtype == w.dtype, f
        np.testing.assert_array_equal(g, w, err_msg=f)


def test_build_vertex_grid_of_the_clustered_case_is_bit_identical():
    _, _, _, want, _ = jax_case(0, True)
    _, _, k = chip_smoke.vm_case("cpu", 0, True)
    for f in interop.VERTEX_GRID_ARRAYS:
        np.testing.assert_array_equal(getattr(k["vgrid"], f).numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)


@pytest.mark.parametrize("cluster", [False, True])
def test_packed_records_equal_the_grid_fields(cluster):
    """B4's kernel reads VertexGrid.packed: each vertex's fields, in
    (position, dVCM), (wo, dVM), (throughput, cont), (depth, x, 0, 0), x
    the x index of the grid cell that holds the vertex."""
    _, _, k = chip_smoke.vm_case("cpu", 0, cluster)
    g = k["vgrid"]
    p = g.packed
    assert p.shape == (g.position.shape[0], vk.RECORD)
    assert p.dtype == torch.float32 and p.is_contiguous()
    for cols, field in (((0, 3), "position"), ((3, 4), "dVCM"),
                        ((4, 7), "wo"), ((7, 8), "dVM"),
                        ((8, 11), "throughput"), ((11, 12), "cont"),
                        ((12, 13), "depth")):
        a = getattr(g, field)
        torch.testing.assert_close(p[:, cols[0]:cols[1]],
                                   a.reshape(a.shape[0], -1),
                                   rtol=0, atol=0)
    res = g.resolution
    off = g.offsets.long()
    n_in = int(off[-1])                  # vertices in some cell
    cell = torch.repeat_interleave(torch.arange(res ** 3),
                                   off[1:] - off[:-1])
    assert torch.equal(p[:n_in, 13], (cell % res).to(torch.float32))
    assert bool((p[n_in:, 13] == 0).all())
    assert int(torch.count_nonzero(p[:, 14:])) == 0


@pytest.mark.parametrize("cluster", [False, True])
def test_slot_rows_hold_the_staged_windows(cluster):
    """``_tile_tables``' slot rows: each non-empty window lies in the cells
    of its (y,z) row, between the starts of the tile box's x cells, which
    is what B4's kernel assumes when it cuts a window to a warp's box."""
    scene, cfg, k = chip_smoke.vm_case("cpu", 0, cluster)
    n = k["cam_pos"].shape[0]
    u_rows = k["u_stride"].reshape(n // vk.TILE, vk.TILE)[:, :vk.ROWS + 2]
    _, (starts, lens, _, rows, _, qtab, g), _, _ = vk.merge_tables(
        k["vgrid"], cfg, k["cam_bsdf"], k["cam_pos"], k["cam_dVCM"],
        k["cam_dVM"], k["active"], k["radius_sq"], k["mis_vc_w"], u_rows,
        k["depth1"])
    res = g.resolution
    off = g.offsets.long()
    used = lens > 0
    assert bool(used.any())
    base = rows.long()[used]
    assert bool((base % res == 0).all())          # the x = 0 cell of a row
    y, z = (base // res) % res, base // (res * res)
    s, e = starts.long()[used], (starts + lens).long()[used]
    assert bool((off[base] <= s).all()) and bool((e <= off[base + res]).all())
    # the window's cells: those of its first and last vertex lie in row
    cell = torch.searchsorted(off, s, right=True) - 1
    assert torch.equal((cell // res) % res, y)
    assert torch.equal(cell // (res * res), z)
    assert bool((rows >= 0).all()) and bool((rows < res ** 3).all())


def test_query_table_matches_jax():
    _, _, _, _, jk = jax_case(0, True)
    _, _, k = chip_smoke.vm_case("cpu", 0, True)
    a_cam = k["cam_dVCM"] * 0.25
    b_cam = k["cam_dVM"] * k["cam_bsdf"].continuation_prob()
    got = vk._query_table(k["cam_bsdf"], k["cam_pos"], a_cam, b_cam,
                          k["active"])
    want = np.asarray(jpv._query_table(
        jk["cam_bsdf"], jk["cam_pos"], jk["cam_dVCM"] * 0.25,
        jk["cam_dVM"] * jk["cam_bsdf"].continuation_prob(), jk["active"]))
    assert got.shape == want.shape == (512, vk.QCOLS)
    np.testing.assert_array_equal(got[:, 24].numpy(), want[:, 24])
    assert 0 < want[:, 24].sum() < 512
    assert (want[:, 21] > 1.0).any()   # glossy queries
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("cluster", [False, True])
def test_tile_merge_plain_matches_jax_tile_kernel(cluster):
    """Port tile merge (B4's plain version on the CPU) against JAX's
    merge_vertices_tiled in interpret mode, on JAX's grid handed over."""
    cfg, _, _, jgrid, jk = jax_case(0, cluster)
    want = jax_tiled(cfg, jgrid, jk)
    got = port_merge(cluster, vgrid=interop.vertex_grid_from_numpy(
        grid_leaves(jgrid), "cpu"))
    assert np.asarray(want).max() > 0.0
    assert np.isfinite(got.numpy()).all()
    assert_close(got.numpy(), want)


def test_clustered_case_subsamples_rows_and_chunks():
    scene, cfg, k = chip_smoke.vm_case("cpu", 0, True)
    n = k["cam_pos"].shape[0]
    u_rows = k["u_stride"].reshape(n // vk.TILE, vk.TILE)[:, :vk.ROWS + 2]
    _, args, _, _ = vk.merge_tables(
        k["vgrid"], cfg, k["cam_bsdf"], k["cam_pos"], k["cam_dVCM"],
        k["cam_dVM"], k["active"], k["radius_sq"], k["mis_vc_w"], u_rows,
        k["depth1"])
    weights = args[2]
    assert bool((weights[0] > 8.0).any())     # rows of a wide tile
    assert bool((args[1] == vk.CHUNK).any())  # a row cut to one chunk
    out1, out2 = vk.merge_vertices_tiled_plain(*args)
    assert float(out2.abs().max()) > 0.0      # the Phong lobe ran


def test_tile_merge_equals_jax_budget_merge_without_subsampling():
    """``test_vcm_vm.py:165``: nothing is subsampled, so the tile merge and
    JAX's budgeted XLA merge compute the same full sum."""
    cfg, _, _, jgrid, jk = jax_case(0, False, vcm_vm_use_pallas=False)
    want = jvcm._merge_vertices(
        None, cfg, jk["cam_bsdf"], jk["cam_pos"], jk["cam_thr"],
        jk["cam_dVCM"], jk["cam_dVM"], jk["active"], jgrid,
        jk["radius_sq"], jk["mis_vc_w"], jk["n_light_paths"],
        jk["u_stride"], jk["depth1"])
    got = port_merge(False)
    assert np.asarray(want).sum() > 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=1e-7)


@pytest.mark.parametrize("budget", [64, 4096])
def test_budget_merge_matches_jax(budget):
    """250 queries do not tile: both packages take the budgeted merge, with
    the same stride subsampling at budget 64."""
    cfg, _, _, jgrid, jk = jax_case(0, True, vcm_vm_use_pallas=False,
                                    vcm_vm_budget=budget)
    n = 250
    jk = {k: v[:n] if k in ("cam_pos", "cam_thr", "cam_dVCM", "cam_dVM",
                            "active", "u_stride") else v
          for k, v in jk.items()}
    want = jvcm._merge_vertices(
        None, cfg, jax.tree_util.tree_map(lambda a: a[:n], jk["cam_bsdf"]),
        jk["cam_pos"], jk["cam_thr"], jk["cam_dVCM"], jk["cam_dVM"],
        jk["active"], jgrid, jk["radius_sq"], jk["mis_vc_w"],
        jk["n_light_paths"], jk["u_stride"], jk["depth1"])
    got = port_merge(True, n=n, vcm_vm_budget=budget)
    assert np.asarray(want).max() > 0.0
    assert_close(got.numpy(), want)


def test_cpu_merge_runs_the_plain_version_without_a_launch():
    before = vk.merge_vertices_tiled.launches
    got = port_merge(True)
    assert vk.merge_vertices_tiled.launches == before
    assert got.shape == (512, 3) and bool(torch.isfinite(got).all())
    scene, cfg, k = chip_smoke.vm_case("cpu", 0, True)
    with pytest.raises(ValueError, match="multiple"):
        vk.merge_vertices_tiled(
            k["vgrid"], cfg, vcm._map_bsdf(k["cam_bsdf"], lambda a: a[:300]),
            k["cam_pos"][:300], k["cam_thr"][:300], k["cam_dVCM"][:300],
            k["cam_dVM"][:300], k["active"][:300], k["radius_sq"],
            k["mis_vc_w"], 64, k["u_stride"][:2, None].repeat(1, 66), 2)


def test_kernel_wrapper_checks_its_inputs():
    scene, cfg, k = chip_smoke.vm_case("cpu", 0, False)
    u_rows = k["u_stride"].reshape(1, vk.TILE)[:, :vk.ROWS + 2]
    _, args, _, _ = vk.merge_tables(
        k["vgrid"], cfg, k["cam_bsdf"], k["cam_pos"], k["cam_dVCM"],
        k["cam_dVM"], k["active"], k["radius_sq"], k["mis_vc_w"], u_rows,
        k["depth1"])
    vgrid = args[6]
    for i, bad, match in ((0, args[0].long(), "int32"),
                          (4, args[4][:3], "shape"),
                          (5, args[5].double(), "float32"),
                          (5, args[5].T.contiguous().T, "contiguous"),
                          (6, dataclasses.replace(
                              vgrid, packed=vgrid.packed[:, :12]), "shape")):
        a = list(args)
        a[i] = bad
        with pytest.raises(ValueError, match=match):
            vk.merge_vertices_tiled_kernel(*a)


def test_vm_requires_a_grid():
    scene, cam = get_scene_by_name("CornellSmall", "cpu")
    cfg = RenderConfig(width=16, height=16, render_method=VCM,
                       vcm_use_vm=True)
    lanes = torch.arange(256)
    with pytest.raises(ValueError, match="VertexGrid"):
        vcm.trace_camera_pass(scene, cam, cfg, make_root_key(0),
                              scene_epsilon(scene), torch.ones(()),
                              torch.ones(()), None, 256, lanes, lanes,
                              lanes, lanes)


@pytest.fixture(scope="module")
def vm_iteration_pair():
    """One VCM+VM iteration of CornellSmall at 32^2, L = 4, through both
    packages; JAX takes its tile merge in interpret mode
    (vcm_vm_use_pallas=True), as the port takes its tile merge."""
    js, jc = jax_scene("CornellSmall")
    ts, tc = get_scene_by_name("CornellSmall", "cpu")
    cfg = RenderConfig(**ITER_CFG, render_method=VCM)
    r2 = Renderer(ts, tc, cfg, seed=SEED).ppm_initial_radius ** 2
    jcfg = JConfig(**ITER_CFG, render_method=VCM, vcm_vm_use_pallas=True)
    want, wst = jax.jit(lambda s, c, k, r: jvcm.render_iteration(
        s, c, jcfg, jnp.int32(0), k, r))(js, jc, jrng.make_root_key(SEED),
                                         jnp.float32(r2))
    got, gst = vcm.render_iteration(ts, tc, cfg, 0, make_root_key(SEED), r2)
    no_vm, _ = vcm.render_iteration(ts, tc, cfg.replace(vcm_use_vm=False),
                                    0, make_root_key(SEED), r2)
    return (got.numpy(), {k: float(v) for k, v in gst.items()},
            np.asarray(want), {k: float(v) for k, v in wst.items()},
            no_vm.numpy())


def test_one_vm_iteration_matches_jax_tile_merge(vm_iteration_pair):
    got, gst, want, wst, no_vm = vm_iteration_pair
    assert got.shape == want.shape == (SIZE, SIZE, 3)
    assert np.isfinite(got).all()
    agree = np.isclose(got, want, rtol=1e-3, atol=0.0).all(axis=-1)
    assert agree.mean() >= 0.99, agree.mean()
    assert got.mean() == pytest.approx(want.mean(), rel=1e-3)
    assert gst["light_vertices_stored"] == pytest.approx(
        wst["light_vertices_stored"], rel=5e-3)
    # merging changed the image: the weights moved energy between
    # techniques
    assert not np.allclose(got, no_vm, rtol=1e-3, atol=0.0)


def test_vm_iteration_is_deterministic_and_light_pass_unchanged(
        vm_iteration_pair):
    """The light pass does not depend on merging: both runs store the same
    number of vertices, and a second VM run repeats the image bit for
    bit."""
    got, gst, _, _, _ = vm_iteration_pair
    ts, tc = get_scene_by_name("CornellSmall", "cpu")
    cfg = RenderConfig(**ITER_CFG, render_method=VCM)
    r2 = Renderer(ts, tc, cfg, seed=SEED).ppm_initial_radius ** 2
    again, st = vcm.render_iteration(ts, tc, cfg, 0, make_root_key(SEED),
                                     r2)
    np.testing.assert_array_equal(again.numpy(), got)
    assert float(st["light_vertices_stored"]) == gst["light_vertices_stored"]


@pytest.mark.slow
def test_vcm_vm_agrees_with_pt():
    """Port-only statistics (``test_vcm_vm.py:61``): full VCM with merging
    and PT estimate the same image."""
    scene, cam = get_scene_by_name("CornellSmall", "cpu")
    rv = Renderer(scene, cam, RenderConfig(width=48, height=48,
                                           render_method=VCM,
                                           vcm_use_vm=True), seed=13)
    vcm_img = rv.render(20).mean_radiance().numpy()
    rt = Renderer(scene, cam, RenderConfig(width=48, height=48), seed=14)
    pt_img = rt.render(80).mean_radiance().numpy()
    assert np.isfinite(vcm_img).all()
    assert vcm_img.mean() == pytest.approx(pt_img.mean(), rel=0.06)
    a = vcm_img.reshape(8, 6, 8, 6, 3).mean(axis=(1, 3, 4))
    b = pt_img.reshape(8, 6, 8, 6, 3).mean(axis=(1, 3, 4))
    mask = b > 0.02
    assert np.median(np.abs(a - b)[mask] / b[mask]) < 0.15


def test_iteration_key_passes_are_jax_ones():
    assert (vcm.PASS_VCM_LIGHT, vcm.PASS_VCM_CAMERA) == (
        jvcm.PASS_VCM_LIGHT, jvcm.PASS_VCM_CAMERA)
    want = jrng.iteration_key(jrng.make_root_key(SEED), 3,
                              jvcm.PASS_VCM_CAMERA)
    assert iteration_key(make_root_key(SEED), 3, vcm.PASS_VCM_CAMERA) == \
        tuple(int(w) for w in np.asarray(jax.random.key_data(want)))
