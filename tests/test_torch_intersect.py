"""Port dense intersection (kernels' plain versions) vs the JAX package.

The port's ``intersect``/``occluded`` on CPU tensors run the plain
versions of the CUDA kernels. They are held against the JAX dense path
(``jnp`` backend) and against the Pallas kernels in interpret mode, at
the tolerances of ``tests/test_pallas_intersect.py`` (t rtol 1e-5, the
winning primitive exact, attributes on hit lanes atol 1e-5, occlusion
exact) plus an absolute 1e-6 on t: XLA:CPU contracts multiply-adds that
torch rounds separately, and for hits a few millimetres from the ray
origin the cancellation in Moller-Trumbore makes that last-ulp difference
reach 5e-5 of t.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oppositerenderer_tpu.accel import pallas_intersect_t as jpk
from oppositerenderer_tpu.scene import get_scene_by_name as jax_scene
from oppositerenderer_tpu_torch.accel import intersect_kernels as ik
from oppositerenderer_tpu_torch.accel.intersect import (dense_tables,
                                                        occluder_mask,
                                                        intersect, occluded)
from oppositerenderer_tpu_torch.scene import SCENE_NAMES, get_scene_by_name

# the JAX package re-exports intersect() under the module's name
jint = importlib.import_module("oppositerenderer_tpu.accel.intersect")

torch.set_num_threads(2)


def random_rays(n, seed, tmax_scale=None, lo=0.2, hi=2.3):
    rng = np.random.default_rng(seed)
    o = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmin = np.full(n, 1e-4, np.float32)
    tmax = (np.full(n, 1e6, np.float32) if tmax_scale is None else
            rng.uniform(0.05, tmax_scale, n).astype(np.float32))
    return o, d, tmin, tmax


def scene_rays(scene, n, seed):
    """Random rays inside the scene's box, a tenth of its extent to its
    extent long: CornellSmall's box is the default one of random_rays."""
    lo = scene.aabb_min.numpy()
    hi = scene.aabb_max.numpy()
    ext = float(np.max(hi - lo))
    o, d, tmin, tmax = random_rays(n, seed, tmax_scale=1.0,
                                   lo=lo + 0.01 * ext, hi=hi - 0.01 * ext)
    return o, d, tmin, tmax * np.float32(ext)


def both(*arrays):
    return ([jnp.asarray(a) for a in arrays],
            [torch.as_tensor(a) for a in arrays])


@pytest.fixture(autouse=True)
def restore_backend():
    yield
    jint.set_backend("jnp")


@pytest.mark.parametrize("backend", ["jnp", "pallas_interpret"])
@pytest.mark.parametrize("name", ["CornellSmall", "CornellSmallLargeSphere"])
def test_intersect_matches_jax(name, backend):
    jint.set_backend(backend)
    jscene, _ = jax_scene(name)
    tscene, _ = get_scene_by_name(name, "cpu")
    ja, ta = both(*random_rays(2000, seed=1))
    a = jint.intersect(jscene, *ja)
    b = intersect(tscene, *ta)
    h = np.asarray(a.hit)
    np.testing.assert_array_equal(b.hit.numpy(), h)
    np.testing.assert_allclose(b.t.numpy(), np.asarray(a.t), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_array_equal(b.prim.numpy(), np.asarray(a.prim))
    for f in ("position", "ns", "ng", "uv"):
        np.testing.assert_allclose(getattr(b, f).numpy()[h],
                                   np.asarray(getattr(a, f))[h], atol=1e-5,
                                   err_msg=f)
    np.testing.assert_array_equal(b.mat.numpy()[h], np.asarray(a.mat)[h])


@pytest.mark.parametrize("backend", ["jnp", "pallas_interpret"])
@pytest.mark.parametrize("name", SCENE_NAMES)
def test_occluded_matches_jax(name, backend):
    """The scene's cached occluder table (kernel B2's input) against JAX's
    any hit over every triangle with its flag, on the eight Cornell
    scenes; and the plain any hit on the table against the flag-mask
    version on the same rays."""
    jint.set_backend(backend)
    jscene, _ = jax_scene(name)
    tscene, _ = get_scene_by_name(name, "cpu")
    rays = scene_rays(tscene, 2000, seed=2)
    ja, ta = both(*rays)
    want = np.asarray(jint.occluded(jscene, *ja))
    got = occluded(tscene, *ta).numpy()
    assert 0.1 < want.mean() < 0.9
    np.testing.assert_array_equal(got, want)
    tris, occ = dense_tables(tscene)
    assert dense_tables(tscene)[1] is occ          # built once per scene
    g = tscene.geometry
    mask = occluder_mask(tscene, g.tri_mat)
    assert occ.shape == (int(mask.sum()), ik.TRI_RECORD)
    *_, valid = ik._mt_terms(*ta, tris)
    assert torch.equal(ik.occluded_tris_plain(*ta, occ),
                       torch.any(valid & mask[None, :], dim=1))


def test_occluder_table_is_rebuilt_for_new_geometry():
    """dataclasses.replace does not carry the cached tables to a scene
    with other geometry. B1's record table holds every triangle, B2's the
    non-emitters', each as tri9's columns in index order with zero
    padding, 16-byte aligned."""
    import dataclasses
    tscene, _ = get_scene_by_name("Cornell", "cpu")
    tris, occ = dense_tables(tscene)
    g = tscene.geometry
    tri9 = ik.tri9_from_geometry(g)
    mask = occluder_mask(tscene, g.tri_mat)
    assert 0 < occ.shape[0] < g.n_triangles
    assert tris.shape == (g.n_triangles, ik.TRI_RECORD)
    cols = [0, 1, 2, 4, 5, 6, 8, 9, 10]
    np.testing.assert_array_equal(tris.numpy()[:, cols], tri9.T.numpy())
    np.testing.assert_array_equal(occ.numpy()[:, cols], tri9.T[mask].numpy())
    for table in (tris, occ):
        assert not table[:, [3, 7, 11]].any()
        assert table.is_contiguous() and table.data_ptr() % 16 == 0
    moved = dataclasses.replace(g, tri_v0=g.tri_v0 + 1.0)
    other = dataclasses.replace(tscene, geometry=moved)
    new_tris, new_occ = dense_tables(other)
    assert torch.equal(new_tris[:, :3], tris[:, :3] + 1.0)
    assert torch.equal(new_tris[:, 4:], tris[:, 4:])
    assert torch.equal(new_occ[:, :3], occ[:, :3] + 1.0)
    again = dense_tables(tscene)
    assert again[0] is tris and again[1] is occ


@pytest.mark.parametrize("n", [131, 2000])
def test_plain_kernels_match_pallas_interpret(n):
    """The plain versions against the TPU kernels themselves, with a ray
    count that is no multiple of any block and a tenth of the lanes dead
    (tmax < tmin)."""
    tscene, _ = get_scene_by_name("CornellSmall", "cpu")
    g = tscene.geometry
    tri9 = ik.tri9_from_geometry(g)
    occ_mask = occluder_mask(tscene, g.tri_mat)
    o, d, tmin, tmax = random_rays(n, seed=3, tmax_scale=3.0)
    tmax[::10] = 0.0
    ja, ta = both(o, d, tmin, tmax)
    jtri9 = jnp.asarray(tri9.numpy())
    t, idx, u, v = (np.asarray(x) for x in jpk.closest_hit_tris(
        *ja, jtri9, interpret=True))
    tt, tidx, tu, tv = (x.numpy() for x in ik.closest_hit_tris_plain(
        *ta, ik.triangle_records(tri9)))
    assert tidx.dtype == np.int32 and tt.dtype == np.float32
    np.testing.assert_array_equal(tidx, idx)
    hit = idx >= 0
    assert not hit[::10].any()           # dead lanes miss
    np.testing.assert_allclose(tt, t, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tu[hit], u[hit], atol=1e-5)
    np.testing.assert_allclose(tv[hit], v[hit], atol=1e-5)
    assert (tu[~hit] == 0).all() and (tv[~hit] == 0).all()
    want = np.asarray(jpk.occluded_tris(*ja, jtri9,
                                        jnp.asarray(occ_mask.numpy()),
                                        interpret=True))
    got = ik.occluded_tris_plain(*ta, ik.triangle_records(
        tri9, occ_mask)).numpy()
    np.testing.assert_array_equal(got, want)
    assert not got[::10].any()


def tie_table(i, j, n_tris=128, seed=7):
    """[9, n_tris]: CornellSmall's 32 triangles, then small triangles far
    outside its box, with triangle j a copy of triangle i."""
    g = get_scene_by_name("CornellSmall", "cpu")[0].geometry
    rng = np.random.default_rng(seed)
    far = n_tris - g.n_triangles
    tri9 = np.concatenate([ik.tri9_from_geometry(g).numpy(), np.concatenate([
        rng.uniform(50.0, 60.0, (3, far)), rng.normal(0.0, 0.1, (6, far))])],
        axis=1).astype(np.float32)
    dup = tri9.copy()
    dup[:, j] = tri9[:, i]
    return tri9, dup


def rays_at_triangle(tri9, i, n, seed):
    """Rays from random points in CornellSmall's box to random points of
    triangle i."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(0.2, 2.3, (n, 3)).astype(np.float32)
    a, b = rng.uniform(0.05, 0.95, (2, n))
    swap = a + b > 1.0
    a, b = np.where(swap, 1.0 - a, a), np.where(swap, 1.0 - b, b)
    target = (tri9[0:3, i][None] + a[:, None] * tri9[3:6, i][None]
              + b[:, None] * tri9[6:9, i][None])
    d = (target - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (o, d, np.full(n, 1e-4, np.float32), np.full(n, 1e6, np.float32))


@pytest.mark.parametrize("i,j", [(0, 1), (4, 31), (10, 70), (31, 127)])
def test_equal_t_goes_to_the_lower_index(i, j):
    """Triangle j is a copy of triangle i (pairs within and across the
    TPU kernel's 64-triangle blocks): every ray that hits it gets index i
    from the plain version, as from the TPU kernel, with the t, u and v
    it gets when triangle j is elsewhere."""
    tri9, dup = tie_table(i, j)
    rays = rays_at_triangle(tri9, i, 512, seed=i + j)
    ja, ta = both(*rays)
    got = ik.closest_hit_tris_plain(*ta, ik.triangle_records(
        torch.as_tensor(dup)))
    alone = ik.closest_hit_tris_plain(*ta, ik.triangle_records(
        torch.as_tensor(tri9)))
    want = [np.asarray(x) for x in jpk.closest_hit_tris(
        *ja, jnp.asarray(dup), interpret=True)]
    idx = got[1].numpy()
    np.testing.assert_array_equal(idx, want[1])
    assert (idx == i).sum() > 100 and not (idx == j).any()
    for a, b in zip(got, alone):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kind", ["equal", "below", "zero"])
def test_dead_lanes_miss(kind):
    """A lane with tmax <= tmin returns (1e30, -1, 0, 0) from the closest
    hit and False from the any hit."""
    tris, occ = dense_tables(get_scene_by_name("CornellSmall", "cpu")[0])
    o, d, tmin, tmax = (torch.as_tensor(a) for a in random_rays(300, seed=8))
    dead = torch.arange(300) % 3 == 0
    tmin = torch.where(dead & (kind == "zero"), 0.0, tmin)
    tmax = torch.where(dead, {"equal": tmin, "below": tmin - 1.0,
                              "zero": torch.zeros_like(tmin)}[kind], tmax)
    t, idx, u, v = ik.closest_hit_tris(o, d, tmin, tmax, tris)
    assert (t[dead] == ik.BIG).all() and (idx[dead] == -1).all()
    assert (u[dead] == 0).all() and (v[dead] == 0).all()
    assert (idx[~dead] >= 0).float().mean() > 0.5   # the box is open
    assert not ik.occluded_tris(o, d, tmin, tmax, occ)[dead].any()


def test_chunking_does_not_change_results():
    tscene, _ = get_scene_by_name("CornellSmall", "cpu")
    tris, occ = dense_tables(tscene)
    ta = [torch.as_tensor(a) for a in random_rays(1000, seed=4, tmax_scale=2)]
    whole = ik.closest_hit_tris_plain(*ta, tris)
    chunked = ik.closest_hit_tris_plain(*ta, tris, chunk_size=97)
    for a, b in zip(whole, chunked):
        assert torch.equal(a, b)
    assert torch.equal(ik.occluded_tris_plain(*ta, occ),
                       ik.occluded_tris_plain(*ta, occ, chunk_size=97))


def test_cpu_calls_run_the_plain_version_and_count_no_launch():
    tscene, _ = get_scene_by_name("CornellSmall", "cpu")
    before = (ik.closest_hit_tris.launches, ik.occluded_tris.launches)
    ta = [torch.as_tensor(a) for a in random_rays(64, seed=5)]
    intersect(tscene, *ta)
    occluded(tscene, *ta)
    assert (ik.closest_hit_tris.launches, ik.occluded_tris.launches) == before


def test_bvh_scene_raises():
    """A scene with a BVH takes the BVH route (kernel B5's plain version on
    the CPU), no longer the dense one: a table the kernel cannot walk (too
    deep for its stack, another arity) raises there on every device, and
    a real one gives the dense path's hits."""
    import dataclasses
    from oppositerenderer_tpu_torch.accel import bvh_kernels
    from oppositerenderer_tpu_torch.accel.bvh import build_scene_bvh
    tscene, _ = get_scene_by_name("CornellSmall", "cpu")
    ta = [torch.as_tensor(a) for a in random_rays(64, seed=6)]
    scene_b, bvh = build_scene_bvh(tscene)
    for bad, match in (
            (dict(max_stack=bvh_kernels.KERNEL_MAX_STACK + 1), "stack"),
            (dict(arity=4), "arity")):
        broken = dataclasses.replace(
            scene_b, bvh=dataclasses.replace(bvh, **bad))
        with pytest.raises(ValueError, match=match):
            intersect(broken, *ta)
        with pytest.raises(ValueError, match=match):
            occluded(broken, *ta)
    a = intersect(tscene, *ta)
    b = intersect(dataclasses.replace(scene_b, bvh=bvh), *ta)
    assert torch.equal(a.hit, b.hit)
    np.testing.assert_allclose(b.t.numpy(), a.t.numpy(), rtol=1e-6)
