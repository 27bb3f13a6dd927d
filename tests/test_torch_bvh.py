"""Port BVH build and traversal (the plain version of kernel B5) vs the JAX
package.

The host build is the same C++ source under the same g++ flags and the
same float64 collapse, so the port's table, root code, depth and triangle
permutation equal JAX's array for array (codes and masks compared as
int32 bit patterns). Traversal: the plain version against JAX's wavefront
(``bvh._traverse_impl`` on its float32 loop) on JAX's own table, with a
seventh of the lanes dead: found and prim exact, t within rtol 1e-5 +
atol 1e-6 (XLA:CPU contracts multiply-adds in Moller-Trumbore), u and v
within 1e-4; and against the packet kernel in interpret mode at
``tests/test_pallas_bvh.py``'s tolerances (the packet kernel pushes
far-first by its tile's entry distance, so an exact tie could pick
another triangle).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oppositerenderer_tpu.accel import bvh as JB
from oppositerenderer_tpu.accel.pallas_bvh import packet_traverse
from oppositerenderer_tpu.scene import SceneBuilder as JSceneBuilder
from oppositerenderer_tpu.scene import get_scene_by_name as jax_scene
from oppositerenderer_tpu.lights import make_point_light as jpoint
from oppositerenderer_tpu_torch import interop
from oppositerenderer_tpu_torch.accel import bvh as TB
from oppositerenderer_tpu_torch.accel import bvh_kernels as bk
from oppositerenderer_tpu_torch.accel.intersect import intersect, occluded
from oppositerenderer_tpu_torch.lights import make_point_light
from oppositerenderer_tpu_torch.native import build_bvh_native
from oppositerenderer_tpu_torch.scene import SceneBuilder, get_scene_by_name

torch.set_num_threads(2)

TRI_FIELDS = ("tri_v0", "tri_e1", "tri_e2", "tri_n0", "tri_n1", "tri_n2",
              "tri_uv0", "tri_uv1", "tri_uv2", "tri_tangent",
              "tri_bitangent", "tri_mat")


def soup(n_tris, seed=0):
    """tests/test_bvh.py:14's random soup, built by both packages."""
    scenes = []
    for Builder, point in ((JSceneBuilder, jpoint),
                           (SceneBuilder, make_point_light)):
        rng = np.random.default_rng(seed)
        b = Builder()
        mat = b.add_diffuse((0.7, 0.7, 0.7))
        centers = rng.uniform(-5, 5, (n_tris, 3)).astype(np.float32)
        for c in centers:
            v1 = c + rng.normal(0, 0.2, 3)
            v2 = c + rng.normal(0, 0.2, 3)
            b.add_triangle(c, v1, v2, mat)
        b.add_light(point((10.0,) * 3, (0, 8, 0)))
        scenes.append(b.build())
    return scenes


def bvh_leaves(jbvh):
    return {f.name: np.asarray(getattr(jbvh, f.name))
            for f in dataclasses.fields(jbvh) if f.name != "q_rows"}


def jax_depth(jbvh):
    """The wide tree's depth from JAX's max_stack: 2 depth + 1 with its
    int8 table (code stack), depth + 1 without."""
    return ((jbvh.max_stack - 1) // 2 if jbvh.q_rows is not None
            else jbvh.max_stack - 1)


def assert_bvh_equal(tbvh, jbvh, built_here=True):
    np.testing.assert_array_equal(tbvh.rows.numpy().view(np.int32),
                                  np.asarray(jbvh.rows).view(np.int32))
    for f in ("nodes_min", "nodes_max", "nodes_a", "nodes_b"):
        np.testing.assert_array_equal(getattr(tbvh, f).numpy(),
                                      np.asarray(getattr(jbvh, f)),
                                      err_msg=f)
    assert (tbvh.root_code, tbvh.arity, tbvh.leaf_size) == (
        jbvh.root_code, jbvh.arity, jbvh.leaf_size)
    if built_here:   # the port's stack holds one entry per level
        assert tbvh.max_stack - 1 == jax_depth(jbvh)
    else:
        assert tbvh.max_stack == jbvh.max_stack


def assert_geometry_equal(tscene, jscene):
    for f in TRI_FIELDS:
        np.testing.assert_array_equal(getattr(tscene.geometry, f).numpy(),
                                      np.asarray(getattr(jscene.geometry, f)),
                                      err_msg=f)


def test_native_builder_compiles_and_runs():
    pmin = np.asarray([[0, 0, 0], [2, 0, 0], [0, 2, 0], [4, 4, 4]],
                      np.float32)
    pmax = pmin + 1.0
    out = build_bvh_native(pmin, pmax, 0.5 * (pmin + pmax), 1)
    assert out is not None, "native builder failed to compile/run"
    nmn, nmx, na, nb, order = out
    assert len(na) >= 4
    assert sorted(order.tolist()) == [0, 1, 2, 3]
    np.testing.assert_allclose(nmn[0], [0, 0, 0])
    np.testing.assert_allclose(nmx[0], [5, 5, 5])


@pytest.mark.parametrize("fallback", [False, True])
def test_bvh_structure_invariants(fallback, monkeypatch):
    if fallback:   # no g++: the numpy median split, as in the JAX package
        monkeypatch.setattr("oppositerenderer_tpu_torch.native.get_lib",
                            lambda: None)
    pmin = np.random.default_rng(3).uniform(0, 10, (500, 3)).astype(
        np.float32)
    pmax = pmin + 0.5
    bvh, order = TB.build_bvh_arrays(pmin, pmax, leaf_size=8)
    assert bvh.builder == ("numpy" if fallback else "native")
    na = bvh.nodes_a.numpy()
    nb = bvh.nodes_b.numpy()
    leaves = na < 0
    covered = []
    for i in np.where(leaves)[0]:
        covered += list(range(~na[i], ~na[i] + nb[i]))
    assert sorted(covered) == list(range(500))
    assert sorted(order.tolist()) == list(range(500))
    for i in np.where(~leaves)[0]:
        assert i < na[i] < na.shape[0] and i < nb[i] < na.shape[0]
    if fallback:
        want = JB._build_numpy(pmin, pmax, 0.5 * (pmin + pmax), 8)
        np.testing.assert_array_equal(na, want[2])
        np.testing.assert_array_equal(order, want[4])


@pytest.mark.parametrize("collapse", ["sah", "greedy"])
@pytest.mark.parametrize("case", ["CornellSmall", "soup300", "soup3000"])
def test_build_matches_jax(case, collapse):
    if case.startswith("soup"):
        jscene, tscene = soup(int(case[4:]))
    else:
        jscene, tscene = jax_scene(case)[0], get_scene_by_name(case)[0]
    jsb, jbvh = JB.build_scene_bvh(jscene, collapse=collapse)
    tsb, tbvh = TB.build_scene_bvh(tscene, collapse=collapse)
    assert tbvh.builder == "native"
    assert_bvh_equal(tbvh, jbvh)
    assert_geometry_equal(tsb, jsb)


@pytest.mark.parametrize("name", ["Atrium:0.1", "Conference:0.15"])
def test_scene_bvh_matches_jax(name):
    jscene, tscene = jax_scene(name)[0], get_scene_by_name(name)[0]
    assert tscene.geometry.n_triangles > TB.BVH_AUTO_THRESHOLD
    assert_bvh_equal(tscene.bvh, jscene.bvh)
    assert_geometry_equal(tscene, jscene)
    # the same table through interop
    assert_bvh_equal(interop.bvh_from_numpy(bvh_leaves(jscene.bvh)),
                     jscene.bvh, built_here=False)


def rays(n, lo, hi, seed, kill_every=7, tmax_value=1e30):
    rng = np.random.default_rng(seed)
    o = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmin = np.full(n, 1e-3, np.float32)
    tmax = np.full(n, tmax_value, np.float32)
    tmax[::kill_every] = 0.0    # dead lanes
    return o, d, tmin, tmax


@pytest.fixture(scope="module")
def atrium():
    jscene, _ = jax_scene("Atrium:0.1")
    return jscene, interop.bvh_from_numpy(bvh_leaves(jscene.bvh))


@pytest.mark.parametrize("seed", [5, 6])
def test_plain_traversal_matches_jax_wavefront(atrium, seed):
    jscene, tbvh = atrium
    jbvh = jscene.bvh.replace(q_rows=None)
    arrays = rays(3000, np.asarray(jscene.aabb_min),
                  np.asarray(jscene.aabb_max), seed)
    ja = [jnp.asarray(a) for a in arrays]
    ta = [torch.as_tensor(a) for a in arrays]
    want = [np.asarray(x) for x in JB._traverse_impl(
        jbvh, jscene.geometry, *ja, any_hit=False)]
    got = [x.numpy() for x in bk.traverse_plain(tbvh, *ta)]
    f = want[4]
    np.testing.assert_array_equal(got[4], f)
    assert 0.3 < f.mean() < 0.95 and not f[::7].any()
    np.testing.assert_array_equal(got[1], want[1])
    assert got[1].dtype == np.int32 and (got[1][~f] == -1).all()
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got[2], want[2], atol=1e-4)
    np.testing.assert_allclose(got[3], want[3], atol=1e-4)
    # dead lanes return min(tmax, BIG) and u = v = 0, as the wavefront
    assert (got[0][::7] == 0.0).all() and (got[2][::7] == 0.0).all()
    short = rays(3000, np.asarray(jscene.aabb_min),
                 np.asarray(jscene.aabb_max), seed, tmax_value=2.0)
    want_any = np.asarray(JB._traverse_impl(
        jbvh, jscene.geometry, *(jnp.asarray(a) for a in short),
        any_hit=True)[4])
    got_any = bk.traverse_any_plain(
        tbvh, *(torch.as_tensor(a) for a in short)).numpy()
    np.testing.assert_array_equal(got_any, want_any)
    assert 0.1 < want_any.mean() < 0.9


@pytest.fixture(scope="module")
def cornell_bvh():
    jscene, _ = jax_scene("CornellSmall")
    jsb, jbvh = JB.build_scene_bvh(jscene)
    tsb, tbvh = TB.build_scene_bvh(get_scene_by_name("CornellSmall")[0])
    return jsb, jbvh, tbvh


@pytest.mark.parametrize("n, seed", [(1500, 0), (777, 5)])
def test_plain_traversal_matches_packet_kernel(cornell_bvh, n, seed):
    jscene, jbvh, tbvh = cornell_bvh
    arrays = rays(n, np.asarray(jscene.aabb_min),
                  np.asarray(jscene.aabb_max), seed)
    ja = [jnp.asarray(a) for a in arrays]
    ta = [torch.as_tensor(a) for a in arrays]
    t1, i1, u1, v1, f1 = (np.asarray(x) for x in packet_traverse(
        jbvh, *ja, any_hit=False, interpret=True))
    t0, i0, u0, v0, f0 = (x.numpy() for x in bk.traverse_plain(tbvh, *ta))
    np.testing.assert_array_equal(f0, f1)
    m = f0
    np.testing.assert_allclose(t0[m], t1[m], rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(i0[m], i1[m])
    np.testing.assert_allclose(u0[m], u1[m], rtol=1e-4, atol=1e-4)
    want_any = np.asarray(packet_traverse(jbvh, *ja, any_hit=True,
                                          interpret=True)[4])
    np.testing.assert_array_equal(bk.traverse_any_plain(tbvh, *ta).numpy(),
                                  want_any)


def test_visits_count_the_rows_read(cornell_bvh):
    *_, tbvh = cornell_bvh
    A, L = tbvh.arity, tbvh.leaf_size
    arrays = [torch.as_tensor(a) for a in rays(500, 0.0, 2.5, 3)]
    rows_i = tbvh.rows.view(torch.int32)
    # the floats each row's read uses, walking the table from the root
    want = {}
    todo = [tbvh.root_code]
    while todo:
        code = todo.pop()
        if code < 0:
            want[(-code - 1) >> 5] = ((-code - 1) & 31, None)
            continue
        mask = int(rows_i[code, 7 * A])
        kids = [int(rows_i[code, 6 * A + c]) for c in range(A)
                if mask >> c & 1]
        want[code] = (None, len(kids))
        todo += kids
    for any_hit in (False, True):
        *_, found, visits, row_floats = bk.plain_traversal(
            tbvh, *arrays, any_hit=any_hit)
        assert (visits[::7] == 0).all()             # dead lanes read nothing
        live = visits[torch.arange(500) % 7 != 0]
        assert (live[:, 0] >= 1).all()              # at least the root
        # every inner visit tests at least one child, at most A
        assert (live[:, 0] <= live[:, 2]).all()
        assert (live[:, 2] <= A * live[:, 0]).all()
        assert (live[:, 3] <= L * live[:, 1]).all()
        read = torch.nonzero(row_floats)[:, 0].tolist()
        assert 0 < len(read) <= tbvh.rows.shape[0]
        for r in read:
            count, n_kids = want[r]
            assert int(row_floats[r]) == (
                7 * n_kids + 1 if count is None
                else 10 * count if any_hit else 9 * count + 1)
    # any hit tests at most the triangles closest hit tests
    closest = bk.plain_traversal(tbvh, *arrays, any_hit=False)[5]
    assert int(visits[:, 3].sum()) <= int(closest[:, 3].sum())
    assert found.any()


@pytest.mark.parametrize("n_tris", [300, 3000])
def test_bvh_intersect_matches_dense(n_tris):
    """tests/test_bvh.py:73-101 on the port: the BVH path against the
    port's dense path on the random soup."""
    _, scene = soup(n_tris)
    scene_b, bvh = TB.build_scene_bvh(scene, leaf_size=16)
    scene_b = dataclasses.replace(scene_b, bvh=bvh)
    o, d, tmin, tmax = (torch.as_tensor(a) for a in rays(
        400, -6.0, 6.0, 1, kill_every=10 ** 9, tmax_value=1e30))
    tmin = torch.full((400,), 1e-4)
    a = intersect(scene, o, d, tmin, tmax)
    b = intersect(scene_b, o, d, tmin, tmax)
    np.testing.assert_allclose(a.t.numpy(), b.t.numpy(), rtol=1e-5)
    np.testing.assert_array_equal(a.hit.numpy(), b.hit.numpy())
    h = a.hit.numpy()
    np.testing.assert_allclose(a.position.numpy()[h], b.position.numpy()[h],
                               atol=1e-4)
    np.testing.assert_allclose(np.abs(a.ng.numpy())[h],
                               np.abs(b.ng.numpy())[h], atol=1e-4)
    tmax = torch.full((400,), 4.0)
    np.testing.assert_array_equal(occluded(scene, o, d, tmin, tmax).numpy(),
                                  occluded(scene_b, o, d, tmin, tmax).numpy())


def test_cpu_calls_run_the_plain_version_and_count_no_launch(cornell_bvh):
    *_, tbvh = cornell_bvh
    before = (bk.traverse.launches, bk.traverse_any.launches)
    arrays = [torch.as_tensor(a) for a in rays(64, 0.0, 2.5, 4)]
    got = bk.traverse(tbvh, *arrays)
    want = bk.traverse_plain(tbvh, *arrays)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    bk.traverse_any(tbvh, *arrays)
    assert (bk.traverse.launches, bk.traverse_any.launches) == before
