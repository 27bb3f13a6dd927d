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
from oppositerenderer_tpu_torch.accel.intersect import (occluder_mask,
                                                        intersect, occluded)
from oppositerenderer_tpu_torch.scene import get_scene_by_name

# the JAX package re-exports intersect() under the module's name
jint = importlib.import_module("oppositerenderer_tpu.accel.intersect")

torch.set_num_threads(2)


def random_rays(n, seed, tmax_scale=None):
    rng = np.random.default_rng(seed)
    o = rng.uniform(0.2, 2.3, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmin = np.full(n, 1e-4, np.float32)
    tmax = (np.full(n, 1e6, np.float32) if tmax_scale is None else
            rng.uniform(0.05, tmax_scale, n).astype(np.float32))
    return o, d, tmin, tmax


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
    tscene, _ = get_scene_by_name(name)
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
@pytest.mark.parametrize("name", ["CornellSmall", "CornellSmallLargeSphere"])
def test_occluded_matches_jax(name, backend):
    jint.set_backend(backend)
    jscene, _ = jax_scene(name)
    tscene, _ = get_scene_by_name(name)
    ja, ta = both(*random_rays(2000, seed=2, tmax_scale=2.0))
    want = np.asarray(jint.occluded(jscene, *ja))
    got = occluded(tscene, *ta).numpy()
    assert 0.1 < want.mean() < 0.9
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", [131, 2000])
def test_plain_kernels_match_pallas_interpret(n):
    """The plain versions against the TPU kernels themselves, with a ray
    count that is no multiple of any block and a tenth of the lanes dead
    (tmax < tmin)."""
    tscene, _ = get_scene_by_name("CornellSmall")
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
        *ta, tri9))
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
    got = ik.occluded_tris_plain(*ta, tri9, occ_mask).numpy()
    np.testing.assert_array_equal(got, want)
    assert not got[::10].any()


def test_chunking_does_not_change_results():
    tscene, _ = get_scene_by_name("CornellSmall")
    tri9 = ik.tri9_from_geometry(tscene.geometry)
    mask = occluder_mask(tscene, tscene.geometry.tri_mat)
    ta = [torch.as_tensor(a) for a in random_rays(1000, seed=4, tmax_scale=2)]
    whole = ik.closest_hit_tris_plain(*ta, tri9)
    chunked = ik.closest_hit_tris_plain(*ta, tri9, chunk_size=97)
    for a, b in zip(whole, chunked):
        assert torch.equal(a, b)
    assert torch.equal(ik.occluded_tris_plain(*ta, tri9, mask),
                       ik.occluded_tris_plain(*ta, tri9, mask,
                                              chunk_size=97))


def test_cpu_calls_run_the_plain_version_and_count_no_launch():
    tscene, _ = get_scene_by_name("CornellSmall")
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
    tscene, _ = get_scene_by_name("CornellSmall")
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
