"""PPM's other photon maps, the stochastic hash and the CPU kd-tree,
against the JAX package's on the same photons, and one PPM iteration with
each against JAX's.

``core.rng.uniform`` is ``jax.random.uniform`` bit for bit (the hash's
priorities feed a sort). The hash table is held bit for bit (a stable
sort of the priorities, and the last photon of that order wins each
slot), its gather at rtol 1e-5 (the same terms in the same order). The
native kd-tree builder is one source in both packages, so the tree's
permutation and split axes are equal; the kd gather visits the same slots
in the same order and agrees at rtol 1e-4 + atol 1e-5, the bar of
``tests/test_photon_map.py:167``. One 24^2 PPM iteration per structure
agrees with JAX's in the mean within 1e-3 and on >= 99% of the pixels at
rtol 1e-3 (PPM's pixel bar, ROADMAP queue C); the hash's on >= 98%, or
on >= 99% when the port gathers from JAX's own photons: its cells turn
the photon pass's last-ulp differences into other slots. The mirrors of the JAX
package's own tests keep their bars: the hash within 35% of the exact
gather (``test_photon_map.py:104``), the kd gather equal to brute force
(``:150``) and within 5% of the grid in a PPM iteration (``:167``), and
the hash's image mean within 25% of the grid's (``test_ppm.py:93``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oppositerenderer_tpu import photon_map as jpm
from oppositerenderer_tpu.config import PhotonMapStructure as JStructure
from oppositerenderer_tpu.config import RenderConfig as JConfig
from oppositerenderer_tpu.core import rng as jrng
from oppositerenderer_tpu.integrators import common as jcommon
from oppositerenderer_tpu.integrators import ppm as jppm
from oppositerenderer_tpu.native import \
    build_photon_kdtree_native as jax_kdtree_native
from oppositerenderer_tpu.scene import get_scene_by_name as jax_scene
from oppositerenderer_tpu_torch import interop, native
from oppositerenderer_tpu_torch import photon_map as pm
from oppositerenderer_tpu_torch.config import (PhotonMapStructure,
                                               RenderConfig, RenderMethod)
from oppositerenderer_tpu_torch.core.rng import (fold_in, make_root_key,
                                                 uniform)
from oppositerenderer_tpu_torch.integrators import ppm
from oppositerenderer_tpu_torch.renderer import Renderer
from oppositerenderer_tpu_torch.scene import get_scene_by_name

torch.set_num_threads(2)

PPM = RenderMethod.PROGRESSIVE_PHOTON_MAPPING
HASH = PhotonMapStructure.STOCHASTIC_HASH
KD = PhotonMapStructure.KD_TREE_CPU
HASH_GATHER_RTOL = 1e-5
KD_RTOL, KD_ATOL = 1e-4, 1e-5
PIXEL_RTOL, MIN_AGREEING, MEAN_RTOL = 1e-3, 0.99, 1e-3


def make_photons(n=3000, seed=0, frac_valid=0.9, cluster=False):
    """numpy photons in [0, 2]^3 with downward directions (a +y normal
    accepts them); ``cluster`` piles half of them near one point, so
    slots and splitting planes meet many equal cells."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0.0, 2.0, (n, 3)).astype(np.float32)
    if cluster:
        pos[: n // 2] = (1.0 + 0.03 * rng.standard_normal((n // 2, 3))
                         ).astype(np.float32)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d[:, 1] = -np.abs(d[:, 1]) - 0.01
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return dict(position=pos,
                power=rng.uniform(0.0, 1.0, (n, 3)).astype(np.float32),
                direction=d, valid=rng.uniform(size=n) < frac_valid)


def both(leaves):
    jb = jpm.PhotonBatch(**{k: jnp.asarray(v) for k, v in leaves.items()})
    return jb, interop.photon_batch_from_numpy(leaves, "cpu")


def queries(n=256, seed=10, lo=0.3, hi=1.7, up=True):
    rng = np.random.default_rng(seed)
    q = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    if up:
        nrm = np.tile(np.asarray([[0.0, 1.0, 0.0]], np.float32), (n, 1))
    else:
        nrm = rng.standard_normal((n, 3)).astype(np.float32)
        nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    return q, nrm


# --------------------------------------------------------------- uniform
@pytest.mark.parametrize("shape", [(1,), (7,), (8,), (4097,), (3, 5)])
def test_uniform_is_jax_random_uniform(shape):
    for seed, data in ((0, 77), (12345, 3)):
        jkey = jax.random.fold_in(jax.random.PRNGKey(seed), data)
        want = np.asarray(jax.random.uniform(jkey, shape))
        got = uniform(fold_in(make_root_key(seed), data), shape, "cpu")
        assert got.dtype == torch.float32 and tuple(got.shape) == shape
        np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------- stochastic hash
def test_hash_cell_wraps_as_int32():
    rng = np.random.default_rng(2)
    c = rng.integers(-2 ** 31, 2 ** 31, (4096, 3)).astype(np.int32)
    c[:4] = [[2 ** 31 - 1] * 3, [-2 ** 31] * 3, [0, 0, 0], [-1, 5, 7]]
    for log2 in (4, 14, 22):
        want = np.asarray(jpm._hash_cell(jnp.asarray(c), 1 << log2))
        got = pm._hash_cell(torch.as_tensor(c), 1 << log2)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("cluster,log2,cell", [(False, 14, 0.12),
                                               (True, 8, 0.05),
                                               (True, 12, 0.3)])
def test_hash_table_is_bit_identical(cluster, log2, cell):
    """Many photons share a slot (2^8 slots for 3000 photons): the
    survivor is the last in the stable priority order, as JAX's scatter
    leaves it."""
    jb, tb = both(make_photons(cluster=cluster))
    jh = jpm.build_stochastic_hash(jb, jnp.float32(cell), log2,
                                   jax.random.fold_in(
                                       jax.random.PRNGKey(4), 77))
    th = pm.build_stochastic_hash(tb, torch.tensor(cell), log2,
                                  fold_in(make_root_key(4), 77))
    for f in ("position", "power", "direction", "count", "origin"):
        want, got = np.asarray(getattr(jh, f)), getattr(th, f).numpy()
        assert got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want, err_msg=f)
    assert int(th.count.sum()) == int(np.asarray(jb.valid).sum())


def test_hash_gather_matches_jax():
    jb, tb = both(make_photons(cluster=True))
    key = (jax.random.PRNGKey(0), make_root_key(0))
    jh = jpm.build_stochastic_hash(jb, jnp.float32(0.12), 14, key[0])
    th = pm.build_stochastic_hash(tb, torch.tensor(0.12), 14, key[1])
    for up in (True, False):
        q, nrm = queries(up=up)
        want, _ = jpm.gather_stochastic_hash(jh, jnp.asarray(q),
                                             jnp.asarray(nrm),
                                             jnp.float32(0.12))
        got, stats = pm.gather_stochastic_hash(
            th, torch.as_tensor(q), torch.as_tensor(nrm), 0.12)
        want = np.asarray(want)
        assert stats == {} and float(want.sum()) > 0
        np.testing.assert_allclose(got.numpy(), want, rtol=HASH_GATHER_RTOL,
                                   atol=1e-6 * float(np.abs(want).max()))


def test_stochastic_hash_gather_approximates():
    """test_photon_map.py:104 on the port: the hash's estimate within 35%
    of the exact gather's in total."""
    _, tb = both(make_photons(n=3000, frac_valid=1.0))
    h = pm.build_stochastic_hash(tb, torch.tensor(0.12), 14, make_root_key(0))
    grid = pm.build_photon_grid(tb, 16)
    q, nrm = queries()
    q, nrm = torch.as_tensor(q), torch.as_tensor(nrm)
    exact, _ = pm.gather_photons(grid, q, nrm, 0.12, max_cells_per_axis=6,
                                 budget_total=1024)
    approx, _ = pm.gather_stochastic_hash(h, q, nrm, 0.12)
    se, sa = float(exact.sum()), float(approx.sum())
    assert se > 0 and abs(sa - se) / se < 0.35


# ------------------------------------------------------------------ kd-tree
@pytest.mark.parametrize("cluster", [False, True])
def test_kdtree_builder_matches_jax(cluster):
    """The native builder (one source in both packages) gives JAX's
    permutation and axes; so does the tree over a batch's valid rows."""
    assert native.kdtree_lib() is not None, "g++ could not build the kd-tree"
    leaves = make_photons(n=1500, frac_valid=0.8, cluster=cluster)
    pos = leaves["position"][leaves["valid"]]
    perm, axis = native.build_photon_kdtree_native(pos)
    jperm, jaxis = jax_kdtree_native(pos)
    np.testing.assert_array_equal(perm, jperm)
    np.testing.assert_array_equal(axis, jaxis)
    jb, tb = both(leaves)
    jt, tt = jpm.build_photon_kdtree(jb), pm.build_photon_kdtree(tb)
    assert tt.axis.shape[0] == pm._kd_capacity(1500) == 2047
    for f in ("position", "power", "direction", "axis", "n_valid"):
        np.testing.assert_array_equal(getattr(tt, f).numpy(),
                                      np.asarray(getattr(jt, f)), err_msg=f)


def test_kdtree_numpy_fallback_is_a_valid_tree():
    """Without g++ the numpy builder runs (np.argpartition as the
    nth_element): each slot's photon splits its subtrees on its axis."""
    pos = make_photons(n=700)["position"]
    perm = np.full(1023, -1, np.int32)
    axis = np.full(1023, native.KD_NULL, np.int32)
    native._build_kdtree_numpy(pos, perm, axis)
    assert sorted(perm[perm >= 0].tolist()) == list(range(700))

    def subtree(s):
        if s >= perm.shape[0] or perm[s] < 0:
            return []
        return [perm[s]] + subtree(2 * s + 1) + subtree(2 * s + 2)

    for s in range(64):
        if axis[s] < 3:
            ax, v = axis[s], pos[perm[s], axis[s]]
            assert all(pos[i, ax] <= v for i in subtree(2 * s + 1))
            assert all(pos[i, ax] >= v for i in subtree(2 * s + 2))


def test_kdtree_of_no_valid_photon():
    leaves = make_photons(n=40)
    leaves["valid"][:] = False
    tree = pm.build_photon_kdtree(both(leaves)[1])
    assert bool((tree.axis == native.KD_NULL).all()) and int(tree.n_valid) == 0
    got, stats = pm.gather_kdtree(tree, torch.rand(8, 3), torch.rand(8, 3),
                                  0.5)
    assert float(got.abs().sum()) == 0.0 and int(stats["kd_overrun"]) == 0


def brute_force_gather(leaves, q, normal, radius):
    pos, pw, dr, vd = (leaves[k] for k in ("position", "power", "direction",
                                           "valid"))
    out = np.zeros((q.shape[0], 3))
    r2 = radius * radius
    for i, p in enumerate(q):
        d2 = ((p - pos) ** 2).sum(1)
        ok = vd & (d2 <= r2) & ((-dr * normal).sum(1) >= 0)
        w = pm.gaussian_kernel_weight(torch.as_tensor(d2[ok]),
                                      torch.tensor(r2)).numpy()
        out[i] = (pw[ok] * w[:, None]).sum(0)
    return out


def test_kdtree_gather_matches_bruteforce():
    """test_photon_map.py:150 on the port, at its bar."""
    leaves = make_photons(n=600, frac_valid=0.8)
    tree = pm.build_photon_kdtree(both(leaves)[1])
    q, nrm = queries(n=64, seed=21, lo=0.2, hi=1.8)
    got, stats = pm.gather_kdtree(tree, torch.as_tensor(q),
                                  torch.as_tensor(nrm), 0.25,
                                  max_visits=4096)
    assert int(stats["kd_overrun"]) == 0
    want = brute_force_gather(leaves, q, np.asarray([0.0, 1.0, 0.0]), 0.25)
    np.testing.assert_allclose(got.numpy(), want, rtol=KD_RTOL, atol=KD_ATOL)


@pytest.mark.parametrize("max_visits", [4096, 37])
@pytest.mark.parametrize("check_normal", [True, False])
def test_kdtree_gather_matches_jax(max_visits, check_normal):
    """Over every step and cut short at a step that is no multiple of the
    live-lane check's period: the sums, the visits and the overrun count
    equal JAX's."""
    leaves = make_photons(n=1200, frac_valid=0.85, cluster=True)
    jb, tb = both(leaves)
    jt, tt = jpm.build_photon_kdtree(jb), pm.build_photon_kdtree(tb)
    q, nrm = queries(n=128, seed=3, lo=0.2, hi=1.8, up=False)
    want, wst = jpm.gather_kdtree(jt, jnp.asarray(q), jnp.asarray(nrm),
                                  jnp.float32(0.3), max_visits=max_visits,
                                  check_normal=check_normal)
    got, gst = pm.gather_kdtree(tt, torch.as_tensor(q), torch.as_tensor(nrm),
                                0.3, max_visits=max_visits,
                                check_normal=check_normal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=KD_RTOL,
                               atol=KD_ATOL)
    np.testing.assert_array_equal(gst["photons_visited"].numpy(),
                                  np.asarray(wst["photons_visited"]))
    assert int(gst["kd_overrun"]) == int(wst["kd_overrun"])
    assert (int(gst["kd_overrun"]) > 0) == (max_visits == 37)


# --------------------------------------------------------- PPM iterations
SIZE = 24
CFG = dict(width=SIZE, height=SIZE, render_method=PPM,
           photons_per_iteration=2048, max_photon_trace_depth=4,
           photon_grid_resolution=16)
R2 = 0.01
# the hash's cells amplify the photon pass's last-ulp differences (ROADMAP
# queue C): 9 of 3,478 photons change cell here, and the pixels that see
# their slots differ (98.4% agree); held to PPM's bar on JAX's photons
HASH_MIN_AGREEING = 0.98
# photons the kd gather visits depend on the tree's shape, which follows
# the positions' last ulps
KD_VISITED_RTOL = 1e-2


def _photons_of(out) -> dict:
    ph = out[0]
    return {k: np.asarray(getattr(ph, k))
            for k in ("position", "power", "direction", "valid")}


@pytest.fixture(scope="module")
def iterations():
    """One 24^2 PPM iteration of CornellSmall per structure through both
    packages (JAX jitted once per structure), at the same seed and
    radius; the port's grid image (its budgeted gather: 24 is no multiple
    of 16); and the port's hash iteration on JAX's own photon batch."""
    js, jc = jax_scene("CornellSmall")
    ts, tc = get_scene_by_name("CornellSmall", "cpu")
    out = {}
    for name, js_struct, ts_struct in (
            ("hash", JStructure.STOCHASTIC_HASH, HASH),
            ("kd", JStructure.KD_TREE_CPU, KD),
            ("grid", JStructure.SORTED_UNIFORM_GRID,
             PhotonMapStructure.SORTED_UNIFORM_GRID)):
        tcfg = RenderConfig(photon_map_structure=ts_struct, **CFG)
        got, gst = ppm.render_iteration(ts, tc, tcfg, 0, make_root_key(0),
                                        R2)
        if name == "grid":
            out[name] = got.numpy(), gst, None, None
            continue
        jcfg = JConfig(photon_map_structure=js_struct, **CFG)
        want, wst = jax.jit(lambda s, c, k, r: jppm.render_iteration(
            s, c, jcfg, jnp.int32(0), k, r))(js, jc, jrng.make_root_key(0),
                                            jnp.float32(R2))
        out[name] = (got.numpy(), {k: float(v) for k, v in gst.items()},
                     np.asarray(want), {k: float(v) for k, v in wst.items()})
    # the hash once more, the port gathering from JAX's photons
    jkey = jrng.iteration_key(jrng.make_root_key(0), jnp.int32(0),
                              jppm.PASS_PPM_PHOTON)
    jcfg = JConfig(photon_map_structure=JStructure.STOCHASTIC_HASH, **CFG)
    leaves = _photons_of(jppm.trace_photon_pass(
        js, jcfg, jkey, jcommon.scene_epsilon(js), jnp.arange(2048)))
    real = ppm.trace_photon_pass

    def jax_photons(*args):
        _, vol, stats = real(*args)
        return interop.photon_batch_from_numpy(leaves, "cpu"), vol, stats

    ppm.trace_photon_pass = jax_photons
    try:
        got, _ = ppm.render_iteration(
            ts, tc, RenderConfig(photon_map_structure=HASH, **CFG), 0,
            make_root_key(0), R2)
    finally:
        ppm.trace_photon_pass = real
    out["hash_on_jax_photons"] = got.numpy(), None, out["hash"][2], None
    return out


def _pixel_agreement(got, want):
    agree = np.isclose(got, want, rtol=PIXEL_RTOL, atol=0.0).all(axis=-1)
    return float(agree.mean())


@pytest.mark.parametrize("name", ["hash", "kd"])
def test_one_ppm_iteration_matches_jax(iterations, name):
    got, gst, want, wst = iterations[name]
    assert got.shape == want.shape == (SIZE, SIZE, 3)
    assert np.isfinite(got).all() and got.mean() > 0
    min_share = HASH_MIN_AGREEING if name == "hash" else MIN_AGREEING
    assert _pixel_agreement(got, want) >= min_share
    assert got.mean() == pytest.approx(want.mean(), rel=MEAN_RTOL)
    assert gst.keys() == wst.keys()
    assert ("kd_overrun" in gst) == (name == "kd")
    for k in wst:
        rtol = KD_VISITED_RTOL if k == "photons_visited" else 1e-3
        assert gst[k] == pytest.approx(wst[k], rel=rtol), k


def test_hash_iteration_on_jax_photons_matches_jax(iterations):
    """On the same photons the hash tables are equal bit for bit: the
    iteration meets PPM's pixel bar."""
    got, _, want, _ = iterations["hash_on_jax_photons"]
    assert _pixel_agreement(got, want) >= MIN_AGREEING
    assert got.mean() == pytest.approx(want.mean(), rel=MEAN_RTOL)


def test_kdtree_in_ppm_iteration(iterations):
    """test_photon_map.py:167 on the port: the kd-tree's image within 5%
    of the grid's (mean absolute difference over the mean)."""
    kd, grid = iterations["kd"][0], iterations["grid"][0]
    assert np.isfinite(kd).all()
    assert np.abs(kd - grid).mean() / (np.abs(grid).mean() + 1e-6) < 0.05


def test_ppm_stochastic_hash_variant():
    """test_ppm.py:93 on the port: 4 iterations at 48^2 with 2^14 photons;
    the hash's image mean within 25% of the grid's."""
    scene, cam = get_scene_by_name("CornellSmall", "cpu")
    base = dict(width=48, height=48, render_method=PPM,
                photons_per_iteration=1 << 14, photon_grid_resolution=24)
    r = Renderer(scene, cam, RenderConfig(
        photon_map_structure=HASH, stochastic_hash_size_log2=15, **base),
        seed=6)
    img = r.render(4).mean_radiance().numpy()
    assert np.isfinite(img).all()
    exact = Renderer(scene, cam, RenderConfig(**base), seed=6).render(
        4).mean_radiance().numpy()
    assert img.mean() == pytest.approx(exact.mean(), rel=0.25)
