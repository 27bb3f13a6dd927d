"""The port's photon map against the JAX package's on the same photons.

The grid build is held bit for bit (both sorts are stable, so equal cells
keep the deposit order), ``gather_cell_indices`` to equal integers, and
the budgeted gather's sums to rtol 1e-4 plus atol 1e-6 * max|ref|: the
two packages sum the same terms, in another order.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oppositerenderer_tpu import photon_map as jpm
from oppositerenderer_tpu_torch import interop
from oppositerenderer_tpu_torch import photon_map as pm

torch.set_num_threads(2)

GATHER_RTOL = 1e-4
GATHER_ATOL_REL = 1e-6


def make_photons(n=4096, seed=0, cluster=False, frac_valid=0.85):
    """numpy photon arrays; ``cluster`` piles half of them into a few
    cells, so equal cell ids are common and the sort's stability shows."""
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
                direction=d,
                valid=rng.uniform(size=n) < frac_valid)


def both_batches(leaves):
    jb = jpm.PhotonBatch(**{k: jnp.asarray(v) for k, v in leaves.items()})
    return jb, interop.photon_batch_from_numpy(leaves, "cpu")


def grid_leaves(g) -> dict:
    return dict(position=np.asarray(g.position), power=np.asarray(g.power),
                direction=np.asarray(g.direction),
                offsets=np.asarray(g.offsets), origin=np.asarray(g.origin),
                cell_size=np.asarray(g.cell_size),
                n_valid=np.asarray(g.n_valid), resolution=g.resolution)


def queries(n=96, seed=1, lo=0.2, hi=1.8):
    rng = np.random.default_rng(seed)
    q = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    nrm = rng.standard_normal((n, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    return q, nrm


@pytest.mark.parametrize("cluster", [False, True])
@pytest.mark.parametrize("resolution,radius", [(16, None), (24, 0.3),
                                               (100, 0.05)])
def test_grid_build_is_bit_identical(cluster, resolution, radius):
    jb, tb = both_batches(make_photons(cluster=cluster))
    if radius is None:
        jg = jpm.build_photon_grid(jb, resolution)
        tg = pm.build_photon_grid(tb, resolution)
    else:
        jg = jpm.build_photon_grid(jb, resolution, jpm.min_cell_size_for_window(
            jnp.float32(radius), 4))
        tg = pm.build_photon_grid(tb, resolution, pm.min_cell_size_for_window(
            torch.tensor(radius, dtype=torch.float32), 4))
    want = grid_leaves(jg)
    for f in ("position", "power", "direction", "offsets", "origin",
              "cell_size", "n_valid"):
        got = getattr(tg, f).numpy()
        assert got.dtype == want[f].dtype, f
        np.testing.assert_array_equal(got, want[f], err_msg=f)
    assert tg.resolution == jg.resolution


@pytest.mark.parametrize("cluster", [False, True])
def test_packed_records_equal_the_grid_fields(cluster):
    """B3's kernel reads PhotonGrid.packed: each photon's fields, in
    (position, x), (direction, 0), (power, 0), x the x index of the grid
    cell that holds the photon, written by the grid's sort; the grid built
    from JAX's arrays through interop packs the same records."""
    jb, tb = both_batches(make_photons(cluster=cluster))
    res = 16
    jg, g = jpm.build_photon_grid(jb, res), pm.build_photon_grid(tb, res)
    p = g.packed
    assert p.shape == (g.position.shape[0], pm.PHOTON_RECORD)
    assert p.dtype == torch.float32 and p.is_contiguous()
    for cols, field in (((0, 3), "position"), ((4, 7), "direction"),
                        ((8, 11), "power")):
        assert torch.equal(p[:, cols[0]:cols[1]], getattr(g, field))
    off = g.offsets.long()
    n_in = int(off[-1])                  # photons in some cell
    cell = torch.repeat_interleave(torch.arange(res ** 3),
                                   off[1:] - off[:-1])
    assert torch.equal(p[:n_in, 3], (cell % res).to(torch.float32))
    assert bool((p[n_in:, 3] == 0).all()) and n_in < p.shape[0]
    assert int(torch.count_nonzero(p[:, [7, 11]])) == 0
    assert torch.equal(
        interop.photon_grid_from_numpy(grid_leaves(jg), "cpu").packed, p)


def test_grid_of_no_valid_photon():
    leaves = make_photons(n=64)
    leaves["valid"][:] = False
    jb, tb = both_batches(leaves)
    jg, tg = jpm.build_photon_grid(jb, 8), pm.build_photon_grid(tb, 8)
    np.testing.assert_array_equal(tg.offsets.numpy(), np.asarray(jg.offsets))
    np.testing.assert_array_equal(tg.origin.numpy(), np.asarray(jg.origin))
    assert int(tg.n_valid) == 0 and int(tg.offsets[-1]) == 0


def test_cell_helpers_and_kernel_weight_match_jax():
    rng = np.random.default_rng(5)
    p = rng.uniform(-1.0, 3.0, (500, 3)).astype(np.float32)
    origin = np.float32([0.1, -0.2, 0.05])
    cs = np.float32(0.137)
    jc = jpm.cell_coords(jnp.asarray(p), jnp.asarray(origin), cs, 20)
    tc = pm.cell_coords(torch.as_tensor(p), torch.as_tensor(origin),
                        torch.tensor(cs), 20)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(pm.cell_index_1d(tc, 20).numpy(),
                                  np.asarray(jpm.cell_index_1d(jc, 20)))
    d2 = rng.uniform(0.0, 0.05, 1000).astype(np.float32)
    np.testing.assert_allclose(
        pm.gaussian_kernel_weight(torch.as_tensor(d2),
                                  torch.tensor(0.04)).numpy(),
        np.asarray(jpm.gaussian_kernel_weight(jnp.asarray(d2),
                                              jnp.float32(0.04))),
        rtol=1e-6)
    assert pm.GAUSS_EXP_NEG_BETA == 0.141847


@pytest.mark.parametrize("budget,with_u", [(1024, False), (32, False),
                                           (32, True)])
def test_gather_cell_indices_equal(budget, with_u):
    jb, tb = both_batches(make_photons(cluster=True))
    jg = jpm.build_photon_grid(jb, 16)
    tg = interop.photon_grid_from_numpy(grid_leaves(jg), "cpu")
    q, _ = queries()
    u = np.random.default_rng(2).uniform(size=q.shape[0]).astype(np.float32)
    want = jpm.gather_cell_indices(
        jg.offsets, jg.origin, jg.cell_size, 16, jnp.asarray(q),
        jnp.float32(0.2), max_cells_per_axis=4, budget_total=budget,
        u_stride=jnp.asarray(u) if with_u else None)
    got = pm.gather_cell_indices(
        tg.offsets, tg.origin, tg.cell_size, 16, torch.as_tensor(q),
        torch.tensor(0.2), max_cells_per_axis=4, budget_total=budget,
        u_stride=torch.as_tensor(u) if with_u else None)
    for name, a, b in zip(("gidx", "gok", "stride", "total"), got, want):
        b = np.asarray(b)
        assert a.numpy().dtype == b.dtype, name
        np.testing.assert_array_equal(a.numpy(), b, err_msg=name)
    assert (np.asarray(want[2]) > 1).any() == (budget == 32)


@pytest.mark.parametrize("budget,check_normal", [(2048, True),
                                                 (2048, False),
                                                 (48, True)])
def test_gather_photons_matches_jax(budget, check_normal):
    """With budget 2048 nothing is subsampled; with 48 most boxes are, at
    the same u_stride in both packages."""
    jb, tb = both_batches(make_photons(cluster=True))
    r = 0.25
    jg = jpm.build_photon_grid(jb, 16, jpm.min_cell_size_for_window(
        jnp.float32(r), 4))
    tg = pm.build_photon_grid(tb, 16, pm.min_cell_size_for_window(
        torch.tensor(r), 4))
    q, nrm = queries(seed=3, lo=0.6, hi=1.4)
    u = np.random.default_rng(4).uniform(size=q.shape[0]).astype(np.float32)
    want, wst = jpm.gather_photons(
        jg, jnp.asarray(q), jnp.asarray(nrm), jnp.float32(r),
        max_cells_per_axis=4, budget_total=budget,
        check_normal=check_normal, u_stride=jnp.asarray(u))
    got, gst = pm.gather_photons(
        tg, torch.as_tensor(q), torch.as_tensor(nrm), torch.tensor(r),
        max_cells_per_axis=4, budget_total=budget,
        check_normal=check_normal, u_stride=torch.as_tensor(u))
    want = np.asarray(want)
    assert want.max() > 0.0
    np.testing.assert_allclose(got.numpy(), want, rtol=GATHER_RTOL,
                               atol=GATHER_ATOL_REL * np.abs(want).max())
    for k in wst:
        np.testing.assert_array_equal(gst[k].numpy(), np.asarray(wst[k]))
    assert (int(gst["photon_subsampled"].sum()) > 0) == (budget == 48)


def test_gather_photons_matches_bruteforce():
    leaves = make_photons()
    _, tb = both_batches(leaves)
    tg = pm.build_photon_grid(tb, 16)
    q, _ = queries(n=40, seed=9)
    nrm = np.tile(np.float32([[0.0, 1.0, 0.0]]), (40, 1))
    r = 0.2
    got, st = pm.gather_photons(tg, torch.as_tensor(q), torch.as_tensor(nrm),
                                r, max_cells_per_axis=6, budget_total=2048)
    assert int(st["photon_subsampled"].sum()) == 0
    want = np.zeros((40, 3))
    for i in range(40):
        diff = q[i] - leaves["position"]
        d2 = (diff * diff).sum(1)
        ok = leaves["valid"] & (d2 <= r * r) & (leaves["direction"][:, 1]
                                                <= 0.0)
        w = pm.gaussian_kernel_weight(torch.as_tensor(d2[ok]),
                                      torch.tensor(r * r)).numpy()
        want[i] = (leaves["power"][ok] * w[:, None]).sum(0)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                               atol=1e-6 * np.abs(want).max())
