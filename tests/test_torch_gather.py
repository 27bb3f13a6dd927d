"""The port's tile gather (B3's plain version and its tables) against the
JAX package's, on JAX-built grids handed over through ``interop``.

``tile_block_order`` and ``_tile_tables`` are held to equal integers and
weights. The sums are held to rtol 1e-4 plus atol 1e-6 * max|ref|: the
JAX side runs its Pallas kernel in interpret mode, as its own tests do,
and sums the same terms in another order.
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oppositerenderer_tpu.accel import pallas_gather as jpg
from oppositerenderer_tpu.photon_map import (PhotonBatch, build_photon_grid,
                                             min_cell_size_for_window)
from oppositerenderer_tpu_torch import interop
from oppositerenderer_tpu_torch import photon_map as pm
from oppositerenderer_tpu_torch.accel import gather_kernels as gk

torch.set_num_threads(2)

RTOL = 1e-4
ATOL_REL = 1e-6
# the cases below share their shapes, so one compile per check_normal serves
jax_tiled_gather = jax.jit(partial(jpg.gather_photons_tiled, interpret=True),
                           static_argnames=("check_normal",))


def _unit(rng, n):
    d = rng.standard_normal((n, 3)).astype(np.float32)
    return d / np.linalg.norm(d, axis=1, keepdims=True)


def make_case(n_photons=8192, n_tiles=2, radius=0.12, seed=0,
              cluster=False):
    """``tests/test_pallas_gather.py``'s case: photons in the unit cube
    (``cluster`` piles half into a few cells, so rows overflow a chunk),
    queries clustered per tile. Returns the JAX grid and numpy queries."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0, 1, (n_photons, 3)).astype(np.float32)
    if cluster:
        pos[: n_photons // 2] = (0.5 + 0.02 * rng.standard_normal(
            (n_photons // 2, 3))).astype(np.float32)
    photons = PhotonBatch(
        position=jnp.asarray(pos),
        power=jnp.asarray(rng.uniform(0, 1, (n_photons, 3)).astype(
            np.float32)),
        direction=jnp.asarray(_unit(rng, n_photons)),
        valid=jnp.asarray(rng.uniform(size=n_photons) < 0.9))
    grid = build_photon_grid(photons, 16, min_cell_size=(
        min_cell_size_for_window(jnp.float32(radius), 4)))
    centers = rng.uniform(0.25, 0.75, (n_tiles, 3)).astype(np.float32)
    jitter = (0.02 * rng.standard_normal((n_tiles, gk.TILE, 3))
              ).astype(np.float32)
    qpos = np.clip(centers[:, None, :] + jitter, 0.0, 1.0).reshape(-1, 3)
    return grid, qpos, _unit(rng, n_tiles * gk.TILE), radius


def port_grid(jgrid):
    return interop.photon_grid_from_numpy(dict(
        position=np.asarray(jgrid.position), power=np.asarray(jgrid.power),
        direction=np.asarray(jgrid.direction),
        offsets=np.asarray(jgrid.offsets), origin=np.asarray(jgrid.origin),
        cell_size=np.asarray(jgrid.cell_size),
        n_valid=np.asarray(jgrid.n_valid), resolution=jgrid.resolution),
        "cpu")


def u_rows_for(n_tiles, seed):
    if seed is None:
        return np.zeros((n_tiles, gk.ROWS + 2), np.float32)
    return np.random.default_rng(seed).uniform(
        size=(n_tiles, gk.ROWS + 2)).astype(np.float32)


def assert_close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=ATOL_REL * np.abs(want).max())


def test_constants_match_jax():
    assert (gk.TILE, gk.BLOCK, gk.ROWS_Y, gk.ROWS_Z, gk.ROWS, gk.CHUNK) == (
        jpg.TILE, jpg.BLOCK, jpg.ROWS_Y, jpg.ROWS_Z, jpg.ROWS, jpg.CHUNK)


@pytest.mark.parametrize("w,h", [(16, 16), (64, 32), (48, 80)])
def test_tile_block_order_matches_jax(w, h):
    perm, inv = gk.tile_block_order(w, h)
    jperm, jinv = jpg.tile_block_order(w, h)
    np.testing.assert_array_equal(perm, jperm)
    np.testing.assert_array_equal(inv, jinv)
    assert perm.dtype == np.int32
    with pytest.raises(ValueError):
        gk.tile_block_order(w + 8, h)


@pytest.mark.parametrize("cluster,seed,masked", [(False, None, False),
                                                 (True, 3, False),
                                                 (True, 4, True)])
def test_tile_tables_equal_jax(cluster, seed, masked):
    jgrid, qpos, _, r = make_case(cluster=cluster, n_tiles=3,
                                  radius=0.2 if cluster else 0.12)
    if cluster:   # spread one tile over the whole box: row subsampling
        qpos[:gk.TILE] = np.random.default_rng(8).uniform(
            0.0, 1.0, (gk.TILE, 3)).astype(np.float32)
    u = u_rows_for(3, seed)
    valid = np.ones(qpos.shape[0], bool)
    if masked:
        valid[::3] = False
        valid[2 * gk.TILE:] = False     # one tile without a valid query
    want = jpg._tile_tables(jgrid, jnp.asarray(qpos), jnp.float32(r),
                            jnp.asarray(u),
                            valid=jnp.asarray(valid) if masked else None)
    got = gk._tile_tables(port_grid(jgrid), torch.as_tensor(qpos),
                          torch.tensor(r, dtype=torch.float32),
                          torch.as_tensor(u),
                          valid=torch.as_tensor(valid) if masked else None)
    want = [want[i] for i in (0, 1, 2, 4, 5)]   # the reference point aside
    for name, a, b in zip(("starts", "lens", "weights", "visited", "total"),
                          got, want):
        b = np.asarray(b)
        assert a.numpy().dtype == b.dtype, name
        np.testing.assert_array_equal(a.numpy(), b, err_msg=name)
    if cluster:
        assert (np.asarray(want[2]) > 1.0).any()   # subsampled slots
    if masked:
        assert int(got[1][2].sum()) == 0


@pytest.mark.parametrize("check_normal", [True, False])
def test_plain_tile_gather_matches_jax(check_normal):
    """No subsampling (``test_pallas_gather.py:49-66``): the same sums."""
    jgrid, qpos, qn, r = make_case()
    u = u_rows_for(2, None)
    want, wst = jax_tiled_gather(
        jgrid, jnp.asarray(qpos), jnp.asarray(qn), jnp.float32(r),
        u_rows=jnp.asarray(u), check_normal=check_normal)
    got, gst = gk.gather_photons_tiled(
        port_grid(jgrid), torch.as_tensor(qpos), torch.as_tensor(qn),
        torch.tensor(r), u_rows=torch.as_tensor(u),
        check_normal=check_normal)
    assert np.asarray(want).max() > 0.0
    assert int(gst["photon_subsampled"].sum()) == 0
    assert_close(got.numpy(), want)
    for k in wst:
        np.testing.assert_array_equal(gst[k].numpy(), np.asarray(wst[k]))


def test_plain_tile_gather_subsampled_matches_jax():
    """The clustered case of ``test_pallas_gather.py:103-127`` at one fixed
    ``u_rows``: rows overflow their chunk, so the chunk picks and weights
    run, and both packages take the same picks."""
    jgrid, qpos, qn, r = make_case(cluster=True, radius=0.2)
    u = u_rows_for(2, 3)
    want, wst = jax_tiled_gather(
        jgrid, jnp.asarray(qpos), jnp.asarray(qn), jnp.float32(r),
        u_rows=jnp.asarray(u), check_normal=True)
    got, gst = gk.gather_photons_tiled(
        port_grid(jgrid), torch.as_tensor(qpos), torch.as_tensor(qn),
        torch.tensor(r), u_rows=torch.as_tensor(u))
    assert int(gst["photon_subsampled"].sum()) > 0
    assert_close(got.numpy(), want)
    for k in wst:
        np.testing.assert_array_equal(gst[k].numpy(), np.asarray(wst[k]))


@pytest.mark.parametrize("check_normal", [True, False])
def test_plain_tile_gather_equals_budget_gather(check_normal):
    """Where nothing is subsampled the tile gather and the budgeted gather
    are the same estimator: the slots' superset rows are masked by the
    distance test. Three tiles: the plain version's last chunk of tiles
    is short."""
    jgrid, qpos, qn, r = make_case(n_tiles=3, seed=11)
    grid = port_grid(jgrid)
    q, n = torch.as_tensor(qpos), torch.as_tensor(qn)
    tiled, tst = gk.gather_photons_tiled(
        grid, q, n, torch.tensor(r), u_rows=torch.rand(3, gk.ROWS + 2),
        check_normal=check_normal)
    assert int(tst["photon_subsampled"].sum()) == 0
    ref, rst = pm.gather_photons(grid, q, n, torch.tensor(r),
                                 max_cells_per_axis=4, budget_total=4096,
                                 check_normal=check_normal)
    assert int(rst["photon_subsampled"].sum()) == 0
    assert_close(tiled.numpy(), ref.numpy())


def test_cpu_call_runs_the_plain_version_without_a_launch():
    jgrid, qpos, qn, r = make_case(n_tiles=3, seed=5)
    grid = port_grid(jgrid)
    q, n = torch.as_tensor(qpos), torch.as_tensor(qn)
    u = torch.as_tensor(u_rows_for(3, 1))
    starts, lens, weights, _, _, rows = gk._tile_tables(grid, q, r, u)
    before = gk.gather_photons_tiled.launches
    got, _ = gk.gather_photons_tiled(grid, q, n, torch.tensor(r), u_rows=u)
    assert gk.gather_photons_tiled.launches == before
    assert torch.equal(got, gk.gather_photons_tiled_plain(
        starts, lens, weights, rows,
        torch.tensor(r * r, dtype=torch.float32), q, n, grid))
    with pytest.raises(ValueError, match="multiple"):
        gk.gather_photons_tiled(grid, q[:100], n[:100], r, u_rows=u)


def _cull_case(case):
    """(grid, queries, radius) of the cull test: the synthetic and the
    clustered photons of make_case with their queries, or photons and
    queries on a lattice of the grid's cell faces (every 0.1 along each
    axis, the cell size) with the radius equal to the cell size, so that
    pairs lie exactly one radius apart."""
    if case != "cell faces":
        jgrid, qpos, _, r = make_case(cluster=case == "clustered",
                                      radius=0.2 if case == "clustered"
                                      else 0.12)
        return port_grid(jgrid), torch.as_tensor(qpos), r
    rng = np.random.default_rng(2)
    step = np.float32(0.1)
    pos = np.concatenate([rng.integers(0, 17, (4096, 3)) * step,
                          rng.uniform(0.0, 1.6, (2048, 3))]).astype(
                              np.float32)
    grid = pm.build_photon_grid(pm.PhotonBatch(
        position=torch.as_tensor(pos),
        power=torch.as_tensor(rng.uniform(size=pos.shape).astype(
            np.float32)),
        direction=torch.as_tensor(_unit(rng, pos.shape[0])),
        valid=torch.ones(pos.shape[0], dtype=torch.bool)), 16)
    cells = rng.integers(2, 15, (2 * gk.TILE, 3))
    cells[gk.TILE:] = cells[gk.TILE:] // 4 + 6       # one dense tile
    qpos = torch.as_tensor((cells * step).astype(np.float32))
    return grid, qpos, float(grid.cell_size)


@pytest.mark.parametrize("case", ["synthetic", "clustered", "cell faces"])
def test_cell_cull_keeps_every_pair_within_the_radius(case):
    """B3's per-query x-cell cull, in its plain version: every staged pair
    with d2 <= r2 (per axis, as the kernel) lies in the part of its slot's
    window that the query walks, and the cull leaves pairs out."""
    grid, q, r = _cull_case(case)
    n_tiles = q.shape[0] // gk.TILE
    u = torch.as_tensor(u_rows_for(n_tiles, 3))
    starts, lens, _, _, _, rows = gk._tile_tables(grid, q, r, u)
    r2 = torch.square(torch.tensor(r, dtype=torch.float32))
    k0, k1 = gk.culled_windows_plain(grid, q, r2, starts, lens, rows)
    j = starts.long()[:, None, :, None] + torch.arange(gk.CHUNK)
    staged = (torch.arange(gk.CHUNK) < lens[:, None, :, None]).expand(
        -1, gk.TILE, -1, -1)
    p = grid.position[j.clamp_max(grid.position.shape[0] - 1)]
    qq = q.reshape(n_tiles, gk.TILE, 1, 1, 3)
    dx, dy, dz = (qq[..., a] - p[..., a] for a in range(3))
    keep = staged & (dx * dx + dy * dy + dz * dz <= r2)
    walked = (j >= k0[..., None]) & (j < k1[..., None])
    assert bool(keep.any())
    assert not bool((keep & ~walked).any())
    assert int(walked.sum()) < int(staged.sum())
    assert bool((k0 <= k1).all())


def test_kernel_wrapper_checks_its_inputs():
    """The kernel's wrapper refuses what the kernel cannot read, the grid's
    packed records among them: missing, cut, strided or misaligned."""
    import dataclasses
    jgrid, qpos, qn, r = make_case(n_tiles=1)
    grid = port_grid(jgrid)
    q, n = torch.as_tensor(qpos), torch.as_tensor(qn)
    u = torch.as_tensor(u_rows_for(1, None))
    starts, lens, weights, _, _, rows = gk._tile_tables(grid, q, r, u)
    r2 = torch.tensor(r * r, dtype=torch.float32)
    ok = [starts, lens, weights, rows, r2, q, n, grid]
    packed = grid.packed
    shifted = torch.zeros(packed.numel() + 1)[1:].reshape(packed.shape)
    for i, bad, match in ((0, starts.long(), "int32"),
                          (3, rows[:, :8].contiguous(), "shape"),
                          (4, r2.reshape(1), "shape"),
                          (5, q.double(), "float32"),
                          (6, n.T.contiguous().T, "contiguous"),
                          (7, dataclasses.replace(grid, packed=None),
                           "packed"),
                          (7, dataclasses.replace(grid, packed=packed[:, :8]),
                           "shape"),
                          (7, dataclasses.replace(
                              grid, packed=packed.T.contiguous().T),
                           "contiguous"),
                          (7, dataclasses.replace(grid, packed=shifted),
                           "aligned")):
        args = list(ok)
        args[i] = bad
        with pytest.raises(ValueError, match=match):
            gk.gather_photons_tiled_kernel(*args)
