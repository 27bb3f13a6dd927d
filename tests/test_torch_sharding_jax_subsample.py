"""The port's tile gather over partial grids against the JAX package's
sharded tile gather where a tile's slots are subsampled (ROADMAP queue C,
item 5).

Two ranks exchange clustered photons by cell owner and gather 32x32
queries with the tile gather: JAX under ``shard_map`` on 2 of the
conftest's virtual devices (``exchange_photons_by_cell`` and
``sharded_gather(tiled_wh=...)``, its Pallas kernel in interpret mode),
the port per rank with the exchange's local half and ``sharded_gather``
over a one-rank mesh, the ranks' partial sums added as the psum adds them.
The tiles' boxes span up to 16 rows of cells in y and z, more than their
8 x 8 slots (row subsampling at stride 2, weight 4), and windows through
the cluster hold more than a slot's 256 photons (one chunk of several,
weights up to 16); both sides draw the same uniforms.
The sums must agree at the gather bar (rtol 1e-4 + 1e-6 max|ref|: the same
terms in another order) on every query.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch
from jax.sharding import PartitionSpec as P

from _sharding_jax import jax_mesh
from oppositerenderer_tpu.parallel.exchange import (
    exchange_photons_by_cell as jax_exchange, sharded_gather as jax_gather)
from oppositerenderer_tpu.photon_map import PhotonBatch as JBatch
from oppositerenderer_tpu_torch.accel.gather_kernels import (
    ROWS, TILE, _tile_tables, tile_block_order)
from oppositerenderer_tpu_torch.parallel import make_mesh
from oppositerenderer_tpu_torch.parallel.exchange import (
    bucket_photons_by_owner, global_grid_geometry, sharded_gather)
from oppositerenderer_tpu_torch.photon_map import (PhotonBatch,
                                                   build_photon_grid)

torch.set_num_threads(2)

D = 2
P_LOCAL = 4096       # photons a rank
RES = 16
W = H = 32
RADIUS = 0.2
U = 0.61             # the exchange's subsample phase
CF = 2.0
MCS = 0.02


def inputs():
    rng = np.random.default_rng(11)
    n = D * P_LOCAL
    pos = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    cluster = rng.uniform(0, 1, n) < 0.5      # half in a 0.1-wide blob
    pos[cluster] = (0.45 + rng.uniform(0, 0.1, (int(cluster.sum()), 3))
                    ).astype(np.float32)
    photons = dict(position=pos,
                   power=rng.uniform(0.1, 1.9, (n, 3)).astype(np.float32),
                   direction=rng.normal(size=(n, 3)).astype(np.float32),
                   valid=rng.uniform(0, 1, n) < 0.95)
    q = rng.uniform(0, 1, (W * H, 3)).astype(np.float32)
    qn = rng.normal(size=(W * H, 3)).astype(np.float32)
    qn /= np.linalg.norm(qn, axis=1, keepdims=True)
    u = rng.uniform(0, 1, W * H).astype(np.float32)
    return photons, q, qn, u


@functools.lru_cache(maxsize=None)
def jax_fn():
    @functools.partial(jax.shard_map, mesh=jax_mesh(D),
                       in_specs=(P("tile"),) * 4, out_specs=P("tile"),
                       check_vma=False)
    def go(b, q, qn, u):
        grid, _ = jax_exchange(b, RES, "tile", D,
                               min_cell_size=jnp.float32(MCS),
                               capacity_factor=CF, subsample_u=U)
        mine, _ = jax_gather(grid, q, qn, jnp.float32(RADIUS), "tile",
                             budget_total=64, u_stride=u, tiled_wh=(W, H))
        return mine
    return jax.jit(go)


def port_partial_grids(photons: dict):
    batch = PhotonBatch(**{k: torch.as_tensor(v) for k, v in photons.items()})
    origin, cell_size = global_grid_geometry(
        batch, RES, make_mesh(1, device="cpu"),
        min_cell_size=torch.tensor(MCS))
    slabs, valids = [], []
    for r in range(D):
        local = PhotonBatch(**{k: getattr(batch, k)[r * P_LOCAL:
                                                     (r + 1) * P_LOCAL]
                               for k in ("position", "power", "direction",
                                         "valid")})
        slab, valid, overflow = bucket_photons_by_owner(
            local, origin, cell_size, RES, D, CF, U)
        assert int(overflow) == 0
        slabs.append(slab)
        valids.append(valid)
    grids = []
    for dst in range(D):    # the all-to-all: slab dst of every rank
        recv = torch.cat([s[dst] for s in slabs])
        ok = torch.cat([v[dst] for v in valids])
        grids.append(build_photon_grid(
            PhotonBatch(position=recv[:, 0:3], power=recv[:, 3:6],
                        direction=recv[:, 6:9], valid=ok),
            RES, origin=origin, cell_size=cell_size))
    return grids


def test_partial_grid_tile_gather_matches_jax_where_slots_subsample():
    photons, q, qn, u = inputs()
    want = np.asarray(jax_fn()(JBatch(**{k: jnp.asarray(v)
                                        for k, v in photons.items()}),
                               jnp.asarray(q), jnp.asarray(qn),
                               jnp.asarray(u)))
    grids = port_partial_grids(photons)
    qt, qnt, ut = (torch.as_tensor(a) for a in (q, qn, u))
    perm = torch.as_tensor(tile_block_order(W, H)[0], dtype=torch.int64)
    u_rows = ut.reshape(-1, TILE)[:, :ROWS + 2]
    got = torch.zeros(W * H, 3)
    weights_used = []
    for grid in grids:
        partial, _ = sharded_gather(grid, qt, qnt, torch.tensor(RADIUS),
                                    make_mesh(1, device="cpu"),
                                    budget_total=64, u_stride=ut,
                                    tiled_wh=(W, H))
        got += partial
        # the slot tables this gather used
        _, lens, weights, _, _, _ = _tile_tables(
            grid, qt[perm], torch.tensor(RADIUS), u_rows)
        weights_used.append(weights[lens > 0])
    # rows at stride 2 in y and z (weight 4), and a chunk of several
    # picked on top of that (weights above 4)
    weights_used = torch.cat(weights_used)
    assert float(weights_used.min()) >= 4.0 and float(weights_used.max()) > 4.0
    scale = float(np.abs(want).max())
    assert scale > 0.0
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                               atol=1e-6 * scale)
