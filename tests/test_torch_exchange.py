"""The port's photon exchange by cell owner, simulated in one process, and
its host-side distribution pieces (scheduler, film merge).

D ranks are simulated with the exchange's local half: each rank's slab
comes from ``bucket_photons_by_owner`` on its photons and the global grid
geometry, the slabs are swapped as the all-to-all would swap them, and
each rank builds its partial grid. On equal photons those grids equal the
JAX package's per-device grids (``exchange_photons_by_cell`` under
``shard_map`` on the conftest's virtual devices) bit for bit. The skew
tests of ``test_exchange_skew.py`` and the scheduler and merge tests of
``test_distributed.py`` follow at their bars.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from oppositerenderer_tpu.parallel import make_mesh as jax_mesh
from oppositerenderer_tpu.parallel.exchange import (
    _row_owner as jax_row_owner, exchange_photons_by_cell as jax_exchange)
from oppositerenderer_tpu.photon_map import PhotonBatch as JBatch
from oppositerenderer_tpu_torch.config import RenderConfig, RenderMethod
from oppositerenderer_tpu_torch.parallel import make_mesh
from oppositerenderer_tpu_torch.parallel.distributed import (
    IterationScheduler, MultiHostRenderer, merge_films)
from oppositerenderer_tpu_torch.parallel.exchange import (
    bucket_photons_by_owner, global_grid_geometry,
    row_owner, slab_capacity)
from oppositerenderer_tpu_torch.photon_map import (PhotonBatch,
                                                   build_photon_grid)
from oppositerenderer_tpu_torch.renderer import Renderer
from oppositerenderer_tpu_torch.scene import get_scene_by_name

torch.set_num_threads(2)

P_LOCAL = 512          # photons per rank
RES = 16
U = 0.37               # the systematic subsample's phase
MCS = 0.02             # a cell-size floor below the AABB's cells


def photons_np(d: int, seed: int, skew: bool = False):
    """[d * P_LOCAL] photons: uniform in [0,1]^3, or with 94% of them in
    one cell of a domain held open by the rest; 10% invalid."""
    rng = np.random.default_rng(seed)
    n = d * P_LOCAL
    pos = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    if skew:
        cluster = rng.uniform(0, 1, n) < 0.94
        pos[cluster] = (np.asarray([0.503, 0.497, 0.501])
                        + rng.uniform(-1e-3, 1e-3, (int(cluster.sum()), 3))
                        ).astype(np.float32)
    return dict(position=pos,
                power=rng.uniform(0.1, 1.9, (n, 3)).astype(np.float32),
                direction=rng.normal(size=(n, 3)).astype(np.float32),
                valid=rng.uniform(0, 1, n) < 0.9)


def port_batch(a: dict) -> PhotonBatch:
    return PhotonBatch(**{k: torch.as_tensor(v) for k, v in a.items()})


def simulate_exchange(batch: PhotonBatch, d: int, cf: float, u=U,
                      min_cell_size=MCS):
    """Every simulated rank's partial grid and the total overflow."""
    origin, cell_size = global_grid_geometry(
        batch, RES, make_mesh(1, device="cpu"),
        min_cell_size=torch.tensor(min_cell_size))
    slabs, valids, overflow = [], [], 0
    for r in range(d):
        local = PhotonBatch(**{k: getattr(batch, k)[r * P_LOCAL:
                                                     (r + 1) * P_LOCAL]
                               for k in ("position", "power", "direction",
                                         "valid")})
        slab, valid, of = bucket_photons_by_owner(
            local, origin, cell_size, RES, d, cf, u)
        slabs.append(slab)
        valids.append(valid)
        overflow += int(of)
    grids = []
    for dst in range(d):   # the all-to-all: slab dst of every rank, in order
        recv = torch.cat([s[dst] for s in slabs])
        ok = torch.cat([v[dst] for v in valids])
        owned = PhotonBatch(position=recv[:, 0:3], power=recv[:, 3:6],
                            direction=recv[:, 6:9], valid=ok)
        grids.append(build_photon_grid(owned, RES, origin=origin,
                                       cell_size=cell_size))
    return grids, overflow


@functools.lru_cache(maxsize=None)
def jax_exchange_fn(d: int, cf: float):
    """JAX's exchange on d virtual devices, jitted once per (d, cf); every
    device's grid as outputs along the tile axis."""
    @functools.partial(jax.shard_map, mesh=jax_mesh(d), in_specs=(P("tile"),),
                       out_specs=P("tile"), check_vma=False)
    def go(b):
        g, st = jax_exchange(b, RES, "tile", d,
                             min_cell_size=jnp.float32(MCS),
                             capacity_factor=cf, subsample_u=U)
        return dict(position=g.position, power=g.power,
                    direction=g.direction, offsets=g.offsets,
                    origin=g.origin[None], cell_size=g.cell_size[None],
                    n_valid=g.n_valid[None],
                    overflow=st["photon_exchange_overflow"][None])
    return jax.jit(go)


@pytest.mark.parametrize("d,cf,skew", [(4, 2.0, False), (8, 2.0, False),
                                       (4, 1.25, True), (8, 1.25, True)])
def test_partial_grids_equal_jax_bit_for_bit(d, cf, skew):
    a = photons_np(d, seed=10 + d, skew=skew)
    out = {k: np.asarray(v) for k, v in jax_exchange_fn(d, cf)(
        JBatch(**{k: jnp.asarray(v) for k, v in a.items()})).items()}
    grids, overflow = simulate_exchange(port_batch(a), d, cf)
    assert overflow == int(out["overflow"][0])
    if skew:
        assert overflow > 0       # the subsample path runs
    rows = out["position"].shape[0] // d
    cells = out["offsets"].shape[0] // d
    for r, g in enumerate(grids):
        for k in ("position", "power", "direction"):
            np.testing.assert_array_equal(
                getattr(g, k).numpy(), out[k][r * rows:(r + 1) * rows],
                err_msg=f"rank {r} {k}")
        np.testing.assert_array_equal(
            g.offsets.numpy(), out["offsets"][r * cells:(r + 1) * cells])
        np.testing.assert_array_equal(g.origin.numpy(), out["origin"][r])
        assert g.cell_size.numpy() == out["cell_size"][r]
        assert int(g.n_valid) == int(out["n_valid"][r])


def test_row_owner_equals_jax():
    cells = np.random.default_rng(0).integers(0, 100 ** 3, 4096,
                                              dtype=np.int32)
    for d in (2, 3, 8):
        want = np.asarray(jax_row_owner(jnp.asarray(cells), 100, d))
        got = row_owner(torch.as_tensor(cells), 100, d).numpy()
        np.testing.assert_array_equal(got, want)


def test_slab_capacity_rule():
    # max(8, ceil(P cf / D) rounded up to 8), as JAX's
    assert slab_capacity(512, 8, 2.0) == 128
    assert slab_capacity(100, 8, 2.0) == 32
    assert slab_capacity(3, 8, 2.0) == 8
    assert slab_capacity(1000, 3, 1.25) == 424


def test_subsample_u_is_required():
    a = port_batch(photons_np(2, seed=1))
    with pytest.raises(TypeError):
        bucket_photons_by_owner(a, torch.zeros(3), torch.tensor(0.1), RES,
                                2, 2.0, None)


def grid_power(grids) -> float:
    return sum(float(torch.sum(g.power[:int(g.n_valid)], dtype=torch.float64))
               for g in grids)


def test_balanced_distribution_no_overflow():
    """Uniform photons: no destination over capacity, no overflow, energy
    conserved exactly (test_exchange_skew.py:59)."""
    d = 8
    a = photons_np(d, seed=2)
    a["power"][:] = 1.0
    a["valid"][:] = True
    grids, overflow = simulate_exchange(port_batch(a), d, 2.0)
    assert overflow == 0
    np.testing.assert_allclose(grid_power(grids), 3.0 * d * P_LOCAL,
                               rtol=1e-6)


def test_spotlight_skew_overflows_but_conserves_energy():
    """94% of the photons in one cell: one owner gets everything, ~75% of
    each rank's photons overflow, and with equal powers the reweighted
    subsample keeps the energy exactly (test_exchange_skew.py:69)."""
    d = 8
    a = photons_np(d, seed=3, skew=True)
    a["power"][:] = 1.0
    a["valid"][:] = True
    grids, overflow = simulate_exchange(port_batch(a), d, 2.0)
    assert overflow > 0.4 * d * P_LOCAL
    np.testing.assert_allclose(grid_power(grids), 3.0 * d * P_LOCAL,
                               rtol=1e-5)


def test_skew_bias_bound_with_unequal_powers():
    """Unequal powers under skew: one draw within 5% of the true total
    (test_exchange_skew.py:90)."""
    d = 8
    a = photons_np(d, seed=4, skew=True)
    a["valid"][:] = True
    grids, overflow = simulate_exchange(port_batch(a), d, 2.0)
    assert overflow > 0
    total = float(np.sum(a["power"], dtype=np.float64))
    assert abs(grid_power(grids) - total) / total < 0.05


def test_one_rank_exchange_is_the_unsharded_grid():
    """A one-rank exchange's grid is the unsharded grid: the owned photons
    keep their deposit order and the geometry is the same."""
    a = port_batch(photons_np(1, seed=5))
    grids, _ = simulate_exchange(a, 1, 2.0)
    want = build_photon_grid(a, RES, min_cell_size=torch.tensor(MCS))
    n = int(want.n_valid)
    assert int(grids[0].n_valid) == n
    for k in ("position", "power", "direction"):
        assert torch.equal(getattr(grids[0], k)[:n], getattr(want, k)[:n])
    assert torch.equal(grids[0].offsets, want.offsets)


# ---------------------------------------------------------------------------
# scheduler and film merge (test_distributed.py:13-97)
# ---------------------------------------------------------------------------

def test_scheduler_hands_out_disjoint_packets():
    s = IterationScheduler(total_iterations=10, packet_size=4)
    _, a = s.acquire("w0", now=0.0)
    _, b = s.acquire("w1", now=0.0)
    _, c = s.acquire("w0", now=0.0)
    assert (a, b, c) == ((0, 1, 2, 3), (4, 5, 6, 7), (8, 9))
    assert not s.done
    for p in (a, b, c):
        s.complete(0, p)
    assert s.done
    assert s.worker_stats() == [
        {"worker": "w0", "iterations": 6, "packets": 2, "pending": 0},
        {"worker": "w1", "iterations": 4, "packets": 1, "pending": 0}]


def test_scheduler_lease_expiry_reassigns():
    """A dead worker's iterations are leased again."""
    s = IterationScheduler(total_iterations=8, packet_size=4,
                           lease_seconds=10.0)
    seq, a = s.acquire("w0", now=0.0)    # 0-3, expires at t=10
    _, b = s.acquire("w1", now=0.0)      # 4-7
    s.complete(seq, b)
    _, c = s.acquire("w1", now=11.0)
    assert c == a
    s.complete(seq, c)
    assert s.done


def test_scheduler_sequence_bump_drops_stale():
    s = IterationScheduler(total_iterations=8, packet_size=4)
    seq, a = s.acquire("w0", now=0.0)
    s.bump_sequence()
    assert not s.complete(seq, a)
    seq2, a2 = s.acquire("w0", now=0.0)
    assert a2 == (0, 1, 2, 3)
    assert s.complete(seq2, a2)


def test_scheduler_flow_control():
    s = IterationScheduler(total_iterations=100, packet_size=4)
    got = [s.acquire("w0", now=0.0)[1] for _ in range(10)]
    assert sum(len(g) for g in got if g) <= 30


def test_multiworker_merge_equals_single():
    """Two simulated workers splitting the iterations reproduce the one
    renderer's film (an iteration is a pure function of its number)."""
    scene, cam = get_scene_by_name("CornellSmall", "cpu")
    cfg = RenderConfig(width=24, height=24,
                       render_method=RenderMethod.PATH_TRACING)
    ref = Renderer(scene, cam, cfg, seed=9)
    ref.render(6)
    w0 = MultiHostRenderer(scene, cam, cfg, seed=9)
    w1 = MultiHostRenderer(scene, cam, cfg, seed=9)
    w0.render_iterations((0, 2, 4))
    w1.render_iterations((1, 3, 5))
    merged = merge_films([(w0.local_film().accum.numpy(), 3),
                          (w1.local_film().accum, 3)])
    assert merged.iterations == 6
    np.testing.assert_allclose(merged.accum.numpy(), ref.film.accum.numpy(),
                               rtol=1e-5, atol=1e-6)


def test_scheduler_driven_run():
    scene, cam = get_scene_by_name("CornellSmall", "cpu")
    cfg = RenderConfig(width=16, height=16,
                       render_method=RenderMethod.PATH_TRACING)
    sched = IterationScheduler(total_iterations=5, packet_size=2)
    w = MultiHostRenderer(scene, cam, cfg, seed=1)
    film = w.run(5, scheduler=sched)
    assert sched.done
    assert film.iterations == 5
    assert w.stats["iterations"] == 5
    assert bool(torch.isfinite(film.accum).all())
