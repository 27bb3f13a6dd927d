"""The port's tile-sharded render steps over gloo ranks on the CPU, against
the port's unsharded render on the same inputs.

One spawn of the worker (``python -m
oppositerenderer_tpu_torch.parallel.worker``) per D in (2, 4), both
started together, renders every case once; each test reads the rank-0
``.npz``. The cases are JAX's ``test_sharding.py`` (seven sharded against
unsharded cases, the band shape, the mesh sizes),
the equality asserts of ``__graft_entry__.dryrun_multichip``, PPM in a
medium with each exchange, and the budgeted branches at 24^2.

Bars against the unsharded render (stated once here):
* bit for bit where every rank computes exactly the unsharded values: PT,
  and PPM with ``ALL_GATHER`` (every rank builds the unsharded grid from
  the photons in the unsharded order);
* rtol 1e-5 + 1e-6 max|ref| where a sum over ranks adds in another order:
  VCM (the t=1 splats are summed per rank, then over ranks), PPM with
  ``ALL_TO_ALL`` (each rank's partial gather, then ``psum_scatter``);
* JAX's own dryrun bar (rtol 2e-3, atol 2e-4) for the dryrun asserts.
"""
import concurrent.futures
import functools
import json

import numpy as np
import pytest
import torch

from oppositerenderer_tpu_torch.config import (PhotonMapStructure,
                                               RenderConfig, RenderMethod)
from oppositerenderer_tpu_torch.core.rng import make_root_key
from oppositerenderer_tpu_torch.parallel import (Mesh, make_mesh,
                                                 make_sharded_render_fn)
from oppositerenderer_tpu_torch.parallel import render as prender
from oppositerenderer_tpu_torch.parallel.worker import (config_from,
                                                        render_unsharded,
                                                        sharding_cases,
                                                        spawn_ranks)
from oppositerenderer_tpu_torch.scene import get_scene_by_name

torch.set_num_threads(2)

RANKS = (2, 4)
JAX_CASES = [c["name"] for c in sharding_cases()]
BITS = {"pt", "ppm_all_gather", "ppm_all_gather_medium",
        "ppm_all_gather_24", "pt_16", "pt_16_mesh1"}
RTOL, ATOL_OF_MAX = 1e-5, 1e-6
MEDIUM = [0.15, 0.02, 2.5]     # JAX's test medium (tests/test_media.py)


def extra_cases(d: int) -> list[dict]:
    ppm = dict(render_method="PROGRESSIVE_PHOTON_MAPPING",
               photon_grid_resolution=16, gather_photon_budget=4096)
    common = dict(kind="render", seed=3, iteration=2, radius_sq=0.002)
    cases = [
        dict(common, name=f"ppm_{x.lower()}_medium", medium=MEDIUM,
             cfg=dict(ppm, width=32, height=32, photons_per_iteration=1 << 12,
                      photon_exchange=x))
        for x in ("ALL_GATHER", "ALL_TO_ALL")]
    cases += [
        dict(common, name=f"ppm_{x.lower()}_24",
             cfg=dict(ppm, width=24, height=24, photons_per_iteration=1 << 12,
                      photon_exchange=x))
        for x in ("ALL_GATHER", "ALL_TO_ALL")]
    pt16 = dict(kind="render", seed=1, iteration=0, radius_sq=0.01,
                cfg=dict(width=16, height=16))
    cases += [dict(pt16, name="pt_16"), dict(pt16, name="pt_16_mesh1",
                                              mesh=1)]
    # __graft_entry__.dryrun_multichip's two sharded steps
    vcm = "VCM_BIDIRECTIONAL_PATH_TRACING"
    cases.append(dict(kind="render", name="dryrun_vcm", seed=0, iteration=0,
                      cfg=dict(width=16, height=d * 4, vcm_max_path_length=4,
                               render_method=vcm)))
    cases.append(dict(kind="render", name="dryrun_ppm", seed=0, iteration=0,
                      cfg=dict(width=16, height=d * 4,
                               render_method="PROGRESSIVE_PHOTON_MAPPING",
                               photons_per_iteration=d * 256,
                               photon_grid_resolution=8,
                               max_photon_trace_depth=3,
                               gather_photon_budget=d * 2048)))
    cases.append(dict(kind="exchange", name="exchange", seed=3, iteration=2,
                      cfg=dict(width=32, height=32,
                               photons_per_iteration=1 << 13,
                               photon_grid_resolution=16)))
    return cases


def all_cases(d: int) -> list[dict]:
    return sharding_cases() + extra_cases(d)


def case_key(case: dict) -> str:
    return json.dumps({k: v for k, v in case.items() if k != "name"},
                      sort_keys=True)


@functools.lru_cache(maxsize=None)
def _unsharded(key: str):
    img, stats = render_unsharded(json.loads(key), "cpu")
    return img.numpy(), {k: float(v) for k, v in stats.items()}


def unsharded(d: int, name: str):
    """The unsharded render of case ``name`` of D ranks' list (the same
    render for every D but the dryrun's)."""
    return _unsharded(case_key(next(c for c in all_cases(d)
                                     if c["name"] == name)))


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """{D: the rank-0 npz of D gloo ranks}, D = 2 and 4 spawned together;
    meanwhile this process renders the unsharded references."""
    tmp = tmp_path_factory.mktemp("shard")

    def run(d):
        out = tmp / f"d{d}.npz"
        spawn_ranks(d, all_cases(d), out, device="cpu", backend="gloo",
                    threads=1, timeout=300)
        return dict(np.load(out))

    with concurrent.futures.ThreadPoolExecutor(len(RANKS)) as pool:
        futures = {d: pool.submit(run, d) for d in RANKS}
        for d in RANKS:
            for case in all_cases(d):
                if case["kind"] == "render":
                    unsharded(d, case["name"])
        return {d: f.result() for d, f in futures.items()}


def assert_matches(got: np.ndarray, want: np.ndarray, name: str) -> None:
    assert np.isfinite(got).all()
    assert got.shape == want.shape
    if name in BITS:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL,
                                   atol=ATOL_OF_MAX * np.abs(want).max())


@pytest.mark.parametrize("d", RANKS)
@pytest.mark.parametrize("name", JAX_CASES)
def test_sharded_matches_unsharded(sharded, d, name):
    """test_sharding.py:29-59's seven cases at D = 2 and 4."""
    want, _ = unsharded(d, name)
    assert_matches(sharded[d][f"{name}.image"], want, name)


@pytest.mark.parametrize("d", RANKS)
@pytest.mark.parametrize("name", ["ppm_all_gather_medium",
                                  "ppm_all_to_all_medium",
                                  "ppm_all_gather_24", "ppm_all_to_all_24"])
def test_medium_and_budgeted_branches_match_unsharded(sharded, d, name):
    """PPM in a participating medium (the volumetric photons exchanged and
    gathered at 3r), and at 24^2, where no 16x16 block tiles the image and
    both exchanges take the budgeted gather."""
    want, _ = unsharded(d, name)
    assert_matches(sharded[d][f"{name}.image"], want, name)


@pytest.mark.parametrize("d", RANKS)
def test_sharded_stats_sum_to_unsharded(sharded, d):
    z = sharded[d]
    for name in JAX_CASES + ["ppm_all_to_all_medium", "ppm_all_to_all_24"]:
        _, want = unsharded(d, name)
        for k, v in want.items():
            got = float(z[f"{name}.stat.{k}"])
            if k.startswith("avg_"):
                assert got == pytest.approx(v, rel=1e-6), (name, k)
            else:
                assert got == v, (name, k)
    assert float(z["ppm_all_to_all.stat.photon_exchange_overflow"]) == 0
    stored = z["vcm_vm.stat.vcm_gathered_store_bytes_per_device"]
    assert stored > 0
    assert z["vcm.stat.vcm_gathered_store_bytes_per_device"] == 0


@pytest.mark.parametrize("d", RANKS)
def test_sharded_output_is_actually_sharded(sharded, d):
    assert tuple(sharded[d]["pt.band_shape"]) == (32 // d, 32, 3)
    assert sharded[d]["pt.image"].shape == (32, 32, 3)


@pytest.mark.parametrize("n", [1, 2, 4])
def test_mesh_sizes(sharded, n):
    """A PT step at 16^2 on meshes of 1 (in this process), 2 and 4 ranks
    equals the unsharded render."""
    want, _ = unsharded(2, "pt_16")
    if n == 1:
        scene, cam = get_scene_by_name("CornellSmall", "cpu")
        band, _ = make_sharded_render_fn(
            scene, cam, RenderConfig(width=16, height=16),
            make_mesh(1, device="cpu"))(0, make_root_key(1), 0.01)
        got = band.numpy()
    else:
        got = sharded[n]["pt_16.image"]
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("d", RANKS)
def test_one_rank_mesh_inside_a_larger_group(sharded, d):
    """make_mesh(1) in a group of D: each rank renders the whole image."""
    z = sharded[d]
    assert tuple(z["pt_16_mesh1.band_shape"]) == (16, 16, 3)
    np.testing.assert_array_equal(z["pt_16_mesh1.image"],
                                  unsharded(d, "pt_16")[0])


@pytest.mark.parametrize("d", [2, 4, 8])
def test_indivisible_raises(d):
    """31^2 pixels split into no band of D ranks (a mesh object of D ranks
    builds no group: the step checks its sizes first)."""
    scene, cam = get_scene_by_name("CornellSmall", "cpu")
    with pytest.raises(ValueError):
        make_sharded_render_fn(scene, cam, RenderConfig(width=31, height=31),
                               Mesh(None, 0, d, torch.device("cpu"), None))


def test_mesh_checks_raise():
    with pytest.raises(ValueError):
        make_mesh(2, device="cpu")       # no process group of 2 ranks
    vm = RenderConfig(
        width=32, height=32, vcm_use_vm=True,
        render_method=RenderMethod.VCM_BIDIRECTIONAL_PATH_TRACING)
    prender._check_divisible(vm, 4)      # bands of 256 vertices tile
    with pytest.raises(ValueError):
        prender._check_divisible(vm, 8)  # bands of 128 would not


@pytest.mark.parametrize("d", RANKS)
@pytest.mark.parametrize("name", ["dryrun_vcm", "dryrun_ppm"])
def test_dryrun_multichip_equalities(sharded, d, name):
    """__graft_entry__.dryrun_multichip:38-77 at D ranks: the VCM and PPM
    steps' shapes, finite values, and equality with unsharded at its
    rtol 2e-3, atol 2e-4."""
    got = sharded[d][f"{name}.image"]
    want, _ = unsharded(d, name)
    assert got.shape == (d * 4, 16, 3)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-4)


@pytest.mark.parametrize("d", RANKS)
def test_exchange_conserves_power(sharded, d):
    """Without overflow the partial grids hold every valid photon and
    their summed power is the photons' (in float64, rtol 1e-12)."""
    z = sharded[d]
    assert int(z["exchange.overflow"]) == 0
    assert z["exchange.grid_photons"] == z["exchange.photons"] > 0
    np.testing.assert_allclose(z["exchange.grid_power"],
                               z["exchange.photon_power"], rtol=1e-12)
    assert int(z["exchange.bytes_per_rank"]) == \
        int(z["exchange.slab_rows"]) * 10 * 4


@pytest.mark.parametrize("name", ["ppm_all_to_all", "vcm_vm"])
def test_one_rank_step_is_the_unsharded_render(name):
    """A one-rank mesh runs the whole sharded path with identity
    collectives: the exchange, the gathers over the partial grid, the
    whole image's tile merge. Its image is the unsharded one, bit for
    bit."""
    case = next(c for c in sharding_cases() if c["name"] == name)
    scene, cam = get_scene_by_name("CornellSmall", "cpu")
    band, _ = make_sharded_render_fn(
        scene, cam, config_from(case["cfg"]), make_mesh(1, device="cpu"))(
        case["iteration"], make_root_key(case["seed"]), case["radius_sq"])
    np.testing.assert_array_equal(band.numpy(), unsharded(2, name)[0])


@pytest.mark.parametrize("structure", [PhotonMapStructure.STOCHASTIC_HASH,
                                       PhotonMapStructure.KD_TREE_CPU])
def test_sharded_ppm_uses_the_grid_whatever_the_structure(structure):
    """As JAX's sharded step, the port's builds the sorted grid for any
    ``photon_map_structure``: its image is the grid's."""
    case = next(c for c in sharding_cases() if c["name"] == "ppm_all_gather")
    scene, cam = get_scene_by_name("CornellSmall", "cpu")
    cfg = config_from(case["cfg"]).replace(photon_map_structure=structure)
    band, _ = make_sharded_render_fn(scene, cam, cfg,
                                     make_mesh(1, device="cpu"))(
        case["iteration"], make_root_key(case["seed"]), case["radius_sq"])
    np.testing.assert_array_equal(band.numpy(),
                                  unsharded(2, "ppm_all_gather")[0])
