"""``python -m oppositerenderer_tpu_torch.scripts.sharded_phase_bench``, the
port of ``scripts/sharded_phase_bench.py``, over 2 gloo ranks on the CPU
at 32^2 with 1<<12 photons and L = 4.

Each regime's image is held against the JAX package's step of the same
case at ``_sharding_jax.py``'s bars: PPM all-to-all and both VCM regimes
against JAX's sharded step on 2 of the conftest's virtual devices (PPM
with JAX's tile gather on the partial grids, ``use_pallas_gather=True``,
the port's rule whenever the image splits into 16x16 blocks). JAX's
sharded ``ALL_GATHER`` step always takes the budgeted gather, while the
port's takes the tile gather and equals its unsharded render, so that
regime is held against JAX's unsharded tile gather
(``test_torch_sharding_jax_unsharded.py``'s rule). The byte columns:
the all-to-all's against the slabs ``worker``'s exchange case sends,
VCM uniform's against JAX's ``vcm_gathered_store_bytes_per_device``, the
model against the JAX script's formula at D = 8.
"""
import concurrent.futures
import json

import jax.numpy as jnp
import numpy as np
import pytest

from _sharding_jax import (assert_agrees, jax_config, jax_mesh, jax_step,
                           jax_unsharded)
from oppositerenderer_tpu.core.rng import make_root_key as jax_key
from oppositerenderer_tpu.scene import make_cornell_small
from oppositerenderer_tpu_torch.parallel.worker import spawn_ranks
from oppositerenderer_tpu_torch.scripts import sharded_phase_bench as spb

D = 2
SIZE = 32
PHOTONS = 1 << 12
L = 4
CASES = spb.regime_cases(SIZE, PHOTONS, L, reps=2)
BY_NAME = {c["name"]: c for c in CASES}
EXCHANGE = dict(BY_NAME["ppm_all_to_all"], name="exchange", kind="exchange")
# a render case as the other callers give it: the reps back to back, one ms
PIPELINED = dict(BY_NAME["vcm_paired"], name="pipelined",
                 time_each_rep=False)
# (JAX's reference, its extra config fields, the bar's kind)
REFS = {"ppm_all_to_all": ("sharded", dict(use_pallas_gather=True), "ppm"),
        "ppm_all_gather": ("unsharded", dict(use_pallas_gather=True), "ppm"),
        "vcm_paired": ("sharded", {}, "vcm"),
        "vcm_uniform": ("sharded", {}, "vcm")}


def jax_sharded_with_stats(c: dict, **extra):
    """JAX's sharded step of case ``c`` on D virtual devices: (image,
    stats)."""
    scene, cam = make_cornell_small()
    step = jax_step(scene, cam, jax_config(c, **extra), jax_mesh(D))
    out, stats = step(jnp.int32(c["iteration"]), jax_key(c["seed"]),
                      jnp.float32(c["radius_sq"]))
    return np.asarray(out), {k: np.asarray(v) for k, v in stats.items()}


def jax_reference(name: str):
    how, extra, _ = REFS[name]
    if how == "unsharded":
        return jax_unsharded(BY_NAME[name], **extra), {}
    return jax_sharded_with_stats(BY_NAME[name], **extra)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """(the workers' arrays, JAX's (image, stats) by regime): the port's
    two ranks run while this process compiles and runs JAX's references
    side by side, each jitted once."""
    out = tmp_path_factory.mktemp("sharded_phase") / "regimes.npz"
    with concurrent.futures.ThreadPoolExecutor(1 + len(REFS)) as pool:
        spawn = pool.submit(spawn_ranks, D, CASES + [EXCHANGE, PIPELINED],
                            out,
                            device="cpu", backend="gloo", threads=2,
                            timeout=300)
        refs = {name: pool.submit(jax_reference, name) for name in REFS}
        refs = {name: f.result() for name, f in refs.items()}
        spawn.result()
    return dict(np.load(out)), refs


@pytest.fixture(scope="module")
def rows(results):
    return spb.rows_of(results[0], CASES, D)


@pytest.mark.parametrize("name", list(REFS))
def test_regime_image_matches_jax(results, name):
    z, refs = results
    got = z[name + ".image"]
    assert got.shape == (SIZE, SIZE, 3)
    assert_agrees(got, refs[name][0], REFS[name][2])


def test_vcm_uniform_bytes_equal_jax_gathered_store(results, rows):
    _, refs = results
    want = int(refs["vcm_uniform"][1]["vcm_gathered_store_bytes_per_device"])
    row = next(r for r in rows if r["regime"].startswith("vcm uniform"))
    assert want > 0
    assert row["bytes_sent"] == want == row["model_bytes"]
    paired = next(r for r in rows if r["regime"].startswith("vcm paired"))
    assert paired["bytes_sent"] == paired["model_bytes"] == 0


def test_all_to_all_bytes_are_the_exchange_slabs(results, rows):
    z, _ = results
    row = next(r for r in rows if r["regime"] == "ppm all_to_all")
    assert row["bytes_sent"] == D * int(z["exchange.bytes_per_rank"])
    # the exchange lost no photon
    assert row["stats"]["photon_exchange_overflow"] == 0
    assert int(z["exchange.overflow"]) == 0
    assert float(z["exchange.grid_photons"]) == float(z["exchange.photons"])


def test_all_gather_bytes_are_every_rank_s_rows_to_the_others(rows):
    from oppositerenderer_tpu_torch.config import RenderConfig
    depth = RenderConfig().max_photon_trace_depth
    row = next(r for r in rows if r["regime"] == "ppm all_gather")
    # position, power, direction in float32 and the validity as a byte
    assert row["bytes_sent"] == D * (D - 1) * (PHOTONS // D) * depth * 37


def test_model_column_is_the_jax_formula_at_eight_ranks():
    photons = 1 << 16
    cases = {c["name"]: c for c in spb.regime_cases(128, photons, 6)}
    # scripts/sharded_phase_bench.py:73-75
    assert spb.model_bytes(cases["ppm_all_to_all"], 8, {}) == \
        photons * 37 * 7 // 8
    assert spb.model_bytes(cases["ppm_all_gather"], 8, {}) == \
        photons * 37 * 7
    stat = {"vcm_gathered_store_bytes_per_device": 1234.0}
    assert spb.model_bytes(cases["vcm_uniform"], 8, stat) == 1234
    assert spb.model_bytes(cases["vcm_paired"], 8, {}) == 0


def test_rows_are_the_jax_regimes_with_slowest_rank_medians(results, rows):
    z, _ = results
    assert [r["regime"] for r in rows] == [
        "ppm all_to_all", "ppm all_gather", "vcm paired (local stores)",
        "vcm uniform (global store)"]
    for r, c in zip(rows, CASES):
        reps = z[c["name"] + ".ms_reps"]
        assert reps.shape == (2,) and (reps > 0).all()
        assert r["wall_ms"] == pytest.approx(float(np.median(reps)))
        assert c["name"] + ".ms" not in z
        # the CPU runs the kernels' plain versions: no launch
        assert r["launches"] == {}


def test_main_prints_the_table_then_one_json_line(rows, monkeypatch,
                                                  capsys):
    desc = "cpu, gloo, 2 processes"
    monkeypatch.setattr(spb, "run", lambda *a, **k: (rows, {}, desc))
    spb.main(["--device", "cpu", "--ranks", "2", "--size", "32"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith(f"| regime | wall/iter ({desc}) |")
    assert "bytes sent" in lines[0] and "37 B model" in lines[0]
    assert len(lines) == 2 + 4 + 1
    rec = json.loads(lines[-1])
    assert rec["device"] == desc and rec["ranks"] == 2
    assert [r["regime"] for r in rec["rows"]] == [r["regime"] for r in rows]


def test_other_render_cases_keep_one_pipelined_ms(results):
    """A render case without ``time_each_rep`` (the ranks phases', the
    tests') still reads one ``ms``: its reps back to back, one
    synchronize, the slowest rank's total over the reps."""
    z, _ = results
    assert "pipelined.ms_reps" not in z
    assert z["pipelined.ms"].shape == () and float(z["pipelined.ms"]) > 0
    np.testing.assert_array_equal(z["pipelined.image"], z["vcm_paired.image"])
