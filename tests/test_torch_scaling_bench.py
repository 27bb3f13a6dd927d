"""``python -m oppositerenderer_tpu_torch.scripts.scaling_bench``, the port
of ``scripts/scaling_bench.py`` and ``tests/distributed_worker.py``, on
the CPU over gloo; and the card a rank that its ranks run on
(``parallel.distributed.rank_device``), with the card count faked.

The 2-process PT film at the JAX worker's configuration (32^2, 4
iterations, seed 5) is held against JAX's one-process
``MultiHostRenderer`` film of the same iterations at the PT pixel bar of
``test_torch_pt.py::test_one_iteration_matches_jax_pixel_by_pixel``
(ROADMAP queue C): rtol 1e-4 on 99.5% of the pixels, the mean
within 1e-3. Over 4 iterations 4 of the 1024 pixels hold a path that
went another way (0.2-0.5% apart), in the port's one-process film as
well; the 2-process film equals that one at the merge's bar (rtol 2e-5,
atol 1e-6: the sums add in another order).
"""
import concurrent.futures
import hashlib
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from oppositerenderer_tpu.config import RenderConfig as JConfig
from oppositerenderer_tpu.config import RenderMethod as JMethod
from oppositerenderer_tpu.parallel.distributed import \
    MultiHostRenderer as JMultiHostRenderer
from oppositerenderer_tpu.scene import make_cornell_small
from oppositerenderer_tpu_torch import devices
from oppositerenderer_tpu_torch.parallel import distributed, mesh
from oppositerenderer_tpu_torch.parallel.distributed import \
    MultiHostRenderer
from oppositerenderer_tpu_torch.parallel.worker import (config_from,
                                                        describe_ranks)
from oppositerenderer_tpu_torch.scene import get_scene_by_name
from oppositerenderer_tpu_torch.scripts import scaling_bench

REPO = Path(__file__).resolve().parents[1]
NPROC = 2
SIZE = 32
ITERS = 4
# scripts/scaling_bench.py:80-91, at --nproc 2
JAX_RECORD_KEYS = {"method", "iterations", "resolution", "seconds_1proc",
                   "seconds_2proc", "speedup", "scaling_efficiency",
                   "merge_seconds", "protocol_overhead_fraction", "backend",
                   "timestamp"}
# (pixel rtol, share of pixels that must agree, image mean rtol)
PT_BAR = (1e-4, 0.995, 1e-3)


def jax_one_process_film() -> np.ndarray:
    """tests/distributed_worker.py's job in one JAX process: the film of
    iterations 0..ITERS-1."""
    scene, cam = make_cornell_small()
    cfg = JConfig(width=SIZE, height=SIZE,
                  render_method=JMethod.PATH_TRACING,
                  photons_per_iteration=1 << 12, photon_grid_resolution=16,
                  gather_photon_budget=64)
    mhr = JMultiHostRenderer(scene, cam, cfg, seed=scaling_bench.SEED)
    mhr.render_iterations(tuple(range(ITERS)))
    return np.asarray(mhr.local_film().accum)


@pytest.fixture(scope="module")
def farm():
    """(the PT record, the 2-process run's arrays, JAX's film): the
    processes run while this process renders JAX's film."""
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        run = pool.submit(scaling_bench.measure, "pt", NPROC, ITERS, SIZE,
                          pin_cores=False, device="cpu", backend="gloo",
                          threads=2)
        want = jax_one_process_film()
        rec, z = run.result()
    return rec, z, want


def test_two_process_film_matches_jax_one_process(farm):
    _, z, want = farm
    assert int(z["scaling.iterations"]) == ITERS
    # each process rendered its strided share
    assert z["scaling.rendered"].tolist() == [2, 2]
    assert int(z["scaling.local_iterations"]) == 2
    got = z["scaling.accum"]
    rtol, share, mean_rtol = PT_BAR
    assert got.shape == want.shape == (SIZE, SIZE, 3)
    assert np.isfinite(got).all()
    agree = np.isclose(got, want, rtol=rtol, atol=0.0).all(axis=-1)
    assert agree.mean() >= share, agree.mean()
    assert got.mean() == pytest.approx(want.mean(), rel=mean_rtol)


def test_two_process_film_equals_the_port_s_one_process_film(farm):
    _, z, _ = farm
    scene, cam = get_scene_by_name("CornellSmall", "cpu")
    case = scaling_bench.scaling_case(ITERS, SIZE, "pt")
    mhr = MultiHostRenderer(scene, cam, config_from(case["cfg"]),
                            seed=scaling_bench.SEED)
    mhr.render_iterations(tuple(range(ITERS)))
    np.testing.assert_allclose(z["scaling.accum"],
                               mhr.local_film().accum.numpy(), rtol=2e-5,
                               atol=1e-6)


def test_record_has_exactly_the_jax_keys(farm):
    rec, z, _ = farm
    assert set(rec) == JAX_RECORD_KEYS
    assert rec["method"] == "pt" and rec["iterations"] == ITERS
    assert rec["resolution"] == f"{SIZE}x{SIZE}"
    assert rec["backend"] == "cpu, gloo, 2 processes"
    assert rec["seconds_1proc"] > 0 and rec["seconds_2proc"] > 0
    assert rec["speedup"] == pytest.approx(
        rec["seconds_1proc"] / rec["seconds_2proc"], rel=5e-3)
    seconds = float(z["scaling.seconds"])
    assert float(z["scaling.render_seconds"]) + float(
        z["scaling.merge_seconds"]) == pytest.approx(seconds)


def digest(path: Path) -> str:
    return hashlib.sha256(path.read_bytes()).hexdigest()


def test_a_run_leaves_the_jax_round_s_files_unchanged(tmp_path, capsys):
    before = {f: digest(REPO / f) for f in ("SCALING.md", "scaling.json")}
    out = tmp_path / "scaling.json"
    recs = scaling_bench.main(["--device", "cpu", "--nproc", "2", "--size",
                               "16", "--iters", "2", "--no-pin",
                               "--table", "--out", str(out)])
    assert {f: digest(REPO / f) for f in before} == before
    assert json.loads(out.read_text()) == recs
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[0]) == recs[0]
    assert lines[-1].startswith("| pt | 16x16 / 2 it | ")


def test_method_iterations_follow_the_jax_script():
    assert scaling_bench.method_iterations("pt", 16) == 16
    assert scaling_bench.method_iterations("ppm", 16) == 8
    assert scaling_bench.method_iterations("ppm", 4) == 4


# --- the card a rank ---------------------------------------------------
@pytest.fixture
def cards(monkeypatch):
    """Fake ``n`` CUDA cards: returns a setter; records set_device and
    init_process_group calls in order."""
    calls = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "set_device",
                        lambda d: calls.append(("set_device", d)))
    monkeypatch.setattr(
        torch.distributed, "init_process_group",
        lambda backend, **kw: calls.append(
            ("init", backend, kw["world_size"], kw["rank"])))
    monkeypatch.setattr(devices, "card_line", lambda: "Card X, 700.00 W")

    def set_cards(n):
        monkeypatch.setattr(torch.cuda, "device_count", lambda: n)
        return calls
    return set_cards


@pytest.mark.parametrize("backend", ["nccl", "gloo", None])
def test_rank_renders_on_its_own_card_when_there_are_enough(cards, backend):
    cards(4)
    for world in (2, 4):
        for r in range(world):
            for dev in ("cuda", None):
                assert distributed.rank_device(dev, r, world, backend) == \
                    torch.device("cuda", r)


def test_gloo_ranks_share_card_zero_with_fewer_cards(cards):
    cards(1)
    for r in range(4):
        assert distributed.rank_device("cuda", r, 4, "gloo") == \
            torch.device("cuda", 0)


def test_cpu_and_an_indexed_card_stay_as_given(cards):
    cards(1)
    assert distributed.rank_device("cpu", 3, 4, "gloo") == \
        torch.device("cpu")
    assert distributed.rank_device("cuda:0", 1, 2, "gloo") == \
        torch.device("cuda", 0)
    assert distributed.rank_device("cuda:1", 0, 1, "nccl") == \
        torch.device("cuda", 1)


@pytest.mark.parametrize("backend", ["nccl", None])
def test_nccl_ranks_on_an_indexed_card_raise_however_many_cards(
        cards, backend):
    calls = cards(4)
    for r in range(4):
        with pytest.raises(RuntimeError, match=r"4 NCCL ranks on cuda:0 .*"
                           r"--device cuda.*--backend gloo"):
            distributed.rank_device("cuda:0", r, 4, backend)
    with pytest.raises(RuntimeError, match="--backend gloo"):
        distributed.init_distributed("127.0.0.1:1", 4, 1, backend=backend,
                                     device="cuda:0")
    with pytest.raises(RuntimeError, match="--backend gloo"):
        describe_ranks("cuda:0", backend, 4)
    assert calls == []


@pytest.mark.parametrize("backend", ["nccl", None])
def test_nccl_with_more_ranks_than_cards_raises_before_the_group(
        cards, backend):
    calls = cards(2)
    with pytest.raises(RuntimeError, match=r"4 NCCL ranks.* has 2.*"
                       r"--backend gloo"):
        distributed.init_distributed("127.0.0.1:1", 4, 1, backend=backend,
                                     device="cuda")
    assert calls == []


def test_init_sets_the_rank_s_card_before_nccl_makes_its_group(cards):
    calls = cards(4)
    dev = distributed.init_distributed("127.0.0.1:1", 4, 2, device="cuda")
    assert dev == torch.device("cuda", 2)
    assert calls == [("set_device", torch.device("cuda", 2)),
                     ("init", "nccl", 4, 2)]


def test_gloo_ranks_on_one_card_make_their_group(cards):
    calls = cards(1)
    dev = distributed.init_distributed("127.0.0.1:1", 2, 1, backend="gloo",
                                       device="cuda")
    assert dev == torch.device("cuda", 0)
    assert calls == [("set_device", torch.device("cuda", 0)),
                     ("init", "gloo", 2, 1)]


def test_one_process_makes_a_group_only_for_a_named_backend(cards):
    calls = cards(1)
    assert distributed.init_distributed(None, 1, 0, device="cuda") == \
        torch.device("cuda", 0)
    assert calls == [("set_device", torch.device("cuda", 0))]
    distributed.init_distributed("127.0.0.1:1", 1, 0, backend="nccl",
                                 device="cuda")
    assert calls[-1] == ("init", "nccl", 1, 0)


def test_make_mesh_refuses_an_nccl_group_larger_than_the_cards(
        cards, monkeypatch):
    cards(2)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda g=None: 4)
    monkeypatch.setattr(torch.distributed, "get_rank", lambda g=None: 0)
    monkeypatch.setattr(torch.distributed, "get_backend",
                        lambda g=None: "nccl")
    with pytest.raises(RuntimeError, match="--backend gloo"):
        mesh.make_mesh(group=object(), device="cuda:0")
    cards(4)
    m = mesh.make_mesh(group=object(), device="cuda:0")
    assert (m.size, m.backend) == (4, "nccl")


def test_without_a_card_cuda_ranks_raise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        distributed.rank_device("cuda", 0, 2, "gloo")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        describe_ranks("cuda", "gloo", 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        scaling_bench.main(["--device", "cuda", "--backend", "gloo"])


def test_describe_ranks_says_whether_ranks_share_a_card(cards):
    cards(4)
    assert describe_ranks("cuda", None, 4) == \
        "cuda, nccl, 1 card a process, 4 processes; Card X, 700.00 W"
    assert describe_ranks("cuda:0", "gloo", 4) == \
        "cuda, gloo, 4 processes sharing 1 card; Card X, 700.00 W"
    cards(1)
    assert describe_ranks("cuda", "gloo", 2) == \
        "cuda, gloo, 2 processes sharing 1 card; Card X, 700.00 W"
    assert describe_ranks("cuda", "nccl", 1) == \
        "cuda, nccl, 1 process; Card X, 700.00 W"
    with pytest.raises(RuntimeError, match="--backend gloo"):
        describe_ranks("cuda", None, 2)
    assert describe_ranks("cpu", None, 2) == "cpu, gloo, 2 processes"
