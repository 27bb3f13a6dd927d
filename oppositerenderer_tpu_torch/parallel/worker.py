"""One rank of a multi-process run of the port's distribution.

Run as

    python -m oppositerenderer_tpu_torch.parallel.worker --rank R \\
        --world D --port P --spec cases.json --out result.npz \\
        [--device cpu|cuda] [--backend gloo|nccl]

once per rank (:func:`spawn_ranks` starts them all, each a fresh
interpreter, never a fork). Every rank joins the process group at
``127.0.0.1:P``, runs the named cases of the JSON spec (``{"cases":
[...]}``) in order, and rank 0 writes every case's results to ``--out``
as ``<name>.<key>`` arrays. A case is a dict with ``name``, ``kind``,
``cfg`` (``RenderConfig`` fields; enums by name) and optionally
``scene`` (a scene name), ``medium`` ([sigma_s, sigma_a, box edge]),
``seed``, ``iteration``, ``radius_sq``, ``mesh`` (the mesh's rank count),
``reps`` and ``time_each_rep``. Kinds:

* ``render``: the sharded step (``parallel.render``), ``reps`` times
  after a warm-up when ``reps`` > 1; ``image`` the gathered bands,
  ``band_shape``, ``stat.<k>``, and ``ms`` a step: the reps run back to
  back with one synchronize after the last, and the slowest rank's time
  over ``reps``. With ``time_each_rep`` every rep is synchronized on
  its own and ``ms_reps`` holds each rep's time, the slowest rank's,
  instead of ``ms``. On a
  CUDA rank over NCCL (or a one-rank ``mesh``) the step and the
  gradient below are replays of captured graphs after their first call
  (``parallel.render.uses_graph``); gloo ranks run them eagerly;
* ``exchange``: one photon pass and ``exchange_photons_by_cell``; the
  photons' and the partial grids' summed power, the overflow, the slab
  bytes a rank sends and the exchange's ms;
* ``grad``: ``diff.make_sharded_loss_and_grad`` for ``wrt`` ([[field,
  index], ...]); ``loss``, ``grad.<field>.<index>``, ``seconds``;
* ``multihost``: ``MultiHostRenderer.run`` over ``iterations``, strided
  or, with ``schedule: "leased"``, through an ``IterationScheduler``;
  ``accum``, ``iterations``, ``rendered`` (per process), ``merge_ms``;
* ``scaling``: ``tests/distributed_worker.py``'s timed job: a
  ``MultiHostRenderer`` warmed up, a barrier, then process w renders
  iterations w, w + N, ... below ``iterations`` and the film merges;
  ``accum``, ``iterations``, ``local_iterations``, ``rendered`` (per
  process), and rank 0's ``seconds`` (render and merge),
  ``render_seconds`` and ``merge_seconds``.

Every case also records each kernel's launches in it, summed over ranks
(``launches.<name>``), and ``rank_devices`` holds the card each rank
rendered on (-1 for the CPU).

With ``--device cuda`` rank r renders on ``cuda:r`` when the machine has
at least ``--world`` cards; with fewer, gloo ranks share ``cuda:0`` and
NCCL ranks raise before the group is made
(``distributed.rank_device``).
"""
from __future__ import annotations

import argparse
import dataclasses
import enum
import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from ..accel import kernel_wrappers
from ..config import RenderConfig

REPO = Path(__file__).resolve().parents[2]


def config_from(fields: dict) -> RenderConfig:
    """A ``RenderConfig`` from JSON fields, enums given by name."""
    kw = {}
    for f in dataclasses.fields(RenderConfig):
        if f.name in fields:
            v = fields[f.name]
            default = f.default
            if isinstance(default, enum.Enum) and isinstance(v, str):
                v = type(default)[v]
            kw[f.name] = v
    unknown = set(fields) - {f.name for f in dataclasses.fields(RenderConfig)}
    if unknown:
        raise ValueError(f"unknown RenderConfig fields {sorted(unknown)}")
    return RenderConfig(**kw)


def sharding_cases(size: int = 32, seed: int = 3,
                   iteration: int = 2) -> list[dict]:
    """The JAX package's seven sharded-against-unsharded cases
    (``tests/test_sharding.py:29-59``) as ``render`` cases at ``size``^2,
    CornellSmall, radius^2 0.002: PT; PPM with each exchange at a gather
    budget no box exceeds, and the all-to-all again at 2^11 photons; VCM,
    with uniform vertex sampling and with vertex merging."""
    base = dict(width=size, height=size, photons_per_iteration=1 << 13,
                photon_grid_resolution=16)
    ppm = dict(render_method="PROGRESSIVE_PHOTON_MAPPING",
               gather_photon_budget=4096)
    vcm = dict(render_method="VCM_BIDIRECTIONAL_PATH_TRACING")
    cfgs = {
        "pt": dict(render_method="PATH_TRACING"),
        "ppm_all_gather": dict(ppm, photon_exchange="ALL_GATHER"),
        "ppm_all_to_all": dict(ppm, photon_exchange="ALL_TO_ALL"),
        "vcm": vcm,
        "vcm_uniform": dict(vcm, vcm_uniform_vertex_sampling=True),
        "ppm_all_to_all_2k": dict(ppm, photon_exchange="ALL_TO_ALL",
                                  photons_per_iteration=1 << 11),
        "vcm_vm": dict(vcm, vcm_use_vm=True),
    }
    return [{"name": name, "kind": "render", "cfg": {**base, **cfg},
             "seed": seed, "iteration": iteration, "radius_sq": 0.002}
            for name, cfg in cfgs.items()]


def case_scene(case: dict, device):
    """(scene, camera) of a case, with its medium if it has one."""
    from ..scene import Medium, get_scene_by_name
    scene, cam = get_scene_by_name(case.get("scene", "CornellSmall"),
                                   device)
    if case.get("medium"):
        s, a, edge = case["medium"]
        scene = dataclasses.replace(scene, medium=Medium(
            sigma_s=torch.tensor(float(s), device=device),
            sigma_a=torch.tensor(float(a), device=device),
            aabb_min=torch.zeros(3, device=device),
            aabb_max=torch.full((3,), float(edge), device=device)))
    return scene, cam


def render_unsharded(case: dict, device):
    """(image [H,W,3], stats) of the case's iteration through the
    unsharded integrator: what its sharded render must equal."""
    from ..config import RenderMethod
    from ..core.rng import make_root_key
    from ..integrators import ppm, pt, vcm
    cfg = config_from(case["cfg"])
    scene, cam = case_scene(case, device)
    key = make_root_key(case.get("seed", 0))
    it = case.get("iteration", 0)
    r2 = case.get("radius_sq", 0.002)
    if cfg.render_method == RenderMethod.PATH_TRACING:
        return pt.render_iteration(scene, cam, cfg, it, key), {}
    mod = (ppm if cfg.render_method == RenderMethod.PROGRESSIVE_PHOTON_MAPPING
           else vcm)
    return mod.render_iteration(scene, cam, cfg, it, key, r2)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _run_render(case, device, world):
    from ..core.rng import make_root_key
    from .mesh import make_mesh
    from .render import gather_image, make_sharded_render_fn
    cfg = config_from(case["cfg"])
    scene, cam = case_scene(case, device)
    mesh = make_mesh(case.get("mesh"), device=device)
    step = make_sharded_render_fn(scene, cam, cfg, mesh)
    args = (case.get("iteration", 0), make_root_key(case.get("seed", 0)),
            case.get("radius_sq", 0.002))
    reps = case.get("reps", 1)
    if reps > 1:
        step(*args)          # warm-up
    _sync(device)
    if case.get("time_each_rep", False):
        ms_reps = []
        for _ in range(reps):
            t0 = time.perf_counter()
            band, stats = step(*args)
            _sync(device)
            ms_reps.append((time.perf_counter() - t0) * 1e3)
        timing = {"ms_reps": world.pmax(torch.tensor(ms_reps,
                                                     dtype=torch.float64))}
    else:
        t0 = time.perf_counter()
        for _ in range(reps):
            band, stats = step(*args)
        _sync(device)
        ms = (time.perf_counter() - t0) / reps * 1e3
        timing = {"ms": world.pmax(torch.tensor([ms]))[0]}
    out = {"image": gather_image(band, mesh),
           "band_shape": torch.tensor(band.shape), **timing,
           GRAPH_LAUNCHES: ({} if step.captured is None
                            else step.captured.launches())}
    out.update({f"stat.{k}": v for k, v in stats.items()})
    return out


def _run_exchange(case, device, world):
    from ..config import RenderMethod
    from ..core.rng import fold_in, iteration_key, make_root_key, uniform
    from ..integrators import ppm
    from ..integrators.common import scene_epsilon
    from ..photon_map import min_cell_size_for_window
    from .exchange import (PHOTON_COLUMNS, exchange_photons_by_cell,
                           slab_capacity)
    from .mesh import make_mesh
    cfg = config_from(case["cfg"]).replace(
        render_method=RenderMethod.PROGRESSIVE_PHOTON_MAPPING)
    scene, _ = case_scene(case, device)
    mesh = make_mesh(case.get("mesh"), device=device)
    key = make_root_key(case.get("seed", 0))
    it = case.get("iteration", 0)
    p_local = cfg.photons_per_iteration // mesh.size
    lanes = torch.arange(mesh.rank * p_local, (mesh.rank + 1) * p_local,
                         dtype=torch.int64, device=device)
    photons, _, _ = ppm.trace_photon_pass(
        scene, cfg, iteration_key(key, it, ppm.PASS_PPM_PHOTON),
        scene_epsilon(scene), lanes)
    est_key = iteration_key(key, it, ppm.PASS_PPM_ESTIMATE)
    radius = torch.sqrt(torch.tensor(case.get("radius_sq", 0.002),
                                     device=device))
    _sync(device)
    t0 = time.perf_counter()
    grid, xstats = exchange_photons_by_cell(
        photons, cfg.photon_grid_resolution, mesh,
        min_cell_size=min_cell_size_for_window(radius, 4),
        capacity_factor=cfg.photon_exchange_capacity_factor,
        subsample_u=uniform(fold_in(est_key, 57), (), device))
    _sync(device)
    ms = (time.perf_counter() - t0) * 1e3
    live = torch.arange(grid.power.shape[0], device=device) < grid.n_valid
    sums = torch.stack([
        torch.sum(torch.where(photons.valid[:, None], photons.power, 0.0),
                  dtype=torch.float64),
        torch.sum(torch.where(live[:, None], grid.power, 0.0),
                  dtype=torch.float64),
        photons.valid.sum().to(torch.float64),
        grid.n_valid.to(torch.float64)])
    sums = mesh.psum(sums)
    cap = slab_capacity(photons.position.shape[0], mesh.size,
                        cfg.photon_exchange_capacity_factor)
    return {"photon_power": sums[0], "grid_power": sums[1],
            "photons": sums[2], "grid_photons": sums[3],
            "overflow": xstats["photon_exchange_overflow"],
            "slab_rows": torch.tensor(cap * mesh.size),
            # float32 columns: position, power, direction, validity
            "bytes_per_rank": torch.tensor(
                cap * mesh.size * (PHOTON_COLUMNS + 1) * 4),
            "ms": world.pmax(torch.tensor([ms]))[0]}


def _run_grad(case, device, world):
    from ..core.rng import make_root_key
    from ..diff import make_sharded_loss_and_grad
    from .mesh import make_mesh
    cfg = config_from(case["cfg"])
    scene, cam = case_scene(case, device)
    mesh = make_mesh(case.get("mesh"), device=device)
    wrt = {}
    for field, idx in case["wrt"]:
        wrt[(field, idx)] = (torch.tensor(1.0) if field == "emission_scale"
                             else getattr(scene.materials, field)[idx])
    fn = make_sharded_loss_and_grad(scene, cam, cfg, mesh, wrt)
    _sync(device)
    t0 = time.perf_counter()
    loss, grads = fn(iteration=case.get("iteration", 0),
                     key=make_root_key(case.get("seed", 0)),
                     radius_sq=case.get("radius_sq", 0.002))
    _sync(device)
    seconds = time.perf_counter() - t0
    out = {"loss": loss, "seconds": world.pmax(torch.tensor([seconds]))[0]}
    out.update({f"grad.{f}.{i}": g for (f, i), g in grads.items()})
    return out


# a case's result key for its Renderer's graph-replay launches
GRAPH_LAUNCHES = "graph_launches"


def _run_multihost(case, device, world):
    from .distributed import IterationScheduler, MultiHostRenderer
    cfg = config_from(case["cfg"])
    scene, cam = case_scene(case, device)
    mhr = MultiHostRenderer(scene, cam, cfg, seed=case.get("seed", 0))
    total = case["iterations"]
    sched = None
    if case.get("schedule") == "leased":
        sched = IterationScheduler(total_iterations=total,
                                   packet_size=case.get("packet_size", 2))
    film = mhr.run(total, sched)
    rendered = torch.zeros(mhr.process_count, dtype=torch.int64)
    rendered[mhr.process_index] = mhr.stats["iterations"]
    _sync(device)
    t0 = time.perf_counter()
    mhr.merged_film()
    _sync(device)
    merge_ms = (time.perf_counter() - t0) * 1e3
    return {"accum": film.accum, "iterations": torch.tensor(film.iterations),
            "rendered": world.psum(rendered),
            "render_seconds": torch.tensor(mhr.stats["render_seconds"]),
            "merge_ms": world.pmax(torch.tensor([merge_ms]))[0],
            GRAPH_LAUNCHES: mhr.kernel_launches()}


def _run_scaling(case, device, world):
    import torch.distributed as dist

    from .distributed import MultiHostRenderer
    cfg = config_from(case["cfg"])
    scene, cam = case_scene(case, device)
    mhr = MultiHostRenderer(scene, cam, cfg, seed=case.get("seed", 0))
    # the first calls (kernel loads, captures) and the merge run outside
    # the clock, and the ranks start it together
    mhr.warmup()
    if world.size > 1:
        dist.barrier()
    t0 = time.perf_counter()
    mhr.render_iterations(tuple(range(world.rank, case["iterations"],
                                      world.size)))
    _sync(device)
    render_s = time.perf_counter() - t0
    film = mhr.merged_film()
    accum = film.accum.cpu()
    seconds = time.perf_counter() - t0
    rendered = torch.zeros(world.size, dtype=torch.int64)
    rendered[world.rank] = mhr.stats["iterations"]
    return {"accum": accum, "iterations": torch.tensor(film.iterations),
            "local_iterations": torch.tensor(mhr.stats["iterations"]),
            "rendered": world.psum(rendered),
            "seconds": torch.tensor(seconds),
            "render_seconds": torch.tensor(render_s),
            "merge_seconds": torch.tensor(seconds - render_s),
            GRAPH_LAUNCHES: mhr.kernel_launches()}


KINDS = {"render": _run_render, "exchange": _run_exchange,
         "grad": _run_grad, "multihost": _run_multihost,
         "scaling": _run_scaling}


def run_cases(cases: list[dict], device, world) -> dict[str, np.ndarray]:
    """Every case on this rank; the results as host arrays, with each
    kernel's launches in the case summed over ranks
    (``launches.<name>``): the wrappers' counts, plus the launches of a
    Renderer's graph replays where a case reports them."""
    out = {}
    wrappers = kernel_wrappers()
    for case in cases:
        for w in wrappers:
            w.launches = 0
        res = KINDS[case["kind"]](case, device, world)
        graph = res.pop(GRAPH_LAUNCHES, {})
        counts = world.psum(torch.tensor(
            [w.launches + graph.get(w.__name__, 0) for w in wrappers],
            dtype=torch.int64))
        res.update({f"launches.{w.__name__}": c
                    for w, c in zip(wrappers, counts)})
        for k, v in res.items():
            out[f"{case['name']}.{k}"] = (v.detach().cpu().numpy()
                                          if torch.is_tensor(v)
                                          else np.asarray(v))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--spec", type=Path, required=True)
    ap.add_argument("--out", type=Path, required=True)
    ap.add_argument("--device", default=None,
                    help="this rank's device (default: the CUDA card)")
    ap.add_argument("--backend", default=None,
                    help="gloo or nccl (default: the device's)")
    ap.add_argument("--threads", type=int, default=0,
                    help="torch CPU threads (0: torch's default)")
    ap.add_argument("--timeout", type=float, default=300.0,
                    help="seconds a collective may wait")
    args = ap.parse_args(argv)
    if args.threads:
        torch.set_num_threads(args.threads)
    import torch.distributed as dist

    from .distributed import init_distributed
    from .mesh import make_mesh
    device = init_distributed(f"127.0.0.1:{args.port}", args.world,
                              args.rank, backend=args.backend,
                              device=args.device,
                              timeout_seconds=args.timeout)
    try:
        cases = json.loads(args.spec.read_text())["cases"]
        world = make_mesh(device=device)
        out = run_cases(cases, device, world)
        # the card each rank rendered on (-1: the CPU)
        out["rank_devices"] = world.all_gather(torch.tensor(
            [device.index if device.type == "cuda" else -1])).numpy()
        if args.rank == 0:
            np.savez(args.out, **out)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    return 0


def describe_ranks(device: str, backend: str | None, world: int) -> str:
    """What ``world`` worker processes on ``device`` run as, e.g. "cuda,
    nccl, 1 card a process, 4 processes; <nvidia-smi's name, power
    limit>" or "cuda, gloo, 2 processes sharing 1 card; ...", from the
    devices ``distributed.rank_device`` gives the ranks: whether they
    share a card decides whether a multi-rank time measures scaling or
    overhead. Raises as ``rank_device`` does (no card, or NCCL ranks
    that would share one)."""
    from ..devices import card_line
    from .distributed import default_backend, rank_device
    backend = backend or default_backend(device)
    devs = {rank_device(device, r, world, backend) for r in range(world)}
    kind = next(iter(devs)).type
    procs = f"{world} process{'es' if world > 1 else ''}"
    if kind != "cuda":
        return f"{kind}, {backend}, {procs}"
    if world == 1:
        how = procs
    elif len(devs) == world:
        how = f"1 card a process, {procs}"
    else:
        how = f"{procs} sharing 1 card"
    return f"{kind}, {backend}, {how}; {card_line()}"


def free_port() -> int:
    """A TCP port free on 127.0.0.1 now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_ranks(world: int, cases: list[dict], out: Path, *,
                device: str = "cuda", backend: str | None = None,
                threads: int = 0, timeout: float = 600.0,
                pin_cores: bool = False) -> list[str]:
    """Run ``cases`` on ``world`` fresh worker processes and wait for them
    all (at most ``timeout`` seconds each); rank 0 writes ``out``. When a
    rank fails or times out the others are killed, so that no rank waits
    on a dead one, and ``RuntimeError`` carries the logs. ``pin_cores``
    runs rank r on core r modulo the cores (``taskset``). Returns each
    rank's output."""
    spec = Path(str(out) + ".spec.json")
    spec.write_text(json.dumps({"cases": cases}))
    port = free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    cmd = [sys.executable, "-m", "oppositerenderer_tpu_torch.parallel.worker",
           "--world", str(world), "--port", str(port), "--spec", str(spec),
           "--out", str(out), "--device", device, "--threads", str(threads),
           "--timeout", str(timeout)]
    if backend is not None:
        cmd += ["--backend", backend]
    # each rank's output goes to a file: a full pipe would stall the rank
    log_paths = [Path(f"{out}.rank{r}.log") for r in range(world)]
    procs = []
    cores = os.cpu_count() or 1
    for r, log in enumerate(log_paths):
        pin = ["taskset", "-c", str(r % cores)] if pin_cores else []
        with open(log, "w") as f:
            procs.append(subprocess.Popen(
                pin + cmd + ["--rank", str(r)], cwd=str(REPO), env=env,
                stdout=f, stderr=subprocess.STDOUT))
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            if (any(p.returncode not in (None, 0) for p in procs)
                    or time.monotonic() > deadline):
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait(timeout=60)
    logs = [log.read_text(errors="replace") for log in log_paths]
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        raise RuntimeError(
            f"ranks {bad} of {world} failed (exit "
            f"{[procs[r].returncode for r in bad]}):\n"
            + "\n".join(f"--- rank {r} ---\n{logs[r][-4000:]}"
                        for r in range(world)))
    return logs


if __name__ == "__main__":
    sys.exit(main())
