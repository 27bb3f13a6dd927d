"""Multi-process distribution: iteration sharding, leases, film merge.

The counterpart of ``oppositerenderer_tpu/parallel/distributed.py``. The
reference's distribution layer is a TCP star: a client hands render
servers packets of iteration numbers, servers render whole frames, and
the client folds results back in iteration order
(``Client/DistributedApplication.cpp:96-122``,
``RenderResultPacketReceiver.cpp:67-148``); a lost server's iterations
are never reassigned. Here:

* transport: ``torch.distributed`` (:func:`init_distributed`, NCCL on the
  card, gloo on the CPU); the client's merge is one all-reduce of the
  film sum and its count (:meth:`MultiHostRenderer.merged_film`);
* iterations shard across processes; an iteration's radiance is a pure
  function of its number and the seed (the PPM radius too), so the merge
  is order-independent;
* :class:`IterationScheduler` leases packets of iterations with expiry
  and a sequence number (a copy of the JAX package's: host-only). Across
  processes rank 0 holds it and hands each process its packet every round
  (:meth:`MultiHostRenderer.run`).
"""
from __future__ import annotations

import datetime
import time
from dataclasses import dataclass, field
from typing import Any

import torch
import torch.distributed as dist

from ..camera import Camera
from ..config import RenderConfig
from ..devices import resolve_device
from ..film import Film
from ..renderer import Renderer
from ..scene.types import Scene
from .mesh import check_nccl_cards, make_mesh

# reference flow-control constants (DistributedApplication.cpp:31,
# RenderServerConnection.cpp:37-48)
ITERATIONS_PER_PACKET = 4
MAX_PENDING_PER_WORKER = 30


def default_backend(device: torch.device | str | None) -> str:
    """The backend a rank on ``device`` takes unless one is named: NCCL
    for the CUDA card (``device`` None), gloo for the CPU."""
    return "nccl" if resolve_device(device).type == "cuda" else "gloo"


def rank_device(device: torch.device | str | None, rank: int, world: int,
                backend: str | None = None) -> torch.device:
    """The device rank ``rank`` of ``world`` renders on, as
    ``jax.distributed`` gives each process its own device. A bare CUDA
    device (``"cuda"``, or None: the card) is card ``rank`` when the
    machine has at least ``world`` cards. With fewer, gloo ranks share
    ``cuda:0`` and NCCL ranks (``backend`` None on a card means NCCL)
    raise ``RuntimeError`` (:func:`~.mesh.check_nccl_cards`). The CPU
    and an indexed card (``"cuda:1"``) stay as given, every rank on it;
    more than one NCCL rank on an indexed card raises, as NCCL ranks
    cannot share a card. Without a card a CUDA device raises."""
    device = resolve_device(device)
    if device.type != "cuda":
        return device
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu (device="
                           '"cpu") to run the ranks on the CPU')
    if device.index is not None:
        if (backend or "nccl") == "nccl" and world > 1:
            raise RuntimeError(
                f"{world} NCCL ranks on {device} would share that card, "
                "which NCCL cannot do: pass --device cuda (a card a rank) "
                "or --backend gloo (backend=\"gloo\")")
        return device
    if torch.cuda.device_count() >= world:
        return torch.device("cuda", rank)
    check_nccl_cards(world, backend or "nccl")
    return torch.device("cuda", 0)


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     backend: str | None = None,
                     device: torch.device | str | None = None,
                     timeout_seconds: float = 300.0) -> torch.device:
    """Join the process group at ``coordinator`` ("host:port"; rank 0
    listens there) as rank ``process_id`` of ``num_processes``, and
    return the device this rank renders on (:func:`rank_device`), made
    CUDA's current device before NCCL creates its communicator. For one
    process no group is made unless ``backend`` is named. ``backend``
    None takes the device's (:func:`default_backend`); NCCL with more
    ranks than cards raises before the group is made. A collective that waits longer than
    ``timeout_seconds`` raises."""
    world = num_processes or 1
    rank = process_id or 0
    named = backend is not None
    backend = backend or default_backend(device)
    device = rank_device(device, rank, world, backend)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if world > 1 or named:
        dist.init_process_group(
            backend, init_method=f"tcp://{coordinator}",
            world_size=world, rank=rank,
            timeout=datetime.timedelta(seconds=timeout_seconds))
    return device


@dataclass
class _Lease:
    iterations: tuple[int, ...]
    worker: str
    expires: float


@dataclass
class IterationScheduler:
    """Lease-based iteration assignment (the reference client's work
    handout, plus the reassignment it lacks).

    Workers call :meth:`acquire` for a packet of iteration numbers and
    :meth:`complete` when rendered. Leases that outlive ``lease_seconds``
    are handed to other workers. A :meth:`bump_sequence` drops all pending
    state (the reference's sequence-number invalidation,
    Application.cpp:119-127)."""

    total_iterations: int
    packet_size: int = ITERATIONS_PER_PACKET
    lease_seconds: float = 60.0
    sequence_number: int = 0
    _next: int = 0
    _completed: set = field(default_factory=set)
    _leases: dict = field(default_factory=dict)   # first_iter -> _Lease
    _pending_reassign: list = field(default_factory=list)
    _worker_stats: dict = field(default_factory=dict)  # worker -> counters

    def acquire(self, worker: str, now: float | None = None
                ) -> tuple[int, tuple[int, ...]]:
        """Returns (sequence_number, iteration numbers): empty when done."""
        now = time.monotonic() if now is None else now
        self._expire(now)
        # bounded in-flight per worker (reference: <=30 pending iterations)
        pending = sum(len(lease.iterations) for lease in self._leases.values()
                      if lease.worker == worker)
        if pending + self.packet_size > MAX_PENDING_PER_WORKER:
            return self.sequence_number, ()
        if self._pending_reassign:
            its = self._pending_reassign.pop(0)
        else:
            its = tuple(range(self._next, min(self._next + self.packet_size,
                                              self.total_iterations)))
            self._next += len(its)
        if not its:
            return self.sequence_number, ()
        self._leases[its[0]] = _Lease(its, worker, now + self.lease_seconds)
        return self.sequence_number, its

    def complete(self, sequence_number: int, iterations: tuple[int, ...]
                 ) -> bool:
        """Returns False when the work is stale (sequence bumped) and must
        be discarded (RenderServerConnection.cpp:185-212 stale drop)."""
        if sequence_number != self.sequence_number or not iterations:
            return False
        lease = self._leases.pop(iterations[0], None)
        self._completed.update(iterations)
        if lease is not None:
            w = self._worker_stats.setdefault(
                lease.worker, {"iterations": 0, "packets": 0})
            w["iterations"] += len(iterations)
            w["packets"] += 1
        return True

    def worker_stats(self) -> list[dict]:
        """Per-worker farm table rows (ConnectedServersTableModel.cpp):
        worker name, completed iterations and packets, pending
        iterations."""
        pending: dict[str, int] = {}
        for lease in self._leases.values():
            pending[lease.worker] = (pending.get(lease.worker, 0)
                                     + len(lease.iterations))
        names = sorted(set(self._worker_stats) | set(pending))
        return [{"worker": w,
                 "iterations": self._worker_stats.get(
                     w, {}).get("iterations", 0),
                 "packets": self._worker_stats.get(w, {}).get("packets", 0),
                 "pending": pending.get(w, 0)}
                for w in names]

    def _expire(self, now: float) -> None:
        for first, lease in list(self._leases.items()):
            if lease.expires <= now:
                del self._leases[first]
                self._pending_reassign.append(lease.iterations)

    def bump_sequence(self) -> int:
        """Camera/scene change: all outstanding work becomes stale."""
        self.sequence_number += 1
        self._next = 0
        self._completed.clear()
        self._leases.clear()
        self._pending_reassign.clear()
        return self.sequence_number

    @property
    def done(self) -> bool:
        return len(self._completed) >= self.total_iterations

    @property
    def completed_count(self) -> int:
        return len(self._completed)


def merge_films(films_and_counts: list[tuple[Any, int]]) -> Film:
    """Order-independent merge of (accum [H,W,3], iterations) pairs, numpy
    or torch (the mergeBufferRunningAverage analog,
    RenderResultPacketReceiver.cpp:169-196, without its ordering)."""
    total = None
    n = 0
    for accum, count in films_and_counts:
        accum = torch.as_tensor(accum)
        total = accum if total is None else total + accum.to(total.device)
        n += count
    return Film(accum=total, iterations=n)


class MultiHostRenderer:
    """Iteration-sharded rendering across processes (or simulated workers
    in one process): each process owns a :class:`Renderer` and renders the
    global iteration numbers it is given; films merge order-independently.
    Process rank and count come from the default process group."""

    def __init__(self, scene: Scene, camera: Camera, cfg: RenderConfig,
                 seed: int = 0):
        self.scene = scene
        self.camera = camera
        self.cfg = cfg
        self.seed = seed
        initialised = dist.is_available() and dist.is_initialized()
        self.process_index = dist.get_rank() if initialised else 0
        self.process_count = dist.get_world_size() if initialised else 1
        self._mesh = (make_mesh(device=scene.device)
                      if self.process_count > 1 else None)
        self._renderer = Renderer(scene, camera, cfg, seed=seed)
        self._accum = None
        self._count = 0
        self.stats: dict[str, Any] = {"packets": 0, "iterations": 0,
                                      "render_seconds": 0.0}

    def render_iterations(self, iterations: tuple[int, ...]) -> None:
        """Render global iteration numbers into the local film (the
        server's onNewRenderCommandInQueue analog). An arithmetic
        progression goes to ``Renderer.compute_iterations`` (the float32
        closed-form radius), anything else one ``compute_iteration`` at a
        time (the radius schedule from scratch): the two radii can differ
        in the last ulp, as in the JAX package."""
        r = self._renderer
        t0 = time.perf_counter()
        diffs = {iterations[i + 1] - iterations[i]
                 for i in range(len(iterations) - 1)}
        if len(iterations) > 1 and len(diffs) == 1:
            rad_sum, _stats = r.compute_iterations(
                iterations[0], len(iterations), stride=diffs.pop())
            self._accum = (rad_sum if self._accum is None
                           else self._accum + rad_sum)
            self._count += len(iterations)
        else:
            for it in iterations:
                radiance, _stats = r.compute_iteration(it)
                safe = torch.where(torch.isfinite(radiance), radiance, 0.0)
                self._accum = safe if self._accum is None else \
                    self._accum + safe
                self._count += 1
        r._sync()
        self.stats["packets"] += 1
        self.stats["iterations"] += len(iterations)
        self.stats["render_seconds"] += time.perf_counter() - t0

    def kernel_launches(self) -> dict[str, int]:
        """The kernel launches of this process's graph replays
        (``Renderer.kernel_launches``)."""
        return self._renderer.kernel_launches()

    def reset(self) -> None:
        """Drop accumulated work (sequence-bump analog; after warm-up)."""
        self._accum = None
        self._count = 0
        self.stats = {"packets": 0, "iterations": 0, "render_seconds": 0.0}

    def warmup(self) -> None:
        """Render and merge once along :meth:`run`'s paths, then reset,
        so a timed ``run`` leaves out first-call costs (the kernels'
        build and load)."""
        self.render_iterations(tuple(range(self.process_index,
                                           self.process_count * 2,
                                           self.process_count)))
        self.merged_film()
        self.reset()

    def local_film(self) -> Film:
        accum = self._accum if self._accum is not None else torch.zeros(
            (self.cfg.height, self.cfg.width, 3), dtype=torch.float32,
            device=self.scene.device)
        return Film(accum=accum, iterations=self._count)

    def merged_film(self) -> Film:
        """Every process's film summed by ONE all-reduce of a float32
        payload [accum..., count] (2x the frame's traffic, where the
        reference ships each server's frame to the client). One process:
        the local film."""
        local = self.local_film()
        if self._mesh is None:
            return local
        payload = torch.cat([local.accum.reshape(-1), torch.tensor(
            [float(local.iterations)], device=local.accum.device)])
        out = self._mesh.psum(payload)
        h, w = self.cfg.height, self.cfg.width
        return Film(accum=out[:h * w * 3].reshape(h, w, 3),
                    iterations=int(round(float(out[-1]))))

    def run(self, total_iterations: int,
            scheduler: IterationScheduler | None = None) -> Film:
        """Render ``total_iterations`` over every process and return the
        merged film. Without a scheduler iterations stride across
        processes (process w renders w, w + P, ...). With one, packets are
        leased from it: in one process as the workers of a farm would;
        across processes the scheduler of rank 0 leases one packet a
        process every round (the others' schedulers go unread), rank 0
        broadcasts them, and after the round completes the packets every
        process reports done."""
        if scheduler is None:
            self.render_iterations(tuple(range(
                self.process_index, total_iterations, self.process_count)))
            return self.merged_film()
        if self._mesh is None:
            name = f"worker{self.process_index}"
            while not scheduler.done:
                seq, its = scheduler.acquire(name)
                if not its:
                    break
                self.render_iterations(its)
                scheduler.complete(seq, its)
            return self.merged_film()
        return self._run_leased(scheduler)

    def _run_leased(self, scheduler: IterationScheduler) -> Film:
        mesh, me = self._mesh, self.process_index
        width = scheduler.packet_size + 1    # sequence number, iterations
        while True:
            table = torch.full((self.process_count, width), -1,
                               dtype=torch.int64)
            if me == 0:
                for w in range(self.process_count):
                    seq, its = scheduler.acquire(f"worker{w}")
                    table[w, 0] = seq
                    table[w, 1:1 + len(its)] = torch.tensor(its,
                                                            dtype=torch.int64)
            table = mesh.broadcast(table).cpu()
            mine = tuple(int(i) for i in table[me, 1:] if i >= 0)
            if not bool((table[:, 1:] >= 0).any()):
                break
            if mine:
                self.render_iterations(mine)
            # the round's packets are done when every process says so
            done = torch.zeros(self.process_count, dtype=torch.int64)
            done[me] = 1 if mine else 0
            done = mesh.psum(done).cpu()
            if me == 0:
                for w in range(self.process_count):
                    its = tuple(int(i) for i in table[w, 1:] if i >= 0)
                    if done[w] and its:
                        scheduler.complete(int(table[w, 0]), its)
        return self.merged_film()

