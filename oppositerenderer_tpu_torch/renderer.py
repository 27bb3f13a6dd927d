"""Renderer: the host-side render loop (OptixRenderer equivalent).

The counterpart of ``oppositerenderer_tpu/renderer.py``: owns the film,
runs one iteration at a time through the integrator, computes the
Knaus-Zwicker PPM radius schedule as a pure function of the iteration
number (``OptixRenderer.cpp:583-589``), restarts on change (the
reference's sequence-number bump, ``Gui/Application.cpp:119-127``) and
records per-iteration metrics.

The JAX package jits one iteration (``_step_fn``) and loops n of them in
one dispatch (``_multi_step_fn`` over ``_build_fused``). On a CUDA scene
the port captures one iteration in a CUDA graph (:class:`CapturedStep`),
the same thing for the card: one device program the host launches once
per iteration, whose operands (the iteration, the root key's words, the
PPM radius and the camera) live in device buffers, so that nothing of
one iteration is baked into the program; ``_step_fn`` and
``_build_fused`` replay it. The kd-tree photon map's host build is in
the graph too, as a host node between two copies
(``photon_map.KdHostStage``, the JAX package's ``pure_callback``), with
its gather's steps. ``_raw_step`` is the eager body, the graph's plain
version: the CPU runs it, and so does the card where autograd needs the
tape, for a scene holding a tensor that requires grad (``diff``). The
route follows from the device and the scene, never from a failure: a
capture or a replay that fails raises. The JAX package's
compile tiers, dispatch budget and iteration batching are TPU compile
workarounds and have no counterpart.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Any

import numpy as np
import torch

from .camera import Camera
from .capture import CapturedCall
from .config import RenderConfig, RenderMethod
from .core.profiling import span
from .core.rng import make_root_key
from .film import Film, load_checkpoint, save_checkpoint
from .photon_map import kd_stages
from .scene.types import Scene

_CAMERA_TENSORS = ("eye", "lookdir", "up", "camera_u", "camera_v",
                   "aperture")


def ppm_radius_sq_at_iteration(r0: float, alpha: float,
                               iteration: int) -> float:
    """Knaus-Zwicker progressive radius r_{i+1}^2 = r_i^2 (i+a)/(i+1),
    evaluated from scratch for any iteration (the same schedule on every
    host)."""
    r2 = r0 * r0
    for i in range(iteration):
        r2 *= (i + alpha) / (i + 1.0)
    return r2


def ppm_radius_sq_traced(r0, alpha: float, iteration) -> torch.Tensor:
    """The same schedule in closed form for a tensor iteration index:
    prod_{k<i} (k+a)/(k+1) = Gamma(i+a) / (Gamma(a) Gamma(i+1)), in float32
    as the JAX package computes it, on the iteration's device (the
    constants are set by fills: no host-to-device copy)."""
    itf = torch.as_tensor(iteration).to(torch.float32)
    dev = itf.device
    a = torch.full((), alpha, dtype=torch.float32, device=dev)
    log_prod = (torch.lgamma(itf + a) - torch.lgamma(a)
                - torch.lgamma(itf + 1.0))
    r0 = (r0.to(device=dev, dtype=torch.float32) if torch.is_tensor(r0)
          else torch.full((), r0, dtype=torch.float32, device=dev))
    return torch.square(r0) * torch.exp(log_prod)


def _scene_tensors(obj):
    """Every tensor of a scene's records (nested dataclasses)."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            yield from _scene_tensors(getattr(obj, f.name))


class CapturedStep(CapturedCall):
    """One iteration of a Renderer captured in a CUDA graph
    (:class:`capture.CapturedCall`).

    The graph's operands are device buffers: the iteration is ``start +
    count * stride`` (int64), ``key`` holds the root key's two words (0-d
    int64 tensors), the camera's tensors are copied into ``camera``, and
    the squared PPM radius is ``radius_sq`` or, where ``closed_form`` is
    set, the float32 closed form of the iteration
    (``ppm_radius_sq_traced``), the JAX fused loop's radius. One replay
    renders that iteration into its static outputs (``radiance``, scrubbed
    of non-finite values, and ``stats``, each a 0-d sum), adds them to
    ``acc`` and ``stats_acc`` (float32) and advances ``count``: n replays
    after :meth:`prepare` render the n iterations ``start, start +
    stride, ...``. The first :meth:`run` renders that iteration eagerly,
    then captures it."""

    def __init__(self, step, camera: Camera, ppm_initial_radius: float,
                 alpha: float, height: int, width: int,
                 device: torch.device):
        super().__init__(None, device)
        self.step = step
        self.r0 = ppm_initial_radius
        self.alpha = alpha

        def zero(dtype, shape=()):
            return torch.zeros(shape, dtype=dtype, device=device)

        self.start = zero(torch.int64)
        self.count = zero(torch.int64)
        self.stride = zero(torch.int64)
        self.key = (zero(torch.int64), zero(torch.int64))
        self.radius_sq = zero(torch.float32)
        self.closed_form = zero(torch.bool)
        self.camera = dataclasses.replace(camera, **{
            k: torch.empty_like(getattr(camera, k), device=device)
            for k in _CAMERA_TENSORS})
        self.acc = zero(torch.float32, (height, width, 3))
        self.stats_acc: dict[str, torch.Tensor] | None = None
        self.kd_stages: dict = {}

    def body(self):
        # the kd-tree's host stages, made by the eager first run, are the
        # graph's: its host node and copies read their addresses
        with kd_stages(self.kd_stages):
            return self._body()

    def _body(self):
        """One iteration on the static buffers (what the graph holds)."""
        it = self.start + self.count * self.stride
        r2 = torch.where(self.closed_form,
                         ppm_radius_sq_traced(self.r0, self.alpha, it),
                         self.radius_sq)
        rad, stats = self.step(self.camera, it, self.key, r2)
        rad = torch.where(torch.isfinite(rad), rad, 0.0)
        stats = {k: torch.sum(v) for k, v in stats.items()}
        self.acc += rad
        if self.stats_acc is None:
            self.stats_acc = {k: torch.zeros((), dtype=torch.float32,
                                             device=self.device)
                              for k in stats}
        for k, v in stats.items():
            self.stats_acc[k] += v.to(torch.float32)
        self.count += 1
        return rad, stats

    def release(self) -> None:
        """Drop the graph, its pool and the kd-tree stages it reads, once
        the card has finished with them."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        super().release()
        self.kd_stages.clear()

    def prepare(self, camera: Camera, key, start: int, stride: int,
                radius_sq: float | None) -> None:
        """Set the operands of the next replays: the camera, the root key,
        the iteration ``start`` and ``stride``, and ``radius_sq`` (None:
        the closed form). Zeroes the sums and the count. Fills and device
        copies only, enqueued on the current stream (span
        ``renderer.operands``)."""
        with span("renderer.operands"):
            for k in _CAMERA_TENSORS:
                getattr(self.camera, k).copy_(getattr(camera, k))
            for buf, w in zip(self.key, key):
                buf.fill_(int(w))
            self.start.fill_(start)
            self.stride.fill_(stride)
            self.count.zero_()
            self.closed_form.fill_(radius_sq is None)
            self.radius_sq.fill_(0.0 if radius_sq is None else radius_sq)
            self.acc.zero_()
            for v in (self.stats_acc or {}).values():
                v.zero_()


class Renderer:
    """Progressive renderer on the scene's device."""

    def __init__(self, scene: Scene, camera: Camera, cfg: RenderConfig,
                 seed: int = 0, ppm_initial_radius: float | None = None):
        self.scene = scene
        self.camera = camera
        self.cfg = cfg
        self.root_key = make_root_key(seed)
        if ppm_initial_radius is None:
            if cfg.ppm_default_radius_from_scene:
                # 1% of the scene diagonal, clamped below by the reference's
                # area heuristic (IScene.cpp:23-31), as the JAX package
                diag = float(np.linalg.norm(
                    (scene.aabb_max - scene.aabb_min).cpu().numpy()))
                ppm_initial_radius = max(
                    0.01 * diag, scene.initial_ppm_radius_estimate())
            else:
                ppm_initial_radius = cfg.ppm_initial_radius
        self.ppm_initial_radius = float(ppm_initial_radius)
        self._captured: CapturedStep | None = None
        self._captured_for = None
        self._released_launches: dict[str, int] = {}
        self.restart()

    @property
    def device(self) -> torch.device:
        return self.scene.device

    def restart(self, camera: Camera | None = None,
                cfg: RenderConfig | None = None,
                scene: Scene | None = None) -> None:
        """Camera/scene/settings change: clear the film and start again. A
        new camera reuses the captured step; a new scene or config
        captures again at the next iteration."""
        if scene is not None:
            self.scene = scene
        if camera is not None:
            self.camera = camera
        if cfg is not None:
            self.cfg = cfg
        self.film = Film.create(self.cfg.width, self.cfg.height, self.device)
        self.iteration = 0
        self.metrics: dict[str, Any] = {}

    # ------------------------------------------------------------------
    def _radius_sq(self, iteration: int) -> float:
        return ppm_radius_sq_at_iteration(self.ppm_initial_radius,
                                          self.cfg.ppm_alpha, iteration)

    def _raw_step(self):
        """(camera, iteration, key, radius_sq) -> (radiance [H,W,3], stats)
        for the configured method: the eager single-iteration body. The
        iteration is an int or a 0-d int64 tensor, the key a host or a
        device key, the radius a number or a 0-d tensor; the tensor forms
        give the same numbers."""
        scene, cfg = self.scene, self.cfg
        method = cfg.render_method
        if method == RenderMethod.PATH_TRACING:
            from .integrators import pt

            def step(camera, iteration, key, _radius_sq):
                return pt.render_iteration(scene, camera, cfg, iteration,
                                           key), {}
        elif method == RenderMethod.PROGRESSIVE_PHOTON_MAPPING:
            from .integrators import ppm

            def step(camera, iteration, key, radius_sq):
                return ppm.render_iteration(scene, camera, cfg, iteration,
                                            key, radius_sq)
        elif method == RenderMethod.VCM_BIDIRECTIONAL_PATH_TRACING:
            from .integrators import vcm

            def step(camera, iteration, key, radius_sq):
                return vcm.render_iteration(scene, camera, cfg, iteration,
                                            key, radius_sq)
        else:
            raise ValueError(f"unknown method {method}")
        return step

    def _iteration(self, iteration, radius_sq):
        """Radiance [H,W,3] + stats of one iteration through the eager body
        at the squared PPM radius ``radius_sq`` (VCM's merge radius too);
        non-finite radiance is scrubbed to 0, as the film does."""
        radiance, stats = self._raw_step()(self.camera, iteration,
                                           self.root_key, radius_sq)
        return torch.where(torch.isfinite(radiance), radiance, 0.0), stats

    def uses_graph(self) -> bool:
        """Whether iterations replay a captured CUDA graph: on a CUDA scene,
        except for a scene holding a tensor that requires grad while grad
        mode is on (a replay records no autograd tape)."""
        if self.device.type != "cuda":
            return False
        return not (torch.is_grad_enabled() and any(
            t.requires_grad for t in _scene_tensors(self.scene)))

    @property
    def captured_step(self) -> CapturedStep | None:
        """The current captured step, or None before the first graph
        iteration (or on the eager route)."""
        return self._captured

    def _current_step(self) -> CapturedStep:
        """The captured step of this scene and config, made anew (and the
        old one's memory returned) when either has changed."""
        # the scene and its medium by identity (their equality would
        # compare tensors; the key holds them, so no id is reused), the
        # config and radius by value
        key = (self.scene, self.scene.medium, self.cfg,
               self.ppm_initial_radius)
        old = self._captured_for
        if self._captured is not None and not (
                old[0] is key[0] and old[1] is key[1] and old[2:] == key[2:]):
            for k, c in self._captured.launches().items():
                self._released_launches[k] = \
                    self._released_launches.get(k, 0) + c
            self._captured.release()
            self._captured = None
        if self._captured is None:
            self._captured = CapturedStep(
                self._raw_step(), self.camera, self.ppm_initial_radius,
                self.cfg.ppm_alpha, self.cfg.height, self.cfg.width,
                self.device)
            self._captured_for = key
        return self._captured

    def kernel_launches(self) -> dict[str, int]:
        """Kernel launches made by this renderer's graph replays, per
        wrapper name (capture counts times replays). Eager iterations,
        the first iteration of each capture included, are counted by the
        wrappers themselves."""
        out = dict(self._released_launches)
        if self._captured is not None:
            for k, c in self._captured.launches().items():
                out[k] = out.get(k, 0) + c
        return out

    def _step_fn(self):
        """(camera, iteration, key, radius_sq) -> (radiance, stats) of one
        iteration, the radiance scrubbed: a replay of the captured step
        (its static outputs, valid until the next replay) on the graph
        route, the eager body otherwise."""
        if self.uses_graph():
            def single(camera, iteration, key, radius_sq):
                step = self._current_step()
                step.prepare(camera, key, iteration, 0, radius_sq)
                return step.run()
            return single
        raw = self._raw_step()

        def eager(camera, iteration, key, radius_sq):
            radiance, stats = raw(camera, iteration, key, radius_sq)
            return torch.where(torch.isfinite(radiance), radiance, 0.0), stats
        return eager

    def _build_fused(self, eager: bool = False):
        """(camera, start, key, n, stride) -> (radiance sum, float32 stats
        sums) over iterations ``start, start + stride, ...``, each at the
        float32 closed-form radius, in the JAX fused loop's order: on the
        graph route n replays of the captured step, which sums on the
        device; otherwise, or with ``eager``, the eager body n times (the
        graph's plain version: the same operations, so the same sums)."""
        if self.uses_graph() and not eager:
            def replays(camera, start, key, n, stride):
                step = self._current_step()
                step.prepare(camera, key, start, stride, None)
                for _ in range(n):
                    step.run()
                return step.acc, step.stats_acc
            return replays
        raw = self._raw_step()
        r0, alpha = self.ppm_initial_radius, self.cfg.ppm_alpha
        H, W = self.cfg.height, self.cfg.width

        def loop(camera, start, key, n, stride):
            acc = torch.zeros((H, W, 3), dtype=torch.float32,
                              device=self.device)
            stats_sum: dict[str, torch.Tensor] = {}
            for k in range(n):
                it = start + k * stride
                r2 = ppm_radius_sq_traced(r0, alpha, torch.full(
                    (), it, dtype=torch.int64, device=self.device))
                rad, stats = raw(camera, it, key, r2)
                acc = acc + torch.where(torch.isfinite(rad), rad, 0.0)
                for kk, v in stats.items():
                    v = torch.sum(v).to(torch.float32)
                    stats_sum[kk] = stats_sum[kk] + v if kk in stats_sum \
                        else v
            return acc, stats_sum
        return loop

    def compute_iteration(self, iteration: int):
        """Radiance [H,W,3] + stats for one GLOBAL iteration number without
        touching the film (the unit of work a distributed worker renders).
        The PPM radius is the schedule evaluated from scratch
        (``ppm_radius_sq_at_iteration``), as the JAX package's
        ``compute_iteration`` takes it."""
        radiance, stats = self._step_fn()(
            self.camera, iteration, self.root_key, self._radius_sq(iteration))
        if self.uses_graph():   # static outputs: the next replay rewrites
            return radiance.clone(), {k: v.clone() for k, v in stats.items()}
        return radiance, stats

    def compute_iterations(self, start: int, n: int, stride: int = 1):
        """Radiance SUM + summed stats (host floats) over iterations
        ``start, start+stride, ..., start+(n-1)*stride``. The PPM radius of
        each is the float32 closed form (``ppm_radius_sq_traced``), as in
        the JAX package's fused multi-iteration loop."""
        acc, stats = self._build_fused()(self.camera, start, self.root_key,
                                         n, stride)
        return acc.clone(), {k: float(v) for k, v in stats.items()}

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def render_next_iteration(self) -> dict[str, Any]:
        """Render one iteration into the film; returns the metrics
        (OptixRenderer::renderNextIteration, OptixRenderer.cpp:507-826)."""
        t0 = time.perf_counter()
        radius_sq = self._radius_sq(self.iteration)
        radiance, stats = self._step_fn()(self.camera, self.iteration,
                                          self.root_key, radius_sq)
        self.film = self.film.add_iteration(radiance)
        stats = {k: float(v) for k, v in stats.items()}
        self._sync()
        dt = time.perf_counter() - t0
        self.iteration += 1
        self.metrics = dict(iteration=self.iteration, iteration_seconds=dt,
                            ppm_radius=math.sqrt(radius_sq),
                            ppm_radius_sq=radius_sq, **stats)
        return self.metrics

    def _render_chunk(self, n: int) -> dict[str, torch.Tensor]:
        """Enqueue ``n`` fused iterations into the film (span
        ``renderer.film``); returns their stats sums, still on the
        device."""
        rad_sum, stats = self._build_fused()(self.camera, self.iteration,
                                             self.root_key, n, 1)
        with span("renderer.film"):
            self.film = self.film.add_iterations(rad_sum, n)
        self.iteration += n
        return stats

    def _render_chunk_sync(self, n: int, t0: float | None = None,
                           iterations: int | None = None) -> None:
        """The last (or only) chunk of a render: ``n`` fused iterations,
        then one synchronize and the metrics, ``iteration_seconds`` over
        the ``iterations`` rendered since ``t0`` (default: this chunk).
        The synchronize and the stats' reads are span
        ``renderer.readback``."""
        t0 = time.perf_counter() if t0 is None else t0
        stats = self._render_chunk(n)
        with span("renderer.readback"):
            self._sync()
            dt = time.perf_counter() - t0
            stats = {k: float(v) for k, v in stats.items()}
        self.metrics = dict(
            iteration=self.iteration,
            iteration_seconds=dt / (iterations or n),
            ppm_radius=math.sqrt(self._radius_sq(self.iteration - 1)),
            **stats)

    def render(self, iterations: int) -> Film:
        """Render ``iterations`` iterations. Up to
        ``cfg.iterations_per_dispatch`` of them are summed before the sum
        is added to the film, the JAX package's accumulation order. The
        chunks are enqueued without reading anything back (the JAX
        package's ``async_dispatch``); one synchronize at the end, after
        which the metrics hold the last chunk's stats and the mean seconds
        per iteration. The call is span ``renderer.render``."""
        with span("renderer.render"):
            chunk = max(1, self.cfg.iterations_per_dispatch)
            t0 = time.perf_counter()
            done = 0
            while iterations - done > chunk:
                self._render_chunk(chunk)
                done += chunk
            if iterations > done:
                self._render_chunk_sync(iterations - done, t0, iterations)
        return self.film

    # ------------------------------------------------------------------
    def save_checkpoint(self, path) -> None:
        save_checkpoint(path, self.film, self.root_key,
                        ppm_radius_sq=self._radius_sq(self.iteration))

    def load_checkpoint(self, path) -> None:
        film, key, _r2, _extra = load_checkpoint(path, self.device)
        if tuple(film.accum.shape) != (self.cfg.height, self.cfg.width, 3):
            raise ValueError(
                f"checkpoint film {tuple(film.accum.shape)} does not match "
                f"{self.cfg.width}x{self.cfg.height}")
        self.film = film
        self.root_key = key
        self.iteration = film.iterations
