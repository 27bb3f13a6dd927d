"""Renderer: the host-side render loop (OptixRenderer equivalent).

The counterpart of ``oppositerenderer_tpu/renderer.py``: owns the film,
dispatches one iteration at a time to the integrator, computes the
Knaus-Zwicker PPM radius schedule as a pure function of the iteration
number (``OptixRenderer.cpp:583-589``), restarts on change (the
reference's sequence-number bump, ``Gui/Application.cpp:119-127``) and
records per-iteration metrics. The JAX package's compile tiers, dispatch
budget and iteration batching have no counterpart in eager PyTorch.
"""
from __future__ import annotations

import math
import time
from typing import Any

import numpy as np
import torch

from .camera import Camera
from .config import RenderConfig, RenderMethod
from .core.rng import make_root_key
from .film import Film, load_checkpoint, save_checkpoint
from .scene.types import Scene


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
    as the JAX package computes it."""
    itf = torch.as_tensor(iteration, dtype=torch.float32)
    a = torch.tensor(alpha, dtype=torch.float32, device=itf.device)
    log_prod = (torch.lgamma(itf + a) - torch.lgamma(a)
                - torch.lgamma(itf + 1.0))
    r0 = torch.as_tensor(r0, dtype=torch.float32, device=itf.device)
    return torch.square(r0) * torch.exp(log_prod)


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
        self.restart()

    @property
    def device(self) -> torch.device:
        return self.scene.device

    def restart(self, camera: Camera | None = None,
                cfg: RenderConfig | None = None,
                scene: Scene | None = None) -> None:
        """Camera/scene/settings change: clear the film and start again."""
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

    def _iteration(self, iteration: int, radius_sq):
        """Radiance [H,W,3] + stats of one iteration at the squared PPM
        radius ``radius_sq``; non-finite radiance is scrubbed to 0, as the
        film does."""
        method = self.cfg.render_method
        if method == RenderMethod.PATH_TRACING:
            from .integrators import pt
            radiance = pt.render_iteration(self.scene, self.camera, self.cfg,
                                           iteration, self.root_key)
            stats = {}
        elif method == RenderMethod.PROGRESSIVE_PHOTON_MAPPING:
            from .integrators import ppm
            radiance, stats = ppm.render_iteration(
                self.scene, self.camera, self.cfg, iteration, self.root_key,
                radius_sq)
        else:
            raise NotImplementedError(
                f"{method.name}: the port renders PATH_TRACING and "
                "PROGRESSIVE_PHOTON_MAPPING; VCM arrives with a later slice")
        return torch.where(torch.isfinite(radiance), radiance, 0.0), stats

    def compute_iteration(self, iteration: int):
        """Radiance [H,W,3] + stats for one GLOBAL iteration number without
        touching the film (the unit of work a distributed worker renders).
        The PPM radius is the schedule evaluated from scratch
        (``ppm_radius_sq_at_iteration``), as the JAX package's
        ``compute_iteration`` takes it."""
        return self._iteration(iteration, self._radius_sq(iteration))

    def compute_iterations(self, start: int, n: int, stride: int = 1):
        """Radiance SUM + summed stats over iterations ``start,
        start+stride, ..., start+(n-1)*stride``. The PPM radius of each is
        the float32 closed form (``ppm_radius_sq_traced``), as in the JAX
        package's fused multi-iteration loop."""
        acc = torch.zeros((self.cfg.height, self.cfg.width, 3),
                          dtype=torch.float32, device=self.device)
        stats_sum: dict[str, torch.Tensor] = {}
        for k in range(n):
            it = start + k * stride
            rad, stats = self._iteration(it, ppm_radius_sq_traced(
                self.ppm_initial_radius, self.cfg.ppm_alpha, it))
            acc = acc + rad
            for key, v in stats.items():
                v = v.to(torch.float32)
                stats_sum[key] = stats_sum[key] + v if key in stats_sum else v
        return acc, {k: float(v) for k, v in stats_sum.items()}

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def render_next_iteration(self) -> dict[str, Any]:
        """Render one iteration into the film; returns the metrics
        (OptixRenderer::renderNextIteration, OptixRenderer.cpp:507-826)."""
        t0 = time.perf_counter()
        radius_sq = self._radius_sq(self.iteration)
        radiance, stats = self.compute_iteration(self.iteration)
        stats = {k: float(v) for k, v in stats.items()}
        self.film = self.film.add_iteration(radiance)
        self._sync()
        dt = time.perf_counter() - t0
        self.iteration += 1
        self.metrics = dict(iteration=self.iteration, iteration_seconds=dt,
                            ppm_radius=math.sqrt(radius_sq),
                            ppm_radius_sq=radius_sq, **stats)
        return self.metrics

    def render(self, iterations: int) -> Film:
        """Render ``iterations`` iterations. Up to
        ``cfg.iterations_per_dispatch`` of them are summed before the sum
        is added to the film, the JAX package's accumulation order."""
        chunk = max(1, self.cfg.iterations_per_dispatch)
        done = 0
        while done < iterations:
            n = min(chunk, iterations - done)
            t0 = time.perf_counter()
            rad_sum, stats = self.compute_iterations(self.iteration, n)
            self.film = self.film.add_iterations(rad_sum, n)
            self._sync()
            dt = time.perf_counter() - t0
            self.iteration += n
            done += n
            self.metrics = dict(
                iteration=self.iteration, iteration_seconds=dt / n,
                ppm_radius=math.sqrt(self._radius_sq(self.iteration - 1)),
                **stats)
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
