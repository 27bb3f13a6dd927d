"""The progressive viewer's loop: ``Renderer.render(1)`` at a time, each
ending in its synchronize (on the card a replay of the captured
iteration), one client that asks for the next frame when it has the
last.

Mix parameters: ``render_method`` (a ``RenderMethod`` name),
``warmup_steps``, ``reference`` (the plain reference's module,
``reference/<name>.py``) and ``trace`` (``from_step``, ``steps``,
``eager_body``: also profile the captured iteration's eager body after
the window, whose pass ranges a replay does not record;
``count_work``: the reference's ray counts for the kernels' rooflines).

Checked: the film the window produced, tile by tile, against the
reference's tile values over the same iterations
(``compare.tile_numbers``); the film's tiles are read after every
``1 / batches`` of the window's expected iterations, between steps, for
the program's standard error. Check
parameters (the cell's ``check``): ``tile``, ``queries`` (a tile's
pixels an iteration of the reference), ``photons`` (its photons an
iteration, where it traces photons), ``iterations`` (its iterations),
``batches``.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from port_bench.harness import cells, compare
from port_bench.harness.trace import Trace, profiled
from port_bench.harness.window import (Run, check_of, free, peak,
                                       port_config, render_fields, sync,
                                       timed, window)


def tiles_of(film_sum: torch.Tensor, tile: int) -> torch.Tensor:
    """The mean over each tile of a [H, W, 3] sum's channels summed [T],
    tiles row-major from the image's bottom row: a few reductions on the
    device, where the window reads the film."""
    H, W, _ = film_sum.shape
    x = film_sum.double().sum(2).reshape(H // tile, tile, W // tile, tile)
    return x.mean((1, 3)).reshape(-1)


def reference_rows(cell, seed: int, scene_name: str, fields: dict,
                   check: dict, n_iter: int, device,
                   low_precision: bool = False):
    """The reference's tile values [M, T], one row an iteration drawn
    stratified over the program's ``n_iter`` iterations in their order,
    and the ray counts of its calls, averaged over its iterations."""
    from port_bench.reference import scene as ref_scene
    method = cells.reference(cell.traffic["reference"])
    s = ref_scene.load(scene_name, device, low_precision=low_precision)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (1 << 63))
    m = int(check["iterations"])
    u = np.random.Generator(np.random.PCG64([seed, 7])).random(m)
    rows, calls = [], None
    for j in range(m):
        it = min(n_iter - 1, int((j + u[j]) / m * n_iter))
        row, c = method.iteration_tiles(s, fields, check, it, gen)
        rows.append(row)
        if c is not None:
            calls = c if calls is None else [
                {"lanes": a["lanes"], "live": a["live"] + b["live"]}
                for a, b in zip(calls, c)]
    if calls is not None:
        calls = [{"kernel": "b1_closest", "lanes": c["lanes"],
                  "live": c["live"] / m, "triangles": s.n_triangles}
                 for c in calls]
    return torch.stack(rows), calls


def run(cell, seed: int, seconds: float, trace: bool, device, t0: float,
        rehearsal: bool = False) -> Run:
    from oppositerenderer_tpu_torch.renderer import Renderer
    from oppositerenderer_tpu_torch.scene import get_scene_by_name

    mix = cell.traffic
    check = check_of(cell, rehearsal)
    scene_name, fields = render_fields(cell, rehearsal)
    spans: dict = {}
    scene, camera = timed(spans, "scene_build_s", device,
                          lambda: get_scene_by_name(scene_name, device))
    r = Renderer(scene, camera, port_config(fields), seed=seed)
    timed(spans, "capture_s", device, lambda: r.render(1))
    t = time.perf_counter()
    for _ in range(mix["warmup_steps"]):
        r.render(1)
    per_step = (time.perf_counter() - t) / max(mix["warmup_steps"], 1)
    r.restart()
    sync(device)
    setup_s = time.perf_counter() - t0

    batches = int(check["batches"])
    n_est = max(batches, int(0.9 * seconds / max(per_step, 1e-6)))
    length = max(1, n_est // batches)
    tile = int(check["tile"])
    films = {0: tiles_of(r.film.accum, tile)}
    first = r.iteration
    tr = mix.get("trace", {})
    trace_from = tr.get("from_step", 2) if trace else None

    def after(i):
        if (i + 1) % length == 0:
            films[i + 1] = tiles_of(r.film.accum, tile)

    times, window_s, traced = window(lambda i: r.render(1), seconds, device,
                                     trace_from, tr.get("steps", 3),
                                     after=after)
    total = tiles_of(r.film.accum, tile)
    n_iter = r.iteration - first
    mem = peak(device)
    eager = None
    if trace and tr.get("eager_body") and r.captured_step is not None:
        r.captured_step.body()          # the allocator's blocks, warmed
        sync(device)
        with profiled(device.type) as prof:
            r.captured_step.body()
            sync(device)
        eager = Trace.of(prof)

    def finish() -> dict:
        nonlocal r, scene
        r = scene = None
        ends = sorted(films)
        batch_rows = torch.stack([(films[b] - films[a]) / (b - a)
                                  for a, b in zip(ends, ends[1:])])
        prog_mean = total / n_iter
        films.clear()
        free(device)
        ref, calls = reference_rows(cell, seed, scene_name, fields, check,
                                    n_iter, device)
        out = {"numbers": compare.tile_numbers(prog_mean, batch_rows, ref),
               "checked": n_iter}
        if trace_from is not None and tr.get("count_work") and calls:
            out["work"] = calls
        return out

    return Run(setup_s=setup_s, step_s=times, window_s=window_s, spans=spans,
               trace=traced, eager=eager, finish=finish,
               memory_peak_bytes=mem)
