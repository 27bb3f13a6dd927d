"""The inverse-rendering loop: one call a step of
``diff.make_sharded_loss_and_grad`` over the rank-less mesh (on the card
a replay of the captured forward and backward), each step rendering the
next iteration, the values then moved by plain gradient descent, each
step ending in a synchronize.

Mix parameters: ``render_method``, ``wrt`` (the (field, material)
pairs differentiated), ``learning_rate``, ``checked_steps`` (the first
steps, run in set-up through the window's own call, the first of them
the capture), ``reference`` (``reference/<name>.py``, which gives
``loss_and_grad``) and ``trace`` (``from_step``, ``steps``,
``eager_step``: also profile one eager step after the window).

Checked (``compare.gradient_numbers``): the loss and gradient of each of
the first steps against the reference's, which follows its own values
from the configuration's; the change of the values over those steps;
and the loss and gradient of ``window_steps`` steps of the window drawn
from the seed, against the reference's at the values the program held
before that step. Check parameters: ``passes`` (the reference's draws a
checked step), ``window_steps``.
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


def initial_values(s, wrt: list) -> list:
    """The configuration's values of ``wrt`` in the reference's scene."""
    out = []
    for field, m in wrt:
        out.append(s.kd[m].clone() if field == "kd"
                   else torch.ones((), device=s.device))
    return out


def reference_draws(method, s, fields, wrt, values, passes: int, gen,
                    rows=None) -> torch.Tensor:
    """[passes, 1 + n]: the loss and every gradient component of
    ``passes`` draws of the reference at ``values``."""
    out = []
    for _ in range(passes):
        loss, grads = method.loss_and_grad(s, fields, wrt, values, gen,
                                           rows=rows)
        out.append(compare.flat(loss, grads))
    return torch.stack(out)


def reference_start(cell, fields, wrt, lr: float, steps: int, passes: int,
                    s, gen, rows=None) -> tuple[list, dict]:
    """The reference's first ``steps`` from its own values: each step's
    draws, and the mean and one step's variance of the values' change."""
    method = cells.reference(cell.traffic["reference"])
    values = initial_values(s, wrt)
    draws = []
    mean = None
    var = None
    for _ in range(steps):
        d = reference_draws(method, s, fields, wrt, values, passes, gen,
                            rows)
        draws.append(d)
        g = d[:, 1:].mean(0)
        v = d[:, 1:].var(0) if passes > 1 else torch.zeros_like(g)
        mean = -lr * g if mean is None else mean - lr * g
        var = lr * lr * v if var is None else var + lr * lr * v
        sizes = [x.numel() for x in values]
        parts = torch.split(g.to(values[0].dtype), sizes)
        values = [x - lr * p.reshape(x.shape) for x, p in zip(values, parts)]
    return draws, {"mean": mean, "var": var * (1.0 + 1.0 / passes)}


def run(cell, seed: int, seconds: float, trace: bool, device, t0: float,
        rehearsal: bool = False) -> Run:
    from oppositerenderer_tpu_torch import diff
    from oppositerenderer_tpu_torch.core.rng import make_root_key
    from oppositerenderer_tpu_torch.parallel.mesh import make_mesh
    from oppositerenderer_tpu_torch.scene import get_scene_by_name

    mix = cell.traffic
    check = check_of(cell, rehearsal)
    scene_name, fields = render_fields(cell, rehearsal)
    spans: dict = {}
    scene, camera = timed(spans, "scene_build_s", device,
                          lambda: get_scene_by_name(scene_name, device))
    keys = [tuple(k) for k in mix["wrt"]]
    wrt = {k: (torch.ones((), device=device) if k[0] == "emission_scale"
               else getattr(scene.materials, k[0])[k[1]].detach().clone())
           for k in keys}
    fn = diff.make_sharded_loss_and_grad(scene, camera, port_config(fields),
                                         make_mesh(1, device=device), wrt)
    key = make_root_key(seed)
    lr = float(mix["learning_rate"])
    values = [wrt[k].clone() for k in keys]
    initial = [v.clone() for v in values]
    n_first = int(mix["checked_steps"])
    seen: dict = {}             # step -> (values before it, loss, grads)
    keep: set = set(range(n_first))

    def step(i):
        before = list(values)
        loss, grads = fn(values, iteration=i, key=key)
        values[:] = [v - lr * grads[k] for v, k in zip(values, keys)]
        sync(device)
        if i in keep:
            seen[i] = (before, loss, [grads[k] for k in keys])

    timed(spans, "capture_s", device, lambda: step(0))
    t = time.perf_counter()
    for i in range(1, n_first):
        step(i)
    per_step = (time.perf_counter() - t) / max(n_first - 1, 1)
    change = [v - v0 for v, v0 in zip(values, initial)]
    setup_s = time.perf_counter() - t0

    tr = mix.get("trace", {})
    trace_from = tr.get("from_step", 2) if trace else None
    n_est = max(2, int(0.9 * seconds / max(per_step, 1e-6)))
    rng = np.random.Generator(np.random.PCG64([seed, 11]))
    drawn = rng.choice(n_est, size=min(int(check["window_steps"]), n_est),
                       replace=False)
    keep.update(n_first + int(x) for x in drawn)
    times, window_s, traced = window(lambda i: step(n_first + i), seconds,
                                     device, trace_from, tr.get("steps", 2))
    mem = peak(device)
    eager = None
    if trace and tr.get("eager_step") and getattr(fn, "captured",
                                                  None) is not None:
        with profiled(device.type) as prof:
            fn.eager(values, iteration=0, key=key)
            sync(device)
        eager = Trace.of(prof)

    def finish() -> dict:
        from port_bench.reference import scene as ref_scene
        nonlocal fn, scene
        fn = scene = None
        free(device)
        s = ref_scene.load(scene_name, device)
        gen = torch.Generator(device=device)
        gen.manual_seed(seed % (1 << 63))
        passes = int(check["passes"])
        method = cells.reference(mix["reference"])
        draws, ref_change = reference_start(cell, fields, keys, lr, n_first,
                                            passes, s, gen)
        steps = [{"program": compare.flat(seen[i][1], seen[i][2]),
                  "reference": draws[i]} for i in range(n_first)]
        for i in sorted(k for k in seen if k >= n_first):
            before, loss, grads = seen[i]
            steps.append({"program": compare.flat(loss, grads),
                          "reference": reference_draws(
                              method, s, fields, keys,
                              [v.to(device) for v in before], passes, gen)})
        prog_change = torch.cat([c.double().reshape(-1) for c in change])
        numbers = compare.gradient_numbers(
            steps, {"program": prog_change, **ref_change})
        return {"numbers": numbers, "checked": len(steps)}

    return Run(setup_s=setup_s, step_s=times, window_s=window_s, spans=spans,
               trace=traced, eager=eager, finish=finish,
               memory_peak_bytes=mem)
