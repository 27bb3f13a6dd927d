"""The numbers that decide ``correct``, each held to its limit.

The program and the plain reference draw their own random numbers, so
they are compared as two estimates of one expectation: each gap is
taken over the standard error of both sides, a z-score.

Render cells compare the film the window produced, tile by tile
(``tile`` pixels square, the sum of the channels): the program's mean
over the window's iterations, its standard error from the film read at
``batches`` equal stretches of the window, against the reference's mean
over its iterations (drawn over the same iterations, and so the same
radii) and its standard error. A standard error is taken from the
squared differences of consecutive batches, so that a slow drift over
the window (the photon radius shrinks) does not count as noise.

* ``tile_z``: the root mean square of the tiles' z-scores;
* ``image_z``: the z-score of the whole image's mean.

Gradient cells compare the loss and each gradient component of steps
drawn from the run (the first steps, which set-up runs, and steps of the
window) and the change of the values over the first steps with the
reference's at the same values. The reference makes ``passes`` draws of
the estimator the program draws once a step, so the program's standard
error is taken as the spread of one of the reference's draws.

* ``loss_z``, ``grad_z``: the worst |z| over the checked steps (and
  over the components);
* ``change_z``: the worst component's |z| of the values' change.
"""
from __future__ import annotations

import math

import torch


def _succ_var(x: torch.Tensor) -> torch.Tensor:
    """The variance of one row of ``x`` [B, ...], from the mean squared
    difference of consecutive rows."""
    d = x[1:].double() - x[:-1].double()
    return (d * d).mean(0) / 2.0


def tile_numbers(prog_mean: torch.Tensor, prog_batches: torch.Tensor,
                 ref_rows: torch.Tensor) -> dict:
    """``prog_mean`` [T] the window's tile means; ``prog_batches`` [B, T]
    the tile means of B equal stretches of it, in order; ``ref_rows``
    [M, T] the reference's tile values, one row an iteration, in the
    order of the iterations they stand for."""
    B, M = prog_batches.shape[0], ref_rows.shape[0]
    p = prog_mean.double()
    r = ref_rows.double().mean(0)
    var = _succ_var(prog_batches) / B + _succ_var(ref_rows) / M
    z = (p - r) / torch.sqrt(torch.clamp_min(var, 1e-300))
    img_var = (_succ_var(prog_batches.mean(1, keepdim=True)) / B
               + _succ_var(ref_rows.mean(1, keepdim=True)) / M)
    img_z = (p.mean() - r.mean()) / math.sqrt(max(float(img_var), 1e-300))
    return {"tile_z": float(torch.sqrt((z * z).mean())),
            "image_z": abs(float(img_z))}


def flat(loss, grads) -> torch.Tensor:
    return torch.cat([torch.as_tensor(loss).double().reshape(1)]
                     + [g.double().reshape(-1) for g in grads])


def gradient_numbers(steps: list[dict], change: dict) -> dict:
    """``steps``: for each checked step ``program`` (the loss and every
    gradient component as one vector, :func:`flat`) and ``reference``
    [P, n] (the reference's ``passes`` draws at the same values);
    ``change``: the program's change of the values over the first steps
    ``program`` [n], and the reference's ``mean`` [n] and ``var`` [n],
    the variance of one step's change."""
    loss_z, grad_z = 0.0, 0.0
    for s in steps:
        ref = s["reference"].double()
        n_pass = ref.shape[0]
        sd = ref.std(0) * math.sqrt(1.0 + 1.0 / n_pass)
        z = ((s["program"].double() - ref.mean(0))
             / torch.clamp_min(sd, 1e-300)).abs()
        loss_z = max(loss_z, float(z[0]))
        grad_z = max(grad_z, float(z[1:].max()))
    var = change["var"].double()
    cz = ((change["program"].double() - change["mean"].double())
          / torch.sqrt(torch.clamp_min(var, 1e-300))).abs()
    return {"loss_z": loss_z, "grad_z": grad_z, "change_z": float(cz.max())}


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, each number beside its limit). A number without a limit,
    or a limit without a number, or a number that is not finite, is not
    correct."""
    table = {k: {"value": numbers.get(k), "limit": limits.get(k)}
             for k in sorted(set(numbers) | set(limits))}
    ok = all(v["value"] is not None and v["limit"] is not None
             and math.isfinite(v["value"]) and v["value"] <= v["limit"]
             for v in table.values())
    return ok, table
