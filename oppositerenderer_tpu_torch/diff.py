"""Differentiable rendering with respect to material and emission
parameters.

The counterpart of ``oppositerenderer_tpu/diff.py``. Radiance estimates
are differentiable in the material BSDF parameters (kd, ks, exponent,
kr, kt) and in the light emission, by the detached-sampling estimator:
sampling decisions, pdfs, Russian-roulette probabilities and MIS weights
are ``detach()``-ed (``bsdf.BSDF``, the integrators), so autograd through
a render is the gradient of the expected image for fixed random streams.
Visibility and geometry edges are not differentiated (no edge sampling).

The kernels give their inputs a zero gradient on both devices
(``accel/zero_grad``), as the JAX package's ``custom_vjp``s do. So the
tile gather (PPM) and the tile merge (VCM+VM) drop the photon-power and
merge terms; the budgeted gather and merge, taken when the image does
not tile, keep them. :func:`make_sharded_loss_and_grad` differentiates
the tile-sharded render (``parallel/render.py``) through its
collectives.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Mapping

import torch

from .scene.types import Scene


def _with_materials(scene: Scene, materials, lights=None) -> Scene:
    """``scene`` with other material (and light) parameters. The dense
    route's triangle tables hold geometry and the emitter flags only, so
    they carry over while the material kinds stay."""
    out = dataclasses.replace(scene, materials=materials,
                              lights=scene.lights if lights is None
                              else lights)
    cache = scene.dense_cache
    if (cache is not None and cache[1] is scene.materials
            and materials.kind is scene.materials.kind):
        out.dense_cache = (cache[0], materials) + cache[2:]
    return out


def set_material_param(scene: Scene, field: str, material_idx: int,
                       value: torch.Tensor) -> Scene:
    """Replace one material's parameter (e.g. kd of wall 2) without
    touching ``scene``; ``value`` may require grad."""
    table = scene.materials
    arr = getattr(table, field)
    new = torch.cat([arr[:material_idx],
                     torch.as_tensor(value, dtype=arr.dtype,
                                     device=arr.device)
                     .reshape((1,) + arr.shape[1:]),
                     arr[material_idx + 1:]])
    return _with_materials(scene, dataclasses.replace(table, **{field: new}))


def scale_emission(scene: Scene, scale) -> Scene:
    """Scale all light emission by ``scale``: the materials' emission and
    the light table's power and emission, which the build derives from
    one another, scale together."""
    m, lt = scene.materials, scene.lights
    return _with_materials(
        scene, dataclasses.replace(m, emission=m.emission * scale),
        dataclasses.replace(lt, power=lt.power * scale,
                            emission=lt.emission * scale))


def _with_values(scene: Scene, keys, values) -> Scene:
    """``scene`` with each (field, material_idx) key set to its value
    (``"emission_scale"``, whose index is ignored, scales the emission)."""
    for (field, idx), v in zip(keys, values):
        scene = (scale_emission(scene, v) if field == "emission_scale"
                 else set_material_param(scene, field, idx, v))
    return scene


def make_sharded_loss_and_grad(scene: Scene, camera, cfg, mesh, wrt:
                               Mapping):
    """Sharded differentiable rendering: ``fn(values=None, iteration=0,
    key=None, radius_sq=0.002) -> (loss, grads)`` on every rank of
    ``mesh``, loss the mean radiance of the whole image.

    Each rank builds the scene from the parameters (``wrt`` maps (field,
    material_idx) to an initial value, as in :func:`render_loss_and_grad`;
    ``values`` replaces them in key order, each of its initial value's
    shape), renders its band
    (``parallel.render.make_sharded_render_raw``), takes ``loss_local =
    band.sum() / (H W 3)`` and back-propagates it: each collective's
    backward carries the cotangents of the other ranks' bands to the
    values this rank contributed (the store, the photons, the splats).
    One ``psum`` then sums the losses and every parameter's gradient over
    ranks. ``key`` None is the root key of seed 0; the iteration, key and
    radius may be tensors (``make_sharded_render_raw``).

    JAX jits this ``value_and_grad``. Where ``parallel.render.uses_graph``
    holds (a CUDA scene over a rank-less or NCCL mesh) the first call runs
    it eagerly, which also runs the autograd engine's first backward, and
    captures forward, backward and ``psum`` in one CUDA graph; a later
    call copies ``values`` into the graph's leaf tensors (which require
    grad), writes the iteration, key and radius into its operands
    (``parallel.render.StepOperands``) and replays. Either way the loss
    and gradients are new tensors that a later call leaves alone, as
    JAX's are new arrays. ``fn.captured`` is the ``capture.CapturedCall``
    (None on the eager route); on the graph route ``fn.eager`` is the
    eager route, the graph's plain version."""
    from .accel.intersect import dense_tables
    from .capture import CapturedCall, set_operand
    from .core.rng import make_root_key
    from .parallel.render import (StepOperands, make_sharded_render_raw,
                                  uses_graph)
    raw = make_sharded_render_raw(scene, camera, cfg, mesh)
    keys = list(wrt)
    dev = scene.device
    n_values = 3 * cfg.width * cfg.height
    if scene.bvh is None:
        # the dense route's triangle tables, built once here and carried
        # into each call's scene by _with_materials: B2's holds only the
        # non-emitters, a size a capture cannot read from the device
        dense_tables(scene)

    def leaves(values):
        return [torch.as_tensor(v, dtype=torch.float32, device=dev)
                .detach().clone().requires_grad_(True) for v in values]

    def summed(vals, iteration, key, radius_sq):
        """[loss, every gradient flattened], summed over ranks."""
        band, _ = raw(_with_values(scene, keys, vals), iteration, key,
                      radius_sq)
        loss_local = band.sum() / n_values
        grads = torch.autograd.grad(loss_local, vals, allow_unused=True)
        flat = torch.cat([loss_local.detach().reshape(1)] + [
            (torch.zeros_like(v) if g is None else g).reshape(-1)
            for v, g in zip(vals, grads)])
        return mesh.psum(flat)

    def unpack(total, vals):
        out, i = {}, 1
        for k, v in zip(keys, vals):
            out[k] = total[i:i + v.numel()].reshape(v.shape)
            i += v.numel()
        return total[0], out

    initial = [wrt[k] for k in keys]

    def eager(values=None, iteration=0, key=None, radius_sq=0.002):
        vals = leaves(initial if values is None else values)
        return unpack(summed(vals, iteration, make_root_key(0)
                             if key is None else key, radius_sq), vals)
    if not uses_graph(scene, mesh):
        eager.captured = None
        return eager

    static = leaves(initial)
    ops = StepOperands(dev)
    captured = CapturedCall(lambda: summed(static, ops.iteration, ops.key,
                                           ops.radius_sq), dev)

    def replay(values=None, iteration=0, key=None, radius_sq=0.002):
        with torch.no_grad():
            for leaf, v in zip(static, initial if values is None
                               else values):
                set_operand(leaf, v)
        ops.set(iteration, make_root_key(0) if key is None else key,
                radius_sq)
        return unpack(captured.run().clone(), static)
    replay.captured, replay.eager = captured, eager
    return replay


def render_loss_and_grad(render_fn: Callable[[Scene], torch.Tensor],
                         scene: Scene, wrt: Mapping):
    """The mean of ``render_fn(scene')`` and its gradients, where ``scene'``
    is ``scene`` with the overrides of ``wrt``: a mapping of (field,
    material_idx) to an initial value (a field of the material table, or
    ``"emission_scale"``, whose index is ignored). Returns (loss, grads
    dict with ``wrt``'s keys)."""
    keys = list(wrt)
    dev = scene.device
    values = [torch.as_tensor(wrt[k], dtype=torch.float32, device=dev)
              .detach().clone().requires_grad_(True) for k in keys]
    loss = torch.mean(render_fn(_with_values(scene, keys, values)))
    grads = torch.autograd.grad(loss, values)
    return loss.detach(), dict(zip(keys, grads))
