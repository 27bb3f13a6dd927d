"""Sharded per-iteration render steps over a :class:`Mesh`.

The counterpart of ``oppositerenderer_tpu/parallel/render.py``: sharding
within one iteration, which the reference does not have (its only
multi-GPU axis is whole iterations over TCP). Every rank runs the same
step on its own shard:

* **PT**: rank r renders the contiguous band of raster lanes
  ``[r n/D, (r+1) n/D)``, H/D whole rows; no collective.
* **PPM**: the eye pass shards pixels, the photon pass shards the emitted
  photons. ``PhotonExchange.ALL_TO_ALL`` sends each photon to the rank
  owning its grid row (``exchange.py``) and gathers every query against
  each rank's partial grid (the tile gather, B3 on CUDA tensors, whenever
  W and H are multiples of 16, as unsharded: ``sharded_gather``);
  ``ALL_GATHER`` gives every rank every photon, in the unsharded deposit
  order, so every rank builds the unsharded grid, and gathers its band
  (through the whole image's queries when the tile gather runs).
  Whatever ``photon_map_structure`` says, the sharded step uses the
  sorted grid, as JAX's does.
* **VCM**: light subpaths shard like pixels (n light paths in all, so the
  1:1 pixel-path pairing stays local); t=1 splats land anywhere and are
  summed over ranks; with merging or uniform vertex sampling the store is
  all-gathered, so every rank builds the same vertex grid, and the tile
  merge (B4 on CUDA tensors) runs over the whole image's camera vertices,
  each rank merging its share of the tiles.

Every sampler is keyed by global lane ids, so each shard draws its
unsharded streams. A step returns this rank's band [H/D, W, 3] as a local
tensor (JAX returns one global array sharded over the mesh;
:func:`gather_image` assembles the whole image) and its stats summed over
ranks (the ``avg_*`` means averaged).

JAX jits the step, collectives included. On a CUDA scene over a mesh
whose collectives stay on the device (:func:`uses_graph`: rank-less or
NCCL) :func:`make_sharded_render_fn` captures it in one CUDA graph
(``capture.CapturedCall``) whose operands, the iteration, the key's
words and the radius, are device buffers (:class:`StepOperands`); gloo
meshes and the CPU run the same body eagerly.
"""
from __future__ import annotations

import dataclasses
import types

import torch

from ..accel.gather_kernels import BLOCK, TILE
from ..camera import Camera
from ..capture import CapturedCall, set_operand
from ..config import PhotonExchange, RenderConfig, RenderMethod
from ..core.rng import (MASK32, LaneSampler, fold_in, iteration_key,
                        uniform)
from ..integrators import ppm, pt, vcm
from ..integrators.common import scene_epsilon
from ..photon_map import PhotonBatch, min_cell_size_for_window
from ..scene.types import Scene
from .exchange import exchange_photons_by_cell, sharded_gather
from .mesh import Mesh


def _check_divisible(cfg: RenderConfig, n_dev: int) -> None:
    n = cfg.n_pixels
    if n % n_dev != 0:
        raise ValueError(f"{n} pixels not divisible by {n_dev} devices")
    if cfg.height % n_dev != 0:
        raise ValueError(f"{cfg.height} rows not divisible by {n_dev} "
                         "devices: a rank renders a band of whole rows")
    if cfg.photons_per_iteration % n_dev != 0:
        raise ValueError("photons_per_iteration must divide by device count")
    if (cfg.render_method == RenderMethod.VCM_BIDIRECTIONAL_PATH_TRACING
            and cfg.vcm_use_vm
            and (n % TILE == 0) != ((n // n_dev) % TILE == 0)):
        raise ValueError(
            f"VCM+VM: the image's {n} camera vertices and a band's "
            f"{n // n_dev} do not both tile by {TILE}, so the bands would "
            "take another merge than the whole image")


def make_sharded_render_raw(scene_template: Scene, camera: Camera,
                            cfg: RenderConfig, mesh: Mesh):
    """The sharded step taking the scene as an argument:
    ``step(scene, iteration, base_key, radius_sq) -> (band [H/D, W, 3],
    stats)``. Every rank calls it. The iteration is an int or a 0-d int64
    tensor, the key a host or a device key, the radius a number or a 0-d
    tensor; the tensor forms give the same numbers and read nothing back
    from the device. Gradients with respect to the scene's parameters
    flow through the collectives (each one's backward is the transposed
    collective): see ``diff.make_sharded_loss_and_grad``."""
    n_dev = mesh.size
    _check_divisible(cfg, n_dev)
    W, H = cfg.width, cfg.height
    n_local = W * H // n_dev
    p_local = cfg.photons_per_iteration // n_dev
    method = cfg.render_method

    def step(scene: Scene, iteration, base_key, radius_sq):
        dev = scene.device
        lanes = torch.arange(mesh.rank * n_local, (mesh.rank + 1) * n_local,
                             dtype=torch.int64, device=dev)
        px, py = lanes % W, lanes // W
        if method == RenderMethod.PATH_TRACING:
            rad = pt.render_lanes(scene, camera, cfg, iteration, base_key,
                                  px, py, lanes)
            stats = {}
        else:
            eps = scene_epsilon(scene)
            r2 = torch.as_tensor(radius_sq, dtype=torch.float32, device=dev)
            shard = (_ppm_shard
                     if method == RenderMethod.PROGRESSIVE_PHOTON_MAPPING
                     else _vcm_shard)
            rad, stats = shard(scene, camera, cfg, mesh, iteration, base_key,
                               r2, eps, px, py, lanes, p_local)
        return rad.reshape(H // n_dev, W, 3), stats

    return step


def uses_graph(scene: Scene, mesh: Mesh) -> bool:
    """Whether the sharded step and the sharded gradient replay a captured
    CUDA graph: on a CUDA scene over a mesh whose collectives a capture
    can hold (``Mesh.capturable``: rank-less, or NCCL). A gloo mesh
    copies every operand to the host and the CPU has no graphs: both run
    the body eagerly."""
    return scene.device.type == "cuda" and mesh.capturable


class StepOperands:
    """The device operands of a captured sharded step: the iteration (0-d
    int64), the key's two words (0-d int64) and the squared radius (0-d
    float32). :meth:`set` writes a call's values, given as numbers and a
    host key or as tensors, by fills and device copies."""

    def __init__(self, device: torch.device):
        self.iteration = torch.zeros((), dtype=torch.int64, device=device)
        self.key = tuple(torch.zeros((), dtype=torch.int64, device=device)
                         for _ in range(2))
        self.radius_sq = torch.zeros((), dtype=torch.float32, device=device)

    def set(self, iteration, key, radius_sq) -> None:
        set_operand(self.iteration, iteration)
        for buf, w in zip(self.key, key):
            set_operand(buf, w if torch.is_tensor(w) else int(w) & MASK32)
        set_operand(self.radius_sq, radius_sq)


def make_sharded_render_fn(scene: Scene, camera: Camera, cfg: RenderConfig,
                           mesh: Mesh):
    """``fn(iteration, base_key, radius_sq) -> (band [H/D, W, 3], stats)``
    over ``mesh``, the scene and camera closed over; the operands as
    :func:`make_sharded_render_raw` takes them.

    Where :func:`uses_graph` holds, the first call runs the step eagerly
    and captures it, and every later call writes its operands into
    :class:`StepOperands` and replays the graph, the counterpart of JAX's
    jitted step. Either way a call returns new tensors, as JAX returns new
    arrays: on the graph route copies of the graph's static outputs,
    which the next replay rewrites. ``fn.captured`` is the
    ``capture.CapturedCall`` (None on the eager route); on the graph route
    ``fn.eager`` is the eager route, the graph's plain version."""
    raw = make_sharded_render_raw(scene, camera, cfg, mesh)

    def eager(iteration, base_key, radius_sq):
        return raw(scene, iteration, base_key, radius_sq)
    if not uses_graph(scene, mesh):
        eager.captured = None
        return eager

    ops = StepOperands(scene.device)
    captured = CapturedCall(
        lambda: raw(scene, ops.iteration, ops.key, ops.radius_sq),
        scene.device)

    def replay(iteration, base_key, radius_sq):
        ops.set(iteration, base_key, radius_sq)
        band, stats = captured.run()
        return band.clone(), {k: v.clone() for k, v in stats.items()}
    replay.captured, replay.eager = captured, eager
    return replay


def gather_image(band: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The whole image [H, W, 3] on every rank from each rank's band."""
    return mesh.all_gather(band)


def reduce_stats(mesh: Mesh, stats: dict) -> dict:
    """Each stat summed over its lanes and over ranks by one ``psum``
    (``avg_*`` means divided by the rank count), in the dtype of its
    unsharded sum."""
    if not stats:
        return {}
    sums = {k: torch.sum(v.detach()) for k, v in stats.items()}
    total = mesh.psum(torch.stack([v.to(torch.float64)
                                   for v in sums.values()]))
    return {k: (t / mesh.size if k.startswith("avg_") else t).to(v.dtype)
            for (k, v), t in zip(sums.items(), total)}


def _in_lane_order(mesh: Mesh, batch: PhotonBatch,
                   p_local: int) -> PhotonBatch:
    """Every rank's photons, in the unsharded deposit order: a rank's rows
    are ``depth * p_local + lane``, the whole batch's ``depth * P +
    global lane``."""
    def gather(a):
        g = mesh.all_gather(a)
        per_lane = a.shape[0] // p_local
        g = g.reshape((mesh.size, per_lane, p_local) + a.shape[1:])
        return g.transpose(0, 1).reshape((-1,) + a.shape[1:])
    return PhotonBatch(**{f.name: gather(getattr(batch, f.name))
                          for f in dataclasses.fields(batch)})


def _ppm_shard(scene, camera, cfg, mesh, it, key, radius_sq, eps, px, py,
               lanes, p_local):
    dev = lanes.device
    n_dev = mesh.size
    W, H = cfg.width, cfg.height
    radius = torch.sqrt(radius_sq)
    eye_key = iteration_key(key, it, ppm.PASS_PPM_EYE)
    photon_key = iteration_key(key, it, ppm.PASS_PPM_PHOTON)
    est_key = iteration_key(key, it, ppm.PASS_PPM_ESTIMATE)

    hp = ppm.trace_eye_pass(scene, camera, cfg, eye_key, eps, px, py, lanes)
    photon_lanes = torch.arange(mesh.rank * p_local,
                                (mesh.rank + 1) * p_local,
                                dtype=torch.int64, device=dev)
    photons, vol, pstats = ppm.trace_photon_pass(scene, cfg, photon_key, eps,
                                                 photon_lanes)
    res = cfg.photon_grid_resolution
    # the port's estimator rule on every device: the tile gather whenever
    # the image splits into 16x16 blocks
    blockable = W % BLOCK == 0 and H % BLOCK == 0
    a2a = cfg.photon_exchange == PhotonExchange.ALL_TO_ALL
    xstats = {}
    if a2a:
        grid, xstats = exchange_photons_by_cell(
            photons, res, mesh, min_cell_size=min_cell_size_for_window(
                radius, 4),
            capacity_factor=cfg.photon_exchange_capacity_factor,
            subsample_u=uniform(fold_in(est_key, 57), (), dev))
        s_gather = LaneSampler(fold_in(est_key, 55), lanes,
                               cheap=cfg.use_cheap_random)
        accum_power, gstats = sharded_gather(
            grid, hp.position, hp.ns, radius, mesh,
            budget_total=max(16, cfg.gather_photon_budget // n_dev),
            u_stride=s_gather.next1(),
            tiled_wh=(W, H) if blockable else None, q_valid=hp.found)
    else:
        photons = _in_lane_order(mesh, photons, p_local)
        if blockable:
            # the tile gather needs the whole image's 16x16 blocks
            q = types.SimpleNamespace(
                position=mesh.all_gather(hp.position),
                ns=mesh.all_gather(hp.ns), found=mesh.all_gather(hp.found))
            all_lanes = torch.arange(W * H, dtype=torch.int64, device=dev)
            acc, gstats = ppm.grid_gather(cfg, q, photons, radius, est_key,
                                          all_lanes)
            accum_power = mesh.band(acc)
            gstats = {k: mesh.band(v) for k, v in gstats.items()}
        else:
            accum_power, gstats = ppm.grid_gather(cfg, hp, photons, radius,
                                                  est_key, lanes)

    rad = ppm.shade(scene, cfg, hp, accum_power, radius_sq, est_key, lanes,
                    eps)
    if scene.medium is not None:
        if a2a:
            vol_radius = radius * 3.0
            vgrid, _ = exchange_photons_by_cell(
                vol, res, mesh, min_cell_size=min_cell_size_for_window(
                    vol_radius, 4),
                capacity_factor=cfg.photon_exchange_capacity_factor,
                subsample_u=uniform(fold_in(est_key, 58), (), dev))
            s_vg = LaneSampler(fold_in(est_key, 56), lanes,
                               cheap=cfg.use_cheap_random)
            vpow, _ = sharded_gather(
                vgrid, hp.vol_point, hp.ns, vol_radius, mesh,
                budget_total=max(16, cfg.gather_photon_budget // n_dev),
                check_normal=False, u_stride=s_vg.next1())
            rad = rad + ppm.volumetric_estimate(scene.medium, cfg, hp, vpow,
                                                radius)
        else:
            rad = rad + ppm._volumetric(
                scene.medium, cfg, hp, _in_lane_order(mesh, vol, p_local),
                radius, est_key, lanes)
    return rad, {**reduce_stats(mesh, {**pstats, **gstats}), **xstats}


def _vcm_shard(scene, camera, cfg, mesh, it, key, radius_sq, eps, px, py,
               lanes, p_local):
    n_light_paths = cfg.width * cfg.height   # light launch = image size
    mis_vm_w, mis_vc_w = vcm.mis_factors(cfg, radius_sq)
    lkey = iteration_key(key, it, vcm.PASS_VCM_LIGHT)
    ckey = iteration_key(key, it, vcm.PASS_VCM_CAMERA)

    # this rank traces the light paths whose global ids are its lanes
    store, splat, lstats = vcm.trace_light_pass(
        scene, camera, cfg, lkey, eps, mis_vc_w, mis_vm_w, lanes,
        n_light_paths)
    # t=1 splats land on any pixel: sum over ranks, keep this band
    splat_mine = mesh.band(mesh.psum(splat.reshape(-1, 3)))

    gathered_bytes = 0
    if cfg.vcm_uniform_vertex_sampling or cfg.vcm_use_vm:
        # uniform vertex sampling draws over every stored vertex and
        # merging gathers from the global population: all-gather the store
        # (rank order = global path order, so the draws and the vertex
        # grid are the unsharded ones)
        store = store.map(mesh.all_gather)
        gathered_bytes = sum(
            a.numel() * a.element_size()
            for a in (getattr(store, f.name)
                      for f in dataclasses.fields(store)))
    vgrid = None
    if cfg.vcm_use_vm:
        vgrid = vcm.build_vertex_grid(scene, cfg, store,
                                      torch.sqrt(radius_sq))
    # pixel i pairs with light path i: a local store's row j is global
    # path lanes[j]; a gathered store's rows are global
    if cfg.vcm_use_vm and not cfg.vcm_uniform_vertex_sampling:
        pair = lanes
    else:
        pair = torch.arange(lanes.shape[0], dtype=torch.int64,
                            device=lanes.device)
    color = vcm.trace_camera_pass(
        scene, camera, cfg, ckey, eps, mis_vc_w, mis_vm_w, store,
        n_light_paths, px, py, lanes, pair, vgrid=vgrid, radius_sq=radius_sq,
        mesh=mesh)
    stats = reduce_stats(mesh, lstats)
    stats["vcm_gathered_store_bytes_per_device"] = torch.full(
        (), gathered_bytes, dtype=torch.int64, device=lanes.device)
    return color + splat_mine, stats
