"""Shared by the port's tests and ``chip_smoke.py``: the golden and main
configurations, the bars that hold the port against the goldens, against
itself on another device and its kernels against their plain versions,
and the functions that make the kernels' inputs.

The card tests (``test_torch_kernels_cuda.py``) check the inputs that
``chip_smoke.py``'s kernel table times, because both build them here; the
CPU tests hold the configurations and the inputs against the JAX
package's. Nothing here imports JAX, and the port's modules are imported
where they are used.
"""
from __future__ import annotations

import dataclasses
import importlib
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
GOLDENS = REPO / "tests" / "goldens" / "goldens.npz"

# scripts/make_goldens.py: golden_config("pt"), ITERS["pt"], SEED
GOLDEN_SEED = 7
GOLDEN_ITERS = 4
# tests/test_goldens.py: float16 storage + cross-platform float noise
GOLDEN_RTOL = 5e-3
# paths flipped by last-ulp differences (golden_agreement): at most 0.5%
# of the 64x64 pixels, and the image mean within 1e-3
GOLDEN_MAX_FLIPPED = 20
# the same z-fight in the *__vcm goldens, which splat light paths too: 18
# pixels on the CPU (tests/test_torch_vcm.py)
VCM_GOLDEN_MAX_FLIPPED = 32
GOLDEN_MEAN_RTOL = 1e-3

GOLDEN_PPM_ITERS = 3
GOLDEN_VCM_ITERS = 2
# the *__ppm goldens come from JAX's budgeted gather, the port's PPM takes
# the tile gather, so the two agree statistically
# (tests/test_pallas_gather.py:98-100): the image mean within 12%, and the
# pixel correlation at least 0.97, or, where JAX's own tile gather at this
# configuration stays below 0.97 (its estimator's variance on these
# scenes: JAX_TILED_GOLDEN_CORR, measured on the CPU with
# use_pallas_gather=True), at least that value less 0.01
PPM_GOLDEN_MEAN_RTOL = 0.12
PPM_GOLDEN_MIN_CORR = 0.97
JAX_TILED_GOLDEN_CORR = {"CornellSmallSmallSpheres": 0.9621,
                         "CornellSmallPointDistant": 0.7712,
                         "CornellSmallPointTest": 0.9658}
# the same estimator on two devices (the card against the CPU port, and
# tests/test_torch_ppm.py): the share of pixels within PPM_PIXEL_RTOL, and
# the image mean
PPM_PIXEL_RTOL = 1e-3
PPM_MIN_AGREEING = 0.99
PPM_MEAN_RTOL = 1e-3
# B3 against its plain version: the same terms summed in another order
GATHER_RTOL = 1e-4
GATHER_ATOL_REL = 1e-6
# B4 against its plain version: the same terms summed in another order
VM_RTOL = 1e-4
VM_ATOL_REL = 1e-6
# VCM's t=1 splats add atomically on the card, so two renders of its
# image agree to float tolerance, not bits: share of pixels within rtol,
# and the image mean
SHARD_PIXEL_RTOL, SHARD_MIN_AGREEING, SHARD_MEAN_RTOL = 1e-4, 0.999, 1e-5

# the JAX bench's scene and size (bench.py:230-243)
MAIN_SCENE = "CornellSmall"
MAIN_SIZE = 512
PPM_MAIN_PHOTONS = 1 << 20
# the JAX package's test medium, which covers all of CornellSmall
MEDIUM_SIGMA_S, MEDIUM_SIGMA_A, MEDIUM_BOX = 0.15, 0.02, 2.5
MEDIA_STORED_RTOL = 1e-3
# gradients of one iteration's mean image: the squared radius of its PPM
# or VCM+VM iteration, and the card's agreement with the CPU port
GRAD_R2 = 0.003
GRAD_RTOL = {"pt": 1e-3, "ppm": 5e-3, "vcm": 5e-3}
# a camera restart's orbit (radians about and toward the up axis), small
# enough that every scene's camera stays inside it
GRAPH_ORBIT = (0.05, 0.02)

# the repo's Collada file (8,098 triangles, above the BVH threshold: B5)
# and tests/test_import.py's DAE (5 triangles: B1 and B2), seen from
# tests/test_import.py's camera (eye, look-at, field of view)
ATRIUM_LITE = REPO / "scenes" / "atrium_lite.dae"
SMALL_DAE_CAMERA = ((0.5, 1.2, 4.0), (0.5, 0.8, 0.0), 50.0)
# tests/test_import.py's DAE (a quad, a glass triangle moved by a node's
# translate, an emissive lamp), word for word
SMALL_DAE = """<?xml version="1.0" encoding="utf-8"?>
<COLLADA xmlns="http://www.collada.org/2005/11/COLLADASchema" version="1.4.1">
  <asset><up_axis>Y_UP</up_axis></asset>
  <library_effects>
    <effect id="fx-white"><profile_COMMON><technique sid="common">
      <lambert><diffuse><color>0.8 0.7 0.6 1</color></diffuse></lambert>
    </technique></profile_COMMON></effect>
    <effect id="fx-glass"><profile_COMMON><technique sid="common">
      <phong><diffuse><color>1 1 1 1</color></diffuse>
      <index_of_refraction><float>1.5</float></index_of_refraction></phong>
    </technique></profile_COMMON></effect>
    <effect id="fx-glow"><profile_COMMON><technique sid="common">
      <lambert><emission><color>2 2 2 1</color></emission>
      <diffuse><color>1 1 1 1</color></diffuse></lambert>
    </technique></profile_COMMON></effect>
  </library_effects>
  <library_materials>
    <material id="white"><instance_effect url="#fx-white"/></material>
    <material id="glassy"><instance_effect url="#fx-glass"/></material>
    <material id="glow"><instance_effect url="#fx-glow"/></material>
  </library_materials>
  <library_geometries>
    <geometry id="quad"><mesh>
      <source id="qp"><float_array id="qpa" count="12">
        0 0 0  1 0 0  1 1 0  0 1 0</float_array>
        <technique_common><accessor source="#qpa" count="4" stride="3">
          <param name="X" type="float"/><param name="Y" type="float"/>
          <param name="Z" type="float"/></accessor></technique_common>
      </source>
      <vertices id="qv"><input semantic="POSITION" source="#qp"/></vertices>
      <triangles material="m0" count="2">
        <input semantic="VERTEX" source="#qv" offset="0"/>
        <p>0 1 2 0 2 3</p>
      </triangles>
    </mesh></geometry>
    <geometry id="tri"><mesh>
      <source id="tp"><float_array id="tpa" count="9">
        2 0 0  3 0 0  2 1 0</float_array>
        <technique_common><accessor source="#tpa" count="3" stride="3">
          <param name="X" type="float"/><param name="Y" type="float"/>
          <param name="Z" type="float"/></accessor></technique_common>
      </source>
      <vertices id="tv"><input semantic="POSITION" source="#tp"/></vertices>
      <triangles material="m1" count="1">
        <input semantic="VERTEX" source="#tv" offset="0"/>
        <p>0 1 2</p>
      </triangles>
    </mesh></geometry>
    <geometry id="lamp"><mesh>
      <source id="lp"><float_array id="lpa" count="12">
        0 2 0  1 2 0  1 2 1  0 2 1</float_array>
        <technique_common><accessor source="#lpa" count="4" stride="3">
          <param name="X" type="float"/><param name="Y" type="float"/>
          <param name="Z" type="float"/></accessor></technique_common>
      </source>
      <vertices id="lv"><input semantic="POSITION" source="#lp"/></vertices>
      <triangles material="m2" count="2">
        <input semantic="VERTEX" source="#lv" offset="0"/>
        <p>0 1 2 0 2 3</p>
      </triangles>
    </mesh></geometry>
  </library_geometries>
  <library_visual_scenes><visual_scene id="vs">
    <node id="n1"><instance_geometry url="#quad">
      <bind_material><technique_common>
        <instance_material symbol="m0" target="#white"/>
      </technique_common></bind_material></instance_geometry></node>
    <node id="n2"><translate>0 0 1</translate>
      <instance_geometry url="#tri"><bind_material><technique_common>
        <instance_material symbol="m1" target="#glassy"/>
      </technique_common></bind_material></instance_geometry></node>
    <node id="n3"><instance_geometry url="#lamp">
      <bind_material><technique_common>
        <instance_material symbol="m2" target="#glow"/>
      </technique_common></bind_material></instance_geometry></node>
  </visual_scene></library_visual_scenes>
  <scene><instance_visual_scene url="#vs"/></scene>
</COLLADA>
"""


def golden_pt_config():
    """The PT golden configuration of scripts/make_goldens.py."""
    from oppositerenderer_tpu_torch.config import RenderConfig
    return RenderConfig(
        width=64, height=64, pt_max_segments_nee=4,
        max_radiance_trace_depth=5, max_photon_trace_depth=4,
        photons_per_iteration=1 << 14, photon_grid_resolution=32,
        gather_photon_budget=64, vcm_max_path_length=6,
        iterations_per_dispatch=GOLDEN_ITERS)


def golden_ppm_config():
    """The PPM golden configuration of scripts/make_goldens.py."""
    from oppositerenderer_tpu_torch.config import RenderMethod
    return golden_pt_config().replace(
        render_method=RenderMethod.PROGRESSIVE_PHOTON_MAPPING,
        iterations_per_dispatch=GOLDEN_PPM_ITERS)


def golden_vcm_config():
    """The VCM golden configuration of scripts/make_goldens.py."""
    from oppositerenderer_tpu_torch.config import RenderMethod
    return golden_pt_config().replace(
        render_method=RenderMethod.VCM_BIDIRECTIONAL_PATH_TRACING,
        iterations_per_dispatch=GOLDEN_VCM_ITERS)


def vcm_main_config(use_vm: bool = False):
    """The JAX bench's VCM case (bench.py:236-237) or, with ``use_vm``, its
    VCM+VM case (:242-243), at 512^2."""
    from oppositerenderer_tpu_torch.config import RenderConfig, RenderMethod
    return RenderConfig(
        width=MAIN_SIZE, height=MAIN_SIZE,
        render_method=RenderMethod.VCM_BIDIRECTIONAL_PATH_TRACING,
        vcm_use_vm=use_vm)


def ppm_main_config():
    """The JAX bench's PPM case (bench.py:232-235) at 512^2."""
    from oppositerenderer_tpu_torch.config import RenderConfig, RenderMethod
    return RenderConfig(width=MAIN_SIZE, height=MAIN_SIZE,
                        render_method=RenderMethod.PROGRESSIVE_PHOTON_MAPPING,
                        photons_per_iteration=PPM_MAIN_PHOTONS)


def golden_agreement(img: np.ndarray, want: np.ndarray):
    """(pixels outside the golden tolerance, worst pixel's error as a
    multiple of its tolerance, relative error of the image mean). A
    last-ulp difference in a ray (the port's float arithmetic is not
    XLA's) can flip a path's decision where two surfaces almost touch:
    Cornell's light lies within two float32 ulps of its ceiling. Such a
    flip moves one pixel far beyond the golden tolerance and the image
    mean by ~1e-4, so a scene must keep all but GOLDEN_MAX_FLIPPED of its
    pixels within the golden tolerance and its mean within
    GOLDEN_MEAN_RTOL."""
    atol = GOLDEN_RTOL * max(float(want.mean()), 0.01)
    ratio = np.abs(img - want) / (atol + GOLDEN_RTOL * np.abs(want))
    return (int((ratio > 1.0).any(axis=-1).sum()), float(ratio.max()),
            abs(float(img.mean()) / float(want.mean()) - 1.0))


def image_agreement(img: np.ndarray, want: np.ndarray):
    """(share of pixels within PPM_PIXEL_RTOL on every channel, relative
    error of the image mean)."""
    agree = np.isclose(img, want, rtol=PPM_PIXEL_RTOL, atol=0.0).all(axis=-1)
    return float(agree.mean()), abs(float(img.mean()) / float(want.mean())
                                    - 1.0)


def loss_and_grad(scene, cam, cfg, param: str, seed: int = 0):
    """Mean image of one iteration and its gradient with respect to kd of
    material 0 (a wall) or the emission scale (``diff``)."""
    from oppositerenderer_tpu_torch import diff
    from oppositerenderer_tpu_torch.renderer import Renderer
    start = scene.materials.kd[0] if param == "kd" else 1.0
    loss, grads = diff.render_loss_and_grad(
        lambda s: Renderer(s, cam, cfg, seed=seed)._iteration(
            0, GRAD_R2)[0], scene, {(param, 0): start})
    return float(loss), grads[(param, 0)].detach().cpu().double()


def iteration_calls(scene, cam, cfg, names):
    """The calls of the wrappers ``names`` in one iteration (iteration 0,
    seed 0) of ``cfg``, recorded where ``accel/intersect.py`` calls them:
    per name, each call's first five positional arguments, in call
    order."""
    from oppositerenderer_tpu_torch.renderer import Renderer
    # the module (the package exports a function of the same name)
    isect = importlib.import_module(
        "oppositerenderer_tpu_torch.accel.intersect")
    calls = {k: [] for k in names}
    wrappers = {k: getattr(isect, k) for k in names}

    def recorder(k):
        def record(*args, **kwargs):
            calls[k].append(args[:5])
            return wrappers[k](*args, **kwargs)
        return record

    for k in names:
        setattr(isect, k, recorder(k))
    try:   # the eager body: a replay would call no wrapper
        r = Renderer(scene, cam, cfg, seed=0)
        r._iteration(0, r._radius_sq(0))
    finally:
        for k, w in wrappers.items():
            setattr(isect, k, w)
    return calls


def _rays(n: int, seed: int, box_lo, box_hi, dev):
    """Random rays inside a box: a mix of unbounded, bounded and dead
    (tmax < tmin) lanes."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(box_lo, box_hi, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    extent = float(np.max(np.asarray(box_hi) - np.asarray(box_lo)))
    tmax = rng.uniform(0.05, 1.5, n).astype(np.float32) * extent
    kind = rng.integers(0, 4, n)
    tmax[kind == 0] = 1e30
    tmax[kind == 1] = 0.0
    tmin = np.full(n, 1e-4, np.float32)
    return [torch.as_tensor(a, device=dev) for a in (o, d, tmin, tmax)]


def dead_or_live(rays, live: bool):
    """The same rays with every lane dead (tmax = tmin, or below it) or
    every lane live (the dead ones unbounded)."""
    o, d, tmin, tmax = rays
    if live:
        return o, d, tmin, torch.where(tmax > tmin, tmax, 1e30)
    odd = torch.arange(tmax.shape[0], device=tmax.device) % 2 == 1
    return o, d, tmin, torch.where(odd, tmin - 1.0, tmin)


def _bits_differ(a: torch.Tensor, b: torch.Tensor) -> int:
    """Lanes whose values differ bit for bit (float32 compared as int32)."""
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return int((a != b).sum())


def _to(obj, device):
    """A tensor, or a record of tensors (nested dataclasses), on
    ``device``."""
    if torch.is_tensor(obj):
        return obj.to(device)
    if isinstance(obj, dict):
        return {k: _to(v, device) for k, v in obj.items()}
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{
            f.name: _to(getattr(obj, f.name), device)
            for f in dataclasses.fields(obj)})
    return obj


def gather_case(dev, n_photons=4096, n_tiles=2, radius=0.12, seed=0,
                cluster=False):
    """The synthetic case of tests/test_pallas_gather.py:16-41, drawn in the
    same order from numpy and built by the port: photons in the unit cube
    (``cluster`` piles half into a few cells, so rows overflow a chunk),
    queries clustered per tile. Returns (grid, qpos, qnormal, radius)."""
    from oppositerenderer_tpu_torch import photon_map as pm
    rng = np.random.default_rng(seed)

    def unit(k):
        d = rng.standard_normal((k, 3)).astype(np.float32)
        return d / np.linalg.norm(d, axis=1, keepdims=True)

    pos = rng.uniform(0, 1, (n_photons, 3)).astype(np.float32)
    if cluster:
        pos[: n_photons // 2] = (0.5 + 0.02 * rng.standard_normal(
            (n_photons // 2, 3))).astype(np.float32)
    power = rng.uniform(0, 1, (n_photons, 3)).astype(np.float32)
    direction = unit(n_photons)
    valid = rng.uniform(size=n_photons) < 0.9
    photons = pm.PhotonBatch(*(torch.as_tensor(a, device=dev) for a in (
        pos, power, direction, valid)))
    grid = pm.build_photon_grid(photons, 16, min_cell_size=(
        pm.min_cell_size_for_window(torch.tensor(radius, device=dev), 4)))
    centers = rng.uniform(0.25, 0.75, (n_tiles, 3)).astype(np.float32)
    jitter = (0.02 * rng.standard_normal((n_tiles, 256, 3))).astype(
        np.float32)
    qpos = np.clip(centers[:, None, :] + jitter, 0.0, 1.0).reshape(-1, 3)
    return (grid, torch.as_tensor(qpos, device=dev),
            torch.as_tensor(unit(n_tiles * 256), device=dev), radius)


def scene_medium(dev):
    """The JAX package's test medium (tests/test_media.py:51-56): sigma_s
    0.15, sigma_a 0.02 over [0, 2.5]^3, which covers all of CornellSmall,
    as the reference's scene-covering AABInstance."""
    from oppositerenderer_tpu_torch.scene import Medium
    return Medium(sigma_s=torch.tensor(MEDIUM_SIGMA_S, device=dev),
                  sigma_a=torch.tensor(MEDIUM_SIGMA_A, device=dev),
                  aabb_min=torch.zeros(3, device=dev),
                  aabb_max=torch.full((3,), MEDIUM_BOX, device=dev))


def ppm_gather_inputs(dev, medium: bool = False, scene=None, cam=None,
                      cfg=None):
    """The tile gather's inputs in one PPM iteration (iteration 0, seed 0)
    of ``scene`` seen from ``cam`` with ``cfg``, by default CornellSmall at
    512^2 with the bench's PPM configuration (with ``medium``, in
    :func:`scene_medium`), recorded where
    ``integrators/ppm.render_iteration`` calls the gather: (grid,
    tile-ordered hitpoint positions and normals, radius, u_rows, found)."""
    from oppositerenderer_tpu_torch.integrators import ppm
    from oppositerenderer_tpu_torch.renderer import Renderer
    from oppositerenderer_tpu_torch.scene import get_scene_by_name

    if scene is None:
        scene, cam = get_scene_by_name(MAIN_SCENE, dev)
    if medium:
        scene.medium = scene_medium(dev)
    r = Renderer(scene, cam, cfg or ppm_main_config(), seed=0)
    calls = []
    gather = ppm.gather_photons_tiled

    def record(grid, position, normal, radius, *, u_rows, valid, **kw):
        calls.append((grid, position, normal, radius, u_rows, valid))
        return gather(grid, position, normal, radius, u_rows=u_rows,
                      valid=valid, **kw)

    ppm.gather_photons_tiled = record
    try:   # the eager body: a replay would call no wrapper
        r._iteration(0, r._radius_sq(0))
    finally:
        ppm.gather_photons_tiled = gather
    (call,) = calls
    return call


def vm_case_arrays(seed: int = 0, cluster: bool = False) -> dict:
    """numpy inputs of one merge round. Without ``cluster``: the synthetic
    setup of tests/test_vcm_vm.py:106-162, drawn in the same order (16
    light vertices in a tight cluster, 256 camera vertices around it, a
    diffuse camera BSDF: nothing is subsampled). With ``cluster``: 16,384
    light vertices, half of them within a few cells of the 0.02 grid
    (rows overflow a chunk), the rest over a box 15 cells wide, at depths
    1-9; 512 camera vertices, half over a box 10 cells wide (more than 8
    rows per axis), half on the cluster; a glossy camera BSDF on half of
    them, every fifth inactive; random uniforms: row and chunk
    subsampling, the path-length cap and the Phong lobe all run."""
    rng = np.random.default_rng(seed)
    P, V, n = (4096, 4, 512) if cluster else (8, 2, 256)
    center = np.array([1.25, 1.0, 1.0])
    pos = center + rng.uniform(-0.05, 0.05, (P, V, 3))
    wo = rng.normal(size=(P, V, 3))
    wo /= np.linalg.norm(wo, axis=-1, keepdims=True)
    # wo in the +z hemisphere, which camera BSDFs with n = +z see
    wo[..., 2] = np.abs(wo[..., 2]) + 0.1
    wo /= np.linalg.norm(wo, axis=-1, keepdims=True)
    up = np.zeros((P, V, 3))
    up[..., 2] = 1.0
    store = dict(position=pos, throughput=rng.uniform(0.1, 1.0, (P, V, 3)),
                 dVCM=rng.uniform(0.0, 2.0, (P, V)),
                 dVC=rng.uniform(0.0, 2.0, (P, V)),
                 dVM=rng.uniform(0.0, 2.0, (P, V)), ns=up, ng=up, wo=wo,
                 valid=np.ones((P, V), bool), depth=np.ones((P, V), np.int32))
    qpos = center + rng.uniform(-0.04, 0.04, (n, 3))
    wfix = rng.normal(size=(n, 3))
    wfix /= np.linalg.norm(wfix, axis=-1, keepdims=True)
    wfix[:, 2] = np.abs(wfix[:, 2]) + 0.2
    wfix /= np.linalg.norm(wfix, axis=-1, keepdims=True)
    cam = dict(thr=rng.uniform(0.2, 1.0, (n, 3)),
               dVCM=rng.uniform(0.0, 2.0, (n,)),
               dVM=rng.uniform(0.0, 2.0, (n,)), active=np.ones(n, bool),
               glossy=np.zeros(n, bool))
    radius_sq = 0.03 ** 2
    if cluster:
        flat = store["position"].reshape(-1, 3)
        half = flat.shape[0] // 2
        flat[:half] = center + 0.025 * rng.standard_normal((half, 3))
        flat[half:] = center + rng.uniform(-0.15, 0.15, (half, 3))
        store["depth"] = rng.integers(1, 10, (P, V)).astype(np.int32)
        store["valid"] = rng.uniform(size=(P, V)) < 0.95
        qpos[:256] = center + rng.uniform(-0.1, 0.1, (256, 3))
        qpos[256:] = center + rng.uniform(-0.01, 0.01, (256, 3))
        cam["active"][::5] = False
        cam["glossy"][1::2] = True
    u = rng.uniform(size=n)
    f32 = {k: np.asarray(v, np.float32) if np.asarray(v).dtype == np.float64
           else v for k, v in store.items()}
    return dict(store=f32, qpos=qpos.astype(np.float32),
                wfix=wfix.astype(np.float32),
                cam={k: np.asarray(v, np.float32) if v.dtype == np.float64
                     else v for k, v in cam.items()},
                radius_sq=np.float32(radius_sq), u=u.astype(np.float32),
                mis_vc_w=np.float32(0.25), n_light_paths=64, depth1=2)


def vm_case(dev, seed: int = 0, cluster: bool = False):
    """:func:`vm_case_arrays` built by the port on ``dev``: the light
    vertices of CornellSmall's brightest diffuse material, their grid, and
    the keyword arguments of ``integrators/vcm._merge_vertices`` (with the
    VCM+VM configuration of tests/test_vcm_vm.py and a merge budget of
    4096). Returns (scene, cfg, kwargs)."""
    from oppositerenderer_tpu_torch.bsdf import BSDF
    from oppositerenderer_tpu_torch.config import RenderConfig, RenderMethod
    from oppositerenderer_tpu_torch.integrators import vcm
    from oppositerenderer_tpu_torch.scene import get_scene_by_name
    a = vm_case_arrays(seed, cluster)
    scene, _ = get_scene_by_name(MAIN_SCENE, dev)
    cfg = RenderConfig(
        width=48, height=48, vcm_use_vm=True, vcm_vm_budget=4096,
        render_method=RenderMethod.VCM_BIDIRECTIONAL_PATH_TRACING)
    mat = int(torch.argmax(scene.materials.kd.sum(dim=-1)))

    def t(x):
        return torch.as_tensor(x, device=dev)

    st = a["store"]
    store = vcm.LightVertexStore(
        mat=torch.full(st["valid"].shape, mat, dtype=torch.int32,
                       device=dev),
        **{k: t(v) for k, v in st.items()})
    n = a["qpos"].shape[0]
    kd, ks, expn, kr, kt, ior, diel = scene.materials.bsdf_coefficients(
        torch.full((n,), mat, device=dev))
    glossy = t(a["cam"]["glossy"])
    ks = torch.where(glossy[:, None], 0.3, ks)
    expn = torch.where(glossy, 20.0, expn)
    qn = torch.zeros((n, 3), device=dev)
    qn[:, 2] = 1.0
    cam_bsdf = BSDF.make(qn, qn, t(a["wfix"]), kd, ks, expn, kr, kt, ior,
                         diel)
    radius_sq = t(a["radius_sq"])
    vgrid = vcm.build_vertex_grid(scene, cfg, store, torch.sqrt(radius_sq))
    cam = a["cam"]
    return scene, cfg, dict(
        cam_bsdf=cam_bsdf, cam_pos=t(a["qpos"]), cam_thr=t(cam["thr"]),
        cam_dVCM=t(cam["dVCM"]), cam_dVM=t(cam["dVM"]),
        active=t(cam["active"]), vgrid=vgrid, radius_sq=radius_sq,
        mis_vc_w=t(a["mis_vc_w"]), n_light_paths=a["n_light_paths"],
        u_stride=t(a["u"]), depth1=a["depth1"])


def partial_grids(grid):
    """The grids of a 2-way exchange of ``grid``'s photons: the exchange's
    local half sends them to 2 owners, and each slab builds its owner's
    grid."""
    from oppositerenderer_tpu_torch.parallel.exchange import \
        bucket_photons_by_owner
    from oppositerenderer_tpu_torch.photon_map import (PhotonBatch,
                                                       build_photon_grid)
    n = int(grid.n_valid)
    photons = PhotonBatch(position=grid.position[:n], power=grid.power[:n],
                          direction=grid.direction[:n],
                          valid=torch.ones(n, dtype=torch.bool,
                                           device=grid.position.device))
    slab, ok, overflow = bucket_photons_by_owner(
        photons, grid.origin, grid.cell_size, grid.resolution, 2, 2.0, 0.5)
    if int(overflow):
        raise AssertionError(f"{int(overflow)} photons overflowed a slab")
    return [build_photon_grid(
        PhotonBatch(position=slab[owner, :, 0:3], power=slab[owner, :, 3:6],
                    direction=slab[owner, :, 6:9], valid=ok[owner]),
        grid.resolution, origin=grid.origin, cell_size=grid.cell_size)
        for owner in range(2)]
