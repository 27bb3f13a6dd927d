"""Smoke run of the PyTorch port's main paths on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

or, to time the parent tree's kernels in turns with this one's (phase
parent-ab), with that tree's kernel sources unpacked under a directory
(``git archive 11d34d2 oppositerenderer_tpu_torch/csrc``; the parent's
entry points are PARENT_ENTRY_POINTS):

    python3 chip_smoke.py --parent _chip_tree/parent

Phases, in order, one line (or a few) of output each; any failure raises
and the script exits non-zero without printing the result line:

1. device      - a CUDA device must be present; prints its name, the torch
                 and CUDA versions, ``nvidia-smi``'s name and power limit,
                 and PIL's version (or "absent").
2. build       - one nvcc per source, all started together, compiles
                 ``csrc/intersect.cu``, ``csrc/gather.cu``, ``csrc/vm.cu``
                 and ``csrc/bvh.cu`` for sm_90a, and one more links them into
                 one library; prints its cache key, the build time and
                 ptxas' registers and spills. Then g++ must build the
                 host libraries (``native/bvh_builder.cpp``,
                 ``kdtree_builder.cpp``, ``text_scan.cpp``).
3. kernels     - each kernel against its plain PyTorch version on the same
                 CUDA tensors. B1 and B2 (random rays from a numpy seed, at
                 the PT path's shape and beyond; both on tables of 32 and
                 4096 triangles with mixed, all dead and all live lanes;
                 B1 on every closest-hit call of one CornellSmall 512^2
                 PT, PPM and VCM iteration, B2 on every shadow-ray call of
                 one VCM iteration, each call timed against its live lanes
                 and its bound and summed per iteration) must be equal bit
                 for bit (the library is built with --fmad=false). B3 with check_normal on and off on
                 three inputs: the synthetic case of
                 tests/test_pallas_gather.py, its clustered variant with
                 random u_rows (row and chunk subsampling), and the grid and
                 hitpoints of one CornellSmall 512^2 PPM iteration with 1<<20
                 photons; stats equal, sums within rtol 1e-4 + 1e-6 max|ref|.
                 B4 on the synthetic case of tests/test_vcm_vm.py, its
                 clustered variant with random u_rows, and the vertex grid
                 and camera vertices of every merge round (camera bounce)
                 of one CornellSmall 512^2 VCM+VM iteration; query order
                 and slot tables equal to the CPU's, both sums within rtol
                 1e-4 + 1e-6 max|ref|. B5 (closest and any hit) bit for
                 bit on random rays in full Atrium's box (a quarter dead,
                 all dead, all live), every traversal call of one Atrium
                 512^2 PT iteration (262,144 lanes a call) and of one
                 Conference 1024^2 PT iteration (1,048,576 lanes), and
                 random rays in CornellSmall with a BVH, its live-lane
                 compaction against its plain version on each; prints the
                 rows, slab tests and triangle tests of each ray. Times
                 kernels (device time: medians of 20 replays of a CUDA
                 graph of 10 calls) and plain versions (enqueued from the
                 host) with CUDA events, B4 on every
                 merge round and B5 on every call of both iterations (the
                 sums: per-iteration kernel ms), and each kernel's bound
                 (the least time of the card for the same work: for B3/B4
                 the pairs each query needs, for B5 the tests and row
                 floats the traversal needs, from the plain version's
                 counts). With ``--parent``: phase parent-ab, the parent
                 tree's kernels built by the same nvcc flags and timed in
                 turns with this tree's, their outputs compared: B1 on
                 every closest-hit call of one PPM and one VCM iteration
                 and on the 4096-triangle soup; B2-B5, which the parent
                 shares, as an A/A check (this tree's wrappers launching
                 the parent's library: B2 over one VCM iteration, B3 at
                 the PPM main shape, B4 and B5 on every call of their
                 iterations).
4. goldens     - the port's Renderer at the golden PT configuration on the
                 eight Cornell scenes against ``tests/goldens/goldens.npz``.
5. main        - PT on CornellSmall at 512x512 with the default RenderConfig,
                 seed 0, 20 iterations: one warm-up render, then 3 timed reps.
                 Each rep must launch B1 and B2 20 x 5 times each.
6. ppm-goldens - PPM at the golden PPM configuration (3 iterations, seed 7)
                 on the eight scenes against the ``*__ppm`` goldens, which
                 JAX rendered with its budgeted gather: statistical bounds.
7. ppm-parity  - one PPM iteration of CornellSmall at 64^2, seed 7, on the
                 card and on the CPU (plain versions), pixel by pixel.
8. ppm-main    - PPM on CornellSmall at 512x512, 1<<20 photons, every other
                 RenderConfig field at its default, seed 0: one warm-up
                 render, then 3 timed reps of 5 iterations. Each rep must
                 launch B3 5 times, B1 5 x (9 + 7) and B2 5 x 4 times.
8a. media-parity - one PPM iteration of CornellSmall at 64^2, seed 7, in
                 the JAX package's test medium (sigma_s 0.15, sigma_a 0.02,
                 box [0, 2.5]^3, which covers the scene) on the card and on
                 the CPU: ppm-parity's pixel bar, and the volumetric photons
                 stored within 0.1%.
8b. media-main - ppm-main in that medium, in ppm-main's protocol and with
                 its launch counts (the volume gather is the budgeted gather
                 in torch: no kernel); prints ms/iter, the volumetric
                 photons stored and the peak memory, and holds B3 against
                 its plain version on the path's surface gather.
9. vcm-goldens - VCM at the golden VCM configuration (2 iterations, L=6,
                 seed 7) on the eight scenes against the ``*__vcm`` goldens
                 at PT's bar.
10. vcm-parity - one VCM+VM iteration of CornellSmall at 64^2, seed 7, on
                 the card and on the CPU, pixel by pixel.
11. vcm-main   - VCM on CornellSmall at 512x512, default RenderConfig (L=10),
                 seed 0: one warm-up render, then 3 timed reps of 5
                 iterations; each rep must launch B1 5 x 19 and B2 5 x 19
                 times (one any hit per light bounce, one per camera bounce
                 for all its shadow rays). Then one profiled iteration.
12. vcm-vm-main - the same with vertex merging, 2 iterations a rep; B4 must
                 launch 2 x 10 times too.
12a. grad-parity - gradients of the mean image of one 32^2 iteration on
                 the card against the CPU port's: PT kd of material 0 (a
                 wall) and emission scale (rel 1e-3), PPM kd (the tile
                 gather: B3's zero gradient), VCM kd (L = 4, continuation
                 pinned to 1) and VCM+VM emission scale (the tile merge:
                 B4's zero gradient), rel 5e-3.
12b. grad-main - loss and gradient with respect to kd and the emission
                 scale at 512^2: PT, PPM (1<<20 photons) and VCM (L = 10);
                 forward + backward seconds and peak memory after one
                 warm-up. Then three steps of gradient descent (Polyak
                 step) on the wall's kd toward a target rendered at 0.8 kd
                 with the same seed, PT 512^2: the loss must fall at every
                 step.
13. bvh-goldens - the eight Cornell scenes with a BVH attached, at the golden
                 PT configuration, against the ``*__pt`` goldens at phase
                 4's bar; B5 runs, B1/B2 do not.
14. bvh-parity - one PT iteration of full Atrium at 64^2, seed 7, on the
                 card and on the CPU, pixel by pixel (phase 7's bar).
15. atrium-main - PT on Atrium (253,508 triangles) at 512x512, default
                 RenderConfig, seed 0: one warm-up render, then 3 timed reps
                 of 5 iterations; each rep must launch B5 5 x 5 times closest
                 and 5 x 5 any hit, and B1/B2 never. Then one profiled
                 iteration.
16. conference-main - the same on Conference (184,714 triangles) at
                 1024x1024, 2 iterations a rep.
17. import-parity - the three native libraries (BVH builder, kd-tree
                 builder, text scanner) must load; the loader on the card
                 against the loader on the CPU, array for array, for
                 ``scenes/atrium_lite.dae`` (8,098 triangles, above the BVH
                 threshold) and tests/test_import.py's DAE (5 triangles);
                 one 64^2 PT iteration of each, card against CPU, at
                 phase 7's bar: the first runs B5 only, the second B1 and
                 B2 only.
18. import-main - milestone4_torch.py's cases: Atrium and Conference
                 exported at full detail to .dae files under
                 chiprun_out/scenes/, imported from them, PPM and VCM at
                 1024x1024 with the default RenderConfig (2^20 photons;
                 L = 10, no merging): one warm-up, two timed iterations;
                 per iteration B5 16 + 4 (PPM) or 19 + 19 (VCM), B3 1
                 (PPM), B1 and B2 never. B3 on the flagship PPM's gather
                 against its plain version, timed and bounded; B5 on every
                 traversal call of one PPM and one VCM iteration of each,
                 bit for bit on a lane sample, timed, summed per iteration.
19. photon-maps - ppm-main's configuration with the stochastic hash and
                 with the CPU kd-tree: one warm-up, 3 timed reps of 2
                 iterations, B1 2 x 16, B2 2 x 4 and B3 no launch a rep;
                 the structure's build timed in one more iteration, and
                 one more profiled; the
                 image mean against the grid's at the same seed within the
                 JAX package's bars (the hash's within 25%, the kd-tree's
                 within 5%); the mean |difference| per pixel printed.

The line before the last is a JSON object with the kernels' launches over
the main phases (5, 8, 8b, 11, 12, 15, 16, 18 and 19), errors, times and
bounds; the last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import dataclasses
import importlib
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
GOLDENS = REPO / "tests" / "goldens" / "goldens.npz"

# scripts/make_goldens.py: golden_config("pt"), ITERS["pt"], SEED
GOLDEN_SEED = 7
GOLDEN_ITERS = 4
# tests/test_goldens.py: float16 storage + cross-platform float noise
GOLDEN_RTOL = 5e-3
# paths flipped by last-ulp differences (phase_goldens): at most 0.5% of
# the 64x64 pixels, and the image mean within 1e-3
GOLDEN_MAX_FLIPPED = 20
# the same z-fight in the *__vcm goldens, which splat light paths too: 18
# pixels on the CPU (tests/test_torch_vcm.py)
VCM_GOLDEN_MAX_FLIPPED = 32
GOLDEN_MEAN_RTOL = 1e-3

GOLDEN_PPM_ITERS = 3
GOLDEN_VCM_ITERS = 2
# ppm-goldens: the *__ppm goldens come from JAX's budgeted gather, the
# port's PPM takes the tile gather, so the two agree statistically
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
# ppm-parity and tests/test_torch_ppm.py: the same estimator on two devices
PPM_PIXEL_RTOL = 1e-3
PPM_MIN_AGREEING = 0.99
PPM_MEAN_RTOL = 1e-3
# B3 against its plain version: the same terms summed in another order
GATHER_RTOL = 1e-4
GATHER_ATOL_REL = 1e-6

MAIN_SCENE = "CornellSmall"
MAIN_SIZE = 512
MAIN_ITERS = 20
MAIN_REPS = 3
TIMING_REPS = 20
LAUNCHES_PER_SAMPLE = 10   # cuda_ms: calls per timed sample of a kernel
# bench.py:232-235: the PPM case runs max(2, iterations // 4) iterations
PPM_MAIN_PHOTONS = 1 << 20
PPM_MAIN_ITERS = max(2, MAIN_ITERS // 4)
PLAIN_GATHER_REPS = 3
# phases media-*: JAX's test medium, and the parity bar of ppm-parity
MEDIUM_SIGMA_S, MEDIUM_SIGMA_A, MEDIUM_BOX = 0.15, 0.02, 2.5
MEDIA_STORED_RTOL = 1e-3
# phases grad-*: the gradient agreement of the card with the CPU port
GRAD_PARITY_SIZE = 32
GRAD_RTOL = {"pt": 1e-3, "ppm": 5e-3, "vcm": 5e-3}
GRAD_R2 = 0.003
GRAD_DESCENT_STEPS = 3
GRAD_TARGET_SCALE = 0.8

# VCM (bench.py:236-243): 5 iterations, and 2 with vertex merging
VCM_MAIN_ITERS = max(2, MAIN_ITERS // 4)
VCM_VM_MAIN_ITERS = 2
# B4 against its plain version: the same terms summed in another order
VM_RTOL = 1e-4
VM_ATOL_REL = 1e-6
PLAIN_VM_REPS = 3

# BVH scenes (bench.py:244-255): Atrium PT at 512^2, 5 iterations;
# Conference PT at 1024^2, 2 iterations
ATRIUM_SIZE = 512
ATRIUM_ITERS = 5
CONFERENCE_SIZE = 1024
CONFERENCE_ITERS = 2
BVH_PARITY_SIZE = 64
PLAIN_BVH_REPS = 3
# the kernels phase's random triangle soup: B1 and B2 beyond the Cornell
# scenes' 36 triangles, up to the dense route's 4096
SOUP_TRIS = 4096
SOUP_BOX = ([0.0] * 3, [10.0] * 3)

# phases import-*: the repo's Collada file (8,098 triangles, above the BVH
# threshold: B5) and tests/test_import.py's DAE (5 triangles: B1 and B2),
# seen from tests/test_import.py's camera (eye, look-at, field of view)
ATRIUM_LITE = REPO / "scenes" / "atrium_lite.dae"
IMPORT_PARITY_SIZE = 64
SMALL_DAE_CAMERA = ((0.5, 1.2, 4.0), (0.5, 0.8, 0.0), 50.0)
# import-main: B5 on every traversal call of a flagship iteration, each
# call held bit for bit on a sample of at most this many lanes and timed
# over this many replays (a camera bounce's shadow rays are 10 x 2^20)
FLAGSHIP_SAMPLE_LANES = 131072
FLAGSHIP_TIMING_REPS = 5
# photon-maps: ppm-main's configuration, PHOTON_MAP_ITERS iterations a rep;
# the image mean against the grid's at the JAX package's bars: the hash's
# within 25% (tests/test_ppm.py:93-107), the kd-tree's within 5%
# (tests/test_photon_map.py:167-194)
PHOTON_MAP_ITERS = 2
HASH_MEAN_RTOL = 0.25
KD_MEAN_RTOL = 0.05

# the card's peaks (NVIDIA H100 SXM data sheet, at the 700 W limit): HBM
# bytes/s and FP32 operations/s outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12
# FP32 operations counted per unit of work for the bounds: one
# Moller-Trumbore test (9 + 5 + 1 + 3 + 6 + 9 + 6 + 6 + 1 arithmetic
# operations, comparisons not counted); one child's slab test (6 sub, 6
# mul, 6 min/max per axis pair, 4 for the three-way reductions, 2 against
# tmin/t_best); one photon/vertex pair's distance test (3 sub, 3 mul, 2 add)
MT_FLOPS = 46
SLAB_FLOPS = 24
PAIR_FLOPS = 8

KERNELS = {
    "closest_hit_tris": "oppositerenderer_tpu/accel/pallas_intersect_t.py:56",
    "occluded_tris": "oppositerenderer_tpu/accel/pallas_intersect_t.py:82",
    "gather_photons_tiled": "oppositerenderer_tpu/accel/pallas_gather.py:180",
    "merge_vertices_tiled": "oppositerenderer_tpu/accel/pallas_vm.py:64",
    "traverse": "oppositerenderer_tpu/accel/pallas_bvh.py:55",
    "traverse_any": "oppositerenderer_tpu/accel/pallas_bvh.py:55",
}
KERNEL_SOURCES = {
    "closest_hit_tris": "oppositerenderer_tpu_torch/csrc/intersect.cu",
    "occluded_tris": "oppositerenderer_tpu_torch/csrc/intersect.cu",
    "gather_photons_tiled": "oppositerenderer_tpu_torch/csrc/gather.cu",
    "merge_vertices_tiled": "oppositerenderer_tpu_torch/csrc/vm.cu",
    "traverse": "oppositerenderer_tpu_torch/csrc/bvh.cu",
    "traverse_any": "oppositerenderer_tpu_torch/csrc/bvh.cu",
}


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


def vcm_rays_per_iteration(cfg) -> int:
    """Ray lanes per VCM iteration (bench.py:43-48): light pass trace and
    t=1 shadow rays, camera pass trace, s=1 shadow rays and (L-1) vertex
    connections per bounce."""
    n = cfg.width * cfg.height
    L = cfg.vcm_max_path_length
    return n * (L - 1) * 2 + n * L * (2 + (L - 1))


def ppm_main_config():
    """The JAX bench's PPM case (bench.py:232-235) at 512^2."""
    from oppositerenderer_tpu_torch.config import RenderConfig, RenderMethod
    return RenderConfig(width=MAIN_SIZE, height=MAIN_SIZE,
                        render_method=RenderMethod.PROGRESSIVE_PHOTON_MAPPING,
                        photons_per_iteration=PPM_MAIN_PHOTONS)


def ppm_rays_per_iteration(cfg) -> int:
    """Eye, photon and shadow ray lanes per PPM iteration (bench.py:36-40)."""
    n = cfg.width * cfg.height
    return (n * cfg.max_radiance_trace_depth
            + cfg.photons_per_iteration * cfg.max_photon_trace_depth
            + n * cfg.ppm_direct_shadow_samples)


def pt_rays_per_iteration(cfg) -> int:
    """Closest-hit + shadow ray lanes per PT iteration (bench.py:28-33)."""
    segs = cfg.pt_max_segments
    return cfg.width * cfg.height * (segs + segs * cfg.pt_shadow_samples)


def bound(n_bytes: float, flops: float) -> dict:
    """The least time the card could take for the work: the larger of the
    bytes over the HBM rate and the FP32 operations over the FP32 peak."""
    ms_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    ms_ops = flops / PEAK_FP32_PER_S * 1e3
    return {"bound_ms": max(ms_bytes, ms_ops),
            "bound_by": "bytes" if ms_bytes >= ms_ops else "operations",
            "library_ms": None}


def covered_rows(starts: torch.Tensor, lens: torch.Tensor, n: int) -> int:
    """Distinct rows of [0, n) inside the windows [start, start + len)."""
    s, ln = starts.reshape(-1).long(), lens.reshape(-1).long()
    keep = ln > 0
    diff = torch.zeros(n + 1, dtype=torch.int64, device=starts.device)
    diff.index_add_(0, s[keep], torch.ones_like(s[keep]))
    diff.index_add_(0, (s + ln)[keep].clamp_max(n), -torch.ones_like(s[keep]))
    return int((torch.cumsum(diff, 0)[:n] > 0).sum())


def query_pairs(grid, qpos, radius, starts, lens, valid=None) -> int:
    """Pairs the tile gather (B3) or merge (B4) needs: each query against
    the staged photons or vertices of its tile's windows that lie in its
    own cell box (the cells within ``radius`` of it, as ``_tile_tables``
    computes them); any other staged element is beyond the radius on some
    axis. Queries with ``valid`` False or a non-finite position need
    none."""
    res = grid.resolution
    n, n_tiles = qpos.shape[0], starts.shape[0]
    tile = n // n_tiles
    dev = qpos.device
    ok_q = torch.isfinite(qpos).all(dim=1)
    if valid is not None:
        ok_q = ok_q & valid
    r = torch.broadcast_to(torch.as_tensor(radius, dtype=torch.float32,
                                           device=dev), (n,))
    npos = torch.where(ok_q[:, None], qpos, grid.origin) - grid.origin
    inv = 1.0 / grid.cell_size
    lo = torch.clamp(torch.floor((npos - r[:, None]) * inv), 0,
                     res - 1).long().reshape(n_tiles, tile, 1, 3)
    hi = torch.clamp(torch.floor((npos + r[:, None]) * inv), 0,
                     res - 1).long().reshape(n_tiles, tile, 1, 3)
    offsets = grid.offsets.long()
    s = starts.long()[:, None, :]                      # [tiles, 1, slots]
    e = s + lens.long()[:, None, :]
    # each window lies in one (y, z) row of cells: that of its first element
    cell = torch.searchsorted(offsets, s.contiguous(), right=True) - 1
    y, z = (cell // res) % res, cell // (res * res)
    row = y * res + z * res * res
    in_box = ((y >= lo[..., 1]) & (y <= hi[..., 1]) & (z >= lo[..., 2])
              & (z <= hi[..., 2]) & (e > s) & ok_q.reshape(n_tiles, tile, 1))
    q_s = offsets[(lo[..., 0] + row).clamp(0, res ** 3 - 1)]
    q_e = offsets[(hi[..., 0] + row + 1).clamp(0, res ** 3)]
    overlap = torch.minimum(e, q_e) - torch.maximum(s, q_s)
    return int(torch.where(in_box, overlap.clamp_min(0), 0).sum())


def cuda_ms(fn, reps: int = TIMING_REPS, warmup: int = 3,
            batch: int = LAUNCHES_PER_SAMPLE, graph: bool = True) -> float:
    """Device time of one call of ``fn`` in ms: the median over ``reps``
    samples, each the CUDA-event time of one replay of a CUDA graph that
    holds ``batch`` calls in a row, divided by ``batch``. The graph leaves
    out the host's enqueue of each call (the wrapper's checks and
    allocations), which takes longer than the device's work on the B1 and
    B2 launches of the main paths. With ``graph`` False the ``batch`` calls
    are enqueued from the host, as a caller makes them: the time is the
    host's where the host is slower. Plain versions, which wait on the
    device, are timed so."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(batch):
                fn()
        run = g.replay
    else:
        def run():
            for _ in range(batch):
                fn()
    run()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / batch)
    return statistics.median(times)


# ---------------------------------------------------------------------------
def phase_device() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke: no CUDA device available")
    name = torch.cuda.get_device_name(0)
    print(f"[device] {name}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.device_count()} device(s)")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])   # name, power limit
    # film.save_png needs PIL; scene import will read images
    try:
        import PIL
        pil = PIL.__version__
    except ImportError:
        pil = "absent"
    print(f"[device] PIL {pil}")
    return name


def phase_build() -> None:
    from oppositerenderer_tpu_torch.accel import cuda_build
    path, seconds, log = cuda_build.build_library()
    sources = " ".join(str(src.relative_to(REPO))
                       for src in cuda_build.SOURCES)
    print(f"[build] cache key {cuda_build.cache_key()}: {sources} -> "
          f"{path.relative_to(REPO)} in {seconds:.2f} s (one nvcc "
          f"{' '.join(cuda_build.NVCC_FLAGS)} -c per source, all at once; "
          f"then nvcc {' '.join(cuda_build.LINK_FLAGS)})")
    for line in log.splitlines():
        if any(w in line for w in ("entry function", "registers", "spill",
                                   "error")):
            print(f"[build] {line.strip()}")
    # the host libraries: g++ at first use, as on a user's machine; the
    # numpy and Python fallbacks would build other trees, and slowly
    from oppositerenderer_tpu_torch import native
    for stem in native.STEMS:
        t0 = time.perf_counter()
        if native.load(stem) is None:
            raise RuntimeError(f"g++ could not build native/{stem}.cpp")
        print(f"[build] host library {native.library_path(stem).name} ready "
              f"in {time.perf_counter() - t0:.2f} s (g++ "
              f"{' '.join(native.GXX_FLAGS)})")


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


def _max_abs(a: torch.Tensor, b: torch.Tensor, mask: torch.Tensor) -> float:
    if not bool(mask.any()):
        return 0.0
    return float((a[mask].double() - b[mask].double()).abs().max())


def phase_kernels(dev) -> dict:
    from oppositerenderer_tpu_torch.accel import intersect_kernels as ik
    from oppositerenderer_tpu_torch.accel.intersect import dense_tables
    from oppositerenderer_tpu_torch.scene import get_scene_by_name

    def scene_case(name):
        scene, _ = get_scene_by_name(name, dev)
        return (*dense_tables(scene), scene.aabb_min.tolist(),
                scene.aabb_max.tolist())

    soup9 = soup_tri9(dev)
    rng = np.random.default_rng(4097)
    soup_occ = ik.triangle_records(soup9, torch.as_tensor(
        rng.random(SOUP_TRIS) < 0.9, device=dev))
    n_main = MAIN_SIZE * MAIN_SIZE
    cases = [
        ("CornellSmall", n_main, *scene_case("CornellSmall")),
        ("CornellSmallLargeSphere", n_main,
         *scene_case("CornellSmallLargeSphere")),
        ("soup4096", n_main, ik.triangle_records(soup9), soup_occ,
         *SOUP_BOX),
        ("CornellSmall", 131, *scene_case("CornellSmall")),
    ]
    out = {name: {"max_abs_err": 0.0} for name in KERNELS}
    for i, (name, n, tris, occ_tab, lo, hi) in enumerate(cases):
        o, d, tmin, tmax = _rays(n, 100 + i, lo, hi, dev)
        got = ik.closest_hit_tris(o, d, tmin, tmax, tris)
        want = ik.closest_hit_tris_plain(o, d, tmin, tmax, tris)
        hit = want[1] >= 0
        err = max(_max_abs(got[k], want[k], hit) for k in (0, 2, 3))
        for label, a, b in zip(("t", "idx", "u", "v"), got, want):
            if _bits_differ(a, b):
                raise AssertionError(
                    f"closest_hit_tris differs from its plain version on "
                    f"{name} n={n}: {label} differs in {_bits_differ(a, b)} "
                    f"rays (max |err| on hits {err:.3g})")
        occ = ik.occluded_tris(o, d, tmin, tmax, occ_tab)
        occ_plain = ik.occluded_tris_plain(o, d, tmin, tmax, occ_tab)
        if not torch.equal(occ, occ_plain):
            raise AssertionError(
                f"occluded_tris differs from its plain version on {name} "
                f"n={n} in {int((occ != occ_plain).sum())} rays")
        out["closest_hit_tris"]["max_abs_err"] = max(
            out["closest_hit_tris"]["max_abs_err"], err)
        timing = ""
        if name == MAIN_SCENE and n == n_main:   # the main path's shape
            out["closest_hit_tris"].update(dense_bound(o, d, tmin, tmax,
                                                       tris, False))
            out["occluded_tris"].update(dense_bound(o, d, tmin, tmax,
                                                    occ_tab, True))
        if n == n_main:
            ms = {
                "closest_hit_tris": (
                    cuda_ms(lambda: ik.closest_hit_tris(o, d, tmin, tmax,
                                                        tris)),
                    cuda_ms(lambda: ik.closest_hit_tris_plain(o, d, tmin,
                                                              tmax, tris),
                            batch=1, graph=False)),
                "occluded_tris": (
                    cuda_ms(lambda: ik.occluded_tris(o, d, tmin, tmax,
                                                     occ_tab)),
                    cuda_ms(lambda: ik.occluded_tris_plain(
                        o, d, tmin, tmax, occ_tab), batch=1, graph=False))}
            timing = "; ms kernel/plain " + ", ".join(
                f"{k} {a:.4f}/{b:.4f}" for k, (a, b) in ms.items())
            if name == MAIN_SCENE:   # the main path's shape
                for k, (a, b) in ms.items():
                    out[k].update(ms=a, plain_ms=b)
            else:
                for k, (a, b) in ms.items():
                    out[k][name] = {"ms": a, "plain_ms": b}
        print(f"[kernels] {name} rays={n} tris={tris.shape[0]} occluders="
              f"{occ_tab.shape[0]}: equal to plain bit for bit (hits "
              f"{int(hit.sum())}, occluded {int(occ.sum())}){timing}")
    for k, v in dense_lane_cases(dev, soup9).items():
        out[k]["lane_cases"] = v
    out["closest_hit_tris"]["per_iteration"] = b1_iterations(dev)
    out["occluded_tris"]["per_iteration"] = {
        f"{MAIN_SCENE} {MAIN_SIZE}^2 VCM": b2_vcm_iteration(dev)}
    out["gather_photons_tiled"] = gather_kernel_cases(dev)
    out["merge_vertices_tiled"] = vm_kernel_cases(dev)
    out.update(bvh_kernel_cases(dev))
    return out


def soup_tri9(dev, n_tris: int = SOUP_TRIS) -> torch.Tensor:
    """[9, n_tris]: the random triangle soup of the kernels phase (v0 in
    SOUP_BOX, edges normal with sigma 0.5), from a numpy seed."""
    rng = np.random.default_rng(4096)
    v0 = rng.uniform(0.0, 10.0, (n_tris, 3))
    e1 = rng.normal(0.0, 0.5, (n_tris, 3))
    e2 = rng.normal(0.0, 0.5, (n_tris, 3))
    return torch.as_tensor(np.concatenate([v0.T, e1.T, e2.T]).astype(
        np.float32), device=dev).contiguous()


def dense_lane_cases(dev, soup9) -> dict:
    """B1 and B2 bit for bit against their plain versions on the first 32
    and the 4096 triangles of the soup (every one an occluder for B2),
    with a mix of dead and live lanes, all lanes dead and all live; each
    one's time against its bound. Returns {kernel: {"T=.. kind": ...}}."""
    from oppositerenderer_tpu_torch.accel import intersect_kernels as ik
    n = MAIN_SIZE * MAIN_SIZE
    kernels = (("closest_hit_tris", ik.closest_hit_tris,
                ik.closest_hit_tris_plain),
               ("occluded_tris", ik.occluded_tris, ik.occluded_tris_plain))
    out = {name: {} for name, _, _ in kernels}
    for T in (32, SOUP_TRIS):
        tab = ik.triangle_records(soup9[:, :T].contiguous())
        rays = _rays(n, 200 + T, *SOUP_BOX, dev)
        for kind, (o, d, tmin, tmax) in (
                ("mixed", rays), ("all dead", dead_or_live(rays, False)),
                ("all live", dead_or_live(rays, True))):
            live = int((tmax > tmin).sum())
            for name, fn, plain in kernels:
                got, want = fn(o, d, tmin, tmax, tab), plain(o, d, tmin,
                                                             tmax, tab)
                if name == "occluded_tris":
                    got, want = (got,), (want,)
                bad = sum(_bits_differ(a, b) for a, b in zip(got, want))
                if bad:
                    raise AssertionError(
                        f"{name} differs from its plain version on T={T} "
                        f"{kind} in {bad} values")
                ms = cuda_ms(lambda: fn(o, d, tmin, tmax, tab))
                b = dense_bound(o, d, tmin, tmax, tab,
                                name == "occluded_tris")
                found = int((got[1] >= 0).sum() if len(got) > 1
                            else got[0].sum())
                out[name][f"T={T} {kind}"] = {
                    "live": live, "found": found, "ms": ms,
                    "bound_ms": b["bound_ms"], "bound_by": b["bound_by"]}
                print(f"[kernels] {name} T={T} {kind}: rays={n} live {live}, "
                      f"found {found}; equal bit for bit; ms kernel "
                      f"{ms:.4f}, bound {b['bound_ms']:.4f} "
                      f"({b['bound_by']})")
    return out


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
    try:
        Renderer(scene, cam, cfg, seed=0).compute_iteration(0)
    finally:
        for k, w in wrappers.items():
            setattr(isect, k, w)
    return calls


def closest_hit_calls(dev, method: str):
    """Every call of B1's wrapper in one CornellSmall 512^2 iteration of
    ``method`` ("PT" with the default RenderConfig, "PPM" with 1<<20
    photons, "VCM" with L = 10: the main phases' configurations), each
    (o, d, tmin, tmax, tris). PT calls it once a segment, PPM once an eye
    and once a photon bounce, VCM once a light and a camera bounce."""
    from oppositerenderer_tpu_torch.config import RenderConfig
    from oppositerenderer_tpu_torch.scene import get_scene_by_name
    cfg = {"PT": lambda: RenderConfig(width=MAIN_SIZE, height=MAIN_SIZE),
           "PPM": ppm_main_config, "VCM": vcm_main_config}[method]()
    want = {"PT": cfg.pt_max_segments,
            "PPM": cfg.max_radiance_trace_depth + cfg.max_photon_trace_depth,
            "VCM": 2 * cfg.vcm_max_path_length - 1}[method]
    scene, cam = get_scene_by_name(MAIN_SCENE, dev)
    calls = iteration_calls(scene, cam, cfg,
                            ("closest_hit_tris",))["closest_hit_tris"]
    if len(calls) != want:
        raise AssertionError(f"{len(calls)} closest-hit calls in one "
                             f"{method} iteration, expected {want}")
    return calls


def b1_iterations(dev) -> dict:
    """B1 on every closest-hit call of one CornellSmall 512^2 PT, PPM and
    VCM iteration: bit for bit against its plain version, each call timed
    against its live lanes and its bound; the sums are B1's time and bound
    per iteration."""
    from oppositerenderer_tpu_torch.accel import intersect_kernels as ik
    out = {}
    for method in ("PT", "PPM", "VCM"):
        it = {"calls": 0, "lanes": 0, "live": 0, "ms": 0.0, "bound_ms": 0.0}
        for i, (o, d, tmin, tmax, tris) in enumerate(
                closest_hit_calls(dev, method)):
            got = ik.closest_hit_tris(o, d, tmin, tmax, tris)
            want = ik.closest_hit_tris_plain(o, d, tmin, tmax, tris)
            bad = sum(_bits_differ(a, b) for a, b in zip(got, want))
            if bad:
                raise AssertionError(
                    f"closest_hit_tris differs from its plain version on "
                    f"{method} call {i} in {bad} values")
            ms = cuda_ms(lambda: ik.closest_hit_tris(o, d, tmin, tmax, tris))
            b = dense_bound(o, d, tmin, tmax, tris, False)
            n, live = o.shape[0], int((tmax > tmin).sum())
            it["calls"] += 1
            it["lanes"] += n
            it["live"] += live
            it["ms"] += ms
            it["bound_ms"] += b["bound_ms"]
            print(f"[kernels] B1 {MAIN_SCENE} {MAIN_SIZE}^2 {method} call "
                  f"{i}: lanes {n}, live {live} ({live / n:.4f}), hits "
                  f"{int((got[1] >= 0).sum())}; equal bit for bit; ms "
                  f"kernel {ms:.4f}, bound {b['bound_ms']:.4f} "
                  f"({b['bound_by']})")
        print(f"[kernels] B1 per {MAIN_SCENE} {MAIN_SIZE}^2 {method} "
              f"iteration: {it['calls']} launches {it['ms']:.4f} ms over "
              f"{it['lanes']} lanes ({it['live']} live); bound "
              f"{it['bound_ms']:.4f} ms")
        out[f"{MAIN_SCENE} {MAIN_SIZE}^2 {method}"] = it
    return out


def vcm_shadow_calls(dev):
    """Every call of B2's wrapper in one CornellSmall 512^2 VCM iteration
    (the bench's VCM configuration, L = 10): the t=1 splats' shadow rays
    of each light bounce, then each camera bounce's batch of its s=1 and
    vertex-connection shadow rays. Returns (cfg, [(o, d, tmin, tmax,
    occ)] in call order)."""
    from oppositerenderer_tpu_torch.scene import get_scene_by_name
    scene, cam = get_scene_by_name(MAIN_SCENE, dev)
    cfg = vcm_main_config()
    calls = iteration_calls(scene, cam, cfg,
                            ("occluded_tris",))["occluded_tris"]
    L = cfg.vcm_max_path_length
    if len(calls) != (L - 1) + L:
        raise AssertionError(f"{len(calls)} shadow-ray calls in one VCM "
                             f"iteration, expected {(L - 1) + L}")
    return cfg, calls


def b2_vcm_iteration(dev) -> dict:
    """B2 on every shadow-ray call of one CornellSmall 512^2 VCM iteration:
    bit for bit against its plain version, each call timed against its
    live lanes and its bound; the sums are B2's time and bound per VCM
    iteration."""
    from oppositerenderer_tpu_torch.accel import intersect_kernels as ik
    _, calls = vcm_shadow_calls(dev)
    it = {"calls": 0, "lanes": 0, "live": 0, "ms": 0.0, "bound_ms": 0.0}
    for i, (o, d, tmin, tmax, occ_tab) in enumerate(calls):
        got = ik.occluded_tris(o, d, tmin, tmax, occ_tab)
        want = ik.occluded_tris_plain(o, d, tmin, tmax, occ_tab)
        if not torch.equal(got, want):
            raise AssertionError(
                f"occluded_tris differs from its plain version on VCM "
                f"shadow-ray call {i} in {int((got != want).sum())} rays")
        ms = cuda_ms(lambda: ik.occluded_tris(o, d, tmin, tmax, occ_tab))
        b = dense_bound(o, d, tmin, tmax, occ_tab, True)
        n, live = o.shape[0], int((tmax > tmin).sum())
        it["calls"] += 1
        it["lanes"] += n
        it["live"] += live
        it["ms"] += ms
        it["bound_ms"] += b["bound_ms"]
        print(f"[kernels] B2 {MAIN_SCENE} {MAIN_SIZE}^2 VCM shadow call {i}: "
              f"lanes {n}, live {live} ({live / n:.4f}), occluded "
              f"{int(got.sum())}; equal bit for bit; ms kernel {ms:.4f}, "
              f"bound {b['bound_ms']:.4f} ({b['bound_by']})")
    print(f"[kernels] B2 per {MAIN_SCENE} {MAIN_SIZE}^2 VCM iteration: "
          f"{it['calls']} launches {it['ms']:.4f} ms over {it['lanes']} "
          f"lanes ({it['live']} live); bound {it['bound_ms']:.4f} ms")
    return it


def _first_blocker(o, d, tmin, tmax, tab, chunk=16384):
    """Per ray, the tests any hit makes over the record table ``tab`` in
    order: up to and including its first hit, all of them on a miss, none
    on a dead lane (the plain version's arithmetic, in chunks of rays)."""
    from oppositerenderer_tpu_torch.accel import intersect_kernels as ik
    T = tab.shape[0]
    parts = []
    for s in range(0, o.shape[0], chunk):
        sl = slice(s, s + chunk)
        *_, valid = ik._mt_terms(o[sl], d[sl], tmin[sl], tmax[sl], tab)
        first = torch.where(valid.any(dim=1),
                            valid.int().argmax(dim=1) + 1, T)
        parts.append(torch.where(tmax[sl] > tmin[sl], first, 0))
    return torch.cat(parts)


def dense_bound(o, d, tmin, tmax, tab, any_hit: bool) -> dict:
    """B1's (``any_hit`` False) or B2's bound on these rays against the
    record table ``tab``: every lane's tmin, tmax and outputs (B1's four,
    16 bytes; B2's flag), the live lanes' o and d and the table's 48 bytes
    a triangle cross HBM once; B1's live rays test every triangle, B2's
    the occluders up to their first hit."""
    n, T = o.shape[0], tab.shape[0]
    live = int((tmax > tmin).sum())
    if any_hit:
        tests, out_bytes = int(_first_blocker(o, d, tmin, tmax, tab).sum()), 1
    else:
        tests, out_bytes = live * T, 16
    return bound(n * (8 + out_bytes) + live * 24 + T * 48, tests * MT_FLOPS)


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
    try:
        r.compute_iteration(0)
    finally:
        ppm.gather_photons_tiled = gather
    (call,) = calls
    return call


def gather_kernel_cases(dev) -> dict:
    """B3 against its plain version on the card, with check_normal on and
    off: the synthetic case, its clustered variant and the PPM main shape.
    The tables (and so the stats) computed on the card must equal those
    computed on the CPU, and the kernel's sums the plain version's within
    GATHER_RTOL + GATHER_ATOL_REL * max|ref|. The PPM main shape with
    check_normal on, the main path's call, is timed and bounded."""
    from oppositerenderer_tpu_torch.accel import gather_kernels as gk
    rng = np.random.default_rng(17)
    inputs = [("synthetic", *gather_case(dev),
               torch.zeros((2, gk.ROWS + 2), device=dev), None)]
    grid, q, qn, r = gather_case(dev, n_photons=8192, cluster=True,
                                 radius=0.2)
    inputs.append(("clustered", grid, q, qn, r, torch.as_tensor(
        rng.uniform(size=(2, gk.ROWS + 2)).astype(np.float32), device=dev),
        None))
    inputs.append((f"{MAIN_SCENE} {MAIN_SIZE}^2 PPM",
                   *ppm_gather_inputs(dev)))

    out = {"max_abs_err": 0.0}
    for label, grid, q, qn, r, u, valid in inputs:
        tables = gk._tile_tables(grid, q, r, u, valid)
        cpu_tables = gk._tile_tables(
            _to(grid, "cpu"), q.cpu(), r.cpu() if torch.is_tensor(r) else r,
            u.cpu(), None if valid is None else valid.cpu())
        for name, a, b in zip(("starts", "lens", "weights", "visited",
                               "total", "rows"), tables, cpu_tables):
            if not torch.equal(a.cpu(), b):
                raise AssertionError(f"B3 {label}: the card's {name} table "
                                     "differs from the CPU's")
        starts, lens, weights, visited, total, rows = tables
        r2 = torch.square(torch.as_tensor(r, dtype=torch.float32,
                                          device=dev))
        for check_normal in (True, False):
            args = (starts, lens, weights, rows, r2, q, qn, grid,
                    check_normal)
            got = gk.gather_photons_tiled_kernel(*args)
            want = gk.gather_photons_tiled_plain(*args)
            torch.cuda.synchronize()
            err = (got.double() - want.double()).abs()
            scale = float(want.abs().max())
            bad = int((err > GATHER_RTOL * want.double().abs()
                       + GATHER_ATOL_REL * scale).sum())
            max_err = float(err.max())
            if bad or not bool(torch.isfinite(got).all()) or scale <= 0.0:
                raise AssertionError(
                    f"B3 differs from its plain version on {label} "
                    f"check_normal={check_normal}: {bad} sums outside the "
                    f"tolerance, max |err| {max_err:.3g} (max |ref| "
                    f"{scale:.3g})")
            out["max_abs_err"] = max(out["max_abs_err"], max_err)
            timing = ""
            if valid is not None and check_normal:   # the main path's call
                # each query against the staged photons in its own cell
                # box; the photons in the windows, the queries, tables and
                # sums cross HBM once
                n_q, n_p = q.shape[0], grid.position.shape[0]
                pairs = query_pairs(grid, q, r, starts, lens)
                k0, k1 = gk.culled_windows_plain(grid, q, r2, starts, lens,
                                                 rows)
                out.update(bound(
                    covered_rows(starts, lens, n_p) * 36 + n_q * (24 + 12)
                    + starts.numel() * 16, pairs * PAIR_FLOPS))
                timing = (f"; pairs needed {pairs}, walked "
                          f"{int((k1 - k0).sum())} of "
                          f"{int(lens.long().sum()) * gk.TILE} staged")
                out["ms"] = cuda_ms(
                    lambda: gk.gather_photons_tiled_kernel(*args))
                out["plain_ms"] = cuda_ms(
                    lambda: gk.gather_photons_tiled_plain(*args),
                    reps=PLAIN_GATHER_REPS, warmup=1, batch=1, graph=False)
                timing += (f"; ms kernel {out['ms']:.4f} (median of "
                           f"{TIMING_REPS}) / plain {out['plain_ms']:.4f} "
                           f"(median of {PLAIN_GATHER_REPS}), bound "
                           f"{out['bound_ms']:.4f} ({out['bound_by']})")
            print(f"[kernels] B3 {label} check_normal={check_normal}: "
                  f"queries={q.shape[0]} photons={grid.position.shape[0]} "
                  f"(valid {int(grid.n_valid)}), visited "
                  f"{int(visited.sum())}, subsampled "
                  f"{int((total - visited).clamp_min(0).sum())}; stats "
                  f"equal, sums within tolerance (max |err| {max_err:.3g}, "
                  f"max |ref| {scale:.4g}){timing}")
    return out


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


def vcm_merge_inputs(dev):
    """The merge's inputs at every camera bounce of one CornellSmall 512^2
    VCM+VM iteration (iteration 0, seed 0, the bench's VCM+VM
    configuration), recorded where ``integrators/vcm._merge_vertices``
    calls the tile merge. Returns (cfg, [kwargs with ``u_rows``] in call
    order)."""
    from oppositerenderer_tpu_torch.integrators import vcm
    from oppositerenderer_tpu_torch.renderer import Renderer
    from oppositerenderer_tpu_torch.scene import get_scene_by_name

    scene, cam = get_scene_by_name(MAIN_SCENE, dev)
    cfg = vcm_main_config(use_vm=True)
    r = Renderer(scene, cam, cfg, seed=0)
    calls = []
    merge = vcm.merge_vertices_tiled

    def record(vgrid, cfg, cam_bsdf, cam_pos, cam_thr, cam_dVCM, cam_dVM,
               active, radius_sq, mis_vc_w, n_light_paths, u_rows, depth1):
        calls.append(dict(
            vgrid=vgrid, cam_bsdf=cam_bsdf, cam_pos=cam_pos,
            cam_thr=cam_thr, cam_dVCM=cam_dVCM, cam_dVM=cam_dVM,
            active=active, radius_sq=radius_sq, mis_vc_w=mis_vc_w,
            n_light_paths=n_light_paths, u_rows=u_rows, depth1=depth1))
        return merge(vgrid, cfg, cam_bsdf, cam_pos, cam_thr, cam_dVCM,
                     cam_dVM, active, radius_sq, mis_vc_w, n_light_paths,
                     u_rows, depth1)

    vcm.merge_vertices_tiled = record
    try:
        r.compute_iteration(0)
    finally:
        vcm.merge_vertices_tiled = merge
    if len(calls) != cfg.vcm_max_path_length:
        raise AssertionError(f"{len(calls)} merge rounds in one VCM+VM "
                             f"iteration, expected {cfg.vcm_max_path_length}")
    return cfg, calls


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


def vm_bound(k, args) -> tuple[dict, int]:
    """B4's bound on one merge round, and the pairs it needs: each valid
    query (a 128-byte table row, two float3 sums out) against the staged
    vertices (52 bytes of fields) in its own cell box; the slot tables
    (16 bytes a slot) once."""
    starts, lens, _, _, scal, qtab, vgrid = args
    pairs = query_pairs(k["vgrid"], qtab[:, 0:3], torch.sqrt(scal[0]),
                        starts, lens, qtab[:, 24] > 0.5)
    n_v = vgrid.packed.shape[0]
    return bound(covered_rows(starts, lens, n_v) * 52
                 + qtab.shape[0] * (128 + 24) + starts.numel() * 16,
                 pairs * PAIR_FLOPS), pairs


def vm_kernel_cases(dev) -> dict:
    """B4 against its plain version on the card: the query order and slot
    tables computed on the card must equal those computed on the CPU, and
    each of the kernel's two sums the plain version's within VM_RTOL +
    VM_ATOL_REL * max|ref|; on the synthetic cases and on every merge
    round of one CornellSmall 512^2 VCM+VM iteration. The second bounce is
    the timed shape (against the plain version too); every round is timed,
    and the sum is the kernel's time per iteration."""
    from oppositerenderer_tpu_torch.accel import vm_kernels as vk
    cases = []
    for label, cluster in (("synthetic", False), ("clustered", True)):
        _, cfg, k = vm_case(dev, 0, cluster)
        n = k["cam_pos"].shape[0]
        k["u_rows"] = k.pop("u_stride").reshape(n // vk.TILE, vk.TILE)[
            :, :vk.ROWS + 2]
        cases.append((label, cfg, k))
    cfg, rounds = vcm_merge_inputs(dev)
    cases += [(f"{MAIN_SCENE} {MAIN_SIZE}^2 VCM+VM bounce {k['depth1']}",
               cfg, k) for k in rounds]

    def tables(cfg, k):
        return vk.merge_tables(
            k["vgrid"], cfg, k["cam_bsdf"], k["cam_pos"], k["cam_dVCM"],
            k["cam_dVM"], k["active"], k["radius_sq"], k["mis_vc_w"],
            k["u_rows"], k["depth1"])

    out = {"max_abs_err": 0.0}
    it = {"calls": 0, "ms": 0.0, "bound_ms": 0.0, "pairs": 0, "staged": 0}
    for label, cfg, k in cases:
        order, args, _, _ = tables(cfg, k)
        cpu_order, cpu_args, _, _ = tables(cfg, _to(k, "cpu"))
        for name, a, b in (("order", order, cpu_order),
                           *zip(("starts", "lens", "weights", "rows"),
                                args[:4], cpu_args[:4])):
            if not torch.equal(a.cpu(), b):
                raise AssertionError(f"B4 {label}: the card's {name} "
                                     "differs from the CPU's")
        got = vk.merge_vertices_tiled_kernel(*args)
        want = vk.merge_vertices_tiled_plain(*args)
        torch.cuda.synchronize()
        errs, scales = [], []
        for which, g, w in zip(("out1", "out2"), got, want):
            err = (g.double() - w.double()).abs()
            scale = float(w.abs().max())
            bad = int((err > VM_RTOL * w.double().abs()
                       + VM_ATOL_REL * scale).sum())
            if bad or not bool(torch.isfinite(g).all()):
                raise AssertionError(
                    f"B4 {which} differs from its plain version on {label}:"
                    f" {bad} sums outside the tolerance, max |err| "
                    f"{float(err.max()):.3g} (max |ref| {scale:.3g})")
            errs.append(float(err.max()))
            scales.append(scale)
        if label.startswith(("synthetic", "clustered")) and scales[0] <= 0.0:
            raise AssertionError(f"B4 {label}: no merge energy")
        out["max_abs_err"] = max(out["max_abs_err"], *errs)
        lens, qtab = args[1], args[5]
        timing = ""
        if "VCM+VM" in label:   # the main path's rounds
            b, pairs = vm_bound(k, args)
            ms = cuda_ms(lambda: vk.merge_vertices_tiled_kernel(*args))
            staged = int(lens.long().sum()) * vk.TILE
            it["calls"] += 1
            it["ms"] += ms
            it["bound_ms"] += b["bound_ms"]
            it["pairs"] += pairs
            it["staged"] += staged
            timing = (f"; pairs needed {pairs} of {staged} staged; ms kernel "
                      f"{ms:.4f} (median of {TIMING_REPS}), bound "
                      f"{b['bound_ms']:.4f} ({b['bound_by']})")
            if k["depth1"] == 2:   # the timed shape of earlier PRs
                out.update(b)
                out["ms"] = ms
                out["plain_ms"] = cuda_ms(
                    lambda: vk.merge_vertices_tiled_plain(*args),
                    reps=PLAIN_VM_REPS, warmup=1, batch=1, graph=False)
                timing += (f" / plain {out['plain_ms']:.4f} (median of "
                           f"{PLAIN_VM_REPS})")
        print(f"[kernels] B4 {label}: queries={qtab.shape[0]} (valid "
              f"{int((qtab[:, 24] > 0.5).sum())}) vertices="
              f"{args[6].packed.shape[0]}, staged {int(lens.sum())}, slots "
              f"subsampled {int((args[2] > 1.0).sum())}; tables equal, sums "
              f"within tolerance (max |err| out1 {errs[0]:.3g} of "
              f"{scales[0]:.4g}, out2 {errs[1]:.3g} of {scales[1]:.4g})"
              f"{timing}")
    # the packed records, built once per grid: its fields read, the
    # records written
    g = rounds[0]["vgrid"]
    fields = {f: getattr(g, f) for f in vk.VERTEX_FIELDS}
    cell = g.packed[:, 13].long()   # the x cells: a stand-in of the same size
    pack_ms = cuda_ms(lambda: vk.pack_vertex_records(
        **fields, cell=cell, resolution=g.resolution))
    pack_b = bound(g.packed.shape[0] * (52 + 4 * vk.RECORD), 0)
    it.update(pack_ms=pack_ms, pack_bound_ms=pack_b["bound_ms"])
    it["bound_ms"] += pack_b["bound_ms"]
    out["per_iteration"] = {f"{MAIN_SCENE} {MAIN_SIZE}^2 VCM+VM": it}
    print(f"[kernels] B4 per VCM+VM iteration: {it['calls']} launches "
          f"{it['ms']:.4f} ms, packing the grid {pack_ms:.4f} ms; bound "
          f"{it['bound_ms']:.4f} ms (packing {pack_b['bound_ms']:.4f}); "
          f"pairs needed {it['pairs']} of {it['staged']} staged")
    return out


def _bits_differ(a: torch.Tensor, b: torch.Tensor) -> int:
    """Lanes whose values differ bit for bit (float32 compared as int32)."""
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return int((a != b).sum())


def pt_traversal_calls(scene, cam, size: int):
    """The traversal calls of one PT iteration of a BVH scene at size^2
    (the default RenderConfig): (closest-hit inputs, any-hit inputs), each
    a list of (bvh, o, d, tmin, tmax) per call."""
    from oppositerenderer_tpu_torch.config import RenderConfig
    calls = iteration_calls(scene, cam, RenderConfig(width=size, height=size),
                            ("traverse", "traverse_any"))
    return ([c[1:] for c in calls["traverse"]],
            [c[1:] for c in calls["traverse_any"]])


def bvh_bound(bvh, n: int, any_hit: bool, visits, row_floats) -> dict:
    """B5's bound on one call from the plain version's counts: the rays and
    results cross HBM once, and so do the floats of each row that some ray
    read and whose traversal uses them; the slab tests of the children in
    ``cmask & valid`` of each inner visit and the triangles each ray
    tested (any hit: the flagged ones up to its first hit)."""
    return bound(n * (32 + (1 if any_hit else 17))
                 + 4 * int(row_floats.sum()),
                 float(visits[:, 2].sum()) * SLAB_FLOPS
                 + float(visits[:, 3].sum()) * MT_FLOPS)


def dead_or_live(rays, live: bool):
    """The same rays with every lane dead (tmax = tmin, or below it) or
    every lane live (the dead ones unbounded)."""
    o, d, tmin, tmax = rays
    if live:
        return o, d, tmin, torch.where(tmax > tmin, tmax, 1e30)
    odd = torch.arange(tmax.shape[0], device=tmax.device) % 2 == 1
    return o, d, tmin, torch.where(odd, tmin - 1.0, tmin)


def bvh_kernel_cases(dev) -> dict:
    """B5 (closest and any hit) against its plain version on the card, bit
    for bit: random rays in full Atrium's box (a quarter dead, then all
    dead and all live), every traversal call of one Atrium 512^2 and one
    Conference 1024^2 PT iteration (each scene's full table at its main
    path's lane count), and random rays in CornellSmall with a BVH; on
    every input the live-lane compaction finds the lanes its plain version
    finds. The timed and bounded shapes are Atrium's main path's: its
    primary rays and first shadow rays; every call of both iterations is
    timed, and the sums are the kernels' times per iteration."""
    from oppositerenderer_tpu_torch.accel import bvh_kernels as bk
    from oppositerenderer_tpu_torch.accel.bvh import build_scene_bvh
    from oppositerenderer_tpu_torch.scene import get_scene_by_name

    cornell, _ = get_scene_by_name(MAIN_SCENE, dev)
    cornell_b, cbvh = build_scene_bvh(cornell)
    cases = []
    for name, size, key in (("Atrium", ATRIUM_SIZE, True),
                            ("Conference", CONFERENCE_SIZE, False)):
        scene, cam = get_scene_by_name(name, dev)
        closest_calls, any_calls = pt_traversal_calls(scene, cam, size)
        it = f"{name} {size}^2"
        if name == "Atrium":
            rays = _rays(65536, 300, scene.aabb_min.tolist(),
                         scene.aabb_max.tolist(), dev)
            cases += [("Atrium random", scene.bvh, rays, None, False, None),
                      ("Atrium random all dead", scene.bvh,
                       dead_or_live(rays, False), None, False, None),
                      ("Atrium random all live", scene.bvh,
                       dead_or_live(rays, True), None, False, None)]
        cases += [(f"{it} PT segment {i} closest", scene.bvh, list(c),
                   "traverse" if i == 0 else None, key, it)
                  for i, c in enumerate(closest_calls)]
        cases += [(f"{it} PT segment {i} shadow", scene.bvh, list(c),
                   "traverse_any" if i == 0 else None, key, it)
                  for i, c in enumerate(any_calls)]
    cases.append((f"{MAIN_SCENE} with a BVH random", cbvh,
                  _rays(MAIN_SIZE * MAIN_SIZE, 301, cornell.aabb_min.tolist(),
                        cornell.aabb_max.tolist(), dev), None, False, None))
    out = {"traverse": {"max_abs_err": 0.0, "per_iteration": {}},
           "traverse_any": {"max_abs_err": 0.0, "per_iteration": {}}}
    for label, bvh, (o, d, tmin, tmax), timed, key, it in cases:
        n = o.shape[0]
        got_c = bk.compact_live(tmin, tmax)
        want_c = bk.compact_live_plain(tmin, tmax)
        if not all(torch.equal(a, b) for a, b in zip(got_c, want_c)):
            raise AssertionError(f"B5's live-lane compaction differs from "
                                 f"its plain version on {label}")
        c = int(want_c[1].sum())
        kinds = ("traverse_any",) if "shadow" in label else (
            ("traverse",) if "closest" in label else ("traverse",
                                                      "traverse_any"))
        lines = []
        for k in kinds:
            any_hit = k == "traverse_any"
            got = getattr(bk, k)(bvh, o, d, tmin, tmax)
            torch.cuda.synchronize()
            t, prim, u, v, found, visits, row_floats = bk.plain_traversal(
                bvh, o, d, tmin, tmax, any_hit)
            want = found if any_hit else (t, prim, u, v, found)
            pairs = ([("found", got, want)] if any_hit else
                     list(zip(("t", "prim", "u", "v", "found"), got, want)))
            for field, a, b in pairs:
                bad = _bits_differ(a, b)
                if bad:
                    raise AssertionError(
                        f"B5 {k} differs from its plain version on {label}:"
                        f" {field} differs in {bad} of {n} rays")
            live = tmax > tmin
            vis = visits[live].double() if c else torch.zeros((1, 4))
            b = bvh_bound(bvh, n, any_hit, visits, row_floats)
            line = (f"{k}: equal bit for bit ({int(found.sum())} of "
                    f"{int(live.sum())} live rays {'blocked' if any_hit else 'hit'}); "
                    f"per live ray: inner rows {float(vis[:, 0].mean()):.3f}, "
                    f"leaf rows {float(vis[:, 1].mean()):.3f}, slab tests "
                    f"{float(vis[:, 2].mean()):.3f}, triangle tests "
                    f"{float(vis[:, 3].mean()):.3f}; "
                    f"{int((row_floats > 0).sum())} of {bvh.rows.shape[0]} "
                    f"rows read, {4 * int(row_floats.sum())} bytes of them "
                    f"used; bound {b['bound_ms']:.4f} ms ({b['bound_by']})")
            if it is not None:   # a call of a main path's iteration
                fn = getattr(bk, k)
                ms = cuda_ms(lambda: fn(bvh, o, d, tmin, tmax))
                line += f"; ms kernel {ms:.4f} (median of {TIMING_REPS})"
                acc = out[k]["per_iteration"].setdefault(
                    it, {"calls": 0, "ms": 0.0, "bound_ms": 0.0})
                acc["calls"] += 1
                acc["ms"] += ms
                acc["bound_ms"] += b["bound_ms"]
                if timed == k and key:
                    plain = bk.traverse_any_plain if any_hit else \
                        bk.traverse_plain
                    out[k].update(b)
                    out[k]["ms"] = ms
                    out[k]["plain_ms"] = cuda_ms(
                        lambda: plain(bvh, o, d, tmin, tmax),
                        reps=PLAIN_BVH_REPS, warmup=1, batch=1, graph=False)
                    line += (f" / plain {out[k]['plain_ms']:.4f} (median of "
                             f"{PLAIN_BVH_REPS})")
            lines.append(line)
        print(f"[kernels] B5 {label}: rays={n}; " + "; ".join(lines))
    for k in ("traverse", "traverse_any"):
        for it, acc in out[k]["per_iteration"].items():
            print(f"[kernels] B5 {k} per {it} PT iteration: {acc['calls']} "
                  f"launches {acc['ms']:.4f} ms, bound {acc['bound_ms']:.4f}"
                  " ms")
    return out


def golden_agreement(img: np.ndarray, want: np.ndarray):
    """(pixels outside the golden tolerance, worst pixel's error as a
    multiple of its tolerance, relative error of the image mean)."""
    atol = GOLDEN_RTOL * max(float(want.mean()), 0.01)
    ratio = np.abs(img - want) / (atol + GOLDEN_RTOL * np.abs(want))
    return (int((ratio > 1.0).any(axis=-1).sum()), float(ratio.max()),
            abs(float(img.mean()) / float(want.mean()) - 1.0))


def phase_goldens(dev, with_bvh: bool = False) -> None:
    """A last-ulp difference in a ray (the port's float arithmetic is not
    XLA's) can flip a path's decision where two surfaces almost touch:
    Cornell's light lies within two float32 ulps of its ceiling. Such a
    flip moves one pixel far beyond the golden tolerance and the image
    mean by ~1e-4, so each scene must keep all but GOLDEN_MAX_FLIPPED of
    its pixels within the golden tolerance and its mean within
    GOLDEN_MEAN_RTOL. ``with_bvh`` attaches a BVH to each scene first
    (phase bvh-goldens): B5 must run and B1/B2 must not."""
    import dataclasses as dc

    from oppositerenderer_tpu_torch.accel import bvh_kernels as bk
    from oppositerenderer_tpu_torch.accel import intersect_kernels as ik
    from oppositerenderer_tpu_torch.accel.bvh import build_scene_bvh
    from oppositerenderer_tpu_torch.renderer import Renderer
    from oppositerenderer_tpu_torch.scene import SCENE_NAMES, \
        get_scene_by_name
    tag = "bvh-goldens" if with_bvh else "goldens"
    goldens = np.load(GOLDENS)
    for name in SCENE_NAMES:
        scene, cam = get_scene_by_name(name, dev)
        if with_bvh:
            scene_b, bvh = build_scene_bvh(scene)
            scene = dc.replace(scene_b, bvh=bvh)
        before = [w.launches for w in (ik.closest_hit_tris, bk.traverse)]
        r = Renderer(scene, cam, golden_pt_config(), seed=GOLDEN_SEED)
        img = r.render(GOLDEN_ITERS).mean_radiance().cpu().numpy()
        dense, walked = [w.launches - c for w, c in zip(
            (ik.closest_hit_tris, bk.traverse), before)]
        if with_bvh and (dense or not walked):
            raise AssertionError(f"{name} with a BVH launched B1 {dense} "
                                 f"and B5 {walked} times")
        if not np.isfinite(img).all():
            raise AssertionError(f"{name}: non-finite pixels")
        bad, worst, mean_err = golden_agreement(
            img, goldens[f"{name}__pt"].astype(np.float32))
        print(f"[{tag}] {name}: {bad} of {img.shape[0] * img.shape[1]} "
              f"pixels outside the tolerance, worst pixel at {worst:.3f} of "
              f"it, image mean off by {mean_err:.2e}")
        if bad > GOLDEN_MAX_FLIPPED or mean_err > GOLDEN_MEAN_RTOL:
            raise AssertionError(f"{name} PT diverged from its golden")


def timed_reps(r, iters: int, wrappers, expected: dict, tag: str):
    """MAIN_REPS timed renders of ``iters`` iterations, each after a
    restart; in every rep each wrapper must launch its kernel ``expected``
    times. Returns (launches summed over the reps, seconds per rep, the
    last rep's film)."""
    launches = {w.__name__: 0 for w in wrappers}
    times = []
    for rep in range(MAIN_REPS):
        r.restart()
        for w in wrappers:
            w.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        film = r.render(iters)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        counts = {w.__name__: w.launches for w in wrappers}
        print(f"[{tag}] rep {rep}: {times[-1]:.4f} s, launches {counts}")
        for k, c in counts.items():
            if c != expected[k]:
                raise AssertionError(f"{k} launched {c} times in a {tag} "
                                     f"rep, expected {expected[k]}")
            launches[k] += c
    return launches, times, film


def phase_main(dev) -> dict:
    from oppositerenderer_tpu_torch.accel import intersect_kernels as ik
    from oppositerenderer_tpu_torch.config import RenderConfig
    from oppositerenderer_tpu_torch.film import save_png
    from oppositerenderer_tpu_torch.renderer import Renderer
    from oppositerenderer_tpu_torch.scene import get_scene_by_name

    cfg = RenderConfig(width=MAIN_SIZE, height=MAIN_SIZE)
    scene, cam = get_scene_by_name(MAIN_SCENE, dev)
    r = Renderer(scene, cam, cfg, seed=0)
    t0 = time.perf_counter()
    r.render(MAIN_ITERS)
    print(f"[main] warm-up: {MAIN_ITERS} iterations in "
          f"{time.perf_counter() - t0:.3f} s")
    wrappers = (ik.closest_hit_tris, ik.occluded_tris)
    # one closest-hit launch per segment, one any-hit per shadow sample
    expected = {"closest_hit_tris": MAIN_ITERS * cfg.pt_max_segments,
                "occluded_tris": (MAIN_ITERS * cfg.pt_max_segments
                                  * cfg.pt_shadow_samples)}
    launches, times, film = timed_reps(r, MAIN_ITERS, wrappers, expected,
                                       "main")
    med = statistics.median(times)
    rays = pt_rays_per_iteration(cfg) * MAIN_ITERS
    print(f"[main] {MAIN_SCENE} {MAIN_SIZE}x{MAIN_SIZE} PT: ms/iter median "
          f"{med / MAIN_ITERS * 1e3:.3f}, min "
          f"{min(times) / MAIN_ITERS * 1e3:.3f}, spread "
          f"{(max(times) - min(times)) / med:.4f}; rays/s {rays / med:.4g}")

    img = film.mean_radiance()
    if tuple(img.shape) != (MAIN_SIZE, MAIN_SIZE, 3):
        raise AssertionError(f"image shape {tuple(img.shape)}")
    if not bool(torch.isfinite(img).all()) or float(img.mean()) <= 0.0:
        raise AssertionError("main-path image is not finite and positive")
    png = Path(tempfile.gettempdir()) / "chip_smoke_cornellsmall_pt.png"
    save_png(film, png)
    print(f"[main] image mean {float(img.mean()):.5f}, saved {png}")
    return launches


def image_agreement(img: np.ndarray, want: np.ndarray):
    """(share of pixels within PPM_PIXEL_RTOL on every channel, relative
    error of the image mean)."""
    agree = np.isclose(img, want, rtol=PPM_PIXEL_RTOL, atol=0.0).all(axis=-1)
    return float(agree.mean()), abs(float(img.mean()) / float(want.mean())
                                    - 1.0)


def phase_ppm_goldens(dev) -> None:
    from oppositerenderer_tpu_torch.renderer import Renderer
    from oppositerenderer_tpu_torch.scene import SCENE_NAMES, \
        get_scene_by_name
    goldens = np.load(GOLDENS)
    for name in SCENE_NAMES:
        scene, cam = get_scene_by_name(name, dev)
        r = Renderer(scene, cam, golden_ppm_config(), seed=GOLDEN_SEED)
        img = r.render(GOLDEN_PPM_ITERS).mean_radiance().cpu().numpy()
        if not np.isfinite(img).all():
            raise AssertionError(f"{name}: non-finite pixels")
        want = goldens[f"{name}__ppm"].astype(np.float32)
        mean_err = abs(float(img.mean()) / float(want.mean()) - 1.0)
        corr = float(np.corrcoef(img.ravel(), want.ravel())[0, 1])
        min_corr = min(PPM_GOLDEN_MIN_CORR,
                       JAX_TILED_GOLDEN_CORR.get(name, 1.0) - 0.01)
        print(f"[ppm-goldens] {name}: image mean off by {mean_err:.4f} "
              f"(bound {PPM_GOLDEN_MEAN_RTOL}), pixel correlation "
              f"{corr:.4f} (bound {min_corr:.4f})")
        if mean_err > PPM_GOLDEN_MEAN_RTOL or corr < min_corr:
            raise AssertionError(f"{name} PPM is further from its golden "
                                 "than the tile estimator allows")


def phase_ppm_parity(dev) -> None:
    from oppositerenderer_tpu_torch.renderer import Renderer
    from oppositerenderer_tpu_torch.scene import get_scene_by_name
    cfg = golden_ppm_config()
    imgs = []
    for d in (dev, torch.device("cpu")):
        scene, cam = get_scene_by_name(MAIN_SCENE, d)
        r = Renderer(scene, cam, cfg, seed=GOLDEN_SEED)
        imgs.append(r.render(1).mean_radiance().cpu().numpy())
    share, mean_err = image_agreement(*imgs)
    print(f"[ppm-parity] {MAIN_SCENE} {cfg.width}x{cfg.height}, one "
          f"iteration: {share:.4%} of the pixels within rtol "
          f"{PPM_PIXEL_RTOL} of the CPU port's, image mean off by "
          f"{mean_err:.2e}")
    if (not np.isfinite(imgs[0]).all() or share < PPM_MIN_AGREEING
            or mean_err > PPM_MEAN_RTOL):
        raise AssertionError("PPM on the card differs from the CPU port")


def phase_ppm_main(dev) -> dict:
    from oppositerenderer_tpu_torch.accel import gather_kernels as gk
    from oppositerenderer_tpu_torch.accel import intersect_kernels as ik
    from oppositerenderer_tpu_torch.film import save_png
    from oppositerenderer_tpu_torch.renderer import Renderer
    from oppositerenderer_tpu_torch.scene import get_scene_by_name

    cfg = ppm_main_config()
    scene, cam = get_scene_by_name(MAIN_SCENE, dev)
    r = Renderer(scene, cam, cfg, seed=0)
    t0 = time.perf_counter()
    r.render(PPM_MAIN_ITERS)
    print(f"[ppm-main] warm-up: {PPM_MAIN_ITERS} iterations in "
          f"{time.perf_counter() - t0:.3f} s")
    wrappers = (ik.closest_hit_tris, ik.occluded_tris,
                gk.gather_photons_tiled)
    # one closest-hit launch per eye and photon bounce, one any-hit per
    # direct shadow sample, one gather per iteration
    expected = {
        "closest_hit_tris": PPM_MAIN_ITERS * (cfg.max_radiance_trace_depth
                                              + cfg.max_photon_trace_depth),
        "occluded_tris": PPM_MAIN_ITERS * cfg.ppm_direct_shadow_samples,
        "gather_photons_tiled": PPM_MAIN_ITERS}
    launches, times, film = timed_reps(r, PPM_MAIN_ITERS, wrappers,
                                       expected, "ppm-main")
    med = statistics.median(times)
    rays = ppm_rays_per_iteration(cfg) * PPM_MAIN_ITERS
    per_it = {k: r.metrics[k] / PPM_MAIN_ITERS for k in (
        "photons_stored", "photons_visited", "photon_subsampled")}
    print(f"[ppm-main] {MAIN_SCENE} {MAIN_SIZE}x{MAIN_SIZE} PPM, "
          f"{cfg.photons_per_iteration} photons: ms/iter median "
          f"{med / PPM_MAIN_ITERS * 1e3:.3f}, min "
          f"{min(times) / PPM_MAIN_ITERS * 1e3:.3f}, spread "
          f"{(max(times) - min(times)) / med:.4f}; rays/s {rays / med:.4g}; "
          "per iteration: " + ", ".join(f"{k} {v:.6g}"
                                        for k, v in per_it.items()))

    img = film.mean_radiance()
    if tuple(img.shape) != (MAIN_SIZE, MAIN_SIZE, 3):
        raise AssertionError(f"image shape {tuple(img.shape)}")
    if not bool(torch.isfinite(img).all()) or float(img.mean()) <= 0.0:
        raise AssertionError("PPM image is not finite and positive")
    if per_it["photons_stored"] <= 0 or per_it["photons_visited"] <= 0:
        raise AssertionError("PPM stored or gathered no photon")
    png = Path(tempfile.gettempdir()) / "chip_smoke_cornellsmall_ppm.png"
    save_png(film, png)
    print(f"[ppm-main] image mean {float(img.mean()):.5f}, saved {png}")
    return launches


def phase_media_parity(dev) -> None:
    """One PPM iteration in the medium at 64^2 on the card and on the CPU:
    ppm-parity's pixel bar, and the volumetric photons stored."""
    from oppositerenderer_tpu_torch.renderer import Renderer
    from oppositerenderer_tpu_torch.scene import get_scene_by_name
    cfg = golden_ppm_config()
    imgs, stored = [], []
    for d in (dev, torch.device("cpu")):
        scene, cam = get_scene_by_name(MAIN_SCENE, d)
        scene.medium = scene_medium(d)
        r = Renderer(scene, cam, cfg, seed=GOLDEN_SEED)
        imgs.append(r.render(1).mean_radiance().cpu().numpy())
        stored.append(r.metrics["volumetric_photons_stored"])
    share, mean_err = image_agreement(*imgs)
    stored_err = abs(stored[0] / max(stored[1], 1.0) - 1.0)
    print(f"[media-parity] {MAIN_SCENE} in the medium, {cfg.width}x"
          f"{cfg.height}, one iteration: {share:.4%} of the pixels within "
          f"rtol {PPM_PIXEL_RTOL} of the CPU port's, image mean off by "
          f"{mean_err:.2e}; volumetric photons stored {stored[0]:.0f} "
          f"(CPU {stored[1]:.0f})")
    if (not np.isfinite(imgs[0]).all() or share < PPM_MIN_AGREEING
            or mean_err > PPM_MEAN_RTOL or stored[1] <= 0
            or stored_err > MEDIA_STORED_RTOL):
        raise AssertionError("PPM in a medium on the card differs from the "
                             "CPU port")


def phase_media_main(dev) -> tuple[dict, float]:
    """PPM in the medium at the ppm-main configuration, in ppm-main's
    protocol; B3 held against its plain version on the path's surface
    gather. Returns (launches, B3's max |err| there)."""
    from oppositerenderer_tpu_torch.accel import gather_kernels as gk
    from oppositerenderer_tpu_torch.accel import intersect_kernels as ik
    from oppositerenderer_tpu_torch.renderer import Renderer
    from oppositerenderer_tpu_torch.scene import get_scene_by_name

    cfg = ppm_main_config()
    scene, cam = get_scene_by_name(MAIN_SCENE, dev)
    scene.medium = scene_medium(dev)
    r = Renderer(scene, cam, cfg, seed=0)
    t0 = time.perf_counter()
    r.render(PPM_MAIN_ITERS)
    print(f"[media-main] warm-up: {PPM_MAIN_ITERS} iterations in "
          f"{time.perf_counter() - t0:.3f} s")
    wrappers = (ik.closest_hit_tris, ik.occluded_tris,
                gk.gather_photons_tiled)
    # ppm-main's launches: the medium adds no kernel call (its volume
    # gather is the budgeted gather in torch)
    expected = {
        "closest_hit_tris": PPM_MAIN_ITERS * (cfg.max_radiance_trace_depth
                                              + cfg.max_photon_trace_depth),
        "occluded_tris": PPM_MAIN_ITERS * cfg.ppm_direct_shadow_samples,
        "gather_photons_tiled": PPM_MAIN_ITERS}
    torch.cuda.reset_peak_memory_stats(dev)
    launches, times, film = timed_reps(r, PPM_MAIN_ITERS, wrappers,
                                       expected, "media-main")
    peak = torch.cuda.max_memory_allocated(dev)
    med = statistics.median(times)
    per_it = {k: r.metrics[k] / PPM_MAIN_ITERS for k in (
        "photons_stored", "volumetric_photons_stored", "photons_visited")}
    print(f"[media-main] {MAIN_SCENE} {MAIN_SIZE}x{MAIN_SIZE} PPM in the "
          f"medium (sigma_s {MEDIUM_SIGMA_S}, sigma_a {MEDIUM_SIGMA_A}, box "
          f"[0, {MEDIUM_BOX}]^3), {cfg.photons_per_iteration} photons: "
          f"ms/iter median {med / PPM_MAIN_ITERS * 1e3:.3f}, min "
          f"{min(times) / PPM_MAIN_ITERS * 1e3:.3f}, spread "
          f"{(max(times) - min(times)) / med:.4f}; peak memory "
          f"{peak / 2 ** 30:.3f} GiB; per iteration: "
          + ", ".join(f"{k} {v:.6g}" for k, v in per_it.items())
          + ", launches " + ", ".join(
              f"{k} {c / (MAIN_REPS * PPM_MAIN_ITERS):g}"
              for k, c in launches.items()))
    img = film.mean_radiance()
    if (tuple(img.shape) != (MAIN_SIZE, MAIN_SIZE, 3)
            or not bool(torch.isfinite(img).all())
            or float(img.mean()) <= 0.0):
        raise AssertionError("PPM image in the medium is not finite and "
                             "positive")
    if per_it["volumetric_photons_stored"] <= 0:
        raise AssertionError("the medium stored no volumetric photon")

    # B3 on the path's surface gather, against its plain version
    grid, q, qn, rad, u, valid = ppm_gather_inputs(dev, medium=True)
    starts, lens, weights, _, _, rows = gk._tile_tables(grid, q, rad, u,
                                                        valid)
    args = (starts, lens, weights, rows,
            torch.square(torch.as_tensor(rad, dtype=torch.float32,
                                         device=dev)), q, qn, grid, True)
    got = gk.gather_photons_tiled_kernel(*args)
    want = gk.gather_photons_tiled_plain(*args)
    err = (got.double() - want.double()).abs()
    scale = float(want.abs().max())
    bad = int((err > GATHER_RTOL * want.double().abs()
               + GATHER_ATOL_REL * scale).sum())
    ms = cuda_ms(lambda: gk.gather_photons_tiled_kernel(*args))
    print(f"[media-main] B3 on the medium path's surface gather: "
          f"{q.shape[0]} queries, {int(grid.n_valid)} photons; max |err| "
          f"{float(err.max()):.3g} (max |ref| {scale:.4g}), {bad} sums "
          f"outside rtol {GATHER_RTOL} + {GATHER_ATOL_REL} max|ref|; kernel "
          f"{ms:.4f} ms (median of {TIMING_REPS})")
    if bad or scale <= 0.0:
        raise AssertionError("B3 differs from its plain version on the "
                             "medium path")
    return launches, float(err.max())


def grad_parity_cases():
    """(label, tolerance key, config, parameter) of phase grad-parity at
    32^2: PT kd and emission scale, PPM kd (the tile gather: B3's zero
    gradient), VCM kd at L = 4 with the continuation pinned to 1, and
    VCM+VM emission scale (the tile merge: B4's zero gradient)."""
    from oppositerenderer_tpu_torch.config import RenderConfig, RenderMethod
    base = dict(width=GRAD_PARITY_SIZE, height=GRAD_PARITY_SIZE)
    vcm_kw = dict(base, vcm_max_path_length=4, render_method=RenderMethod.
                  VCM_BIDIRECTIONAL_PATH_TRACING)
    return [("PT kd", "pt", RenderConfig(**base), "kd"),
            ("PT emission", "pt", RenderConfig(**base), "emission_scale"),
            ("PPM kd", "ppm", RenderConfig(
                **base, photons_per_iteration=1 << 14,
                render_method=RenderMethod.PROGRESSIVE_PHOTON_MAPPING),
             "kd"),
            ("VCM kd", "vcm", RenderConfig(
                **vcm_kw, vcm_force_continuation_prob=1.0), "kd"),
            ("VCM+VM emission", "vcm", RenderConfig(
                **vcm_kw, vcm_use_vm=True), "emission_scale")]


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


def phase_grad_parity(dev) -> None:
    """Gradients of 32^2 iterations on the card against the CPU port's."""
    from oppositerenderer_tpu_torch.scene import get_scene_by_name
    for label, tol, cfg, param in grad_parity_cases():
        out = []
        for d in (dev, torch.device("cpu")):
            scene, cam = get_scene_by_name(MAIN_SCENE, d)
            out.append(loss_and_grad(scene, cam, cfg, param))
        (lc, gc), (lh, gh) = out
        rel = float(((gc - gh).abs() / gh.abs()).max())
        print(f"[grad-parity] {label} {GRAD_PARITY_SIZE}^2: loss card "
              f"{lc:.7g} CPU {lh:.7g}; gradient card {gc.tolist()} CPU "
              f"{gh.tolist()}: max rel err {rel:.3g} (bound "
              f"{GRAD_RTOL[tol]})")
        if (not bool(torch.isfinite(gc).all()) or not bool((gh > 0).all())
                or rel > GRAD_RTOL[tol]):
            raise AssertionError(f"{label} gradient on the card differs "
                                 "from the CPU port's")


def phase_grad_main(dev) -> None:
    """Loss and gradient at full width: forward plus backward seconds and
    peak memory (one warm-up, then one timed run), and three steps of
    gradient descent on the wall's kd toward a target rendered at 0.8 kd
    with the same seed (PT 512^2)."""
    from oppositerenderer_tpu_torch import diff
    from oppositerenderer_tpu_torch.config import RenderConfig
    from oppositerenderer_tpu_torch.renderer import Renderer
    from oppositerenderer_tpu_torch.scene import get_scene_by_name
    scene, cam = get_scene_by_name(MAIN_SCENE, dev)
    cases = (("PT", RenderConfig(width=MAIN_SIZE, height=MAIN_SIZE)),
             ("PPM", ppm_main_config()), ("VCM", vcm_main_config()))
    for label, cfg in cases:
        for param in ("kd", "emission_scale"):
            loss_and_grad(scene, cam, cfg, param)      # warm-up
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.perf_counter()
            loss, g = loss_and_grad(scene, cam, cfg, param)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated(dev)
            print(f"[grad-main] {label} {MAIN_SIZE}^2 d/d{param}: "
                  f"loss {loss:.6g}, gradient {g.tolist()}; forward + "
                  f"backward {dt:.3f} s, peak memory {peak / 2 ** 30:.3f} "
                  "GiB")
            if not bool(torch.isfinite(g).all()) or not bool((g > 0).all()):
                raise AssertionError(f"{label}: gradient not finite and "
                                     "positive")

    # gradient descent with the Polyak step (the loss's minimum is 0: the
    # target is the same render at the target kd)
    cfg = RenderConfig(width=MAIN_SIZE, height=MAIN_SIZE)
    kd0 = scene.materials.kd[0]

    def render(s):
        return Renderer(s, cam, cfg, seed=0)._iteration(0, GRAD_R2)[0]

    with torch.no_grad():
        target = render(diff.set_material_param(
            scene, "kd", 0, kd0 * GRAD_TARGET_SCALE))
    kd = kd0.clone()
    losses = []
    for step in range(GRAD_DESCENT_STEPS + 1):
        x = kd.clone().requires_grad_(True)
        loss = torch.mean(torch.square(
            render(diff.set_material_param(scene, "kd", 0, x)) - target))
        (g,) = torch.autograd.grad(loss, x)
        losses.append(float(loss.detach()))
        print(f"[grad-main] descent step {step}: kd {kd.tolist()}, loss "
              f"{losses[-1]:.6g}")
        if step < GRAD_DESCENT_STEPS:
            kd = kd - (loss.detach() / torch.sum(g * g)) * g
    if not all(b < a for a, b in zip(losses, losses[1:])):
        raise AssertionError(f"gradient descent did not lower the loss at "
                             f"every step: {losses}")


def phase_vcm_goldens(dev) -> None:
    """The ``*__vcm`` goldens come from JAX's VC (no merging), which the
    port follows stream by stream: PT's bar, with Cornell's z-fight
    allowance of VCM_GOLDEN_MAX_FLIPPED pixels (phase_goldens)."""
    from oppositerenderer_tpu_torch.renderer import Renderer
    from oppositerenderer_tpu_torch.scene import SCENE_NAMES, \
        get_scene_by_name
    goldens = np.load(GOLDENS)
    for name in SCENE_NAMES:
        scene, cam = get_scene_by_name(name, dev)
        r = Renderer(scene, cam, golden_vcm_config(), seed=GOLDEN_SEED)
        img = r.render(GOLDEN_VCM_ITERS).mean_radiance().cpu().numpy()
        if not np.isfinite(img).all():
            raise AssertionError(f"{name}: non-finite pixels")
        bad, worst, mean_err = golden_agreement(
            img, goldens[f"{name}__vcm"].astype(np.float32))
        allowed = VCM_GOLDEN_MAX_FLIPPED if name == "Cornell" else 0
        print(f"[vcm-goldens] {name}: {bad} of {img.shape[0] * img.shape[1]}"
              f" pixels outside the tolerance (allowed {allowed}), worst "
              f"pixel at {worst:.3f} of it, image mean off by "
              f"{mean_err:.2e}")
        if bad > allowed or mean_err > GOLDEN_MEAN_RTOL:
            raise AssertionError(f"{name} VCM diverged from its golden")


def phase_vcm_parity(dev) -> None:
    """One VCM+VM iteration at the golden VCM configuration on the card and
    on the CPU (plain versions): the same estimator on two devices, up to
    float rounding and the order of the splats' atomic adds."""
    from oppositerenderer_tpu_torch.renderer import Renderer
    from oppositerenderer_tpu_torch.scene import get_scene_by_name
    cfg = golden_vcm_config().replace(vcm_use_vm=True)
    imgs = []
    for d in (dev, torch.device("cpu")):
        scene, cam = get_scene_by_name(MAIN_SCENE, d)
        r = Renderer(scene, cam, cfg, seed=GOLDEN_SEED)
        imgs.append(r.render(1).mean_radiance().cpu().numpy())
    share, mean_err = image_agreement(*imgs)
    print(f"[vcm-parity] {MAIN_SCENE} {cfg.width}x{cfg.height} VCM+VM, one "
          f"iteration: {share:.4%} of the pixels within rtol "
          f"{PPM_PIXEL_RTOL} of the CPU port's, image mean off by "
          f"{mean_err:.2e}")
    if (not np.isfinite(imgs[0]).all() or share < PPM_MIN_AGREEING
            or mean_err > PPM_MEAN_RTOL):
        raise AssertionError("VCM+VM on the card differs from the CPU port")


def profile_iteration(r, tag: str) -> None:
    """One more iteration under torch.profiler: device operations launched,
    their summed device time against the profiled wall time, the costliest
    ones and the port's kernels, and the host time of the integrator's
    ranges (whose device-side annotations are not operations)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        r.render(1)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    ranges: dict[str, float] = {}
    by_name: dict[str, list] = {}
    for e in prof.events():
        ms = e.time_range.elapsed_us() / 1e3
        if e.name.startswith(("vcm_", "pt_", "ppm_")):
            if e.device_type == torch.autograd.DeviceType.CPU:
                ranges[e.name] = ranges.get(e.name, 0.0) + ms
        elif e.device_type == torch.autograd.DeviceType.CUDA:
            t = by_name.setdefault(e.name, [0, 0.0])
            t[0] += 1
            t[1] += ms
    n_ops = sum(c for c, _ in by_name.values())
    busy_ms = sum(ms for _, ms in by_name.values())
    print(f"[{tag}] profiled iteration: {n_ops} device operations, device "
          f"busy {busy_ms:.3f} ms of {wall_ms:.3f} ms wall (idle "
          f"{1.0 - busy_ms / wall_ms:.4f} under the profiler); host ms per "
          "range " + ", ".join(f"{k} {v:.3f}" for k, v in ranges.items()))
    ours = ("closest_hit_tris_kernel", "occluded_tris_kernel",
            "gather_tiled_kernel", "gather_reduce_kernel", "vm_tiled_kernel",
            "vm_reduce_kernel", "bvh_kernel")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    top += [kv for kv in by_name.items()
            if any(k in kv[0] for k in ours) and kv not in top]
    for name, (count, ms) in top:
        print(f"[{tag}]   {ms:9.3f} ms {ms / busy_ms:7.2%} x{count:<6d} "
              f"{name[:100]}")


def phase_vcm_main(dev, use_vm: bool) -> dict:
    from oppositerenderer_tpu_torch.accel import intersect_kernels as ik
    from oppositerenderer_tpu_torch.accel import vm_kernels as vk
    from oppositerenderer_tpu_torch.film import save_png
    from oppositerenderer_tpu_torch.renderer import Renderer
    from oppositerenderer_tpu_torch.scene import get_scene_by_name

    tag = "vcm-vm-main" if use_vm else "vcm-main"
    iters = VCM_VM_MAIN_ITERS if use_vm else VCM_MAIN_ITERS
    cfg = vcm_main_config(use_vm)
    L = cfg.vcm_max_path_length
    scene, cam = get_scene_by_name(MAIN_SCENE, dev)
    r = Renderer(scene, cam, cfg, seed=0)
    t0 = time.perf_counter()
    r.render(iters)
    print(f"[{tag}] warm-up: {iters} iterations in "
          f"{time.perf_counter() - t0:.3f} s")
    wrappers = [ik.closest_hit_tris, ik.occluded_tris]
    # per iteration: one closest hit per light bounce (L-1) and camera
    # bounce (L); one any hit per light bounce's t=1 splats (L-1) and one
    # per camera bounce for its s=1 sample and its L-1 vertex connections
    # together (L); one merge per camera bounce
    expected = {"closest_hit_tris": iters * (2 * L - 1),
                "occluded_tris": iters * ((L - 1) + L)}
    if use_vm:
        wrappers.append(vk.merge_vertices_tiled)
        expected["merge_vertices_tiled"] = iters * L
    torch.cuda.reset_peak_memory_stats(dev)
    launches, times, film = timed_reps(r, iters, wrappers, expected, tag)
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    med = statistics.median(times)
    rays = vcm_rays_per_iteration(cfg) * iters
    stored = r.metrics["light_vertices_stored"] / iters
    print(f"[{tag}] {MAIN_SCENE} {MAIN_SIZE}x{MAIN_SIZE} VCM"
          f"{'+VM' if use_vm else ''}, L={L}: ms/iter median "
          f"{med / iters * 1e3:.3f}, min {min(times) / iters * 1e3:.3f}, "
          f"spread {(max(times) - min(times)) / med:.4f}; rays/s "
          f"{rays / med:.4g}; light vertices stored per iteration "
          f"{stored:.6g}; peak device memory {peak:.3f} GiB")

    img = film.mean_radiance()
    if tuple(img.shape) != (MAIN_SIZE, MAIN_SIZE, 3):
        raise AssertionError(f"image shape {tuple(img.shape)}")
    if not bool(torch.isfinite(img).all()) or float(img.mean()) <= 0.0:
        raise AssertionError(f"{tag} image is not finite and positive")
    if stored <= 0:
        raise AssertionError(f"{tag} stored no light vertex")
    png = Path(tempfile.gettempdir()) / f"chip_smoke_cornellsmall_{tag}.png"
    save_png(film, png)
    print(f"[{tag}] image mean {float(img.mean()):.5f}, saved {png}")
    profile_iteration(r, tag)
    return launches


def phase_bvh_parity(dev) -> None:
    """One PT iteration of full Atrium on the card and on the CPU (plain
    versions): the same estimator and streams on two devices."""
    from oppositerenderer_tpu_torch.config import RenderConfig
    from oppositerenderer_tpu_torch.renderer import Renderer
    from oppositerenderer_tpu_torch.scene import get_scene_by_name
    cfg = RenderConfig(width=BVH_PARITY_SIZE, height=BVH_PARITY_SIZE)
    imgs = []
    for d in (dev, torch.device("cpu")):
        scene, cam = get_scene_by_name("Atrium", d)
        r = Renderer(scene, cam, cfg, seed=GOLDEN_SEED)
        imgs.append(r.render(1).mean_radiance().cpu().numpy())
    share, mean_err = image_agreement(*imgs)
    print(f"[bvh-parity] Atrium {cfg.width}x{cfg.height} PT, one iteration: "
          f"{share:.4%} of the pixels within rtol {PPM_PIXEL_RTOL} of the "
          f"CPU port's, image mean off by {mean_err:.2e}")
    if (not np.isfinite(imgs[0]).all() or share < PPM_MIN_AGREEING
            or mean_err > PPM_MEAN_RTOL or float(imgs[1].mean()) <= 0.0):
        raise AssertionError("Atrium PT on the card differs from the CPU "
                             "port")


def phase_bvh_main(dev, tag: str, name: str, size: int, iters: int) -> dict:
    """PT on a BVH scene at full width (the JAX bench's atrium_pt and
    conference_pt cases, bench.py:244-255): the scene build, one warm-up
    render, 3 timed reps, one profiled iteration."""
    from oppositerenderer_tpu_torch.accel import bvh_kernels as bk
    from oppositerenderer_tpu_torch.accel import intersect_kernels as ik
    from oppositerenderer_tpu_torch.config import RenderConfig
    from oppositerenderer_tpu_torch.film import save_png
    from oppositerenderer_tpu_torch.renderer import Renderer
    from oppositerenderer_tpu_torch.scene import get_scene_by_name

    cfg = RenderConfig(width=size, height=size)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scene, cam = get_scene_by_name(name, dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    bvh = scene.bvh
    if bvh is None or bvh.builder != "native":
        raise AssertionError(f"{name}: no BVH from the native builder")
    print(f"[{tag}] {name}: {scene.geometry.n_triangles} triangles, "
          f"{bvh.rows.shape[0]} rows, depth {bvh.max_stack - 1}, built in "
          f"{build_s:.3f} s")
    r = Renderer(scene, cam, cfg, seed=0)
    t0 = time.perf_counter()
    r.render(iters)
    print(f"[{tag}] warm-up: {iters} iterations in "
          f"{time.perf_counter() - t0:.3f} s")
    wrappers = (bk.traverse, bk.traverse_any, ik.closest_hit_tris,
                ik.occluded_tris)
    # one closest hit per segment, one any hit per shadow sample; the
    # dense kernels never
    expected = {"traverse": iters * cfg.pt_max_segments,
                "traverse_any": (iters * cfg.pt_max_segments
                                 * cfg.pt_shadow_samples),
                "closest_hit_tris": 0, "occluded_tris": 0}
    torch.cuda.reset_peak_memory_stats(dev)
    launches, times, film = timed_reps(r, iters, wrappers, expected, tag)
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    med = statistics.median(times)
    rays = pt_rays_per_iteration(cfg) * iters
    print(f"[{tag}] {name} {size}x{size} PT: ms/iter median "
          f"{med / iters * 1e3:.3f}, min {min(times) / iters * 1e3:.3f}, "
          f"spread {(max(times) - min(times)) / med:.4f}; rays/s "
          f"{rays / med:.4g}; scene build {build_s:.3f} s; peak device "
          f"memory {peak:.3f} GiB")

    img = film.mean_radiance()
    if tuple(img.shape) != (size, size, 3):
        raise AssertionError(f"image shape {tuple(img.shape)}")
    if not bool(torch.isfinite(img).all()) or float(img.mean()) <= 0.0:
        raise AssertionError(f"{tag} image is not finite and positive")
    png = Path(tempfile.gettempdir()) / f"chip_smoke_{name.lower()}_pt.png"
    save_png(film, png)
    print(f"[{tag}] image mean {float(img.mean()):.5f}, saved {png}")
    profile_iteration(r, tag)
    return launches


# ---------------------------------------------------------------------------
# scene import and PPM's other photon maps
def record_differences(a, b, path: str = "") -> list[str]:
    """Fields of two records (dataclasses of tensors, nested) that differ:
    tensors compared on the host bit for bit (float32 through its int32
    bits, so NaN-coded BVH rows compare too), other values by equality."""
    if dataclasses.is_dataclass(a):
        return [d for f in dataclasses.fields(a) for d in record_differences(
            getattr(a, f.name), getattr(b, f.name), f"{path}{f.name}.")]
    if torch.is_tensor(a):
        a, b = a.cpu(), b.cpu()
        if a.dtype == torch.float32 and b.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        same = a.shape == b.shape and a.dtype == b.dtype and torch.equal(a, b)
        return [] if same else [path.rstrip(".")]
    return [] if a == b else [path.rstrip(".")]


def small_dae_file() -> Path:
    path = Path(tempfile.mkdtemp(prefix="chip_smoke_")) / "test.dae"
    path.write_text(SMALL_DAE)
    return path


def phase_import_parity(dev) -> None:
    """The loader on the card against the loader on the CPU, array for
    array, for the repo's Collada file (above the BVH threshold: B5) and
    tests/test_import.py's DAE (below it: B1, B2); then one 64^2 PT
    iteration of each, card against CPU, at ppm-parity's bar. All three
    native libraries must load: the text scanner parses the payloads."""
    from oppositerenderer_tpu_torch import native
    from oppositerenderer_tpu_torch.accel import bvh_kernels as bk
    from oppositerenderer_tpu_torch.accel import intersect_kernels as ik
    from oppositerenderer_tpu_torch.camera import Camera
    from oppositerenderer_tpu_torch.config import RenderConfig
    from oppositerenderer_tpu_torch.renderer import Renderer
    from oppositerenderer_tpu_torch.scene import (LAST_LOAD_PHASES,
                                                  get_scene_by_name)
    missing = [s for s in native.STEMS if native.load(s) is None]
    if missing:
        raise AssertionError(f"native libraries not loaded: {missing}")
    print("[import-parity] native libraries loaded: " + ", ".join(
        native.library_path(s).name for s in native.STEMS))
    small = small_dae_file()

    def atrium_camera(d):
        return get_scene_by_name("Atrium:0.1", d)[1]

    def small_camera(d):
        eye, lookat, fov = SMALL_DAE_CAMERA
        return Camera.make(eye, lookat, hfov=fov, vfov=fov, device=d)

    wrappers = (bk.traverse, bk.traverse_any, ik.closest_hit_tris,
                ik.occluded_tris)
    cfg = RenderConfig(width=IMPORT_PARITY_SIZE, height=IMPORT_PARITY_SIZE)
    for label, path, camera, launched in (
            ("atrium_lite.dae", ATRIUM_LITE, atrium_camera,
             {"traverse", "traverse_any"}),
            ("tests/test_import.py DAE", small, small_camera,
             {"closest_hit_tris", "occluded_tris"})):
        loaded, imgs, counts = [], [], {}
        for d in (dev, torch.device("cpu")):
            t0 = time.perf_counter()
            scene, fcam = get_scene_by_name(str(path), d)
            load_s = time.perf_counter() - t0
            loaded.append((scene, fcam, dict(LAST_LOAD_PHASES), load_s))
            for w in wrappers:
                w.launches = 0
            r = Renderer(scene, camera(d), cfg, seed=GOLDEN_SEED)
            imgs.append(r.render(1).mean_radiance().cpu().numpy())
            if d.type == "cuda":
                counts = {w.__name__: w.launches for w in wrappers}
        (gs, gcam, phases, load_s), (cs, ccam, _, _) = loaded
        diff = record_differences(gs, cs) + record_differences(gcam, ccam)
        if diff or gs.device != dev or gcam.eye.device != dev:
            raise AssertionError(f"{label}: the card's import differs from "
                                 f"the CPU's in {diff}")
        ran = {k for k, c in counts.items() if c > 0}
        share, mean_err = image_agreement(*imgs)
        print(f"[import-parity] {label}: {gs.geometry.n_triangles} "
              f"triangles, {gs.materials.kind.shape[0]} materials, "
              f"{gs.lights.n_lights} lights, {int(gs.textures.shape[0])} "
              f"textures, BVH "
              f"{'none' if gs.bvh is None else tuple(gs.bvh.rows.shape)}; "
              f"loaded in {load_s:.3f} s ("
              + ", ".join(f"{k} {v:.3f} s" for k, v in phases.items())
              + "); every array equal to the CPU's; PT "
              f"{cfg.width}x{cfg.height}, one iteration: {share:.4%} of the "
              f"pixels within rtol {PPM_PIXEL_RTOL} of the CPU port's, image "
              f"mean off by {mean_err:.2e}; launches {counts}")
        if (not np.isfinite(imgs[0]).all() or share < PPM_MIN_AGREEING
                or mean_err > PPM_MEAN_RTOL or float(imgs[1].mean()) <= 0.0):
            raise AssertionError(f"{label}: PT on the card differs from the "
                                 "CPU port")
        if ran != launched:
            raise AssertionError(f"{label}: kernels {sorted(ran)} launched, "
                                 f"expected {sorted(launched)}")


def flagship_b3(dev, scene, cam, cfg, label: str) -> dict:
    """B3 on the gather of one flagship PPM iteration: against its plain
    version (rtol GATHER_RTOL + GATHER_ATOL_REL max|ref|), timed, bounded."""
    from oppositerenderer_tpu_torch.accel import gather_kernels as gk
    grid, q, qn, r, u, valid = ppm_gather_inputs(dev, scene=scene, cam=cam,
                                                 cfg=cfg)
    starts, lens, weights, visited, total, rows = gk._tile_tables(
        grid, q, r, u, valid)
    r2 = torch.square(torch.as_tensor(r, dtype=torch.float32, device=dev))
    args = (starts, lens, weights, rows, r2, q, qn, grid, True)
    got = gk.gather_photons_tiled_kernel(*args)
    want = gk.gather_photons_tiled_plain(*args)
    err = (got.double() - want.double()).abs()
    scale = float(want.abs().max())
    bad = int((err > GATHER_RTOL * want.double().abs()
               + GATHER_ATOL_REL * scale).sum())
    if bad or not bool(torch.isfinite(got).all()) or scale <= 0.0:
        raise AssertionError(f"B3 differs from its plain version on {label}:"
                             f" {bad} sums outside the tolerance")
    n_q, n_p = q.shape[0], grid.position.shape[0]
    pairs = query_pairs(grid, q, r, starts, lens)
    out = bound(covered_rows(starts, lens, n_p) * 36 + n_q * (24 + 12)
                + starts.numel() * 16, pairs * PAIR_FLOPS)
    out.update(calls=1, max_abs_err=float(err.max()),
               ms=cuda_ms(lambda: gk.gather_photons_tiled_kernel(*args)),
               plain_ms=cuda_ms(lambda: gk.gather_photons_tiled_plain(*args),
                                reps=PLAIN_GATHER_REPS, warmup=1, batch=1,
                                graph=False))
    print(f"[import-main] B3 {label}: queries={n_q} photons={n_p} (valid "
          f"{int(grid.n_valid)}), tiles {starts.shape[0]}, visited "
          f"{int(visited.sum())}, pairs needed {pairs}; sums within "
          f"tolerance (max |err| {out['max_abs_err']:.3g}, max |ref| "
          f"{scale:.4g}); ms kernel {out['ms']:.4f} / plain "
          f"{out['plain_ms']:.4f}, bound {out['bound_ms']:.4f} "
          f"({out['bound_by']})")
    return out


def flagship_b5(dev, scene, cam, cfg, label: str) -> dict:
    """B5 on every traversal call of one flagship iteration: each call's
    results against its plain version, bit for bit, on a 1-in-k sample of
    its lanes (at most FLAGSHIP_SAMPLE_LANES; each ray is traversed alone,
    so a sample checks the call's bits where it falls); each call timed
    (median of FLAGSHIP_TIMING_REPS graph replays); its bound from the
    sample's counts, scaled to the call's lanes (the rows are those the
    sample read: a lower bound). Returns per kernel the summed calls, ms
    and bound."""
    from oppositerenderer_tpu_torch.accel import bvh_kernels as bk
    calls = iteration_calls(scene, cam, cfg, ("traverse", "traverse_any"))
    out = {}
    for k, ks in calls.items():
        any_hit = k == "traverse_any"
        fn = getattr(bk, k)
        acc = {"calls": 0, "lanes": 0, "ms": 0.0, "bound_ms": 0.0}
        for i, (bvh, o, d, tmin, tmax) in enumerate(ks):
            n = o.shape[0]
            step = -(-n // FLAGSHIP_SAMPLE_LANES)
            got = fn(bvh, o, d, tmin, tmax)
            sample = torch.arange(0, n, step, device=dev)
            t, prim, u, v, found, visits, row_floats = bk.plain_traversal(
                bvh, o[sample], d[sample], tmin[sample], tmax[sample],
                any_hit)
            want = (found,) if any_hit else (t, prim, u, v, found)
            got = (got,) if any_hit else got
            bad = sum(_bits_differ(a[sample], b) for a, b in zip(got, want))
            if bad:
                raise AssertionError(f"B5 {k} differs from its plain version "
                                     f"on {label} call {i} in {bad} values")
            scale = n / sample.shape[0]
            b = bound(n * (32 + (1 if any_hit else 17))
                      + 4 * int(row_floats.sum()),
                      scale * (float(visits[:, 2].sum()) * SLAB_FLOPS
                               + float(visits[:, 3].sum()) * MT_FLOPS))
            ms = cuda_ms(lambda: fn(bvh, o, d, tmin, tmax),
                         reps=FLAGSHIP_TIMING_REPS, batch=2)
            acc["calls"] += 1
            acc["lanes"] += n
            acc["ms"] += ms
            acc["bound_ms"] += b["bound_ms"]
        print(f"[import-main] B5 {k} per {label} iteration: {acc['calls']} "
              f"launches over {acc['lanes']} lanes, equal bit for bit on "
              f"1-in-k samples, {acc['ms']:.4f} ms, bound "
              f"{acc['bound_ms']:.4f} ms")
        out[k] = acc
    return out


def check_flagship_launches(label: str, cfg, got: dict) -> None:
    """A BVH scene's launches per iteration: B5 once per eye and photon
    bounce and once per direct shadow sample, and B3 once (PPM); B5 once
    per light and camera bounce and once per light bounce's and camera
    bounce's shadow rays (VCM, no merging); B1 and B2 never."""
    from oppositerenderer_tpu_torch.config import RenderMethod
    if cfg.render_method == RenderMethod.PROGRESSIVE_PHOTON_MAPPING:
        expected = {"traverse": (cfg.max_radiance_trace_depth
                                 + cfg.max_photon_trace_depth),
                    "traverse_any": cfg.ppm_direct_shadow_samples,
                    "gather_photons_tiled": 1}
    else:
        L = cfg.vcm_max_path_length
        expected = {"traverse": 2 * L - 1, "traverse_any": (L - 1) + L,
                    "gather_photons_tiled": 0}
    expected.update(closest_hit_tris=0, occluded_tris=0)
    if got != {k: float(v) for k, v in expected.items()}:
        raise AssertionError(f"{label}: launches per iteration {got}, "
                             f"expected {expected}")


def phase_import_main(dev, kernels: dict) -> dict:
    """milestone4_torch.py's Atrium and Conference cases: each scene
    exported at full detail, imported from its .dae, PPM and VCM at
    1024^2 (one warm-up, two timed iterations) with the launches of each
    timed iteration checked; then B3 on the flagship PPM's gather and B5
    on every call of one PPM and one VCM iteration, added to ``kernels``'
    per-iteration figures. Returns the timed iterations' launches."""
    import milestone4_torch as m4
    launches = {k: 0 for k in KERNELS}
    for base in m4.SCENES:
        record, scene, cam = m4.run_case(base, dev)
        print(f"[import-main] {json.dumps(record)}")
        if (record["triangles"] != record["factory_triangles"]
                or scene.bvh is None
                or scene.bvh.builder != "native"):
            raise AssertionError(f"{base}: the import lost triangles or "
                                 "its native BVH")
        for method in m4.METHODS:
            rec = record[method]
            cfg = m4.method_config(method, m4.SIZE)
            check_flagship_launches(f"{base} {method}", cfg,
                                    rec["launches_per_iteration"])
            if not rec["image_finite"] or rec["image_mean"] <= 0.0:
                raise AssertionError(f"{base} {method}: the image is not "
                                     "finite and positive")
            for k, c in rec["launches"].items():
                launches[k] += c
            label = f"{base} import {m4.SIZE}^2 {method.upper()}"
            if method == "ppm":
                b3 = flagship_b3(dev, scene, cam, cfg, label)
                k3 = kernels["gather_photons_tiled"]
                k3["max_abs_err"] = max(k3["max_abs_err"],
                                        b3["max_abs_err"])
                k3.setdefault("per_iteration", {})[label] = b3
            for k, acc in flagship_b5(dev, scene, cam, cfg, label).items():
                kernels[k]["per_iteration"][label] = acc
        # the exports are rebuilt from the factories: keep chiprun_out small
        dae = REPO / record["asset"]
        for f in (dae, *dae.parent.glob(f"{dae.stem}_tex*.png")):
            f.unlink()
        del scene
        torch.cuda.empty_cache()
    return launches


def phase_photon_maps(dev) -> dict:
    """PPM main's configuration with the stochastic hash and with the CPU
    kd-tree: one warm-up render, MAIN_REPS timed reps of PHOTON_MAP_ITERS
    iterations (B1 and B2 as on the grid, B3 never); one more iteration
    times the structure's build, and one more is profiled; the image of
    the last rep against the
    grid's at the same seed and iterations: its mean within the JAX
    package's bars. The mean |difference| per pixel is printed, not held:
    at this size the grid's tile gather subsamples its rows and the
    kd-tree's lanes overrun their 512 visits, where the JAX test's 24^2
    iteration with 2,048 photons does neither (tests/test_torch_photon_maps.py
    holds that bar there)."""
    from oppositerenderer_tpu_torch.accel import gather_kernels as gk
    from oppositerenderer_tpu_torch.accel import intersect_kernels as ik
    from oppositerenderer_tpu_torch.config import PhotonMapStructure
    from oppositerenderer_tpu_torch.integrators import ppm
    from oppositerenderer_tpu_torch.renderer import Renderer
    from oppositerenderer_tpu_torch.scene import get_scene_by_name

    scene, cam = get_scene_by_name(MAIN_SCENE, dev)
    base = ppm_main_config()
    grid = Renderer(scene, cam, base, seed=0).render(
        PHOTON_MAP_ITERS).mean_radiance().double()
    wrappers = (ik.closest_hit_tris, ik.occluded_tris,
                gk.gather_photons_tiled)
    expected = {
        "closest_hit_tris": PHOTON_MAP_ITERS * (base.max_radiance_trace_depth
                                                + base.max_photon_trace_depth),
        "occluded_tris": PHOTON_MAP_ITERS * base.ppm_direct_shadow_samples,
        "gather_photons_tiled": 0}
    launches = {w.__name__: 0 for w in wrappers}
    for structure, builder in (
            (PhotonMapStructure.STOCHASTIC_HASH, "build_stochastic_hash"),
            (PhotonMapStructure.KD_TREE_CPU, "build_photon_kdtree")):
        tag = f"photon-maps {structure.name}"
        r = Renderer(scene, cam, base.replace(photon_map_structure=structure),
                     seed=0)
        r.render(PHOTON_MAP_ITERS)
        got, times, film = timed_reps(r, PHOTON_MAP_ITERS, wrappers,
                                      expected, tag)
        for k, c in got.items():
            launches[k] += c
        per_it = {k: v / PHOTON_MAP_ITERS for k, v in r.metrics.items()
                  if k in ("photons_stored", "photons_visited",
                           "kd_overrun")}
        img = film.mean_radiance().double()
        # the build alone, in one more iteration
        build = getattr(ppm, builder)
        build_s = []

        def timed_build(*args, build=build, build_s=build_s):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = build(*args)
            torch.cuda.synchronize()
            build_s.append(time.perf_counter() - t0)
            return out

        setattr(ppm, builder, timed_build)
        try:
            r.compute_iteration(0)
        finally:
            setattr(ppm, builder, build)
        med = statistics.median(times)
        mean_rel = abs(float(img.mean() / grid.mean()) - 1.0)
        mean_abs = float((img - grid).abs().mean() / grid.abs().mean())
        print(f"[{tag}] {MAIN_SCENE} {MAIN_SIZE}x{MAIN_SIZE}, "
              f"{base.photons_per_iteration} photons: ms/iter median "
              f"{med / PHOTON_MAP_ITERS * 1e3:.3f}, min "
              f"{min(times) / PHOTON_MAP_ITERS * 1e3:.3f}, spread "
              f"{(max(times) - min(times)) / med:.4f}; build "
              f"{build_s[0]:.4f} s an iteration; per iteration: "
              + ", ".join(f"{k} {v:.6g}" for k, v in per_it.items())
              + f"; against the grid's image ({PHOTON_MAP_ITERS} iterations,"
              f" seed 0): mean off by {mean_rel:.4f}, mean |difference| "
              f"{mean_abs:.4f} of the mean")
        if not bool(torch.isfinite(img).all()) or float(img.mean()) <= 0.0:
            raise AssertionError(f"{tag}: the image is not finite and "
                                 "positive")
        bar = (HASH_MEAN_RTOL if structure == PhotonMapStructure.STOCHASTIC_HASH
               else KD_MEAN_RTOL)
        if mean_rel > bar:
            raise AssertionError(f"{tag}: image mean {mean_rel:.4f} off the "
                                 f"grid's (bound {bar})")
        profile_iteration(r, tag)
    return launches


# The parent tree's entry points and their argument types, as its
# accel/cuda_build.py has them at commit 11d34d2: B1 took the [9, T]
# table, B2-B5 take what this tree's take.
_P, _I = ctypes.c_void_p, ctypes.c_int
PARENT_ENTRY_POINTS = {
    "closest_hit_tris": [_P] * 5 + [_I, _I] + [_P] * 5,
    "occluded_tris": [_P] * 5 + [_I, _I] + [_P] * 2,
    "gather_photons_tiled": [_P] * 11 + [_I] * 4 + [_P] * 3,
    "merge_vertices_tiled": [_P] * 10 + [_I] * 3 + [_P] * 4,
    "bvh_closest": [_P] + [_I] * 3 + [_P] * 4 + [_I] + [_P] * 6,
    "bvh_any": [_P] + [_I] * 3 + [_P] * 4 + [_I] + [_P] * 2,
    "bvh_compact_live": [_P] * 2 + [_I] + [_P] * 3,
}


def parent_library(parent: Path) -> ctypes.CDLL:
    """The parent tree's kernels, built by this tree's nvcc calls into
    ``<parent>/_build_parent``."""
    from oppositerenderer_tpu_torch.accel import cuda_build
    srcs = sorted((parent / "oppositerenderer_tpu_torch" / "csrc").glob(
        "*.cu"))
    out = parent / "_build_parent" / "kernels.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    log = cuda_build.compile_sources(srcs, out)
    for line in log.splitlines():
        if any(w in line for w in ("entry function", "registers", "spill")):
            print(f"[parent-ab] parent build: {line.strip()}")
    lib = ctypes.CDLL(str(out))
    for name, argtypes in PARENT_ENTRY_POINTS.items():
        getattr(lib, name).argtypes = argtypes
        getattr(lib, name).restype = _I
    return lib


@contextlib.contextmanager
def kernels_of(lib: ctypes.CDLL):
    """Inside the block the port's wrappers launch ``lib``'s kernels (its
    entry points must take this tree's arguments) instead of the built
    library's."""
    from oppositerenderer_tpu_torch.accel import cuda_build
    own = cuda_build.library
    cuda_build.library = lambda: lib
    try:
        yield
    finally:
        cuda_build.library = own


def in_turns(old, new, graph: bool = True) -> tuple[float, float]:
    """``cuda_ms`` medians of the parent's and this tree's launches in turns
    (parent, this, this, parent): the mean of each pair."""
    a, b, c, e = (cuda_ms(f, graph=graph) for f in (old, new, new, old))
    return (a + e) / 2, (b + c) / 2


def parent_b1(lib, calls, label: str) -> dict:
    """The parent's B1 (on the [9, T] rows of each call's records) and
    this tree's in turns on each of ``calls``, outputs bit for bit;
    returns the sums and each call's times."""
    from oppositerenderer_tpu_torch.accel import intersect_kernels as ik
    acc = {"calls": 0, "parent_iteration_ms": 0.0, "iteration_ms": 0.0,
           "per_call": []}
    for i, (o, d, tmin, tmax, tris) in enumerate(calls):
        tri9 = tris[:, list(ik._TRI9_COLS)].T.contiguous()
        n = o.shape[0]
        res = (torch.empty(n, device=o.device),
               torch.empty(n, dtype=torch.int32, device=o.device),
               torch.empty(n, device=o.device), torch.empty(n, device=o.device))

        def old():
            rc = lib.closest_hit_tris(
                o.data_ptr(), d.data_ptr(), tmin.data_ptr(), tmax.data_ptr(),
                tri9.data_ptr(), n, tri9.shape[1],
                *(a.data_ptr() for a in res),
                torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise RuntimeError(f"the parent's closest_hit_tris failed: "
                                   f"cudaError {rc}")

        def new():
            return ik.closest_hit_tris(o, d, tmin, tmax, tris)

        old()
        bad = sum(_bits_differ(a, b) for a, b in zip(res, new()))
        if bad:
            raise AssertionError(f"B1 {label} call {i}: this tree differs "
                                 f"from the parent in {bad} values")
        t_old, t_new = in_turns(old, new)
        live = int((tmax > tmin).sum())
        acc["calls"] += 1
        acc["parent_iteration_ms"] += t_old
        acc["iteration_ms"] += t_new
        acc["per_call"].append([n, live, t_old, t_new])
        print(f"[parent-ab] B1 {label} call {i}: lanes {n}, live {live}; "
              f"parent {t_old:.4f} ms, this tree {t_new:.4f} ms (in turns, "
              f"medians of {TIMING_REPS}); equal bit for bit")
    print(f"[parent-ab] B1 {label}: parent {acc['parent_iteration_ms']:.4f} "
          f"ms, this tree {acc['iteration_ms']:.4f} ms over "
          f"{acc['calls']} calls")
    return acc


def phase_parent_ab(dev, parent: Path) -> dict:
    """This tree's kernels against the parent tree's, in one call on one
    card, each timed in turns with its outputs compared: B1 (redesigned
    since) on every closest-hit call of one CornellSmall 512^2 PPM and VCM
    iteration and on the 4096-triangle soup, bit for bit; and, as an A/A
    check of kernels the parent shares (the port's wrappers launching the
    parent's library), B2 over one VCM iteration (bit for bit), B3 at the
    PPM main shape (within GATHER_RTOL), B4 on every merge round of one
    VCM+VM iteration (within VM_RTOL) and B5 on every call of one Atrium
    512^2 and Conference 1024^2 PT iteration (bit for bit). Returns, per
    kernel, the parent's and this tree's ms at the timed shapes and summed
    over the iteration."""
    from oppositerenderer_tpu_torch.accel import bvh_kernels as bk
    from oppositerenderer_tpu_torch.accel import gather_kernels as gk
    from oppositerenderer_tpu_torch.accel import intersect_kernels as ik
    from oppositerenderer_tpu_torch.accel import vm_kernels as vk
    from oppositerenderer_tpu_torch.scene import get_scene_by_name
    lib = parent_library(parent)

    def aa(fn):
        """fn, launching the parent's kernels."""
        def run():
            with kernels_of(lib):
                return fn()
        return run

    out = {"closest_hit_tris": {}}
    for method in ("PPM", "VCM"):
        out["closest_hit_tris"][f"{MAIN_SCENE} {MAIN_SIZE}^2 {method}"] = \
            parent_b1(lib, closest_hit_calls(dev, method),
                      f"{MAIN_SCENE} {MAIN_SIZE}^2 {method}")
    soup = (*_rays(MAIN_SIZE * MAIN_SIZE, 102, *SOUP_BOX, dev),
            ik.triangle_records(soup_tri9(dev)))
    out["closest_hit_tris"]["soup4096"] = parent_b1(lib, [soup], "soup4096")

    # B2 (A/A) over one VCM iteration
    _, calls = vcm_shadow_calls(dev)

    def b2():
        return torch.cat([ik.occluded_tris(*call) for call in calls])

    if not torch.equal(aa(b2)(), b2()):
        raise AssertionError("B2 over a VCM iteration: this tree's booleans "
                             "differ from the parent's")
    t_old, t_new = in_turns(aa(b2), b2)
    out["occluded_tris"] = {f"{MAIN_SCENE} {MAIN_SIZE}^2 VCM": {
        "launches": len(calls), "parent_iteration_ms": t_old,
        "iteration_ms": t_new}}
    print(f"[parent-ab] B2 (A/A) per {MAIN_SCENE} {MAIN_SIZE}^2 VCM "
          f"iteration, {len(calls)} launches: parent {t_old:.4f} ms, this "
          f"tree {t_new:.4f} ms (in turns, medians of {TIMING_REPS}); "
          f"booleans equal")

    # B3 (A/A) on the PPM main shape
    grid, q, qn, r, u, valid = ppm_gather_inputs(dev)
    starts, lens, weights, _, _, rows = gk._tile_tables(grid, q, r, u, valid)
    r2 = torch.square(torch.as_tensor(r, dtype=torch.float32, device=dev))
    args = (starts, lens, weights, rows, r2, q, qn, grid, True)

    def b3():
        return gk.gather_photons_tiled_kernel(*args)

    g_old, g_new = aa(b3)(), b3()
    scale = float(g_old.abs().max())
    if not torch.allclose(g_new, g_old, rtol=GATHER_RTOL,
                          atol=GATHER_ATOL_REL * scale):
        raise AssertionError("B3 on the PPM main shape: this tree's sums "
                             "differ from the parent's")
    t_old, t_new = in_turns(aa(b3), b3)
    out["gather_photons_tiled"] = {"parent_ms": t_old, "ms": t_new}
    print(f"[parent-ab] B3 (A/A) {MAIN_SCENE} {MAIN_SIZE}^2 PPM: parent "
          f"{t_old:.4f} ms, this tree {t_new:.4f} ms (in turns, medians of "
          f"{TIMING_REPS})")

    # B4 (A/A) on every merge round of one VCM+VM iteration
    cfg, rounds = vcm_merge_inputs(dev)
    acc = out["merge_vertices_tiled"] = {"parent_iteration_ms": 0.0,
                                         "iteration_ms": 0.0}
    for k in rounds:
        _, margs, _, _ = vk.merge_tables(
            k["vgrid"], cfg, k["cam_bsdf"], k["cam_pos"], k["cam_dVCM"],
            k["cam_dVM"], k["active"], k["radius_sq"], k["mis_vc_w"],
            k["u_rows"], k["depth1"])

        def b4(margs=margs):
            return vk.merge_vertices_tiled_kernel(*margs)

        for a, b in zip(aa(b4)(), b4()):
            scale = float(a.abs().max())
            if not torch.allclose(b, a, rtol=VM_RTOL,
                                  atol=VM_ATOL_REL * scale):
                raise AssertionError(f"B4 bounce {k['depth1']}: this tree's "
                                     "sums differ from the parent's")
        t_old, t_new = in_turns(aa(b4), b4)
        acc["parent_iteration_ms"] += t_old
        acc["iteration_ms"] += t_new
        if k["depth1"] == 2:
            acc.update(parent_ms=t_old, ms=t_new)
        print(f"[parent-ab] B4 (A/A) bounce {k['depth1']}: parent "
              f"{t_old:.4f} ms, this tree {t_new:.4f} ms (in turns, medians "
              f"of {TIMING_REPS})")

    # B5 (A/A) on every call of one Atrium and one Conference iteration
    for name, size in (("Atrium", ATRIUM_SIZE),
                       ("Conference", CONFERENCE_SIZE)):
        scene, cam = get_scene_by_name(name, dev)
        bvh = scene.bvh
        calls = pt_traversal_calls(scene, cam, size)
        for kname, kcalls in (("traverse", calls[0]),
                              ("traverse_any", calls[1])):
            acc = out.setdefault(kname, {}).setdefault(
                f"{name} {size}^2", {"parent_iteration_ms": 0.0,
                                     "iteration_ms": 0.0})
            fn = getattr(bk, kname)
            for i, (o, d, tmin, tmax) in enumerate(kcalls):
                def b5(o=o, d=d, tmin=tmin, tmax=tmax):
                    got = fn(bvh, o, d, tmin, tmax)
                    return got if kname == "traverse" else (got,)

                if any(_bits_differ(a, b) for a, b in zip(aa(b5)(), b5())):
                    raise AssertionError(f"B5 {kname} {name} segment {i}: "
                                         "this tree differs from the parent")
                t_old, t_new = in_turns(aa(b5), b5)
                acc["parent_iteration_ms"] += t_old
                acc["iteration_ms"] += t_new
                if i == 0:
                    acc.update(parent_ms=t_old, ms=t_new)
                print(f"[parent-ab] B5 (A/A) {kname} {name} {size}^2 segment "
                      f"{i}: parent {t_old:.4f} ms, this tree {t_new:.4f} ms")
    for k, v in out.items():
        print(f"[parent-ab] {k}: {json.dumps(v)}")
    return out


def timed(tag: str, fn, *args):
    """Run one phase and print its seconds."""
    t0 = time.perf_counter()
    out = fn(*args)
    print(f"[{tag}] phase took {time.perf_counter() - t0:.1f} s")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="the unpacked parent tree: time its kernels in "
                         "turns with this tree's (phase parent-ab)")
    args = ap.parse_args()
    name = phase_device()   # first: no CUDA device, no result
    dev = torch.device("cuda", 0)
    # the plain versions' products in full float32, as on the CPU
    torch.backends.cuda.matmul.allow_tf32 = False
    phase_build()
    kernels = timed("kernels", phase_kernels, dev)
    if args.parent is not None:
        ab = timed("parent-ab", phase_parent_ab, dev, args.parent)
        for k, v in ab.items():
            kernels[k]["parent_ab"] = v
    phase_goldens(dev)
    launches = {k: 0 for k in KERNELS}
    launches.update(phase_main(dev))
    phase_ppm_goldens(dev)
    phase_ppm_parity(dev)
    for k, c in phase_ppm_main(dev).items():
        launches[k] += c
    timed("media-parity", phase_media_parity, dev)
    media_launches, media_err = timed("media-main", phase_media_main, dev)
    for k, c in media_launches.items():
        launches[k] += c
    b3 = kernels["gather_photons_tiled"]
    b3["max_abs_err"] = max(b3["max_abs_err"], media_err)
    phase_vcm_goldens(dev)
    phase_vcm_parity(dev)
    for use_vm in (False, True):
        for k, c in phase_vcm_main(dev, use_vm).items():
            launches[k] += c
    timed("grad-parity", phase_grad_parity, dev)
    timed("grad-main", phase_grad_main, dev)
    timed("bvh-goldens", phase_goldens, dev, True)
    timed("bvh-parity", phase_bvh_parity, dev)
    for tag, scene_name, size, iters in (
            ("atrium-main", "Atrium", ATRIUM_SIZE, ATRIUM_ITERS),
            ("conference-main", "Conference", CONFERENCE_SIZE,
             CONFERENCE_ITERS)):
        for k, c in timed(tag, phase_bvh_main, dev, tag, scene_name, size,
                          iters).items():
            launches[k] += c
    timed("import-parity", phase_import_parity, dev)
    for phase, args in (("import-main", (phase_import_main, dev, kernels)),
                        ("photon-maps", (phase_photon_maps, dev))):
        for k, c in timed(phase, *args).items():
            launches[k] += c
    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": KERNEL_SOURCES[k],
         "replaces": KERNELS[k], "launches": launches[k], **kernels[k]}
        for k in KERNELS]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
