"""Smoke run of the PyTorch port's main paths on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

or, to time the parent tree's kernels in turns with this one's (phase
parent-ab), with that tree's kernel sources unpacked under a directory
(``git archive a2a280b oppositerenderer_tpu_torch/csrc``; the parent's
entry points are PARENT_ENTRY_POINTS):

    python3 chip_smoke.py --parent _chip_tree/parent

Phases, in order, one line (or a few) of output each; any failure raises
and the script exits non-zero without printing the result line:

1. device      - a CUDA device must be present; prints its name, the torch
                 and CUDA versions, ``nvidia-smi``'s name and power limit,
                 and PIL's version (or "absent").
2. build       - one nvcc per source, all started together, compiles
                 ``csrc/intersect.cu``, ``csrc/gather.cu``, ``csrc/vm.cu``,
                 ``csrc/bvh.cu``, ``csrc/packet_exp.cu``, ``csrc/kd_stage.cu``
                 and ``csrc/rows.cu`` for sm_90a, and one more links them into
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
                 counts). The row sums (the table-row gather's backward)
                 on every row sum of a 512^2 PT gradient's backward against
                 their plain version, aten's accumulate, at rtol 1e-5 and
                 repeatable bit for bit, timed against their bound (bytes),
                 the plain version and ``index_put_(accumulate=True)``
                 alone. With ``--parent``: phase parent-ab, the parent
                 tree's kernels built by the same nvcc flags and timed in
                 turns with this tree's through this tree's wrappers, their
                 outputs compared: B6 (redesigned since) at 64 and 528
                 tiles, bit for bit; B1-B5, which the parent shares, as an
                 A/A check (B1 on every closest-hit call of one PPM and one
                 VCM iteration and on the 4096-triangle soup, B2 over one
                 VCM iteration, B3 at the PPM main shape, B4 and B5 on
                 every call of their iterations).
3a. b6         - the packet node-step microbenchmark's kernel (B6) in each
                 of its nine variants against its plain version bit for
                 bit at the defaults (64 tiles, 64 steps, 49,152 rows) and
                 at 528 tiles (4 for each SM), each timed (kernel and
                 plain) with its bound (8 slab tests of 24 FP32 operations
                 a ray and step), with the CTAs a tile (2 when twice the
                 tiles fit the SMs) printed and checked; then the
                 microbenchmark's entry point (``python -m
                 oppositerenderer_tpu_torch.scripts.packet_kernel_exp``'s
                 main) at its defaults once per variant: its two lines,
                 (1 + 5) x 9 launches.
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
                 B4's zero gradient), rel 5e-3; each through the eager
                 ``diff.render_loss_and_grad`` and through the captured
                 ``diff.make_sharded_loss_and_grad`` over the rank-less
                 mesh (a replay of the graph of forward and backward).
12b. grad-main - the captured gradient: ``make_sharded_loss_and_grad``
                 over the rank-less mesh with respect to kd and the
                 emission scale at once, at 512^2: PT, PPM (1<<20 photons)
                 and VCM (L = 10). A replay against the eager route
                 (``fn.eager``): bit for bit where two eager calls are,
                 else within rel 1e-5, the eager calls' own difference
                 printed; the capture's launches equal an eager call's,
                 the wrappers' counters still over the replays; forward +
                 backward seconds in turns (eager, graph, graph, eager; 3
                 calls a turn), median and spread; capture seconds, the
                 graph pool's bytes, peak memory of an eager call and of
                 a replay, and one profiled replay (device busy time, the
                 costliest operations). Then three steps of gradient
                 descent (Polyak step) on the wall's kd toward a target
                 rendered at 0.8 kd with the same seed, PT 512^2 (eager):
                 the loss must fall at every step.
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
16a. bench     - ``bench_torch.main([])``: the JAX bench's six cases
                 (bench.py:230-255) at full size on the card, in its
                 protocol (one warm-up render, 3 timed reps, each after a
                 restart, median, min and spread), which the main phases
                 above share (``bench_torch.timed_renders``); its JSON
                 line is printed. Every case must have replayed a graph,
                 at a finite and positive rays/s, and launched over its
                 reps each kernel its path runs and no other: B1 and B2
                 (pt, ppm, vcm, vcm_vm), B3 (ppm), B4 (vcm_vm), B5 closest
                 and any hit (atrium_pt, conference_pt).
16b. pass-timing - ``python -m oppositerenderer_tpu_torch.scripts.
                 pass_timing --method both`` at 512^2: the JAX script's
                 eight passes in its order, each a captured call timed
                 over 5 replays; ppm_gather must have launched B3.
16c. vcm-modes - ``python -m oppositerenderer_tpu_torch.scripts.
                 vcm_modes_bench`` at 512^2: the four VCM modes, each a
                 captured iteration timed over 3 replays; the two with
                 vertex merging must launch B4, the two without must not.
                 Each of 16a-16c prints nvidia-smi's SM and memory clocks,
                 power draw and temperature before and after it.
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
                 with the CPU kd-tree, both replaying a captured graph:
                 one warm-up, 3 timed reps of 2 iterations, B1 2 x 16, B2
                 2 x 4 and B3 no launch a rep; the hash's build timed in
                 one more eager iteration, the kd-tree's host build by its
                 host node's own clock in the reps' last replay; one more
                 iteration profiled; the
                 image mean against the grid's at the same seed within the
                 JAX package's bars (the hash's within 25%, the kd-tree's
                 within 5%); the mean |difference| per pixel printed.
19a. graphs    - the compiled iteration. On the card a Renderer renders
                 PT, PPM (grid, hash, kd-tree, medium), VCM and VCM+VM,
                 dense and BVH, as replays of one iteration captured in a
                 CUDA graph (renderer.CapturedStep; the kd-tree's host
                 build as a host node between two copies, its gather as
                 512 captured steps), so every main phase above times the
                 graph route; a phase's launches are its
                 wrappers' counts (eager iterations: the first of each
                 capture) plus the replays' (the capture's counts times
                 the replays). For PT main, PPM main, PPM in the medium,
                 the hash, the kd-tree, VCM main, VCM+VM main, Atrium PT
                 512^2 and Conference PT 1024^2, at the main phases'
                 iteration counts: the film of n replays against the film
                 of the eager body (the graph's plain version), bit for
                 bit (VCM and VCM+VM, whose t=1 splats add atomically, at
                 shard-main's bar, the max difference printed); for the
                 kd-tree also the replays' photons_visited and kd_overrun
                 equal to the eager body's, B1 16, B2 4 and B3 0 launches
                 a replay and the host node's build seconds; one eager
                 step with the iteration, key and radius as device
                 tensors under torch.cuda.set_sync_debug_mode("error")
                 (not the kd-tree's, whose eager gather reads a live-lane
                 flag by design: its capture shows its body reads none);
                 the capture's launches equal to an eager iteration's,
                 and the wrappers' counters still during the replays;
                 ms/iter eager against graph in turns (eager, graph,
                 graph, eager), median and spread; the capture's seconds,
                 the graph pool's bytes and the device's idle share over
                 one replayed iteration under torch.profiler (the device
                 alone), and over one eager iteration (its busy time
                 beside); a camera
                 restart (Camera.orbit) that replays the same graph and
                 equals the eager film at the new camera. Each line
                 carries nvidia-smi's name and power limit.

20. shard-main - the distribution's sharded step (parallel/render.py) over
                 a one-rank NCCL process group in this process, at full
                 width, iteration 1, seed 0: PT on CornellSmall 512^2, PPM
                 main with the all-to-all and the all-gather exchange,
                 VCM+VM at vcm-vm-main's configuration, PT on Atrium 512^2.
                 Three runs: the unsharded Renderer iteration (a replay),
                 the sharded step's eager route and the captured sharded
                 step (a replay of one CUDA graph holding the step and its
                 NCCL collectives). Each sharded band must equal the
                 unsharded iteration bit for bit (VCM+VM: 99.9% of the
                 pixels within rtol 1e-4, the mean within 1e-5: its t=1
                 splats add atomically) with the same kernel launches;
                 the three are timed in turns (unsharded, eager, graph,
                 graph, eager, unsharded), with the capture's seconds and
                 pool bytes. B3 also runs on the partial grids of a 2-way
                 exchange of PPM main's photons, against its plain version.
21. grad-shard - the sharded gradient on the one NCCL rank at 512^2: PT
                 d mean(image) / d kd and PPM main (all-to-all) d/demission
                 scale, the captured gradient (the collectives' backward in
                 the graph) and its eager route against the unsharded
                 gradient (rel 5e-3), forward + backward seconds of each.
22. ranks      - two worker processes (python -m
                 oppositerenderer_tpu_torch.parallel.worker, spawned after
                 the kernels are built) share the card over gloo and run:
                 shard-ranks (tests/test_torch_sharding.py's seven cases at
                 64^2 against the unsharded card render at its bars; PPM
                 main's exchange, whose partial grids must hold every photon
                 and its power within 1e-5, and its step, whose image mean
                 must be within 1% of the unsharded); multihost (PT 512^2,
                 8 iterations, strided and leased through the scheduler,
                 the merged film against one process's at rtol 2e-5, atol
                 1e-6; merge ms); and grad-shard's 2-rank PT gradient at
                 64^2 against the unsharded one (rel 5e-3).
22a. sharded-phase - ``python -m oppositerenderer_tpu_torch.scripts.
                 sharded_phase_bench``'s four regimes (PPM all-to-all and
                 all-gather at 1<<16 photons, VCM paired and uniform at
                 L = 6; 128^2, iteration 0, seed 0) over 4 worker
                 processes sharing the card over gloo (one spawn; the JAX
                 mesh had 8), then over one NCCL rank on the card it maps
                 to (``distributed.rank_device``; the step replays a
                 captured graph): one warm-up and 3 timed steps each,
                 the table with the bytes sent beside the JAX script's
                 37-byte model; each gathered image against the unsharded
                 card render (all-gather bit for bit, VCM at rtol 1e-5,
                 all-to-all by its mean within 1%, no photon lost).
22b. scaling   - ``python -m oppositerenderer_tpu_torch.scripts.
                 scaling_bench``'s job, PT 16 and PPM 8 iterations at
                 512^2, over 1 and 2 processes sharing the card (gloo),
                 each pinned to a core: the merged film against one
                 process's at rtol 2e-5, atol 1e-6, the iteration count
                 exact, every process one or more; each record printed.
23. tooling    - ``debug.check_iteration`` finds no NaN or infinity in any
                 pass output of PT, PPM and VCM main; the photon
                 histogram (2^16 photons) on the card against the CPU's
                 (at most 0.1% of the paths one deposit apart);
                 ``core.profiling.trace`` of a PT main iteration holds a
                 CUDA kernel and the pt_raytrace_pass range; the device
                 table lists the card and the CPU.
24. viewer     - ``viewer.RenderService`` at PT main behind
                 ``make_server(port=0)``: frames and stats over HTTP until
                 4 iterations, a switch to PPM and then VCM (each restarts
                 and serves a decodable, finite, non-black frame), a gamma
                 change with no restart, a clean stop of both threads; the
                 renders must have launched B1, B2 and B3.

The line before the last is a JSON object with the kernels' launches over
the main phases (5, 8, 8b, 11, 12, 12b's graph turns, 15, 16, 16a's,
16b's and 16c's timed replays, 18, 19,
19a's graph turns, 20's sharded timed steps, eager and replayed, and 22's,
22a's and 22b's workers, summed over their ranks; B6's over 3a's run of the
microbenchmark), errors, times and bounds; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import dataclasses
import importlib
import json
import math
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

import bench_torch
from bench_torch import (card_line, launch_counts, ppm_rays_per_iteration,
                         pt_rays_per_iteration, vcm_rays_per_iteration)

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
# grad-main: the captured gradient against its eager route where two
# eager calls differ (atomic sums in the backward), and calls a timed turn
GRAD_GRAPH_RTOL = 1e-5
GRAD_TURN_CALLS = 3
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
# distribution: shard-main and grad-shard's first part run one NCCL rank in
# this process at full width; phase ranks spawns RANKS worker processes
# that share the card over gloo (shard-ranks, multihost, grad-shard's
# second part). Sharded steps render iteration SHARD_ITERATION; each is
# timed in turns with the unsharded iteration (unsharded, sharded,
# sharded, unsharded) over SHARD_TIMING_ITERS iterations a turn.
SHARD_ITERATION = 1
SHARD_TIMING_ITERS = {"PT": 5, "PPM": 3, "VCM+VM": 1, "Atrium PT": 3}
# VCM's t=1 splats add atomically on the card, so two renders of its
# image agree to float tolerance, not bits: share of pixels within rtol,
# and the image mean
SHARD_PIXEL_RTOL, SHARD_MIN_AGREEING, SHARD_MEAN_RTOL = 1e-4, 0.999, 1e-5
# graphs: the camera restart's orbit (radians about and toward the up
# axis), small enough that every cell's camera stays inside its scene
GRAPH_ORBIT = (0.05, 0.02)
RANKS = 2
RANKS_SIZE = 64
# 2-rank sharded image against the unsharded one where a sum over ranks
# adds in another order (the CPU tests' bar): rtol + atol * max|ref|
RANKS_RTOL, RANKS_ATOL_OF_MAX = 1e-5, 1e-6
# PPM main over 2 ranks' partial grids: the tile gather takes another
# 256-photon block of a row longer than that (a partial grid holds a
# row's photons in another order), so the image agrees in its mean
RANKS_PPM_MEAN_RTOL = 0.01
EXCHANGE_POWER_RTOL = 1e-5
MULTIHOST_ITERS = 8
MULTIHOST_RTOL, MULTIHOST_ATOL = 2e-5, 1e-6
GRAD_SHARD_RTOL = 5e-3
# sharded-phase: the port of scripts/sharded_phase_bench.py at the JAX
# script's size (128^2, 1<<16 photons, L = 6) over 4 gloo ranks sharing
# the card (the JAX mesh had 8; 4 keeps the phase short), then over one
# NCCL rank; 3 timed steps after a warm-up
SHARDED_PHASE_RANKS = 4
SHARDED_PHASE_SIZE = 128
SHARDED_PHASE_PHOTONS = 1 << 16
SHARDED_PHASE_PATH_LENGTH = 6
SHARDED_PHASE_REPS = 3
# scaling: the port of scripts/scaling_bench.py, PT 16 and PPM 8
# iterations at MAIN_SIZE over 1 and 2 processes sharing the card (gloo)
SCALING_NPROC = 2
SCALING_ITERS = 16     # the JAX script's --iters default

# b6: the microbenchmark's defaults (scripts/packet_kernel_exp.py), and
# 528 = 4 x 132 tiles: 4 blocks for each SM of the H100
B6_STEPS, B6_TILES, B6_ROWS = 64, 64, 48 * 1024
B6_WIDE_TILES = 528
B6_SCRIPT_REPS = 5
# tooling: photons of the histogram held card against CPU; a path may end
# one deposit apart after a last-ulp difference (tests/test_torch_debug.py)
HISTOGRAM_PHOTONS = 1 << 16
HISTOGRAM_MAX_MOVED = 1e-3
# viewer: iterations the first frame waits for, and each wait's deadline
VIEWER_ITERS = 4
VIEWER_TIMEOUT_S = 300

# the card's peaks at the 700 W limit: HBM bytes/s (NVIDIA H100 SXM data
# sheet) and FP32 instructions/s outside the tensor cores. The data
# sheet's 67e12 counts a fused multiply-add as two operations; the kernels
# are built with --fmad=false and every operation counted below is one
# instruction, so the rate is one per lane and cycle: 128 lanes x 132 SMs
# x 1.98 GHz = 33.5e12
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 33.5e12
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
    "packet_steps": "scripts/packet_kernel_exp.py:124",
    "sum_rows": "none: the table-row gather's backward, aten's accumulate",
}
KERNEL_SOURCES = {
    "closest_hit_tris": "oppositerenderer_tpu_torch/csrc/intersect.cu",
    "occluded_tris": "oppositerenderer_tpu_torch/csrc/intersect.cu",
    "gather_photons_tiled": "oppositerenderer_tpu_torch/csrc/gather.cu",
    "merge_vertices_tiled": "oppositerenderer_tpu_torch/csrc/vm.cu",
    "traverse": "oppositerenderer_tpu_torch/csrc/bvh.cu",
    "traverse_any": "oppositerenderer_tpu_torch/csrc/bvh.cu",
    "packet_steps": "oppositerenderer_tpu_torch/csrc/packet_exp.cu",
    "sum_rows": "oppositerenderer_tpu_torch/csrc/rows.cu",
}
# the kernels each case of bench_torch.py launches, and no other
BENCH_KERNELS = {
    "pt": ("closest_hit_tris", "occluded_tris"),
    "ppm": ("closest_hit_tris", "occluded_tris", "gather_photons_tiled"),
    "vcm": ("closest_hit_tris", "occluded_tris"),
    "vcm_vm": ("closest_hit_tris", "occluded_tris", "merge_vertices_tiled"),
    "atrium_pt": ("traverse", "traverse_any"),
    "conference_pt": ("traverse", "traverse_any"),
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


def ppm_main_config():
    """The JAX bench's PPM case (bench.py:232-235) at 512^2."""
    from oppositerenderer_tpu_torch.config import RenderConfig, RenderMethod
    return RenderConfig(width=MAIN_SIZE, height=MAIN_SIZE,
                        render_method=RenderMethod.PROGRESSIVE_PHOTON_MAPPING,
                        photons_per_iteration=PPM_MAIN_PHOTONS)


def bound(n_bytes: float, flops: float) -> dict:
    """The least time the card could take for the work: the larger of the
    bytes over the HBM rate and the FP32 operations over the FP32
    instruction rate."""
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
    print(card_line())   # name, power limit
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
    out["sum_rows"] = row_sum_cases(dev)
    return out


def pt_grad_row_sums(dev) -> list:
    """(idx, g, rows) of every row sum in the backward of one CornellSmall
    512^2 PT gradient (kd of material 0 and the emission scale, eager): the
    backward of each gather of a field that requires grad."""
    from oppositerenderer_tpu_torch.accel import row_kernels as rk
    from oppositerenderer_tpu_torch.config import RenderConfig
    from oppositerenderer_tpu_torch.scene import get_scene_by_name
    scene, cam = get_scene_by_name(MAIN_SCENE, dev)
    calls = []
    real = rk.sum_rows

    def record(idx, g, rows):
        calls.append((idx, g.contiguous(), rows))
        return rk.sum_rows_plain(idx, g, rows)

    rk.sum_rows = record
    try:
        for param in ("kd", "emission_scale"):
            loss_and_grad(scene, cam, RenderConfig(width=MAIN_SIZE,
                                                   height=MAIN_SIZE), param)
    finally:
        rk.sum_rows = real
    return calls


def row_sum_cases(dev) -> dict:
    """The row-sum kernel on every row sum of a 512^2 PT gradient's
    backward (:func:`pt_grad_row_sums`) against its plain version (aten's
    accumulate) in float64 at rtol 1e-5 plus 1e-6 of the largest row's
    |sum|, the float32 plain version's own difference printed; two calls
    equal bit for bit. Per call and summed over the calls: the kernel
    (graph replays), its bound (the bytes: the indices, the cotangents,
    the blocks' partials written and read, the table), the plain version
    and the library call alone (``index_put_(accumulate=True)`` into a
    zeroed table), both enqueued from the host."""
    from oppositerenderer_tpu_torch.accel import cuda_build
    from oppositerenderer_tpu_torch.accel import row_kernels as rk
    calls = pt_grad_row_sums(dev)
    if not calls:
        raise AssertionError("rows: the PT gradient summed no rows")
    tot = {"ms": 0.0, "bound_ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0}
    err = err_f32 = 0.0
    shapes = {}
    for idx, g, rows in calls:
        got, again = rk.sum_rows(idx, g, rows), rk.sum_rows(idx, g, rows)
        if not torch.equal(got, again):
            raise AssertionError("rows: two calls of the kernel differ")
        exact = rk.sum_rows_plain(idx, g.double(), rows)
        # a row sum whose cotangents are all zero must come out zero
        scale = max(float(exact.abs().max()), 1e-30)
        torch.testing.assert_close(got.double(), exact, rtol=1e-5,
                                   atol=1e-6 * scale)
        f32 = rk.sum_rows_plain(idx, g, rows).double()
        err = max(err, float((got.double() - exact).abs().max()) / scale)
        err_f32 = max(err_f32, float((f32 - exact).abs().max()) / scale)
        n, c = idx.shape[0], g[0].numel()
        part = cuda_build.library().sum_rows_blocks(n) * rows * c * 4
        bnd = bound(n * 8 + n * c * 4 + 2 * part + rows * c * 4, 0)
        table = torch.zeros_like(got)
        ms = {"ms": cuda_ms(lambda: rk.sum_rows(idx, g, rows)),
              "bound_ms": bnd["bound_ms"],
              "plain_ms": cuda_ms(lambda: rk.sum_rows_plain(idx, g, rows),
                                  batch=1, graph=False),
              "library_ms": cuda_ms(lambda: table.index_put_(
                  (idx,), g, accumulate=True), batch=1, graph=False)}
        for k, v in ms.items():
            tot[k] += v
        shapes.setdefault((n, rows, c), ms)
    for (n, rows, c), ms in shapes.items():
        print(f"[kernels] rows {rows} x {c}, {n} lanes: kernel "
              f"{ms['ms']:.4f} ms, bound {ms['bound_ms']:.4f} (bytes), plain "
              f"{ms['plain_ms']:.4f}, index_put_ accumulate "
              f"{ms['library_ms']:.4f}")
    print(f"[kernels] sum_rows on the {len(calls)} row sums of a "
          f"{MAIN_SCENE} {MAIN_SIZE}^2 PT gradient's backward (kd, then the "
          f"emission scale): off the float64 sums by {err:.3g} of the "
          f"largest |sum| at most (aten's float32 accumulate {err_f32:.3g}), "
          f"repeatable bit for bit; summed: kernel {tot['ms']:.4f} ms, bound "
          f"{tot['bound_ms']:.4f}, plain {tot['plain_ms']:.4f}, index_put_ "
          f"accumulate {tot['library_ms']:.4f}")
    return {"max_rel_err": err, "plain_rel_err": err_f32,
            "calls": len(calls), **{k: v / len(calls) for k, v in
                                    tot.items()},
            "per_step": tot, "bound_by": "bytes"}


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
    try:   # the eager body: a replay would call no wrapper
        r = Renderer(scene, cam, cfg, seed=0)
        r._iteration(0, r._radius_sq(0))
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
    try:   # the eager body: a replay would call no wrapper
        r._iteration(0, r._radius_sq(0))
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
               active, radius_sq, mis_vc_w, n_light_paths, u_rows, depth1,
               mesh=None):
        calls.append(dict(
            vgrid=vgrid, cam_bsdf=cam_bsdf, cam_pos=cam_pos,
            cam_thr=cam_thr, cam_dVCM=cam_dVCM, cam_dVM=cam_dVM,
            active=active, radius_sq=radius_sq, mis_vc_w=mis_vc_w,
            n_light_paths=n_light_paths, u_rows=u_rows, depth1=depth1))
        return merge(vgrid, cfg, cam_bsdf, cam_pos, cam_thr, cam_dVCM,
                     cam_dVM, active, radius_sq, mis_vc_w, n_light_paths,
                     u_rows, depth1, mesh=mesh)

    vcm.merge_vertices_tiled = record
    try:   # the eager body: a replay would call no wrapper
        r._iteration(0, r._radius_sq(0))
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
        graph = r.kernel_launches()
        dense, walked = [w.launches - c + graph.get(w.__name__, 0)
                         for w, c in zip((ik.closest_hit_tris, bk.traverse),
                                         before)]
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


def _reset_launches() -> None:
    from oppositerenderer_tpu_torch.accel import kernel_wrappers
    for w in kernel_wrappers():
        w.launches = 0


def graph_pool_gib(r) -> float:
    """The GiB the renderer's captured step reserved at its capture (its
    graph pool, which a replay reuses: the peak a timed rep measures
    leaves it out)."""
    step = r.captured_step
    return 0.0 if step is None else step.pool_bytes / 2 ** 30


def timed_reps(r, iters: int, wrappers, expected: dict, tag: str):
    """MAIN_REPS timed renders of ``iters`` iterations in the bench's
    protocol (``bench_torch.timed_renders``: each after a restart, every
    count set to 0 before it); in every rep each wrapper must launch its
    kernel ``expected`` times (on the graph route: the replays' launches,
    the wrappers' own counts staying at 0). Returns (launches summed over
    the reps, seconds per rep, the last rep's film)."""
    times, per_rep = bench_torch.timed_renders(r, iters, MAIN_REPS)
    launches = {w.__name__: 0 for w in wrappers}
    for rep, (t, every) in enumerate(zip(times, per_rep)):
        counts = {w.__name__: every[w.__name__] for w in wrappers}
        print(f"[{tag}] rep {rep}: {t:.4f} s, launches {counts}")
        for k, c in counts.items():
            if c != expected[k]:
                raise AssertionError(f"{k} launched {c} times in a {tag} "
                                     f"rep, expected {expected[k]}")
            launches[k] += c
    return launches, times, r.film


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
          f"{peak / 2 ** 30:.3f} GiB besides the graph pool's "
          f"{graph_pool_gib(r):.3f} GiB; per iteration: "
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


def grad_parity_fn(scene, cam, cfg, param: str, mesh):
    """The captured gradient of :func:`loss_and_grad`'s loss on ``mesh``
    (``diff.make_sharded_loss_and_grad``, one rank: the mean image of
    iteration 0 at GRAD_R2, seed 0)."""
    from oppositerenderer_tpu_torch import diff
    start = scene.materials.kd[0] if param == "kd" else 1.0
    return diff.make_sharded_loss_and_grad(scene, cam, cfg, mesh,
                                           {(param, 0): start})


def grad_args() -> dict:
    from oppositerenderer_tpu_torch.core.rng import make_root_key
    return dict(iteration=0, key=make_root_key(0), radius_sq=GRAD_R2)


def phase_grad_parity(dev) -> None:
    """Gradients of 32^2 iterations on the card against the CPU port's:
    the eager ``render_loss_and_grad`` and the captured sharded gradient
    over the rank-less mesh (a replay), each at the case's bar."""
    from oppositerenderer_tpu_torch.parallel import make_mesh
    from oppositerenderer_tpu_torch.scene import get_scene_by_name
    mesh = make_mesh(1, device=dev)
    for label, tol, cfg, param in grad_parity_cases():
        out = []
        for d in (dev, torch.device("cpu")):
            scene, cam = get_scene_by_name(MAIN_SCENE, d)
            out.append(loss_and_grad(scene, cam, cfg, param))
        (lc, gc), (lh, gh) = out
        rel = float(((gc - gh).abs() / gh.abs()).max())
        scene, cam = get_scene_by_name(MAIN_SCENE, dev)
        fn = grad_parity_fn(scene, cam, cfg, param, mesh)
        fn(**grad_args())                       # eager, then the capture
        lr, gr = fn(**grad_args())              # a replay
        gr = gr[(param, 0)].double().cpu()
        rel_graph = float(((gr - gh).abs() / gh.abs()).max())
        if fn.captured is None or fn.captured.replays != 1:
            raise AssertionError(f"{label}: the gradient was not replayed")
        print(f"[grad-parity] {label} {GRAD_PARITY_SIZE}^2: loss card "
              f"{lc:.7g} CPU {lh:.7g}; gradient card {gc.tolist()} CPU "
              f"{gh.tolist()}: max rel err {rel:.3g}; captured on the card "
              f"(a replay) loss {float(lr):.7g}, gradient {gr.tolist()}: "
              f"max rel err {rel_graph:.3g} (bound {GRAD_RTOL[tol]})")
        if (not bool(torch.isfinite(gc).all()) or not bool((gh > 0).all())
                or max(rel, rel_graph) > GRAD_RTOL[tol]):
            raise AssertionError(f"{label} gradient on the card differs "
                                 "from the CPU port's")


def grads_rel(got, want) -> float:
    """Largest relative difference of (loss, grads) ``got`` from
    ``want`` over the loss and every gradient element."""
    pairs = [(got[0], want[0])] + [(got[1][k], v) for k, v in
                                   want[1].items()]
    return max(float(((a.double() - b.double()).abs()
                      / b.double().abs().clamp_min(1e-30)).max())
               for a, b in pairs)


def grads_equal(got, want) -> bool:
    return torch.equal(got[0], want[0]) and all(
        torch.equal(got[1][k], v) for k, v in want[1].items())


def phase_grad_main(dev) -> dict:
    """The captured gradient at full width (PT, PPM main and VCM main at
    512^2, d/dkd and d/demission_scale in one call) over the rank-less
    mesh, against its eager route (``fn.eager``, the graph's plain
    version): loss and gradients bit for bit where two eager calls are,
    else within GRAD_GRAPH_RTOL beside the eager calls' own difference;
    launches per call equal; forward + backward seconds in turns (eager,
    graph, graph, eager; GRAD_TURN_CALLS calls a turn), capture seconds,
    the graph pool's bytes, peak memory of a replay and of an eager call,
    and one replay under torch.profiler (device busy time, the costliest
    operations). Then three steps of gradient descent on the wall's kd
    toward a target rendered at 0.8 kd with the same seed (PT 512^2,
    eager). Returns the replays' launches (the graph turns)."""
    from oppositerenderer_tpu_torch import diff
    from oppositerenderer_tpu_torch.accel import kernel_wrappers
    from oppositerenderer_tpu_torch.config import RenderConfig
    from oppositerenderer_tpu_torch.parallel import make_mesh
    from oppositerenderer_tpu_torch.renderer import Renderer
    from oppositerenderer_tpu_torch.scene import get_scene_by_name
    scene, cam = get_scene_by_name(MAIN_SCENE, dev)
    mesh = make_mesh(1, device=dev)
    wrappers = kernel_wrappers()
    launches = {w.__name__: 0 for w in wrappers}
    card = card_line()
    rows = []
    cases = (("PT", RenderConfig(width=MAIN_SIZE, height=MAIN_SIZE)),
             ("PPM", ppm_main_config()), ("VCM", vcm_main_config()))
    for label, cfg in cases:
        wrt = {("kd", 0): scene.materials.kd[0],
               ("emission_scale", 0): 1.0}
        fn = diff.make_sharded_loss_and_grad(scene, cam, cfg, mesh, wrt)
        step = fn.captured
        if step is None:
            raise AssertionError(f"grad-main {label}: no graph route")
        fn(**grad_args())                        # eager, then the capture
        # the eager route twice: its launches a call, its repeatability,
        # its peak
        before = [w.launches for w in wrappers]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        e1 = fn.eager(**grad_args())
        torch.cuda.synchronize()
        eager_peak = torch.cuda.max_memory_allocated(dev)
        e2 = fn.eager(**grad_args())
        torch.cuda.synchronize()
        eager_counts = {w.__name__: (w.launches - b) // 2
                        for w, b in zip(wrappers, before)}
        if step.capture_launches != eager_counts:
            raise AssertionError(f"grad-main {label}: the capture launches "
                                 f"{step.capture_launches}, an eager call "
                                 f"{eager_counts}")
        counts = [w.launches for w in wrappers]
        replays = step.replays
        torch.cuda.reset_peak_memory_stats(dev)
        g = fn(**grad_args())
        torch.cuda.synchronize()
        replay_peak = torch.cuda.max_memory_allocated(dev)
        # equality: the eager calls' own difference first
        eager_bits = grads_equal(e1, e2)
        eager_rel = grads_rel(e2, e1)
        rel = grads_rel(g, e1)
        if eager_bits and not grads_equal(g, e1):
            raise AssertionError(f"grad-main {label}: the replay differs "
                                 f"from the eager route (max rel {rel:.3g}),"
                                 " which repeats bit for bit")
        if rel > GRAD_GRAPH_RTOL:
            raise AssertionError(f"grad-main {label}: the replay is off the "
                                 f"eager route by {rel:.3g} (eager calls "
                                 f"{eager_rel:.3g})")
        found = ("equal bit for bit" if grads_equal(g, e1) else
                 f"max rel {rel:.3g} (two eager calls: {eager_rel:.3g})")
        # timing in turns
        times = {"eager": [], "graph": []}
        for kind in ("eager", "graph", "graph", "eager"):
            call = fn.eager if kind == "eager" else fn
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(GRAD_TURN_CALLS):
                out = call(**grad_args())
            torch.cuda.synchronize()
            times[kind].append((time.perf_counter() - t0) / GRAD_TURN_CALLS)
        if [w.launches for w in wrappers] != [
                c + 2 * GRAD_TURN_CALLS * eager_counts[w.__name__]
                for c, w in zip(counts, wrappers)]:
            raise AssertionError(f"grad-main {label}: a wrapper was called "
                                 "during the replays")
        # where a replay's time goes: the device alone
        prof = profile_iteration(None, f"grad-main {label} replay",
                                 lambda: fn(**grad_args()), host=False)
        n_replays = step.replays - replays
        for k, c in step.capture_launches.items():
            launches[k] += c * n_replays
        loss, grads = out
        kd_g, em_g = (grads[k].double().cpu() for k in wrt)
        if (not bool(torch.isfinite(kd_g).all()) or not bool((kd_g > 0).all())
                or not float(em_g) > 0):
            raise AssertionError(f"{label}: gradient not finite and "
                                 "positive")
        eager_s, graph_s = (statistics.median(times[k])
                            for k in ("eager", "graph"))
        spread = {k: (max(v) - min(v)) / statistics.median(v)
                  for k, v in times.items()}
        launched = {k: c for k, c in step.capture_launches.items() if c}
        print(f"[grad-main] {label} {MAIN_SIZE}^2 d/dkd, d/demission_scale "
              f"over the rank-less mesh: loss {float(loss):.6g}, gradients "
              f"{kd_g.tolist()}, {float(em_g):.6g}; the replay against the "
              f"eager route: {found}; launches a call {launched}, equal; "
              f"forward + backward s in turns (eager, graph, graph, eager, "
              f"{GRAD_TURN_CALLS} calls a turn): eager {eager_s:.4f} "
              f"({', '.join(f'{t:.4f}' for t in times['eager'])}; spread "
              f"{spread['eager']:.4f}), graph {graph_s:.4f} "
              f"({', '.join(f'{t:.4f}' for t in times['graph'])}; spread "
              f"{spread['graph']:.4f}), {eager_s / graph_s:.3f}x; capture "
              f"{step.capture_seconds:.3f} s, pool {step.pool_bytes} bytes; "
              f"peak memory eager {eager_peak / 2 ** 30:.3f} GiB, replay "
              f"{replay_peak / 2 ** 30:.3f} GiB besides the pool; device "
              f"busy over a profiled replay {prof['busy_ms']:.3f} ms "
              f"({prof['operations']} operations, idle {prof['idle']:.4f});"
              f" {card}")
        rows.append({"cell": label, "eager_s": eager_s, "graph_s": graph_s,
                     "spread": spread, "capture_s": step.capture_seconds,
                     "pool_bytes": step.pool_bytes,
                     "eager_peak_bytes": eager_peak,
                     "replay_peak_bytes": replay_peak,
                     "bit_for_bit": grads_equal(g, e1), "rel": rel,
                     "eager_rel": eager_rel, "busy_ms": prof["busy_ms"],
                     "idle": prof["idle"]})
        step.release()
        del fn, step, e1, e2, g, out
        torch.cuda.empty_cache()
    print(f"[grad-main] {json.dumps(rows)}")

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
    return launches


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


def profile_iteration(r, tag: str, render=None, host: bool = True) -> dict:
    """One more iteration (``r.render(1)``, or ``render()``) under
    torch.profiler: device operations launched, their summed device time
    against the profiled wall time, the costliest ones and the port's
    kernels, and, with ``host``, the host time of the integrator's ranges
    (whose device-side annotations are not operations; a graph replay
    runs no range). Returns the operations, busy ms, wall ms and idle
    share."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    activities = [ProfilerActivity.CUDA]
    if host:
        activities.append(ProfilerActivity.CPU)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        if render is None:
            r.render(1)
        else:
            render()
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
    if n_ops == 0:
        raise AssertionError(f"{tag}: the profile holds no device operation")
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
    return {"operations": n_ops, "busy_ms": busy_ms, "wall_ms": wall_ms,
            "idle": 1.0 - busy_ms / wall_ms}


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
          f"{stored:.6g}; peak device memory {peak:.3f} GiB besides the "
          f"graph pool's {graph_pool_gib(r):.3f} GiB")

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
          f"memory {peak:.3f} GiB besides the graph pool's "
          f"{graph_pool_gib(r):.3f} GiB")

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
# the measurement entry points: bench_torch.py and the two pass scripts
def card_state() -> str:
    """``nvidia-smi``'s SM and memory clocks, power draw and temperature
    now (printed beside the measurement phases' figures)."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,"
                          "power.draw,temperature.gpu",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return (smi.stdout or smi.stderr).strip().splitlines()[0]


def phase_bench(dev) -> dict:
    """``bench_torch.main([])``: the JAX bench's six cases at full size on
    the card, its JSON line printed by it. Every case must have replayed a
    graph, at a finite and positive rays/s, and launched over its reps
    each kernel of BENCH_KERNELS[case] and no other."""
    print(f"[bench] before: {card_state()}")
    result = bench_torch.main([])
    print(f"[bench] after: {card_state()}")
    d = result["detail"]
    launches = {k: 0 for k in KERNELS}
    for case in bench_torch.CASES:
        c = d[case]
        print(f"[bench] {case}: {c['scene']} {c['resolution']}, "
              f"{c['iterations']} iterations: ms/iter median "
              f"{c['ms_per_iteration']:.3f}, min "
              f"{c['ms_per_iteration_min']:.3f}, spread {c['spread']:.4f}; "
              f"rays/s {c['rays_per_s']:.4g}; first frames "
              f"{c['compile_seconds']:.3f} s; load_1m {c['load_1m']} "
              f"(ok {c['load_ok']}); graph {c['graph']}; launches "
              + str({k: v for k, v in c["launches"].items() if v}))
        if not c["graph"]:
            raise AssertionError(f"bench case {case} did not replay a graph")
        if not (math.isfinite(c["rays_per_s"]) and c["rays_per_s"] > 0):
            raise AssertionError(f"bench case {case}: rays/s "
                                 f"{c['rays_per_s']}")
        for k, v in c["launches"].items():
            if (v > 0) != (k in BENCH_KERNELS[case]):
                raise AssertionError(f"bench case {case} launched {k} {v} "
                                     "times")
            launches[k] += v
    if not d["graph"]:
        raise AssertionError("the bench's detail does not say graph")
    print(f"[bench] {card_line()}; kernels built in "
          f"{d['build_seconds']:.3f} s")
    return launches


def phase_pass_timing(dev) -> dict:
    """``python -m oppositerenderer_tpu_torch.scripts.pass_timing --method
    both`` at 512^2: the JAX script's eight passes, each a captured call;
    ppm_gather must have timed B3."""
    from oppositerenderer_tpu_torch.scripts import pass_timing
    print(f"[pass-timing] before: {card_state()}")
    res = pass_timing.main(["--method", "both", "--size", str(MAIN_SIZE)])
    print(f"[pass-timing] after: {card_state()}")
    if tuple(res) != pass_timing.NAMES:
        raise AssertionError(f"pass_timing printed {tuple(res)}")
    launches = {k: 0 for k in KERNELS}
    for name, rec in res.items():
        if not (math.isfinite(rec["seconds"]) and rec["seconds"] > 0):
            raise AssertionError(f"pass {name} took {rec['seconds']} s")
        for k, v in rec["launches"].items():
            launches[k] += v
    b3 = res["ppm_gather"]["launches"].get("gather_photons_tiled", 0)
    print(f"[pass-timing] {card_line()}; ppm_gather launched B3 {b3} times "
          "over its replays; launches "
          + str({k: v for k, v in launches.items() if v}))
    if b3 < 1:
        raise AssertionError("pass_timing's ppm_gather did not run B3")
    return launches


def phase_vcm_modes(dev) -> dict:
    """``python -m oppositerenderer_tpu_torch.scripts.vcm_modes_bench`` at
    512^2: four modes, each a captured call; the modes with vertex
    merging must launch B4, the others must not."""
    from oppositerenderer_tpu_torch.scripts import vcm_modes_bench
    print(f"[vcm-modes] before: {card_state()}")
    recs = vcm_modes_bench.main(["--size", str(MAIN_SIZE)])
    print(f"[vcm-modes] after: {card_state()}")
    if len(recs) != 4:
        raise AssertionError(f"vcm_modes_bench ran {len(recs)} modes")
    launches = {k: 0 for k in KERNELS}
    for rec in recs:
        b4 = rec["launches"].get("merge_vertices_tiled", 0)
        if (b4 > 0) != rec["vm"] or not rec["seconds"] > 0:
            raise AssertionError(f"vcm mode {rec}: B4 launched {b4} times")
        for k, v in rec["launches"].items():
            launches[k] += v
    print(f"[vcm-modes] {card_line()}; B4 launches by mode "
          + str([rec["launches"].get("merge_vertices_tiled", 0)
                 for rec in recs]))
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


def eager_build_seconds(r, ppm, builder: str) -> float:
    """The seconds of ``ppm.<builder>`` in one iteration of ``r``'s eager
    body (a replay would not call it)."""
    build = getattr(ppm, builder)
    build_s = []

    def timed_build(*args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = build(*args)
        torch.cuda.synchronize()
        build_s.append(time.perf_counter() - t0)
        return out

    setattr(ppm, builder, timed_build)
    try:
        r._iteration(0, r._radius_sq(0))
    finally:
        setattr(ppm, builder, build)
    return build_s[0]


def phase_photon_maps(dev) -> dict:
    """PPM main's configuration with the stochastic hash and with the CPU
    kd-tree, both on the graph route: one warm-up render, MAIN_REPS timed
    reps of PHOTON_MAP_ITERS iterations (B1 and B2 as on the grid, B3
    never); the build's seconds (the hash's in one more eager iteration,
    the kd-tree's by its host node's clock in the reps' last replay), and
    one more iteration is profiled; the image of the last rep against the
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
            (PhotonMapStructure.KD_TREE_CPU, None)):
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
        if builder is None:
            # the kd-tree's host build in the reps' last replay, by the
            # host node's own clock
            build_s = kd_build_seconds(r)
            build_how = "host node"
        else:
            build_s = eager_build_seconds(r, ppm, builder)
            build_how = "eager body"
        med = statistics.median(times)
        mean_rel = abs(float(img.mean() / grid.mean()) - 1.0)
        mean_abs = float((img - grid).abs().mean() / grid.abs().mean())
        print(f"[{tag}] {MAIN_SCENE} {MAIN_SIZE}x{MAIN_SIZE}, "
              f"{base.photons_per_iteration} photons: ms/iter median "
              f"{med / PHOTON_MAP_ITERS * 1e3:.3f}, min "
              f"{min(times) / PHOTON_MAP_ITERS * 1e3:.3f}, spread "
              f"{(max(times) - min(times)) / med:.4f}; build "
              f"{build_s:.4f} s an iteration ({build_how}); per iteration: "
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


# ---------------------------------------------------------------------------
# the compiled iteration: one captured CUDA graph a Renderer replays
def graph_cells(dev):
    """(label, scene, camera, config, iterations, bit for bit) of the
    graphs phase: the main phases' configurations and iteration counts."""
    from oppositerenderer_tpu_torch.config import (PhotonMapStructure,
                                                   RenderConfig)
    from oppositerenderer_tpu_torch.scene import get_scene_by_name
    scene, cam = get_scene_by_name(MAIN_SCENE, dev)
    medium = dataclasses.replace(scene, medium=scene_medium(dev))
    pt = RenderConfig(width=MAIN_SIZE, height=MAIN_SIZE)
    ppm = ppm_main_config()
    hashed = ppm.replace(
        photon_map_structure=PhotonMapStructure.STOCHASTIC_HASH)
    kd = ppm.replace(photon_map_structure=PhotonMapStructure.KD_TREE_CPU)
    yield "PT main", scene, cam, pt, MAIN_ITERS, True
    yield "PPM main", scene, cam, ppm, PPM_MAIN_ITERS, True
    yield "PPM in the medium", medium, cam, ppm, PPM_MAIN_ITERS, True
    yield "the hash", scene, cam, hashed, PHOTON_MAP_ITERS, True
    yield "the kd-tree", scene, cam, kd, PHOTON_MAP_ITERS, True
    # VCM's t=1 splats add atomically: two renders agree to float
    # tolerance (shard-main's bar), not bits
    yield "VCM main", scene, cam, vcm_main_config(), VCM_MAIN_ITERS, False
    yield ("VCM+VM main", scene, cam, vcm_main_config(True),
           VCM_VM_MAIN_ITERS, False)
    for name, size, iters in (("Atrium", ATRIUM_SIZE, ATRIUM_ITERS),
                              ("Conference", CONFERENCE_SIZE,
                               CONFERENCE_ITERS)):
        bscene, bcam = get_scene_by_name(name, dev)
        yield (f"{name} PT", bscene, bcam,
               RenderConfig(width=size, height=size), iters, True)


def eager_film(r, n: int, camera=None) -> torch.Tensor:
    """The film ``r.render(n)`` accumulates from a restart, through the
    eager body (the graph's plain version): the same chunks, sums and
    order, so the same bits where nothing adds atomically."""
    chunk = max(1, r.cfg.iterations_per_dispatch)
    fused = r._build_fused(eager=True)
    camera = r.camera if camera is None else camera
    accum = torch.zeros((r.cfg.height, r.cfg.width, 3), dtype=torch.float32,
                        device=r.device)
    done = 0
    while done < n:
        k = min(chunk, n - done)
        accum = accum + fused(camera, done, r.root_key, k, 1)[0]
        done += k
    return accum


def films_agree(label: str, got: torch.Tensor, want: torch.Tensor,
                bits: bool) -> str:
    """Raise unless the graph's film equals the eager film bit for bit
    (``bits``) or within shard-main's bar; returns what was found."""
    err = float((got - want).abs().max())
    if bits:
        if not torch.equal(got, want):
            raise AssertionError(f"graphs {label}: the graph's film differs "
                                 f"from the eager film (max |diff| {err:.3g})")
        return "equal bit for bit"
    g, w = got.double(), want.double()
    agree = float(torch.isclose(g, w, rtol=SHARD_PIXEL_RTOL,
                                atol=0.0).all(dim=-1).double().mean())
    mean_rel = abs(float(g.mean() / w.mean()) - 1.0)
    if agree < SHARD_MIN_AGREEING or mean_rel > SHARD_MEAN_RTOL:
        raise AssertionError(f"graphs {label}: {agree:.6f} of the pixels "
                             f"within rtol {SHARD_PIXEL_RTOL}, mean off by "
                             f"{mean_rel:.2e} (max |diff| {err:.3g})")
    return (f"{agree:.6f} of the pixels within rtol {SHARD_PIXEL_RTOL}, "
            f"mean off by {mean_rel:.2e}, max |diff| {err:.3g} (atomic "
            "splats)")


def kd_graph_checks(r, n: int, capture: dict) -> str:
    """The kd-tree's graph beyond its film: B1 16, B2 4 and B3 no launch a
    replay; n replays' film and gather stats (photons visited, lanes cut
    short) equal to the eager body's; the host build's own seconds in
    each replay (its stage's clock, read after the replay). Returns what
    was found."""
    cfg = r.cfg
    expected = {"closest_hit_tris": (cfg.max_radiance_trace_depth
                                     + cfg.max_photon_trace_depth),
                "occluded_tris": cfg.ppm_direct_shadow_samples,
                "gather_photons_tiled": 0}
    for k, c in expected.items():
        if capture.get(k, 0) != c:
            raise AssertionError(f"graphs the kd-tree: {k} launches "
                                 f"{capture.get(k, 0)} a replay, not {c}")
    acc, stats = r._build_fused(eager=True)(r.camera, 0, r.root_key, n, 1)
    step = r.captured_step
    step.prepare(r.camera, r.root_key, 0, 1, None)
    build_s = []
    for _ in range(n):
        step.run()
        torch.cuda.synchronize()
        build_s.append(kd_build_seconds(r))
    if not torch.equal(step.acc, acc):
        raise AssertionError("graphs the kd-tree: the replays' sum differs "
                             "from the eager body's")
    for k in ("photons_visited", "kd_overrun"):
        if not torch.equal(step.stats_acc[k], stats[k]):
            raise AssertionError(f"graphs the kd-tree: {k} "
                                 f"{float(step.stats_acc[k])} in the replays"
                                 f", {float(stats[k])} eager")
    return (f"; sums and stats equal the eager body's (photons_visited "
            f"{float(stats['photons_visited']):.0f}, kd_overrun "
            f"{float(stats['kd_overrun']):.0f} over {n} iterations); host "
            f"build in the replays "
            + ", ".join(f"{t:.4f}" for t in build_s) + " s")


def kd_build_seconds(r) -> float:
    """The host build's wall time in the last replay of ``r``'s captured
    kd-tree step, by the host node's own clock."""
    stages = list(r.captured_step.kd_stages.values())
    if len(stages) != 1:
        raise AssertionError(f"the kd-tree's captured step holds "
                             f"{len(stages)} stages, not 1")
    return stages[0].build_seconds


def phase_graphs(dev) -> dict:
    """Each main configuration through the captured iteration
    (``renderer.CapturedStep``) against the eager body it captured: the
    film of n replays equal to the eager film (bit for bit, VCM at
    shard-main's bar); one eager step with device operands under
    ``torch.cuda.set_sync_debug_mode("error")``; the capture's launches
    equal to one eager iteration's, the wrappers' counters still during
    the replays; ms/iter eager against graph in turns (eager, graph,
    graph, eager); capture seconds, the graph pool's bytes, device idle
    over one replayed and one eager iteration; a camera restart
    (``Camera.orbit``) that replays without a new capture and equals the
    eager film at the new camera. Returns the replays' launches (the graph
    turns)."""
    from oppositerenderer_tpu_torch.accel import kernel_wrappers
    from oppositerenderer_tpu_torch.config import PhotonMapStructure
    from oppositerenderer_tpu_torch.core.rng import device_key
    from oppositerenderer_tpu_torch.renderer import (Renderer,
                                                     ppm_radius_sq_traced)
    wrappers = kernel_wrappers()
    card = card_line()
    launches = {w.__name__: 0 for w in wrappers}
    rows = []
    for label, scene, cam, cfg, n, bits in graph_cells(dev):
        tag = f"graphs {label}"
        r = Renderer(scene, cam, cfg, seed=0)
        if not r.uses_graph():
            raise AssertionError(f"{tag}: the renderer takes the eager "
                                 "route")
        # the eager counts of one iteration, which also builds the kernels
        # and the scene's tables before the sync check
        before = [w.launches for w in wrappers]
        eager_film(r, 1)
        torch.cuda.synchronize()
        eager_counts = {w.__name__: w.launches - b
                        for w, b in zip(wrappers, before)}
        # one eager step with device operands reads nothing back (but the
        # kd-tree's, whose eager gather reads a live-lane flag by design:
        # its captured body, which reads none, is what the capture checks)
        kd = cfg.photon_map_structure == PhotonMapStructure.KD_TREE_CPU
        it = torch.full((), 1, dtype=torch.int64, device=dev)
        if not kd:
            torch.cuda.set_sync_debug_mode("error")
            try:
                r._raw_step()(r.camera, it, device_key(r.root_key, dev),
                              ppm_radius_sq_traced(r.ppm_initial_radius,
                                                   cfg.ppm_alpha, it))
            finally:
                torch.cuda.set_sync_debug_mode(0)
        # the first render runs its first iteration eagerly and captures
        r.render(1)
        step = r.captured_step
        if step is None or step.graph is None:
            raise AssertionError(f"{tag}: no graph was captured")
        capture = {k: c for k, c in step.capture_launches.items()}
        if capture != eager_counts:
            raise AssertionError(f"{tag}: the capture launches {capture}, "
                                 f"an eager iteration {eager_counts}")
        kd_found = kd_graph_checks(r, n, capture) if kd else ""
        # timing in turns; the replays' launches by the capture's counts;
        # the first turn's films of each route compared after
        times = {"eager": [], "graph": []}
        films = {}
        for kind in ("eager", "graph", "graph", "eager"):
            counts = [w.launches for w in wrappers]
            graph_before = r.kernel_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if kind == "eager":
                film = eager_film(r, n)
            else:
                r.restart()
                film = r.render(n).accum
            torch.cuda.synchronize()
            times[kind].append((time.perf_counter() - t0) / n * 1e3)
            films.setdefault(kind, film)
            if kind == "graph":
                if [w.launches for w in wrappers] != counts:
                    raise AssertionError(f"{tag}: a wrapper was called "
                                         "during the replays")
                graph = r.kernel_launches()
                for k, c in capture.items():
                    got = graph.get(k, 0) - graph_before.get(k, 0)
                    if got != n * c:
                        raise AssertionError(f"{tag}: {k} launched {got} "
                                             f"times in {n} replays")
                    launches[k] += got
        # films: n replays against the eager body
        found = films_agree(label, films["graph"], films["eager"], bits)
        # the device alone (no host operations recorded, which would
        # slow the eager iteration's profile most)
        prof = profile_iteration(r, tag, host=False)
        # the eager body's device time in the same call: what the graph's
        # replay can approach
        eager_prof = profile_iteration(r, f"{tag} eager",
                                       lambda: eager_film(r, 1), host=False)
        # a camera restart: the same graph, the new camera's film
        orbited = cam.orbit(*GRAPH_ORBIT)
        replays = step.replays
        r.restart(camera=orbited)
        moved = r.render(1).accum
        if (r.captured_step is not step or step.graph is None
                or step.replays != replays + 1):
            raise AssertionError(f"{tag}: the camera restart captured anew")
        moved_found = films_agree(f"{label} orbited", moved,
                                  eager_film(r, 1, orbited), bits)
        if float(moved.double().mean()) <= 0.0 or not bool(
                torch.isfinite(moved).all()):
            raise AssertionError(f"{tag}: the orbited film is not finite "
                                 "and positive")
        eager_ms, graph_ms = (statistics.median(times[k])
                              for k in ("eager", "graph"))
        spread = {k: (max(v) - min(v)) / statistics.median(v)
                  for k, v in times.items()}
        print(f"[{tag}] {cfg.width}^2, {n} iterations: graph film {found}"
              f"{kd_found}; "
              f"orbited camera replayed without a capture, {moved_found}; "
              f"launches an iteration {capture}, equal to the eager body's;"
              f" ms/iter in turns (eager, graph, graph, eager): eager "
              f"{eager_ms:.3f} ({', '.join(f'{t:.3f}' for t in times['eager'])}"
              f"; spread {spread['eager']:.4f}), graph {graph_ms:.3f} "
              f"({', '.join(f'{t:.3f}' for t in times['graph'])}; spread "
              f"{spread['graph']:.4f}), {eager_ms / graph_ms:.3f}x; capture "
              f"{step.capture_seconds:.3f} s, pool {step.pool_bytes} bytes; "
              f"device idle over a replayed iteration {prof['idle']:.4f} "
              f"({prof['operations']} operations, busy "
              f"{prof['busy_ms']:.3f} of {prof['wall_ms']:.3f} ms), over an "
              f"eager iteration {eager_prof['idle']:.4f} "
              f"({eager_prof['operations']} operations, busy "
              f"{eager_prof['busy_ms']:.3f} of {eager_prof['wall_ms']:.3f} "
              f"ms); {card}")
        rows.append({"cell": label, "eager_ms": eager_ms,
                     "graph_ms": graph_ms, "spread": spread,
                     "capture_s": step.capture_seconds,
                     "pool_bytes": step.pool_bytes, "idle": prof["idle"],
                     "busy_ms": prof["busy_ms"],
                     "eager_busy_ms": eager_prof["busy_ms"],
                     "eager_idle": eager_prof["idle"]})
        del r, step
        torch.cuda.empty_cache()
    print(f"[graphs] {json.dumps(rows)}")
    return launches


# ---------------------------------------------------------------------------
# distribution
def _scrubbed(x: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.isfinite(x), x, 0.0)


def one_rank_nccl_mesh(dev):
    """A one-rank NCCL process group in this process and its mesh: the
    collectives run through NCCL, each over one rank."""
    import datetime

    import torch.distributed as dist

    from oppositerenderer_tpu_torch.parallel import make_mesh
    from oppositerenderer_tpu_torch.parallel.worker import free_port
    dist.init_process_group(
        "nccl", init_method=f"tcp://127.0.0.1:{free_port()}", world_size=1,
        rank=0, timeout=datetime.timedelta(seconds=300))
    mesh = make_mesh(device=dev)
    print(f"[shard-main] mesh: {mesh.size} rank, backend {mesh.backend}, "
          f"device {mesh.device}")
    return mesh


def partial_grid_b3(dev, call) -> float:
    """B3 on the partial grids of a 2-way exchange of PPM main's photons:
    the exchange's local half sends the photons of the one-rank step's grid
    to 2 owners, each slab builds its owner's grid, and the kernel runs
    over every query against each, held against its plain version (phase
    kernels' tolerance); the two partial sums add up to the whole grid's
    image (the means within 1%: rows over 256 photons take another block).
    Returns the largest |err|."""
    from oppositerenderer_tpu_torch.accel import gather_kernels as gk
    from oppositerenderer_tpu_torch.parallel.exchange import \
        bucket_photons_by_owner
    from oppositerenderer_tpu_torch.photon_map import (PhotonBatch,
                                                       build_photon_grid)
    grid, q, qn, r, u_rows, valid = call
    n = int(grid.n_valid)
    photons = PhotonBatch(position=grid.position[:n], power=grid.power[:n],
                          direction=grid.direction[:n],
                          valid=torch.ones(n, dtype=torch.bool, device=dev))
    slab, ok, overflow = bucket_photons_by_owner(
        photons, grid.origin, grid.cell_size, grid.resolution, 2, 2.0, 0.5)
    if int(overflow):
        raise AssertionError(f"B3 partial grids: {int(overflow)} photons "
                             "overflowed a slab")
    r2 = torch.square(torch.as_tensor(r, dtype=torch.float32, device=dev))
    total, worst = None, 0.0
    for owner in range(2):
        part = build_photon_grid(
            PhotonBatch(position=slab[owner, :, 0:3],
                        power=slab[owner, :, 3:6],
                        direction=slab[owner, :, 6:9], valid=ok[owner]),
            grid.resolution, origin=grid.origin, cell_size=grid.cell_size)
        starts, lens, weights, _, _, rows = gk._tile_tables(part, q, r,
                                                            u_rows, valid)
        args = (starts, lens, weights, rows, r2, q, qn, part, True)
        got = gk.gather_photons_tiled_kernel(*args)
        want = gk.gather_photons_tiled_plain(*args)
        err = (got.double() - want.double()).abs()
        scale = float(want.abs().max())
        bad = int((err > GATHER_RTOL * want.double().abs()
                   + GATHER_ATOL_REL * scale).sum())
        ms = cuda_ms(lambda: gk.gather_photons_tiled_kernel(*args))
        print(f"[shard-main] B3 on owner {owner}'s partial grid "
              f"({int(part.n_valid)} of {n} photons): max |err| "
              f"{float(err.max()):.3g} of max |ref| {scale:.4g}, {bad} "
              f"sums outside the tolerance; {ms:.4f} ms")
        if bad or not bool(torch.isfinite(got).all()):
            raise AssertionError("B3 on a partial grid differs from its "
                                 "plain version")
        worst = max(worst, float(err.max()))
        total = got if total is None else total + got
    whole = gk.gather_photons_tiled(grid, q, qn, r, u_rows=u_rows,
                                    valid=valid)[0]
    rel = abs(float(total.double().sum() / whole.double().sum()) - 1.0)
    print(f"[shard-main] B3 partial sums against the whole grid's: summed "
          f"power off by {rel:.2e}")
    if rel > RANKS_PPM_MEAN_RTOL:
        raise AssertionError("B3's partial sums do not add up to the "
                             "whole grid's")
    return worst


def phase_shard_main(dev, mesh) -> tuple[dict, float]:
    """The sharded step over a one-rank NCCL mesh at full width: PT,
    PPM main with each exchange, VCM+VM and Atrium PT, iteration
    SHARD_ITERATION, seed 0, as three runs: the unsharded Renderer
    iteration (a replay), the sharded step's eager route (``fn.eager``)
    and the captured sharded step (a replay of the graph that holds the
    step and its NCCL collectives). Each sharded band must equal the
    unsharded iteration (bit for bit; VCM at SHARD_PIXEL_RTOL, its atomic
    splats), with the same kernel launches; then the three are timed in
    turns. Returns the sharded timed runs' launches (eager and replays)
    and B3's largest |err| on partial grids (:func:`partial_grid_b3`)."""
    from oppositerenderer_tpu_torch.accel import kernel_wrappers
    from oppositerenderer_tpu_torch.config import PhotonExchange, RenderConfig
    from oppositerenderer_tpu_torch.parallel import exchange as xch
    from oppositerenderer_tpu_torch.parallel import make_sharded_render_fn
    from oppositerenderer_tpu_torch.renderer import Renderer
    from oppositerenderer_tpu_torch.scene import get_scene_by_name

    pt_cfg = RenderConfig(width=MAIN_SIZE, height=MAIN_SIZE)
    cases = [("PT", MAIN_SCENE, pt_cfg, True),
             ("PPM all-to-all", MAIN_SCENE, ppm_main_config(), True),
             ("PPM all-gather", MAIN_SCENE, ppm_main_config().replace(
                 photon_exchange=PhotonExchange.ALL_GATHER), True),
             ("VCM+VM", MAIN_SCENE, vcm_main_config(True), False),
             ("Atrium PT", "Atrium", RenderConfig(width=ATRIUM_SIZE,
                                                  height=ATRIUM_SIZE), True)]
    wrappers = kernel_wrappers()
    card = card_line()
    total = {k: 0 for k in KERNELS}
    b3_err = 0.0
    scenes = {}
    rows = []
    for label, name, cfg, bits in cases:
        if name not in scenes:
            scenes[name] = get_scene_by_name(name, dev)
        scene, cam = scenes[name]
        r = Renderer(scene, cam, cfg, seed=0)
        it = SHARD_ITERATION
        step = make_sharded_render_fn(scene, cam, cfg, mesh)
        captured = step.captured
        if captured is None:
            raise AssertionError(f"shard-main {label}: the sharded step "
                                 f"over {mesh.backend} takes no graph")
        calls = []
        gather = xch.gather_photons_tiled

        def record(*args, **kw):
            calls.append(args + (kw["u_rows"], kw["valid"]))
            return gather(*args, **kw)

        args = (it, r.root_key, r._radius_sq(it))
        runs = {"unsharded": lambda: r.compute_iteration(it)[0],
                "eager": lambda: _scrubbed(step.eager(*args)[0]),
                "graph": lambda: _scrubbed(step(*args)[0])}

        def replayed():
            """Launches of the graph replays so far: the Renderer's and
            the captured sharded step's."""
            out = r.kernel_launches()
            for k, c in captured.launches().items():
                out[k] = out.get(k, 0) + c
            return out

        images, counts = {}, {}
        for kind, fn in runs.items():
            fn()                         # warm-up (and the captures)
            torch.cuda.synchronize()
            _reset_launches()
            before = replayed()
            if kind == "eager" and label == "PPM all-to-all":
                xch.gather_photons_tiled = record
            try:
                images[kind] = fn().reshape(cfg.height, cfg.width, 3)
            finally:
                xch.gather_photons_tiled = gather
            torch.cuda.synchronize()
            after = replayed()
            counts[kind] = {w.__name__: w.launches + after.get(w.__name__, 0)
                            - before.get(w.__name__, 0) for w in wrappers}
        if captured.graph is None or captured.capture_launches != {
                k: c for k, c in counts["eager"].items()}:
            raise AssertionError(f"shard-main {label}: the capture launches "
                                 f"{captured.capture_launches}, the eager "
                                 f"step {counts['eager']}")
        found = {}
        for kind in ("eager", "graph"):
            if counts[kind] != counts["unsharded"]:
                raise AssertionError(f"shard-main {label}: {kind} sharded "
                                     f"launches {counts[kind]}, unsharded "
                                     f"{counts['unsharded']}")
            got, want = (images[k].double() for k in (kind, "unsharded"))
            if not bool(torch.isfinite(got).all()) or float(got.mean()) <= 0:
                raise AssertionError(f"shard-main {label}: {kind} band not "
                                     "finite and positive")
            agree = float(torch.isclose(got, want, rtol=SHARD_PIXEL_RTOL,
                                        atol=0.0).all(dim=-1).double()
                          .mean())
            mean_rel = abs(float(got.mean() / want.mean()) - 1.0)
            equal = torch.equal(images[kind], images["unsharded"])
            if bits and not equal:
                raise AssertionError(
                    f"shard-main {label}: the {kind} sharded band differs "
                    f"from the unsharded iteration ({agree:.6f} of the "
                    f"pixels within {SHARD_PIXEL_RTOL})")
            if not bits and (agree < SHARD_MIN_AGREEING
                             or mean_rel > SHARD_MEAN_RTOL):
                raise AssertionError(f"shard-main {label}: {kind}: "
                                     f"{agree:.6f} of the pixels agree, "
                                     f"mean off by {mean_rel:.2e}")
            found[kind] = ("equal bit for bit" if equal else
                           f"{agree:.6f} of the pixels within rtol "
                           f"{SHARD_PIXEL_RTOL}, mean off by "
                           f"{mean_rel:.2e}")
        n = SHARD_TIMING_ITERS[label.split(" ")[0] if label.startswith("PPM")
                               else label]
        times = {k: [] for k in runs}
        for kind in ("unsharded", "eager", "graph", "graph", "eager",
                     "unsharded"):
            _reset_launches()
            before = replayed()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                runs[kind]()
            torch.cuda.synchronize()
            times[kind].append((time.perf_counter() - t0) / n * 1e3)
            if kind == "unsharded":
                continue
            after = replayed()
            for w in wrappers:
                k = w.__name__
                c = w.launches + after.get(k, 0) - before.get(k, 0)
                if kind == "graph" and w.launches:
                    raise AssertionError(f"shard-main {label}: {k} was "
                                         "called during the replays")
                if c != n * counts[kind][k]:
                    raise AssertionError(f"shard-main {label}: {k} "
                                         f"launched {c} times in {n} "
                                         f"{kind} steps")
                total[k] += c
        launched = {k: c for k, c in counts["graph"].items() if c}
        ms = {k: statistics.median(v) for k, v in times.items()}

        def turns(ts):
            return ", ".join(f"{t:.3f}" for t in ts)
        spread = {k: (max(v) - min(v)) / ms[k] for k, v in times.items()}
        print(f"[shard-main] {label} {name} {cfg.width}^2 over "
              f"{mesh.size} {mesh.backend} rank: eager sharded band "
              f"{found['eager']}, captured sharded band {found['graph']} "
              f"against the unsharded iteration; launches an iteration "
              f"{launched}, equal in the three; ms/iter in turns "
              f"(unsharded, eager, graph, graph, eager, unsharded; {n} "
              f"iterations a turn): "
              + "; ".join(f"{k} {ms[k]:.3f} ({turns(times[k])}; spread "
                          f"{spread[k]:.4f})" for k in runs)
              + f"; eager / graph {ms['eager'] / ms['graph']:.3f}x; "
              f"capture {captured.capture_seconds:.3f} s, pool "
              f"{captured.pool_bytes} bytes; {card}")
        rows.append({"cell": label, "ms": ms, "spread": spread,
                     "capture_s": captured.capture_seconds,
                     "pool_bytes": captured.pool_bytes})
        if calls:
            b3_err = max(b3_err, partial_grid_b3(dev, calls[0]))
        captured.release()
        del r, step, captured
        torch.cuda.empty_cache()
    print(f"[shard-main] {json.dumps(rows)}")
    return total, b3_err


def phase_grad_shard(dev, mesh) -> None:
    """The sharded gradient over the one-rank NCCL mesh at 512^2: PT
    d mean(image) / d kd of material 0, and PPM main with the all-to-all
    exchange d/demission_scale (the collectives' backward in the graph).
    The captured gradient (a replay) and its eager route
    (``fn.eager``) against the unsharded gradient (rel GRAD_SHARD_RTOL):
    one warm-up each, then the seconds of one call each."""
    from oppositerenderer_tpu_torch import diff
    from oppositerenderer_tpu_torch.config import RenderConfig
    from oppositerenderer_tpu_torch.core.rng import make_root_key
    from oppositerenderer_tpu_torch.integrators import ppm, pt
    from oppositerenderer_tpu_torch.scene import get_scene_by_name
    scene, cam = get_scene_by_name(MAIN_SCENE, dev)
    key = make_root_key(0)
    card = card_line()
    cases = (("PT", RenderConfig(width=MAIN_SIZE, height=MAIN_SIZE), "kd",
              lambda s, cfg: pt.render_iteration(s, cam, cfg, 0, key)),
             ("PPM all-to-all", ppm_main_config(), "emission_scale",
              lambda s, cfg: ppm.render_iteration(s, cam, cfg, 0, key,
                                                  GRAD_R2)[0]))
    for label, cfg, param, render in cases:
        wrt = {(param, 0): scene.materials.kd[0] if param == "kd" else 1.0}
        sharded = diff.make_sharded_loss_and_grad(scene, cam, cfg, mesh, wrt)
        args = dict(iteration=0, key=key, radius_sq=GRAD_R2)
        runs = {"graph": lambda: sharded(**args),
                "eager": lambda: sharded.eager(**args),
                "unsharded": lambda: diff.render_loss_and_grad(
                    lambda s: render(s, cfg), scene, wrt)}
        out = {}
        for kind, fn in runs.items():
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss, grads = fn()
            torch.cuda.synchronize()
            out[kind] = (float(loss), grads[(param, 0)].double().cpu(),
                         time.perf_counter() - t0)
        if sharded.captured is None or sharded.captured.replays != 1:
            raise AssertionError(f"grad-shard {label}: the gradient over "
                                 f"{mesh.backend} was not replayed")
        lu, gu, tu = out["unsharded"]
        rel = {k: float(((out[k][1] - gu).abs() / gu.abs()).max())
               for k in ("graph", "eager")}
        print(f"[grad-shard] {label} {MAIN_SIZE}^2 d/d{param} over "
              f"{mesh.size} {mesh.backend} rank: loss captured "
              f"{out['graph'][0]:.7g}, eager {out['eager'][0]:.7g} "
              f"(unsharded {lu:.7g}); gradient captured "
              f"{out['graph'][1].tolist()}, eager {out['eager'][1].tolist()}"
              f" (unsharded {gu.tolist()}): max rel err captured "
              f"{rel['graph']:.3g}, eager {rel['eager']:.3g} (bound "
              f"{GRAD_SHARD_RTOL}); forward + backward {out['graph'][2]:.4f}"
              f" s captured, {out['eager'][2]:.4f} s eager, {tu:.4f} s "
              f"unsharded; capture {sharded.captured.capture_seconds:.3f} s,"
              f" pool {sharded.captured.pool_bytes} bytes; {card}")
        if max(rel.values()) > GRAD_SHARD_RTOL or not bool(
                (out["graph"][1] > 0).all()):
            raise AssertionError(f"grad-shard {label}: the sharded gradient "
                                 "differs from the unsharded one")
        sharded.captured.release()


def ranks_cases() -> list[dict]:
    """The cases phase ranks runs on RANKS processes sharing the card."""
    from oppositerenderer_tpu_torch.parallel.worker import sharding_cases
    ppm = dict(width=MAIN_SIZE, height=MAIN_SIZE,
               render_method="PROGRESSIVE_PHOTON_MAPPING",
               photons_per_iteration=PPM_MAIN_PHOTONS)
    pt = dict(width=MAIN_SIZE, height=MAIN_SIZE)
    mh = dict(kind="multihost", cfg=pt, iterations=MULTIHOST_ITERS, seed=0)
    return sharding_cases(RANKS_SIZE) + [
        dict(name="ppm_main", kind="render", cfg=ppm, seed=0,
             iteration=SHARD_ITERATION, reps=2),
        dict(name="ppm_main_exchange", kind="exchange", cfg=ppm, seed=0,
             iteration=SHARD_ITERATION),
        dict(mh, name="multihost_strided"),
        dict(mh, name="multihost_leased", schedule="leased", packet_size=2),
        dict(name="grad_pt", kind="grad", wrt=[["kd", 0]], seed=0,
             cfg=dict(width=RANKS_SIZE, height=RANKS_SIZE))]


def phase_ranks(dev) -> dict:
    """RANKS worker processes (python -m
    oppositerenderer_tpu_torch.parallel.worker, spawned) share the card
    over gloo and run :func:`ranks_cases`; this process then renders the
    references on the card. Phases shard-ranks (the 64^2 cases of
    tests/test_torch_sharding.py at its bars, and PPM main's 2-rank
    exchange and step), multihost (PT 512^2, 8 iterations, strided and
    leased, against one process's film) and grad-shard's 2-rank part.
    Returns the workers' launches summed over their ranks."""
    from oppositerenderer_tpu_torch import diff
    from oppositerenderer_tpu_torch.config import RenderConfig
    from oppositerenderer_tpu_torch.core.rng import make_root_key
    from oppositerenderer_tpu_torch.integrators import pt
    from oppositerenderer_tpu_torch.parallel.distributed import \
        MultiHostRenderer
    from oppositerenderer_tpu_torch.parallel.worker import (
        config_from, render_unsharded, sharding_cases, spawn_ranks)
    from oppositerenderer_tpu_torch.scene import get_scene_by_name

    cases = ranks_cases()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "ranks.npz"
        t0 = time.perf_counter()
        spawn_ranks(RANKS, cases, out, device="cuda", backend="gloo",
                    timeout=600)
        spawn_s = time.perf_counter() - t0
        z = dict(np.load(out))
    print(f"[shard-ranks] {RANKS} worker processes on the card over gloo: "
          f"{len(cases)} cases in {spawn_s:.1f} s (start-up included)")
    # the workers count the render paths' kernels (worker.kernel_wrappers)
    launches = {k: 0 for k in launch_counts()}
    for c in cases:
        for k in launches:
            launches[k] += int(z[f"{c['name']}.launches.{k}"])

    # the 64^2 cases against the unsharded card render
    for c in sharding_cases(RANKS_SIZE):
        name = c["name"]
        got = z[f"{name}.image"]
        want, stats = render_unsharded(c, dev)
        want = want.cpu().numpy()
        bits = name in ("pt", "ppm_all_gather")
        ok = (np.array_equal(got, want) if bits else np.allclose(
            got, want, rtol=RANKS_RTOL,
            atol=RANKS_ATOL_OF_MAX * np.abs(want).max()))
        err = float(np.abs(got - want).max())
        print(f"[shard-ranks] {name} {RANKS_SIZE}^2 over {RANKS} ranks: "
              f"max |sharded - unsharded| {err:.3g} "
              f"({'bit for bit' if bits else f'bar rtol {RANKS_RTOL}'}); "
              f"step {float(z[f'{name}.ms']):.1f} ms; launches "
              + str({k: int(z[f'{name}.launches.{k}']) for k in launches
                     if int(z[f'{name}.launches.{k}'])}))
        if not ok or not np.isfinite(got).all():
            raise AssertionError(f"shard-ranks {name}: the sharded image "
                                 "differs from the unsharded one")
        for k, v in stats.items():
            if not k.startswith("avg_") and float(z[f"{name}.stat.{k}"]) \
                    != float(v):
                raise AssertionError(f"shard-ranks {name}: stat {k}")

    # PPM main over the ranks' partial grids
    c = next(c for c in cases if c["name"] == "ppm_main")
    got = z["ppm_main.image"].astype(np.float64)
    want, stats = render_unsharded(c, dev)
    want = want.double().cpu().numpy()
    mean_rel = abs(got.mean() / want.mean() - 1.0)
    agree = float(np.isclose(got, want, rtol=1e-3, atol=0.0).all(-1).mean())
    print(f"[shard-ranks] PPM main {MAIN_SIZE}^2 all-to-all over {RANKS} "
          f"ranks: {float(z['ppm_main.ms']):.1f} ms a step (the slower "
          f"rank's); image mean off the unsharded by {mean_rel:.2e} (bar "
          f"{RANKS_PPM_MEAN_RTOL}), {agree:.4f} of the pixels within rtol "
          "1e-3; stats " + ", ".join(
              f"{k} {float(z[f'ppm_main.stat.{k}']):.6g} (unsharded "
              f"{float(v):.6g})" for k, v in stats.items())
          + f", overflow {int(z['ppm_main.stat.photon_exchange_overflow'])}")
    if mean_rel > RANKS_PPM_MEAN_RTOL or not np.isfinite(got).all():
        raise AssertionError("shard-ranks PPM main: image mean off")
    for k in ("photons_stored",):
        if float(z[f"ppm_main.stat.{k}"]) != float(stats[k]):
            raise AssertionError(f"shard-ranks PPM main: stat {k}")
    x = {k: float(z[f"ppm_main_exchange.{k}"]) for k in (
        "photon_power", "grid_power", "photons", "grid_photons", "overflow",
        "bytes_per_rank", "ms")}
    print(f"[shard-ranks] PPM main exchange: {x['photons']:.0f} photons, "
          f"{x['grid_photons']:.0f} in the partial grids, overflow "
          f"{x['overflow']:.0f}; summed power {x['photon_power']:.9g} "
          f"photons, {x['grid_power']:.9g} grids; {x['bytes_per_rank']:.0f} "
          f"bytes sent a rank; {x['ms']:.1f} ms (the slower rank's)")
    if x["overflow"] or x["grid_photons"] != x["photons"] or abs(
            x["grid_power"] / x["photon_power"] - 1) > EXCHANGE_POWER_RTOL:
        raise AssertionError("shard-ranks: the exchange lost photons")

    # multihost: against one process's film of the same iterations
    scene, cam = get_scene_by_name(MAIN_SCENE, dev)
    mh = next(c for c in cases if c["name"] == "multihost_strided")
    single = MultiHostRenderer(scene, cam, config_from(mh["cfg"]),
                               seed=0).run(MULTIHOST_ITERS)
    want = single.accum.cpu().numpy()
    for name in ("multihost_strided", "multihost_leased"):
        got = z[f"{name}.accum"]
        ok = np.allclose(got, want, rtol=MULTIHOST_RTOL, atol=MULTIHOST_ATOL)
        print(f"[multihost] {name.split('_')[1]}: {RANKS} processes, "
              f"{int(z[f'{name}.iterations'])} iterations (per process "
              f"{z[f'{name}.rendered'].tolist()}), merged film against one "
              f"process's: max |diff| {float(np.abs(got - want).max()):.3g} "
              f"(rtol {MULTIHOST_RTOL}); merge "
              f"{float(z[f'{name}.merge_ms']):.3f} ms (one all-reduce of the "
              "film, the slower rank's)")
        if (not ok or int(z[f"{name}.iterations"]) != MULTIHOST_ITERS
                or not (z[f"{name}.rendered"] > 0).all()):
            raise AssertionError(f"multihost {name}: merged film differs")

    # grad-shard: 2 ranks at 64^2 against the unsharded gradient
    scene, cam = get_scene_by_name(MAIN_SCENE, dev)
    cfg = RenderConfig(width=RANKS_SIZE, height=RANKS_SIZE)
    key = make_root_key(0)
    loss, grads = diff.render_loss_and_grad(
        lambda s: pt.render_iteration(s, cam, cfg, 0, key), scene,
        {("kd", 0): scene.materials.kd[0]})
    gu = grads[("kd", 0)].double().cpu().numpy()
    gs = z["grad_pt.grad.kd.0"].astype(np.float64)
    rel = float(np.max(np.abs(gs - gu) / np.abs(gu)))
    print(f"[grad-shard] PT {RANKS_SIZE}^2 d/dkd over {RANKS} gloo ranks: "
          f"loss {float(z['grad_pt.loss']):.7g} (unsharded {float(loss):.7g})"
          f", gradient {gs.tolist()} (unsharded {gu.tolist()}): max rel "
          f"err {rel:.3g} (bound {GRAD_SHARD_RTOL}); "
          f"{float(z['grad_pt.seconds']):.3f} s (the slower rank's)")
    if rel > GRAD_SHARD_RTOL:
        raise AssertionError("the 2-rank sharded gradient differs from the "
                             "unsharded one")
    return launches


# ---------------------------------------------------------------------------
# the packet node-step microbenchmark (B6)
def b6_bound(steps: int, tiles: int, variant: str = "scalar") -> dict:
    """B6's least time in ``variant``: 8 slab tests of SLAB_FLOPS operations
    a ray and step (dmaonly: one addition); the bytes are the rows the
    steps read (48 floats each; fixedrow one a tile), the rays' origins
    and directions (not read by dmaonly), and best."""
    rays = tiles * 1024
    if variant == "dmaonly":
        return bound((steps * tiles * 48 + rays) * 4, rays * steps)
    rows_read = tiles * (1 if variant == "fixedrow" else steps)
    return bound((rows_read * 48 + 2 * 3 * rays + rays) * 4,
                 rays * steps * 8 * SLAB_FLOPS)


def phase_b6(dev) -> tuple[dict, int]:
    """B6 in every variant against its plain version bit for bit at the
    microbenchmark's defaults and at B6_WIDE_TILES tiles, each timed with
    its bound, and the CTAs a tile checked against the rule (2 when twice
    the tiles fit the SMs); then the microbenchmark's entry point
    (``python -m oppositerenderer_tpu_torch.scripts.packet_kernel_exp``'s
    main) at its defaults once per variant, its two lines printed and its
    launches counted. Returns scalar's entry (the 528-tile one and the
    other variants' under it) and the launches."""
    import io

    from oppositerenderer_tpu_torch.accel import packet_exp_kernels as pk
    from oppositerenderer_tpu_torch.scripts import packet_kernel_exp as script
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out = {"max_abs_err": 0.0, "variants": {v: {} for v in pk.VARIANTS[1:]}}
    for tiles in (B6_TILES, B6_WIDE_TILES):
        cluster = pk.cluster_size(tiles, dev)
        if cluster != (2 if 2 * tiles <= sms else 1):
            raise AssertionError(f"B6 at {tiles} tiles on {sms} SMs takes "
                                 f"{cluster} CTAs a tile")
        print(f"[b6] {tiles} tiles x 1024 rays, {B6_STEPS} steps, "
              f"{B6_ROWS} rows, {sms} SMs: {cluster} CTA(s) a tile")
        table, o, d = script.make_inputs(B6_ROWS, tiles, dev)
        for v in pk.VARIANTS:
            got = pk.packet_steps(table, o, d, B6_STEPS, v)
            want = pk.plain_packet_steps(table, o, d, B6_STEPS, v)
            bad = _bits_differ(got, want)
            if bad:
                raise AssertionError(f"packet_steps {v} differs from its "
                                     f"plain version at {tiles} tiles in "
                                     f"{bad} rays")
            entry = {"ms": cuda_ms(lambda: pk.packet_steps(
                         table, o, d, B6_STEPS, v)),
                     "plain_ms": cuda_ms(lambda: pk.plain_packet_steps(
                         table, o, d, B6_STEPS, v), reps=3, warmup=1,
                         batch=1, graph=False),
                     **b6_bound(B6_STEPS, tiles, v),
                     "hit_share": float((got < 1e30).float().mean()),
                     "ctas_per_tile": cluster}
            if v == "scalar":
                scalar_ms = entry["ms"]
                if tiles == B6_TILES:
                    out.update(entry)
                else:
                    out[f"{tiles} tiles"] = entry
            else:
                entry["of_scalar"] = entry["ms"] / scalar_ms
                out["variants"][v][f"{tiles} tiles"] = entry
            print(f"[b6] {tiles} tiles {v}: equal to plain bit for bit "
                  f"(rays with a hit {entry['hit_share']:.4f}); ms kernel "
                  f"{entry['ms']:.4f} ({entry['ms'] / scalar_ms:.3f} of "
                  f"scalar), plain {entry['plain_ms']:.4f}, bound "
                  f"{entry['bound_ms']:.4f} ({entry['bound_by']})")
    pk.packet_steps.launches = 0
    want_head = (f"device={torch.cuda.get_device_name(dev)} G={B6_TILES} "
                 f"STEPS={B6_STEPS} R={B6_ROWS}")
    for v in pk.VARIANTS:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            script.main(["--reps", str(B6_SCRIPT_REPS), "--variant", v])
        lines = buf.getvalue().splitlines()
        for line in lines:
            print(f"[b6] packet_kernel_exp --variant {v}: {line}")
        if len(lines) != 2 or lines[0] != want_head:
            raise AssertionError(f"packet_kernel_exp --variant {v} printed "
                                 f"{lines}")
    launches = pk.packet_steps.launches
    if launches != (1 + B6_SCRIPT_REPS) * len(pk.VARIANTS):
        raise AssertionError(f"packet_kernel_exp launched B6 {launches} "
                             f"times, not (1 + {B6_SCRIPT_REPS}) x "
                             f"{len(pk.VARIANTS)}")
    return out, launches


# ---------------------------------------------------------------------------
# tooling and the viewer
def phase_sharded_phase(dev) -> dict:
    """``sharded_phase_bench``'s four regimes (PPM all-to-all and
    all-gather, VCM paired and uniform) over SHARDED_PHASE_RANKS gloo
    ranks sharing the card, then over one NCCL rank (its card by
    ``distributed.rank_device``; the step a replay of a captured graph);
    each gathered image against the unsharded card render: the
    all-gather bit for bit, VCM at RANKS_RTOL, the all-to-all by its mean
    (RANKS_PPM_MEAN_RTOL) with no photon lost. Prints each run's table,
    bytes sent beside the JAX script's model. Returns the runs' launches
    summed over ranks."""
    from oppositerenderer_tpu_torch.parallel.worker import render_unsharded
    from oppositerenderer_tpu_torch.scripts import sharded_phase_bench as spb
    cases = spb.regime_cases(SHARDED_PHASE_SIZE, SHARDED_PHASE_PHOTONS,
                             SHARDED_PHASE_PATH_LENGTH, SHARDED_PHASE_REPS)
    launches = {k: 0 for k in launch_counts()}
    runs = []
    torch.cuda.empty_cache()
    for ranks, backend in ((SHARDED_PHASE_RANKS, "gloo"), (1, "nccl")):
        t0 = time.perf_counter()
        rows, z, desc = spb.run(
            ranks, "cuda", backend, SHARDED_PHASE_SIZE,
            SHARDED_PHASE_PHOTONS, SHARDED_PHASE_PATH_LENGTH,
            SHARDED_PHASE_REPS, timeout=600)
        cards = z["rank_devices"].tolist()
        print(f"[sharded-phase] {desc}: the ranks rendered on cuda:{cards};"
              f" four regimes at {SHARDED_PHASE_SIZE}^2 in "
              f"{time.perf_counter() - t0:.1f} s (start-up included)")
        if cards != [0] * ranks:
            raise AssertionError("sharded-phase: a rank left card 0")
        for line in spb.table(rows, desc).splitlines():
            print(f"[sharded-phase] {line}")
        print(f"[sharded-phase] {json.dumps({'ranks': ranks, 'rows': rows})}")
        for r in rows:
            for k, c in r["launches"].items():
                launches[k] += c
        runs.append((ranks, backend, z, rows))
    for c in cases:
        name = c["name"]
        want, stats = render_unsharded(c, dev)
        want = want.double().cpu().numpy()
        ppm = name.startswith("ppm")
        for ranks, backend, z, rows in runs:
            got = z[f"{name}.image"].astype(np.float64)
            err = float(np.abs(got - want).max())
            mean_rel = abs(got.mean() / want.mean() - 1.0)
            if name == "ppm_all_gather":
                ok, bar = np.array_equal(got, want), "bit for bit"
            elif ppm:
                ok = mean_rel <= RANKS_PPM_MEAN_RTOL
                bar = f"image mean within {RANKS_PPM_MEAN_RTOL}"
            else:
                ok = np.allclose(got, want, rtol=RANKS_RTOL,
                                 atol=RANKS_ATOL_OF_MAX * np.abs(want).max())
                bar = f"rtol {RANKS_RTOL}"
            lost = ""
            if ppm:
                overflow = int(z[f"{name}.stat.photon_exchange_overflow"]
                               if name == "ppm_all_to_all" else 0)
                stored = float(z[f"{name}.stat.photons_stored"])
                lost = (f"; photons stored {stored:.0f} (unsharded "
                        f"{float(stats['photons_stored']):.0f}), overflow "
                        f"{overflow}")
                ok = ok and overflow == 0 and stored == float(
                    stats["photons_stored"])
            print(f"[sharded-phase] {name} over {ranks} {backend} "
                  f"rank{'s' if ranks > 1 else ''}: max |sharded - "
                  f"unsharded| {err:.3g}, image mean off by {mean_rel:.2e} "
                  f"({bar}){lost}")
            if not ok or not np.isfinite(got).all():
                raise AssertionError(f"sharded-phase {name} over {ranks} "
                                     f"{backend} ranks: the sharded image "
                                     "differs from the unsharded one")
    for k in ("closest_hit_tris", "occluded_tris", "gather_photons_tiled"):
        if not launches[k]:
            raise AssertionError(f"sharded-phase: {k} never launched")
    return launches


def phase_scaling(dev) -> dict:
    """``scaling_bench``'s job, PT (SCALING_ITERS iterations) and PPM
    (half) at MAIN_SIZE^2, over 1 and SCALING_NPROC processes sharing the
    card over gloo, each pinned to a core: the merged film against one
    process's film rendered here at MULTIHOST_RTOL, the iteration count
    exact, every process one iteration or more. Prints each record (two
    processes on one card: overhead, not scaling). Returns the
    SCALING_NPROC runs' launches summed over ranks."""
    from oppositerenderer_tpu_torch.parallel.distributed import \
        MultiHostRenderer
    from oppositerenderer_tpu_torch.parallel.worker import config_from
    from oppositerenderer_tpu_torch.scene import get_scene_by_name
    from oppositerenderer_tpu_torch.scripts import scaling_bench as sb
    launches = {k: 0 for k in launch_counts()}
    torch.cuda.empty_cache()
    for method in ("pt", "ppm"):
        rec, z = sb.measure(method, SCALING_NPROC, SCALING_ITERS, MAIN_SIZE,
                            pin_cores=True, device="cuda", backend="gloo")
        print(f"[scaling] {json.dumps(rec)}")
        iters = rec["iterations"]
        scene, cam = get_scene_by_name(MAIN_SCENE, dev)
        case = sb.scaling_case(iters, MAIN_SIZE, method)
        mhr = MultiHostRenderer(scene, cam, config_from(case["cfg"]),
                                seed=sb.SEED)
        mhr.render_iterations(tuple(range(iters)))
        want = mhr.local_film().accum.cpu().numpy()
        got = z["scaling.accum"]
        rendered = z["scaling.rendered"].tolist()
        ok = np.allclose(got, want, rtol=MULTIHOST_RTOL, atol=MULTIHOST_ATOL)
        counts = {k: int(z[f"scaling.launches.{k}"]) for k in launches}
        print(f"[scaling] {method} {MAIN_SIZE}^2: {SCALING_NPROC} processes"
              f" rendered {rendered} of {int(z['scaling.iterations'])} "
              f"iterations; merged film against one process's: max |diff| "
              f"{float(np.abs(got - want).max()):.3g} (rtol "
              f"{MULTIHOST_RTOL}); launches "
              + str({k: c for k, c in counts.items() if c}))
        if (not ok or not np.isfinite(got).all()
                or int(z["scaling.iterations"]) != iters
                or sum(rendered) != iters or min(rendered) < 1):
            raise AssertionError(f"scaling {method}: the merged film differs"
                                 " from one process's")
        need = ("gather_photons_tiled",) if method == "ppm" else (
            "closest_hit_tris", "occluded_tris")
        for k in need:
            if not counts[k]:
                raise AssertionError(f"scaling {method}: {k} never launched")
        for k, c in counts.items():
            launches[k] += c
    return launches


def phase_tooling(dev) -> None:
    """``debug.check_iteration`` on PT, PPM and VCM main; the photon
    histogram on the card against the CPU; ``core.profiling.trace`` of a
    PT main iteration (a CUDA kernel and the pass scope in the trace); the
    device table."""
    from oppositerenderer_tpu_torch import debug
    from oppositerenderer_tpu_torch.config import RenderConfig
    from oppositerenderer_tpu_torch.core.profiling import TRACE_FILE, trace
    from oppositerenderer_tpu_torch.devices import ComputeDeviceRepository
    from oppositerenderer_tpu_torch.renderer import Renderer
    from oppositerenderer_tpu_torch.scene import get_scene_by_name

    scene, cam = get_scene_by_name(MAIN_SCENE, dev)
    pt_cfg = RenderConfig(width=MAIN_SIZE, height=MAIN_SIZE)
    for label, cfg in (("PT", pt_cfg), ("PPM", ppm_main_config()),
                       ("VCM", vcm_main_config())):
        t0 = time.perf_counter()
        msg, radiance = debug.check_iteration(scene, cam, cfg)
        if msg is not None:
            raise AssertionError(f"check_iteration {label}: {msg}")
        if not bool(torch.isfinite(radiance).all()):
            raise AssertionError(f"check_iteration {label}: non-finite "
                                 "radiance")
        print(f"[tooling] check_iteration {MAIN_SCENE} {MAIN_SIZE}^2 "
              f"{label}: no pass output holds a NaN or an infinity "
              f"({time.perf_counter() - t0:.2f} s)")

    hcfg = RenderConfig(photons_per_iteration=HISTOGRAM_PHOTONS)
    cpu_scene, _ = get_scene_by_name(MAIN_SCENE, "cpu")
    got = debug.photon_depth_histogram(scene, hcfg)
    want = debug.photon_depth_histogram(cpu_scene, hcfg)
    hist, ref = got["deposits_histogram"], want["deposits_histogram"]
    moved = int(np.abs(hist.astype(np.int64) - ref).sum()) // 2
    print(f"[tooling] photon_depth_histogram {HISTOGRAM_PHOTONS} photons: "
          f"card {hist.tolist()}, CPU {ref.tolist()}; stored "
          f"{got['photons_stored']} / {want['photons_stored']}; "
          f"{'equal' if moved == 0 else f'{moved} paths moved'}")
    if hist.sum() != HISTOGRAM_PHOTONS or moved > (HISTOGRAM_MAX_MOVED
                                                   * HISTOGRAM_PHOTONS):
        raise AssertionError("the photon histogram on the card differs from "
                             "the CPU's")

    r = Renderer(scene, cam, pt_cfg, seed=0)
    r.render_next_iteration()
    with tempfile.TemporaryDirectory() as logdir:
        # a replay (the graph's kernels) and the eager body (its pass
        # ranges: a replay runs no Python)
        with trace(logdir):
            r.render_next_iteration()
            r._iteration(r.iteration, r._radius_sq(r.iteration))
        events = json.loads((Path(logdir) / TRACE_FILE).read_text())[
            "traceEvents"]
    kernels = {e["name"] for e in events if e.get("cat") == "kernel"}
    ours = sorted(k for k in kernels if "closest" in k or "occluded" in k)
    scopes = [e for e in events if e.get("name") == "pt_raytrace_pass"]
    print(f"[tooling] trace: {len(events)} events, {len(kernels)} kernel "
          f"names (B1/B2: {ours}), {len(scopes)} pt_raytrace_pass ranges")
    if not kernels or not scopes:
        raise AssertionError("the trace holds no CUDA kernel or no "
                             "pt_raytrace_pass range")

    table = ComputeDeviceRepository.enumerate().table()
    print("[tooling] devices:\n" + "\n".join(
        f"[tooling]   {row}" for row in table.splitlines()))
    if torch.cuda.get_device_name(dev) not in table or "cpu" not in table:
        raise AssertionError("the device table misses the card or the CPU")


def phase_viewer(dev) -> None:
    """The live viewer on the card: ``RenderService`` at PT main behind
    ``make_server(port=0)``; frames and stats until VIEWER_ITERS
    iterations; a switch to PPM and then VCM, each restarting and serving
    a decodable, finite, non-black frame; a gamma change with no restart;
    a clean stop."""
    import io
    import threading
    import urllib.request

    from PIL import Image

    from oppositerenderer_tpu_torch.config import RenderConfig
    from oppositerenderer_tpu_torch.scene import get_scene_by_name
    from oppositerenderer_tpu_torch.viewer import RenderService, make_server

    scene, cam = get_scene_by_name(MAIN_SCENE, dev)
    svc = RenderService(scene, cam, RenderConfig(width=MAIN_SIZE,
                                                 height=MAIN_SIZE), seed=0)
    server = make_server(svc, port=0)
    serving = threading.Thread(target=server.serve_forever, daemon=True)
    base = f"http://127.0.0.1:{server.server_address[1]}"

    def get(path):
        with urllib.request.urlopen(base + path, timeout=60) as resp:
            return resp.read(), dict(resp.headers)

    def stats():
        return json.loads(get("/stats")[0])

    def wait_for(pred, what):
        deadline = time.monotonic() + VIEWER_TIMEOUT_S
        while time.monotonic() < deadline:
            if pred():
                return
            time.sleep(0.05)
        raise AssertionError(f"viewer: {what} within {VIEWER_TIMEOUT_S} s; "
                             f"stats {stats()}")

    def frame(label):
        png, headers = get("/frame.png")
        img = np.asarray(Image.open(io.BytesIO(png)), np.float64)
        mean = float(img.mean())
        if img.shape != (MAIN_SIZE, MAIN_SIZE, 3) or not 0.0 < mean < 255.0:
            raise AssertionError(f"viewer {label}: frame {img.shape}, mean "
                                 f"{mean}")
        return png, int(headers["X-Iteration"]), mean

    _reset_launches()
    serving.start()
    svc.start()
    t0 = time.perf_counter()
    try:
        wait_for(lambda: stats()["iterations"] >= VIEWER_ITERS,
                 f"{VIEWER_ITERS} PT iterations")
        _, it, mean = frame("pt")
        s = stats()
        print(f"[viewer] PT {MAIN_SIZE}^2 on {s['device']}: frame of "
              f"iteration {it}, mean {mean:.2f}; {s['iteration_seconds']:.4f} "
              f"s/iteration; {time.perf_counter() - t0:.1f} s")
        for method in ("ppm", "vcm"):
            seq0 = s["sequence_number"]
            get(f"/set?method={method}")
            wait_for(lambda: (stats()["render_method"] == method
                              and stats()["sequence_number"] == seq0 + 1
                              and stats()["iterations"] >= 1),
                     f"a restart into {method}")
            wait_for(lambda: int(get("/frame.png")[1]["X-Iteration"]) >= 1,
                     f"a {method} frame")
            _, it, mean = frame(method)
            s = stats()
            print(f"[viewer] /set?method={method}: sequence {seq0} -> "
                  f"{s['sequence_number']}, frame of iteration {it}, mean "
                  f"{mean:.2f}; {s['iteration_seconds']:.4f} s/iteration")
        seq0 = s["sequence_number"]
        png1, _, mean1 = frame("gamma 2.2")
        get("/set?gamma=1.0")
        png2, _, mean2 = frame("gamma 1.0")
        if stats()["sequence_number"] != seq0 or png2 == png1 \
                or not mean2 < mean1:
            raise AssertionError("viewer: the gamma change restarted the "
                                 "render or left the frame as it was")
        print(f"[viewer] /set?gamma=1.0: no restart (sequence {seq0}), "
              f"frame mean {mean1:.2f} -> {mean2:.2f}")
    finally:
        svc.stop()
        server.shutdown()
        server.server_close()
        serving.join(timeout=60)
    if serving.is_alive() or svc._thread.is_alive():
        raise AssertionError("viewer: a thread outlived the stop")
    launches = launch_counts(svc.renderer)
    print(f"[viewer] stopped cleanly after {time.perf_counter() - t0:.1f} "
          f"s; kernel launches {launches}")
    for k in ("closest_hit_tris", "occluded_tris", "gather_photons_tiled"):
        if launches[k] == 0:
            raise AssertionError(f"viewer: the renders never launched {k}")


# The parent tree's entry points and their argument types, as its
# accel/cuda_build.py has them at commit a2a280b: this tree's, without
# packet_steps_variant and packet_steps_cluster.
_P, _I = ctypes.c_void_p, ctypes.c_int
PARENT_ENTRY_POINTS = {
    "closest_hit_tris": [_P] * 5 + [_I, _I] + [_P] * 5,
    "occluded_tris": [_P] * 5 + [_I, _I] + [_P] * 2,
    "gather_photons_tiled": [_P] * 11 + [_I] * 4 + [_P] * 3,
    "merge_vertices_tiled": [_P] * 10 + [_I] * 3 + [_P] * 4,
    "bvh_closest": [_P] + [_I] * 3 + [_P] * 4 + [_I] + [_P] * 6,
    "bvh_any": [_P] + [_I] * 3 + [_P] * 4 + [_I] + [_P] * 2,
    "bvh_compact_live": [_P] * 2 + [_I] + [_P] * 3,
    "packet_steps": [_P, _I, _P, _P, _I, _I, _P, _P],
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
    # entry points added since that commit take this tree's arguments,
    # where the parent has them
    for name, argtypes in cuda_build.ENTRY_POINTS.items():
        if name not in PARENT_ENTRY_POINTS and hasattr(lib, name):
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
    """The parent's B1 and this tree's, both through this tree's wrapper,
    in turns on each of ``calls``, outputs bit for bit (an A/A check: the
    parent takes the same triangle records); returns the sums and each
    call's times."""
    from oppositerenderer_tpu_torch.accel import intersect_kernels as ik
    acc = {"calls": 0, "parent_iteration_ms": 0.0, "iteration_ms": 0.0,
           "per_call": []}
    for i, (o, d, tmin, tmax, tris) in enumerate(calls):
        def new(o=o, d=d, tmin=tmin, tmax=tmax, tris=tris):
            return ik.closest_hit_tris(o, d, tmin, tmax, tris)

        def old():
            with kernels_of(lib):
                return new()

        bad = sum(_bits_differ(a, b) for a, b in zip(old(), new()))
        if bad:
            raise AssertionError(f"B1 {label} call {i}: this tree differs "
                                 f"from the parent in {bad} values")
        t_old, t_new = in_turns(old, new)
        n, live = o.shape[0], int((tmax > tmin).sum())
        acc["calls"] += 1
        acc["parent_iteration_ms"] += t_old
        acc["iteration_ms"] += t_new
        acc["per_call"].append([n, live, t_old, t_new])
        print(f"[parent-ab] B1 (A/A) {label} call {i}: lanes {n}, live "
              f"{live}; parent {t_old:.4f} ms, this tree {t_new:.4f} ms (in "
              f"turns, medians of {TIMING_REPS}); equal bit for bit")
    print(f"[parent-ab] B1 (A/A) {label}: parent "
          f"{acc['parent_iteration_ms']:.4f} ms, this tree "
          f"{acc['iteration_ms']:.4f} ms over {acc['calls']} calls")
    return acc


def phase_parent_ab(dev, parent: Path) -> dict:
    """This tree's kernels against the parent tree's, in one call on one
    card, each timed in turns with its outputs compared, the port's
    wrappers launching the parent's library for the parent: B6 (redesigned
    since) at the microbenchmark's defaults and at B6_WIDE_TILES tiles,
    bit for bit; and, as an A/A check of kernels the parent shares, B1 on
    every closest-hit call of one CornellSmall 512^2 PPM and VCM iteration
    and on the 4096-triangle soup, B2 over one VCM iteration (bit for
    bit), B3 at the PPM main shape (within GATHER_RTOL), B4 on every merge
    round of one VCM+VM iteration (within VM_RTOL) and B5 on every call of
    one Atrium 512^2 and Conference 1024^2 PT iteration (bit for bit).
    Returns, per kernel, the parent's and this tree's ms at the timed
    shapes and summed over the iteration."""
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
    # B6 (A/B): the parent's first design against the redesign
    from oppositerenderer_tpu_torch.accel import packet_exp_kernels as pk
    from oppositerenderer_tpu_torch.scripts.packet_kernel_exp import \
        make_inputs
    acc = out["packet_steps"] = {}
    for tiles in (B6_TILES, B6_WIDE_TILES):
        table, o, d = make_inputs(B6_ROWS, tiles, dev)

        def b6(table=table, o=o, d=d):
            return pk.packet_steps(table, o, d, B6_STEPS)

        if _bits_differ(aa(b6)(), b6()):
            raise AssertionError(f"B6 at {tiles} tiles: this tree differs "
                                 "from the parent")
        t_old, t_new = in_turns(aa(b6), b6)
        bnd = b6_bound(B6_STEPS, tiles)["bound_ms"]
        if tiles == B6_TILES:
            acc.update(parent_ms=t_old, ms=t_new)
        else:
            acc[f"{tiles} tiles"] = {"parent_ms": t_old, "ms": t_new}
        print(f"[parent-ab] B6 (A/B) {tiles} tiles: parent (first design) "
              f"{t_old:.4f} ms, this tree {t_new:.4f} ms "
              f"({t_old / t_new:.2f}x), bound {bnd:.4f} ms (in turns, "
              f"medians of {TIMING_REPS}); equal bit for bit")
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
    kernels["packet_steps"], b6_launches = timed("b6", phase_b6, dev)
    if args.parent is not None:
        ab = timed("parent-ab", phase_parent_ab, dev, args.parent)
        for k, v in ab.items():
            kernels[k]["parent_ab"] = v
    phase_goldens(dev)
    launches = {k: 0 for k in KERNELS}
    launches.update(phase_main(dev))
    launches["packet_steps"] = b6_launches
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
    for k, c in timed("grad-main", phase_grad_main, dev).items():
        launches[k] += c
    timed("bvh-goldens", phase_goldens, dev, True)
    timed("bvh-parity", phase_bvh_parity, dev)
    for tag, scene_name, size, iters in (
            ("atrium-main", "Atrium", ATRIUM_SIZE, ATRIUM_ITERS),
            ("conference-main", "Conference", CONFERENCE_SIZE,
             CONFERENCE_ITERS)):
        for k, c in timed(tag, phase_bvh_main, dev, tag, scene_name, size,
                          iters).items():
            launches[k] += c
    for tag, phase in (("bench", phase_bench),
                       ("pass-timing", phase_pass_timing),
                       ("vcm-modes", phase_vcm_modes)):
        _reset_launches()
        for k, c in timed(tag, phase, dev).items():
            launches[k] += c
    timed("import-parity", phase_import_parity, dev)
    for phase, args in (("import-main", (phase_import_main, dev, kernels)),
                        ("photon-maps", (phase_photon_maps, dev)),
                        ("graphs", (phase_graphs, dev))):
        for k, c in timed(phase, *args).items():
            launches[k] += c
    mesh = one_rank_nccl_mesh(dev)
    shard_launches, partial_err = timed("shard-main", phase_shard_main, dev,
                                        mesh)
    for k, c in shard_launches.items():
        launches[k] += c
    b3["max_abs_err"] = max(b3["max_abs_err"], partial_err)
    timed("grad-shard", phase_grad_shard, dev, mesh)
    torch.distributed.destroy_process_group()
    for tag, phase in (("ranks", phase_ranks),
                       ("sharded-phase", phase_sharded_phase),
                       ("scaling", phase_scaling)):
        for k, c in timed(tag, phase, dev).items():
            launches[k] += c
    timed("tooling", phase_tooling, dev)
    timed("viewer", phase_viewer, dev)
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
