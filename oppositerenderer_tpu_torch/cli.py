"""Command-line renderer — the Standalone application analog.

The counterpart of ``oppositerenderer_tpu/cli.py`` with its flags: pick a
scene, render iterations, write a preview every few iterations, print a
stats line per iteration, checkpoint and resume, or serve the live
viewer (``--serve``). The port renders path tracing, progressive photon
mapping and VCM (``--vm`` adds vertex merging). There is no
``--pallas``: the device decides whether the CUDA kernels run.
``--list-devices`` prints the compute-device table (the CUDA cards, then
the CPU) and ``--device N`` renders on its row N; ``--cpu`` is the CPU.

Usage:
  python -m oppositerenderer_tpu_torch.cli --scene CornellSmall --method vcm \
      --size 512 --iterations 64 --output out.png
  python -m oppositerenderer_tpu_torch.cli --cpu --method pt --size 64 \
      --serve 8000
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import torch


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="opposite-torch",
        description="Progressive renderer on PyTorch/CUDA")
    p.add_argument("--scene", default="CornellSmall",
                   help="a built-in scene (a Cornell scene, Atrium or "
                        "Conference; Atrium:<detail>, Conference:<detail> "
                        "scale the triangle count) or a .dae/.obj file")
    p.add_argument("--method", default="vcm", choices=["pt", "ppm", "vcm"],
                   help="render method")
    p.add_argument("--size", type=int, default=512,
                   help="square output resolution")
    p.add_argument("--width", type=int, default=None)
    p.add_argument("--height", type=int, default=None)
    p.add_argument("--iterations", "-n", type=int, default=32)
    p.add_argument("--output", "-o", default="render.png",
                   help=".png or .tga output")
    p.add_argument("--preview-every", type=int, default=5,
                   help="write the output every N iterations (0 = end only)")
    p.add_argument("--gamma", type=float, default=2.2)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--photons", type=int, default=1 << 20,
                   help="photons per PPM iteration")
    p.add_argument("--ppm-radius", type=float, default=None,
                   help="initial PPM/VCM merge radius (default: scene "
                        "heuristic)")
    p.add_argument("--vm", action="store_true",
                   help="VCM: enable vertex merging")
    p.add_argument("--checkpoint", default=None,
                   help="checkpoint file to save to after rendering")
    p.add_argument("--resume", action="store_true",
                   help="resume from --checkpoint if it exists")
    p.add_argument("--cpu", action="store_true",
                   help="render on the CPU (plain PyTorch, no kernels)")
    p.add_argument("--device", type=int, default=None,
                   help="render on the device of this row of "
                        "--list-devices (default: the first CUDA card)")
    p.add_argument("--list-devices", action="store_true",
                   help="print the compute-device table and exit")
    p.add_argument("--profile", default=None, metavar="LOGDIR",
                   help="write a torch.profiler Chrome trace of the render "
                        "loop to LOGDIR/trace.json")
    p.add_argument("--serve", type=int, default=None, metavar="PORT",
                   help="serve a live progressive viewer on this port")
    # camera overrides (Mouse.cpp interaction analogs)
    p.add_argument("--eye", type=float, nargs=3, default=None)
    p.add_argument("--lookat", type=float, nargs=3, default=None)
    p.add_argument("--fov", type=float, default=None)
    p.add_argument("--aperture", type=float, default=None)
    p.add_argument("--dolly", type=float, default=None,
                   help="move eye toward lookat by this fraction")
    p.add_argument("--pan", type=float, nargs=2, default=None,
                   help="pan in image plane (u, v)")
    p.add_argument("--quiet", "-q", action="store_true")
    return p


def main(argv=None) -> int:
    p = build_parser()
    args = p.parse_args(argv)
    from .devices import ComputeDeviceRepository
    if args.list_devices:
        print(ComputeDeviceRepository.enumerate().table())
        return 0

    from .camera import Camera
    from .config import RenderConfig, RenderMethod
    from .core.profiling import trace
    from .film import save_png, save_tga
    from .renderer import Renderer
    from .scene import get_scene_by_name

    if args.cpu:
        device = torch.device("cpu")
    elif args.device is not None:
        repo = ComputeDeviceRepository.enumerate()
        try:
            device = repo.pick(args.device)
        except ValueError as e:
            p.error(str(e))
        if not args.quiet:
            print(f"rendering on {repo.devices[args.device].summary()}")
    elif torch.cuda.is_available():
        device = torch.device("cuda", 0)
    else:
        p.error("no CUDA device: pass --cpu to render with plain PyTorch")

    method = {"pt": RenderMethod.PATH_TRACING,
              "ppm": RenderMethod.PROGRESSIVE_PHOTON_MAPPING,
              "vcm": RenderMethod.VCM_BIDIRECTIONAL_PATH_TRACING}[args.method]
    cfg = RenderConfig(width=args.width or args.size,
                       height=args.height or args.size, render_method=method,
                       photons_per_iteration=args.photons, gamma=args.gamma,
                       vcm_use_vm=args.vm)
    t0 = time.perf_counter()
    scene, camera = get_scene_by_name(args.scene, device)
    if not args.quiet:
        print(f"scene '{scene.name}': {scene.geometry.n_triangles} tris, "
              f"{scene.geometry.n_spheres} spheres, "
              f"{scene.lights.n_lights} lights on {device} "
              f"(loaded in {time.perf_counter() - t0:.2f}s)")

    if args.eye or args.lookat or args.fov or args.aperture is not None:
        eye = args.eye or camera.eye.tolist()
        lookat = args.lookat or camera.lookat.tolist()
        fov = args.fov or camera.hfov
        ap = (args.aperture if args.aperture is not None
              else float(camera.aperture))
        camera = Camera.make(eye, lookat, hfov=fov, vfov=fov, aperture=ap,
                             device=device)
    if args.dolly:
        camera = camera.dolly(args.dolly)
    if args.pan:
        camera = camera.translate(*args.pan)

    if args.serve is not None:
        from .viewer import serve
        serve(scene, camera, cfg, port=args.serve, seed=args.seed,
              preview_every=max(1, args.preview_every),
              ppm_initial_radius=args.ppm_radius)
        return 0

    r = Renderer(scene, camera, cfg, seed=args.seed,
                 ppm_initial_radius=args.ppm_radius)
    if args.resume and args.checkpoint and Path(args.checkpoint).exists():
        r.load_checkpoint(args.checkpoint)
        if not args.quiet:
            print(f"resumed from {args.checkpoint} at iteration "
                  f"{r.iteration}")

    save = save_tga if args.output.endswith(".tga") else save_png
    target = r.iteration + args.iterations
    with trace(args.profile):
        while r.iteration < target:
            m = r.render_next_iteration()
            if not args.quiet:
                extra = "".join(f" {k}={v:.3g}" for k, v in m.items()
                                if k in ("photons_stored",
                                         "light_vertices_stored",
                                         "ppm_radius"))
                print(f"iter {m['iteration']:4d}  "
                      f"{m['iteration_seconds'] * 1e3:7.1f} ms{extra}")
            if args.preview_every and r.iteration % args.preview_every == 0:
                save(r.film, args.output, gamma=args.gamma)

    save(r.film, args.output, gamma=args.gamma)
    if args.checkpoint:
        r.save_checkpoint(args.checkpoint)
        if not args.quiet:
            print(f"checkpoint -> {args.checkpoint}")
    if not args.quiet:
        print(f"wrote {args.output} ({r.iteration} iterations)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
