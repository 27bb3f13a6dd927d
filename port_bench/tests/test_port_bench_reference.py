"""The plain reference's scene is the one the program renders (its own
copy, read from ``reference/scenes/``), and its estimators agree with
the program's on the CPU at a small size, tile by tile."""
from __future__ import annotations

import json
import math
from pathlib import Path

import torch

from port_bench.reference import pt, scene

ROOT = Path(__file__).resolve().parents[2]
FIELDS = json.loads((ROOT / "port_bench/configs/cornell_small.json")
                    .read_text())["render_config"]


def test_the_reference_scene_is_the_programs():
    import oppositerenderer_tpu_torch as ort
    prog, cam = ort.get_scene_by_name("CornellSmall", "cpu")
    s = scene.load("CornellSmall", "cpu")
    data = json.loads((scene.SCENES / "CornellSmall.json").read_text())
    tris = []
    for _, a, e1, e2, _m in data["parallelograms"]:
        a, e1, e2 = (torch.tensor(x, dtype=torch.float32)
                     for x in (a, e1, e2))
        tris += [(a, a + e1, a + e1 + e2), (a, a + e1 + e2, a + e2)]
    g = prog.geometry
    assert g.n_triangles == len(tris) == s.n_triangles
    for i, (v0, v1, v2) in enumerate(tris):
        torch.testing.assert_close(g.tri_v0[i], v0, rtol=0, atol=1e-6)
        torch.testing.assert_close(g.tri_e1[i], v1 - v0, rtol=0, atol=1e-6)
        torch.testing.assert_close(g.tri_e2[i], v2 - v0, rtol=0, atol=1e-6)
        m = s.material[i // 2]
        assert int(g.tri_mat[i]) == int(m)
        if not s.emitter[m]:    # an emitter stops a path: its kd is unread
            torch.testing.assert_close(prog.materials.kd[m], s.kd[m])
    torch.testing.assert_close(prog.lights.emission[0], s.light_radiance)
    torch.testing.assert_close(cam.camera_u, s.cam_u)
    torch.testing.assert_close(cam.camera_v, s.cam_v)
    torch.testing.assert_close(cam.lookdir, s.look)


def test_the_reference_pt_agrees_with_the_programs_on_the_cpu():
    """Both images of CornellSmall at 16x16, 4x4 tiles, as two estimates
    of one expectation: every tile's z-score within 5."""
    import oppositerenderer_tpu_torch as ort
    W = H = 16
    n = 256
    sc, cam = ort.get_scene_by_name("CornellSmall", "cpu")
    r = ort.Renderer(sc, cam, ort.RenderConfig(width=W, height=H), seed=3)
    rows = []
    for _ in range(8):
        rows.append(r.render(n // 8).accum.clone())
    batches = torch.stack([b - a for a, b in zip([torch.zeros_like(rows[0])]
                                                 + rows, rows)]) / (n // 8)
    s = scene.load("CornellSmall", "cpu")
    gen = torch.Generator().manual_seed(5)
    py, px = torch.meshgrid(torch.arange(H), torch.arange(W),
                            indexing="ij")
    ref = torch.stack([
        pt.radiance(s, px.reshape(-1), py.reshape(-1), W, H, gen,
                    pt.segments(FIELDS), FIELDS["path_rr_start_depth"])
        .reshape(H, W, 3) for _ in range(n)])

    def tiles(x):
        return x.double().sum(-1).reshape(-1, 4, 4, 4, 4).mean((2, 4))

    p, r_ = tiles(batches), tiles(ref)
    var = p.var(0) / p.shape[0] + r_.var(0) / r_.shape[0]
    z = (p.mean(0) - r_.mean(0)) / var.sqrt()
    assert float(z.abs().max()) < 5.0, z
    assert math.isfinite(float(z.abs().max()))
