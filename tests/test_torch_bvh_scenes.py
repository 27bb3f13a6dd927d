"""The port's BVH slice as a whole: the procedural Atrium and Conference
scenes against the JAX package's, one PT iteration on Atrium against
JAX's, and the BVH route against the dense route in PT, PPM and VCM.

Scene construction is host-side numpy in both packages, so every field is
array-equal, the BVH table bit for bit (its codes are int32 bit patterns).
One PT iteration of Atrium:0.1 at 32^2 agrees with JAX's (its coherent
peel off, which changes JAX's last ulps) on >= 99% of the pixels at rtol
1e-3 with the mean within 1e-3, the bar of ROADMAP queue C. On CornellSmall
with a BVH attached, the BVH route and the dense route trace the same
paths: the images agree at rtol 2e-4 + atol 2e-4, the bar of
``tests/test_coherent_routing.py``.
"""
import dataclasses

import numpy as np
import pytest
import torch

from oppositerenderer_tpu import renderer as jrenderer
from oppositerenderer_tpu.config import RenderConfig as JConfig
from oppositerenderer_tpu.scene import get_scene_by_name as jax_scene
from oppositerenderer_tpu_torch import cli, interop
from oppositerenderer_tpu_torch.accel import bvh_kernels as bk
from oppositerenderer_tpu_torch.accel.bvh import build_scene_bvh
from oppositerenderer_tpu_torch.config import RenderConfig, RenderMethod
from oppositerenderer_tpu_torch.renderer import Renderer
from oppositerenderer_tpu_torch.scene import get_scene_by_name

torch.set_num_threads(2)


def leaves(obj):
    """Nested numpy leaves of a JAX record (flax struct dataclass)."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            out[f.name] = leaves(v)
        elif v is None or isinstance(v, str):
            out[f.name] = v
        else:
            out[f.name] = np.asarray(v)
    return out


def assert_scene_equal(got, want_leaves, path=""):
    for name, want in want_leaves.items():
        if want is None or isinstance(want, str) or name == "q_rows":
            continue
        g = getattr(got, name)
        if isinstance(want, dict):
            assert_scene_equal(g, want, f"{path}{name}.")
        elif name == "max_stack":
            # JAX sizes its stack for its code stack: 2 depth + 1
            assert g == (int(want) - 1) // 2 + 1, f"{path}{name}"
        elif isinstance(g, (int, float)):
            assert g == want.item(), f"{path}{name}"
        else:
            g = g.cpu().numpy()
            assert g.dtype == want.dtype, f"{path}{name}"
            if name == "rows":    # int32 codes stored as float32 bits
                g, want = g.view(np.int32), want.view(np.int32)
            np.testing.assert_array_equal(g, want, err_msg=f"{path}{name}")


@pytest.mark.parametrize("name", ["Atrium:0.1", "Conference:0.15"])
def test_scene_fields_match_jax(name):
    jscene, jcam = jax_scene(name)
    tscene, tcam = get_scene_by_name(name, "cpu")
    jl = leaves(jscene)
    assert_scene_equal(tscene, jl)
    assert tscene.name == jscene.name and tscene.bvh.builder == "native"
    assert_scene_equal(tcam, leaves(jcam))
    # interop: JAX's leaves give the port's own build (the BVH as JAX
    # sized it)
    via = interop.scene_from_numpy(jl, "cpu")
    assert via.bvh.max_stack == jscene.bvh.max_stack
    via.bvh.max_stack = tscene.bvh.max_stack
    assert_scene_equal(via, jl)


def test_one_pt_iteration_of_atrium_matches_jax():
    cfg = dict(width=32, height=32)
    jscene, jcam = jax_scene("Atrium:0.1")
    jr = jrenderer.Renderer(jscene, jcam, JConfig(
        **cfg, use_pallas=False, iterations_per_dispatch=1,
        coherent_peel="off"), seed=7)
    want = np.asarray(jr.render(1).mean_radiance())
    tscene, tcam = get_scene_by_name("Atrium:0.1", "cpu")
    got = Renderer(tscene, tcam, RenderConfig(**cfg), seed=7).render(
        1).mean_radiance().numpy()
    agree = np.isclose(got, want, rtol=1e-3, atol=0.0).all(axis=-1)
    assert agree.mean() >= 0.99, agree.mean()
    assert got.mean() == pytest.approx(want.mean(), rel=1e-3)
    assert want.mean() > 0.1


@pytest.fixture(scope="module")
def cornell_pair():
    scene, cam = get_scene_by_name("CornellSmall", "cpu")
    scene_b, bvh = build_scene_bvh(scene)
    return scene, dataclasses.replace(scene_b, bvh=bvh), cam


@pytest.mark.parametrize("method", ["pt", "ppm", "vcm"])
def test_bvh_route_leaves_the_estimators_unchanged(cornell_pair, method):
    """tests/test_coherent_routing.py:48 on the port: the same estimator
    and random streams, only the traversal differs."""
    dense, with_bvh, cam = cornell_pair
    cfg = RenderConfig(
        width=16, height=16, photons_per_iteration=1 << 10,
        photon_grid_resolution=8, gather_photon_budget=64,
        vcm_max_path_length=5, render_method={
            "pt": RenderMethod.PATH_TRACING,
            "ppm": RenderMethod.PROGRESSIVE_PHOTON_MAPPING,
            "vcm": RenderMethod.VCM_BIDIRECTIONAL_PATH_TRACING}[method])
    imgs = [Renderer(s, cam, cfg, seed=7).render(1).mean_radiance().numpy()
            for s in (dense, with_bvh)]
    np.testing.assert_allclose(imgs[1], imgs[0], rtol=2e-4, atol=2e-4)
    assert imgs[0].sum() > 0.0


def test_cli_renders_the_bvh_scenes(tmp_path, capsys):
    for name in ("Atrium:0.1", "Conference:0.1"):
        out = tmp_path / f"{name[:3]}.png"
        assert cli.main(["--cpu", "--scene", name, "--method", "pt",
                         "--size", "8", "-n", "1", "-o", str(out)]) == 0
        assert out.exists()
    assert "tris" in capsys.readouterr().out
    assert "Atrium" in cli.build_parser().format_help()


def test_renders_count_no_launch_on_the_cpu():
    before = (bk.traverse.launches, bk.traverse_any.launches)
    scene, cam = get_scene_by_name("Conference:0.1", "cpu")
    img = Renderer(scene, cam, RenderConfig(width=8, height=8),
                   seed=1).render(1).mean_radiance()
    assert bool(torch.isfinite(img).all()) and float(img.mean()) > 0.0
    assert (bk.traverse.launches, bk.traverse_any.launches) == before


def test_scene_files_still_raise():
    for name in ("scene.dae", "model.obj"):
        with pytest.raises(NotImplementedError, match="scene-import"):
            get_scene_by_name(name, "cpu")
    jl = leaves(jax_scene("CornellSmall")[0])
    # a medium no longer raises: it arrives with the scene
    jl["medium"] = {"sigma_s": np.float32(0.1), "sigma_a": np.float32(0.0),
                    "aabb_min": np.zeros(3, np.float32),
                    "aabb_max": np.ones(3, np.float32)}
    assert float(interop.scene_from_numpy(jl, "cpu").medium.sigma_t) == \
        pytest.approx(0.1)
