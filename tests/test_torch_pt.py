"""The port's path-tracing slice as a whole, against the JAX package and
against the stored goldens.

Both packages draw the same per-lane random streams, so their images
agree pixel by pixel, but not bit for bit: XLA:CPU's rsqrt and contracted
multiply-adds differ from torch's in the last ulp, and such a difference
can flip a rare Russian-roulette or validity decision, or which of two
almost touching surfaces a ray hits. So one iteration must agree at rtol
1e-4 on at least 99.5% of the pixels, with the image mean within 1e-3.
"""
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "scripts"))

import _torch_cases  # noqa: E402
from make_goldens import ITERS, SEED, golden_config  # noqa: E402
from oppositerenderer_tpu import renderer as jrenderer  # noqa: E402
from oppositerenderer_tpu.config import RenderConfig as JConfig  # noqa: E402
from oppositerenderer_tpu.scene import \
    get_scene_by_name as jax_scene  # noqa: E402
from oppositerenderer_tpu_torch import cli, renderer  # noqa: E402
from oppositerenderer_tpu_torch.config import (RenderConfig,  # noqa: E402
                                               RenderMethod)
from oppositerenderer_tpu_torch.core.rng import make_root_key  # noqa: E402
from oppositerenderer_tpu_torch.integrators import pt  # noqa: E402
from oppositerenderer_tpu_torch.integrators.common import \
    pixel_coords  # noqa: E402
from oppositerenderer_tpu_torch.renderer import Renderer  # noqa: E402
from oppositerenderer_tpu_torch.scene import (SCENE_NAMES,  # noqa: E402
                                              get_scene_by_name)

torch.set_num_threads(2)


def test_one_iteration_matches_jax_pixel_by_pixel():
    cfg = dict(width=64, height=64)
    jscene, jcam = jax_scene("CornellSmall")
    jr = jrenderer.Renderer(jscene, jcam, JConfig(
        **cfg, use_pallas=False, iterations_per_dispatch=1), seed=7)
    want = np.asarray(jr.render(1).mean_radiance())
    tscene, tcam = get_scene_by_name("CornellSmall", "cpu")
    got = Renderer(tscene, tcam, RenderConfig(**cfg), seed=7).render(
        1).mean_radiance().numpy()
    agree = np.isclose(got, want, rtol=1e-4, atol=0.0).all(axis=-1)
    assert agree.mean() >= 0.995, agree.mean()
    assert got.mean() == pytest.approx(want.mean(), rel=1e-3)


def test_golden_config_is_the_jax_one():
    want = golden_config("pt")
    got = _torch_cases.golden_pt_config()
    for f in RenderConfig.__dataclass_fields__:
        assert getattr(got, f) == getattr(want, f), f
    assert (_torch_cases.GOLDEN_SEED, _torch_cases.GOLDEN_ITERS) == (SEED,
                                                                 ITERS["pt"])


@pytest.mark.parametrize("name", SCENE_NAMES)
def test_matches_pt_golden(name):
    """``tests/test_goldens.py``'s tolerance on every pixel, except that on
    Cornell, whose area light lies within two float32 ulps of its ceiling,
    up to ``GOLDEN_MAX_FLIPPED`` pixels may hold a path that went the other
    way at that z-fight (8 of 4096 measured); the image mean must still
    agree within ``GOLDEN_MEAN_RTOL``."""
    scene, cam = get_scene_by_name(name, "cpu")
    r = Renderer(scene, cam, _torch_cases.golden_pt_config(),
                 seed=_torch_cases.GOLDEN_SEED)
    img = r.render(_torch_cases.GOLDEN_ITERS).mean_radiance().numpy()
    assert np.isfinite(img).all()
    want = np.load(_torch_cases.GOLDENS)[f"{name}__pt"].astype(np.float32)
    bad, worst, mean_err = _torch_cases.golden_agreement(img, want)
    assert bad <= (_torch_cases.GOLDEN_MAX_FLIPPED if name == "Cornell"
                   else 0), (bad, worst)
    assert mean_err <= _torch_cases.GOLDEN_MEAN_RTOL


def small_renderer(**kw):
    scene, cam = get_scene_by_name("CornellSmallSmallSpheres", "cpu")
    return Renderer(scene, cam, RenderConfig(width=24, height=16, **kw),
                    seed=3)


def test_restart_determinism_and_accumulation_order():
    r = small_renderer()
    a = r.render(3).accum.clone()
    assert r.iteration == 3 and r.metrics["iteration"] == 3
    r.restart()
    assert r.iteration == 0 and float(r.film.accum.abs().sum()) == 0.0
    b = r.render(3).accum
    assert torch.equal(a, b)
    r.restart()
    for _ in range(3):
        m = r.render_next_iteration()
    assert m["iteration"] == 3 and m["iteration_seconds"] > 0
    assert torch.equal(r.film.accum, a)


def test_checkpoint_resume_continues_the_same_render(tmp_path):
    straight = small_renderer()
    straight.render(3)
    first = small_renderer()
    first.render(2)
    first.save_checkpoint(tmp_path / "ck.npz")
    resumed = Renderer(first.scene, first.camera, first.cfg, seed=99)
    resumed.load_checkpoint(tmp_path / "ck.npz")
    assert resumed.iteration == 2 and resumed.root_key == make_root_key(3)
    resumed.render_next_iteration()
    assert torch.equal(resumed.film.accum, straight.film.accum)
    with pytest.raises(ValueError):
        Renderer(first.scene, first.camera,
                 first.cfg.replace(width=8), seed=3).load_checkpoint(
            tmp_path / "ck.npz")


def test_stacked_iterations_draw_the_separate_streams():
    """render_lanes with G iteration numbers equals G separate renders."""
    r = small_renderer()
    W, H = r.cfg.width, r.cfg.height
    px, py = pixel_coords(W, H, "cpu")
    lanes = torch.arange(W * H)
    one = [pt.render_lanes(r.scene, r.camera, r.cfg, it, r.root_key, px, py,
                           lanes) for it in (4, 9)]
    both = pt.render_lanes(r.scene, r.camera, r.cfg, [4, 9], r.root_key,
                           px.repeat(2), py.repeat(2), lanes.repeat(2))
    assert torch.equal(both, torch.cat(one))


def test_ppm_radius_schedules_match_jax():
    for it in (0, 1, 5, 40):
        assert renderer.ppm_radius_sq_at_iteration(0.2, 2 / 3, it) == \
            jrenderer.ppm_radius_sq_at_iteration(0.2, 2 / 3, it)
    its = np.arange(0, 200, 7)
    want = np.asarray(jax.vmap(lambda i: jrenderer.ppm_radius_sq_traced(
        0.2, 2 / 3, i))(jnp.asarray(its)))
    got = renderer.ppm_radius_sq_traced(0.2, 2 / 3, torch.as_tensor(its))
    # float32 lgamma reaches ~800 here (ulp 6e-5) and the closed form
    # subtracts such values: both packages' results carry ~1e-4 of
    # relative noise, XLA's and torch's lgamma differing in the last ulps
    np.testing.assert_allclose(got.numpy(), want, rtol=5e-4)
    np.testing.assert_allclose(
        got.numpy(), [renderer.ppm_radius_sq_at_iteration(0.2, 2 / 3, int(i))
                      for i in its], rtol=5e-4)


def test_config_validation_and_later_slices():
    with pytest.raises(ValueError):
        RenderConfig(pt_max_segments_nee=0)
    with pytest.raises(ValueError):
        RenderConfig(pt_shadow_samples=-1)
    assert RenderConfig(pt_direct_light_sampling=False).pt_max_segments == 10
    # scene files are in: a missing one raises as in the JAX package
    with pytest.raises(FileNotFoundError):
        get_scene_by_name("conference.obj", "cpu")
    # the stochastic hash and the kd-tree are in
    from oppositerenderer_tpu_torch.config import PhotonMapStructure
    r = small_renderer(
        render_method=RenderMethod.PROGRESSIVE_PHOTON_MAPPING,
        photon_map_structure=PhotonMapStructure.STOCHASTIC_HASH)
    assert bool(torch.isfinite(r.render(1).mean_radiance()).all())
    # a BVH deeper than the kernel's stack is refused on every device
    import dataclasses
    from oppositerenderer_tpu_torch.accel import bvh_kernels
    from oppositerenderer_tpu_torch.accel.bvh import build_scene_bvh
    r = small_renderer(
        render_method=RenderMethod.VCM_BIDIRECTIONAL_PATH_TRACING)
    r.scene, bvh = build_scene_bvh(r.scene)
    r.scene.bvh = dataclasses.replace(
        bvh, max_stack=bvh_kernels.KERNEL_MAX_STACK + 1)
    with pytest.raises(ValueError, match="stack"):
        r.render(1)


def test_cli_renders_checkpoints_and_resumes(tmp_path, capsys):
    out, ck = tmp_path / "x.png", tmp_path / "ck.npz"
    args = ["--cpu", "--scene", "CornellSmall", "--method", "pt", "--size",
            "16", "-n", "2", "-o", str(out), "--checkpoint", str(ck),
            "--preview-every", "1"]
    assert cli.main(args) == 0
    assert out.exists() and ck.exists()
    assert cli.main(args + ["--resume", "--pan", "0.1", "0.0"]) == 0
    assert "resumed from" in capsys.readouterr().out
    assert cli.main(["--cpu", "--method", "pt", "--size", "8", "-n", "1",
                     "-q", "-o", str(tmp_path / "y.tga")]) == 0
    assert (tmp_path / "y.tga").stat().st_size == 18 + 8 * 8 * 3
    # a device ordinal past the device table is refused
    with pytest.raises(SystemExit) as e:
        cli.main(["--device", "99", "-n", "1"])
    assert e.value.code == 2
