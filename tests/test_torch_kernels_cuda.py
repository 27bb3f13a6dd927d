"""The port's CUDA kernels on the card: each against its plain version.

These tests need an NVIDIA GPU (sm_90a) and nvcc; without them they skip.
Run them on such a machine with

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

(``--noconftest``: the suite's conftest imports JAX, which these tests do
not need.)
The library is built with --fmad=false, so kernel and plain version must
agree bit for bit.
"""
import numpy as np
import pytest
import torch

from oppositerenderer_tpu_torch.accel import intersect_kernels as ik
from oppositerenderer_tpu_torch.accel.intersect import occluder_mask
from oppositerenderer_tpu_torch.renderer import Renderer
from oppositerenderer_tpu_torch.config import RenderConfig
from oppositerenderer_tpu_torch.scene import get_scene_by_name

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def rays(n, seed, dev):
    rng = np.random.default_rng(seed)
    o = rng.uniform(0.2, 2.3, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmin = np.full(n, 1e-4, np.float32)
    tmax = rng.uniform(0.05, 3.0, n).astype(np.float32)
    tmax[::7] = 1e30
    tmax[::11] = 0.0           # dead lanes
    return [torch.as_tensor(a, device=dev) for a in (o, d, tmin, tmax)]


@pytest.mark.parametrize("n", [131, 4096, 262144])
@pytest.mark.parametrize("name", ["CornellSmall", "CornellSmallLargeSphere"])
def test_kernels_equal_plain_versions(cuda, name, n):
    scene, _ = get_scene_by_name(name, cuda)
    g = scene.geometry
    tri9 = ik.tri9_from_geometry(g)
    mask = occluder_mask(scene, g.tri_mat)
    args = rays(n, n, cuda)
    before = ik.closest_hit_tris.launches
    got = ik.closest_hit_tris(*args, tri9)
    assert ik.closest_hit_tris.launches == before + 1
    want = ik.closest_hit_tris_plain(*args, tri9)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert not bool((got[1][::11] >= 0).any())
    assert torch.equal(ik.occluded_tris(*args, tri9, mask),
                       ik.occluded_tris_plain(*args, tri9, mask))


def test_wrapper_rejects_bad_inputs(cuda):
    scene, _ = get_scene_by_name("CornellSmall", cuda)
    tri9 = ik.tri9_from_geometry(scene.geometry)
    o, d, tmin, tmax = rays(64, 0, cuda)
    with pytest.raises(ValueError, match="float32"):
        ik.closest_hit_tris(o.double(), d, tmin, tmax, tri9)
    with pytest.raises(ValueError, match="contiguous"):
        ik.closest_hit_tris(o, d, tmin, tmax, tri9.T.contiguous().T)


def test_render_on_the_card_matches_the_cpu_render(cuda):
    cfg = RenderConfig(width=32, height=32)
    imgs = []
    for dev in ("cpu", cuda):
        scene, cam = get_scene_by_name("CornellSmall", dev)
        imgs.append(Renderer(scene, cam, cfg, seed=1).render(
            2).mean_radiance().cpu().numpy())
    assert np.isfinite(imgs[1]).all()
    assert imgs[1].mean() == pytest.approx(imgs[0].mean(), rel=1e-3)
