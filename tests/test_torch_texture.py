"""Port textures (atlas, bilinear sampling, normal maps) and the textured
branch of ``bsdf_at_hit`` vs the JAX package.

The atlas resize is PIL's bilinear resize written out in numpy, so the
atlases equal JAX's (which calls PIL) exactly, Conference's upsampled
128^2 carpet included. Sampling is float32 arithmetic in the same order
as JAX's: rtol 1e-6. The normal map's normalize goes through rsqrt, which
differs from XLA's in the last ulp: atol 1e-6. The textured BSDF at the
hits of one Atrium:0.1 camera wavefront, on JAX's hit record: kd rtol
1e-6, the shading normal atol 1e-5 (rsqrt).
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from oppositerenderer_tpu.integrators.common import bsdf_at_hit as jbsdf_at_hit
from oppositerenderer_tpu.scene import get_scene_by_name as jax_scene
from oppositerenderer_tpu.scene import texture as jtex
from oppositerenderer_tpu_torch.accel.intersect import Hit, intersect
from oppositerenderer_tpu_torch.integrators.common import bsdf_at_hit
from oppositerenderer_tpu_torch.scene import get_scene_by_name
from oppositerenderer_tpu_torch.scene import texture as ttex

jint = importlib.import_module("oppositerenderer_tpu.accel.intersect")

torch.set_num_threads(2)


@pytest.mark.parametrize("shape", [(128, 128), (256, 256), (100, 37),
                                   (300, 513), (7, 9)])
def test_resize_is_pils(shape):
    rng = np.random.default_rng(shape[0])
    img = (rng.random(shape + (3,)) * 255).astype(np.uint8)
    want = np.asarray(Image.fromarray(img).resize((64, 64) if shape[0] < 10
                                                  else (256, 256),
                                                  Image.BILINEAR))
    got = ttex._resize_bilinear_u8(img, want.shape[0])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["Atrium:0.1", "Conference:0.15"])
def test_atlases_match_jax(name):
    jscene, _ = jax_scene(name)
    tscene, _ = get_scene_by_name(name)
    for f in ("textures", "normal_maps"):
        want = np.asarray(getattr(jscene, f))
        got = getattr(tscene, f).numpy()
        assert got.dtype == np.float32 and got.shape == want.shape, f
        np.testing.assert_array_equal(got, want, err_msg=f)
    assert tscene.has_textures


def test_empty_atlas_matches_jax():
    np.testing.assert_array_equal(ttex.build_atlas([]).numpy(),
                                  np.asarray(jtex.build_atlas([])))


def test_sampling_and_normal_map_match_jax():
    rng = np.random.default_rng(11)
    atlas = rng.random((3, 16, 16, 3)).astype(np.float32)
    n = 4000
    uv = rng.uniform(-2.5, 3.5, (n, 2)).astype(np.float32)
    uv[:8] = [[0, 0], [1, 1], [-1, 2], [-1e-9, 1 + 1e-7], [0.5, -0.5],
              [3.0, -3.0], [1e-30, -1e-30], [0.999999, 0.0]]
    tex_id = rng.integers(-1, 4, n).astype(np.int32)
    want = np.asarray(jtex.sample_bilinear(jnp.asarray(atlas),
                                           jnp.asarray(tex_id),
                                           jnp.asarray(uv)))
    got = ttex.sample_bilinear(torch.as_tensor(atlas),
                               torch.as_tensor(tex_id),
                               torch.as_tensor(uv)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)

    def unit(k):
        a = rng.normal(size=(k, 3)).astype(np.float32)
        return a / np.linalg.norm(a, axis=1, keepdims=True)

    ns, tangent, bitangent = unit(n), unit(n), unit(n)
    want = np.asarray(jtex.apply_normal_map(
        *(jnp.asarray(a) for a in (ns, tangent, bitangent, want))))
    got = ttex.apply_normal_map(
        *(torch.as_tensor(a) for a in (ns, tangent, bitangent, got))).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_textured_bsdf_at_hit_matches_jax():
    jscene, jcam = jax_scene("Atrium:0.1")
    tscene, tcam = get_scene_by_name("Atrium:0.1")
    W = H = 32
    py, px = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    jitter = np.random.default_rng(2).random((W * H, 2), dtype=np.float32)
    o, d = tcam.generate_rays(torch.as_tensor(px.ravel()),
                              torch.as_tensor(py.ravel()),
                              torch.as_tensor(jitter), W, H)
    n = o.shape[0]
    tmin = torch.full((n,), 1e-3)
    tmax = torch.full((n,), 1e30)
    ja = [jnp.asarray(a.numpy()) for a in (o, d, tmin, tmax)]
    jhit = jint.intersect(jscene, *ja)
    thit = intersect(tscene, o, d, tmin, tmax)
    h = np.asarray(jhit.hit)
    np.testing.assert_array_equal(thit.hit.numpy(), h)
    np.testing.assert_array_equal(thit.prim.numpy(), np.asarray(jhit.prim))
    np.testing.assert_allclose(thit.uv.numpy()[h], np.asarray(jhit.uv)[h],
                               atol=1e-5)
    # the textured branch on the same hit record (JAX's): the uv of the
    # two intersectors differ in the last ulps, which the bilinear weights
    # amplify by the texture's width (255)
    thit = Hit(**{f: torch.as_tensor(np.asarray(getattr(jhit, f)))
                  for f in Hit.__dataclass_fields__})
    jb, jem, jrad = jbsdf_at_hit(jscene, jhit, ja[1])
    tb, tem, trad = bsdf_at_hit(tscene, thit, d)
    kinds = tscene.materials.kind[thit.mat.long()].numpy()
    assert (kinds[h] == 5).mean() > 0.3          # textured lanes dominate
    np.testing.assert_array_equal(tem.numpy(), np.asarray(jem))
    np.testing.assert_allclose(tb.kd.numpy()[h], np.asarray(jb.kd)[h],
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tb.frame.n.numpy()[h],
                               np.asarray(jb.frame.n)[h], atol=1e-5)
    np.testing.assert_allclose(trad.numpy(), np.asarray(jrad), rtol=1e-6)
