"""Port scene data, camera and film vs the JAX package's builders.

Scene and camera construction is host-side numpy in both packages, so
every field must be array-equal. Camera rays go through float32 torch and
XLA arithmetic (rsqrt differs in the last ulp): rtol 1e-6.
"""
import dataclasses
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oppositerenderer_tpu import film as jfilm
from oppositerenderer_tpu.camera import Camera as JCamera
from oppositerenderer_tpu.scene import get_scene_by_name as jax_scene
from oppositerenderer_tpu_torch import film as tfilm
from oppositerenderer_tpu_torch import interop
from oppositerenderer_tpu_torch.camera import Camera
from oppositerenderer_tpu_torch.core.rng import make_root_key
from oppositerenderer_tpu_torch.scene import SCENE_NAMES, get_scene_by_name

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


def assert_records_equal(got, want_leaves, path=""):
    for name, want in want_leaves.items():
        if not hasattr(got, name) or want is None or isinstance(want, str):
            continue
        g = getattr(got, name)
        if g is None:   # the texture atlases: empty in JAX, None here
            assert want.shape[0] == 0, f"{path}{name}"
            continue
        if isinstance(want, dict):
            assert_records_equal(g, want, f"{path}{name}.")
            continue
        if isinstance(g, float):
            assert g == float(want), f"{path}{name}"
            continue
        g = g.cpu().numpy()
        assert g.dtype == want.dtype, f"{path}{name}: {g.dtype} {want.dtype}"
        np.testing.assert_array_equal(g, want, err_msg=f"{path}{name}")


def test_scene_names_match_the_golden_scenes():
    sys.path.insert(0, str(Path(__file__).parent.parent / "scripts"))
    from make_goldens import SCENES
    assert list(SCENE_NAMES) == SCENES


@pytest.mark.parametrize("name", SCENE_NAMES)
def test_scene_and_camera_fields_match_jax(name):
    jscene, jcam = jax_scene(name)
    tscene, tcam = get_scene_by_name(name, "cpu")
    jl = leaves(jscene)
    assert_records_equal(tscene, jl)
    assert jl["textures"].shape[0] == 0 and jl["bvh"] is None
    assert tscene.name == jscene.name
    assert_records_equal(tcam, leaves(jcam))
    # interop: the JAX scene's leaves give the port's own build
    assert_records_equal(interop.scene_from_numpy(jl, "cpu"), jl)
    assert_records_equal(interop.camera_from_numpy(leaves(jcam), "cpu"),
                         leaves(jcam))


def test_unknown_and_later_slice_inputs_raise():
    """An unknown name is a scene file (tests/test_torch_import.py), and
    a missing file raises as in the JAX package; Atrium, Conference,
    textured scenes and media are in (tests/test_torch_bvh_scenes.py,
    tests/test_torch_texture.py, tests/test_torch_media.py)."""
    for name in ("sponza.dae", "NoSuchScene"):
        with pytest.raises(FileNotFoundError):
            get_scene_by_name(name, "cpu")
    jl = leaves(jax_scene("CornellSmall")[0])
    jl["textures"] = np.zeros((1, 4, 4, 3), np.float32)
    assert interop.scene_from_numpy(jl, "cpu").has_textures
    jl["medium"] = {"sigma_s": np.float32(0.5), "sigma_a": np.float32(0.25),
                    "aabb_min": np.zeros(3, np.float32),
                    "aabb_max": np.full(3, 2.5, np.float32)}
    medium = interop.scene_from_numpy(jl, "cpu").medium
    assert float(medium.sigma_t) == 0.75
    assert medium.aabb_max.tolist() == [2.5] * 3
    with pytest.raises(ValueError):
        interop.key_from_numpy(np.zeros(3, np.uint32))


@pytest.mark.parametrize("aperture", [0.0, 0.05])
def test_camera_rays_match_jax(aperture):
    args = dict(eye=(1.25, 1.25, -2.85), lookat=(1.25, 1.25, 0),
                hfov=45.0, vfov=40.0, aperture=aperture)
    jcam = JCamera.make(**args)
    tcam = Camera.make(**args, device="cpu")
    rng = np.random.default_rng(3)
    px = rng.integers(0, 64, 2000)
    py = rng.integers(0, 48, 2000)
    jit = rng.random((2000, 2), dtype=np.float32)
    dof = rng.random((2000, 2), dtype=np.float32)
    jo, jd = jcam.generate_rays(jnp.asarray(px), jnp.asarray(py),
                                jnp.asarray(jit), 64, 48,
                                dof_u=jnp.asarray(dof))
    to, td = tcam.generate_rays(torch.as_tensor(px), torch.as_tensor(py),
                                torch.as_tensor(jit), 64, 48,
                                dof_u=torch.as_tensor(dof))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-6,
                               atol=1e-6)


def test_camera_pan_and_dolly_match_jax():
    args = dict(eye=(278, 273, -850), lookat=(278, 273, 0), hfov=35.0,
                vfov=35.0)
    jcam = JCamera.make(**args)
    tcam = Camera.make(**args, device="cpu")
    for jc, tc in ((jcam.translate(3.0, -2.0), tcam.translate(3.0, -2.0)),
                   (jcam.dolly(0.25), tcam.dolly(0.25))):
        for f in ("eye", "lookdir", "camera_u", "camera_v"):
            np.testing.assert_allclose(getattr(tc, f).numpy(),
                                       np.asarray(getattr(jc, f)),
                                       rtol=1e-6, err_msg=f)


def test_film_display_and_checkpoints_interchange_with_jax(tmp_path):
    rng = np.random.default_rng(5)
    rad = [rng.random((6, 5, 3), dtype=np.float32) * 3 for _ in range(3)]
    rad[1][0, 0, 0] = np.nan
    jf = jfilm.Film.create(5, 6)
    tf = tfilm.Film.create(5, 6, "cpu")
    for r in rad:
        jf = jf.add_iteration(jnp.asarray(r))
        tf = tf.add_iteration(torch.as_tensor(r))
    np.testing.assert_array_equal(tf.accum.numpy(), np.asarray(jf.accum))
    np.testing.assert_array_equal(tf.to_display().numpy(),
                                  np.asarray(jf.to_display()))
    tfilm.save_png(tf, tmp_path / "a.png")
    tfilm.save_tga(tf, tmp_path / "a.tga")
    assert (tmp_path / "a.tga").stat().st_size == 18 + 6 * 5 * 3

    # port checkpoint -> JAX loader, and back
    key = make_root_key(11)
    tfilm.save_checkpoint(tmp_path / "port.npz", tf, key, 0.25)
    jf2, jkey, r2, _ = jfilm.load_checkpoint(tmp_path / "port.npz")
    np.testing.assert_array_equal(np.asarray(jf2.accum), tf.accum.numpy())
    assert int(jf2.iterations) == 3 and r2 == 0.25
    np.testing.assert_array_equal(np.asarray(jkey), [0, 11])
    jfilm.save_checkpoint(tmp_path / "jax.npz", jf2, jkey, 0.5,
                          extra={"note": np.arange(2)})
    tf2, tkey, r2, extra = tfilm.load_checkpoint(tmp_path / "jax.npz",
                                                  "cpu")
    assert tkey == key and tf2.iterations == 3 and r2 == 0.5
    np.testing.assert_array_equal(extra["note"], np.arange(2))
    np.testing.assert_array_equal(tf2.accum.numpy(), tf.accum.numpy())
