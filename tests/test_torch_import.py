"""The port's scene import (Collada and OBJ) and Collada export against
the JAX package's.

Both packages parse with ``xml.etree``, the same native float32 token
scanner and numpy, so a file imports to equal arrays, bit for bit: the
in-test DAE and OBJ of ``tests/test_import.py``, and ``scenes/
atrium_lite.dae`` (8,098 triangles behind a BVH, two PNG textures) with
its atlas and BVH table. The exporter writes the same text as JAX's for
the same scene. One 32^2 PT iteration of the imported Atrium agrees with
JAX's at PR 1's pixel bar (rtol 1e-4 on >= 99.5% of the pixels, the mean
within 1e-3). The rest mirrors ``tests/test_import.py`` (all six cases),
``tests/test_collada_roundtrip.py`` (all four, on Atrium:0.15) and
``tests/test_scene.py:79`` (the scanner against Python).
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tests"))

from test_import import DAE, MTL, OBJ  # noqa: E402
from test_torch_bvh_scenes import assert_scene_equal, leaves  # noqa: E402

from oppositerenderer_tpu import renderer as jrenderer  # noqa: E402
from oppositerenderer_tpu.config import RenderConfig as JConfig  # noqa: E402
from oppositerenderer_tpu.scene import collada as jcollada  # noqa: E402
from oppositerenderer_tpu.scene import \
    get_scene_by_name as jax_scene  # noqa: E402
from oppositerenderer_tpu.scene.collada_export import \
    export_collada as jax_export  # noqa: E402
from oppositerenderer_tpu_torch import native  # noqa: E402
from oppositerenderer_tpu_torch.camera import Camera  # noqa: E402
from oppositerenderer_tpu_torch.config import RenderConfig  # noqa: E402
from oppositerenderer_tpu_torch.core.rng import make_root_key  # noqa: E402
from oppositerenderer_tpu_torch.integrators import pt  # noqa: E402
from oppositerenderer_tpu_torch.lights import make_point_light  # noqa: E402
from oppositerenderer_tpu_torch.renderer import Renderer  # noqa: E402
from oppositerenderer_tpu_torch.scene import (  # noqa: E402
    DIFFUSE, EMITTER, GLASS, GLOSSY, LAST_LOAD_PHASES, SceneBuilder,
    export_collada, generate_smooth_normals, get_scene_by_name, load_collada,
    load_obj, load_scene_file)
from oppositerenderer_tpu_torch.scene.collada import \
    default_camera_for  # noqa: E402

torch.set_num_threads(2)

ATRIUM_LITE = REPO / "scenes" / "atrium_lite.dae"


def assert_equal_to_jax(got, want):
    """Every array of the port's record equal to the JAX record's, bit for
    bit (BVH codes through their int32 bits)."""
    assert_scene_equal(got, leaves(want))


@pytest.fixture
def dae_file(tmp_path):
    f = tmp_path / "test.dae"
    f.write_text(DAE)
    return f


@pytest.fixture
def obj_file(tmp_path):
    (tmp_path / "test.mtl").write_text(MTL)
    f = tmp_path / "test.obj"
    f.write_text(OBJ)
    return f


# ------------------------------------------------- equal to the JAX import
def test_in_test_files_import_as_in_jax(dae_file, obj_file):
    for path, jload, tload in ((dae_file, jcollada.load_collada,
                                load_collada),
                               (obj_file, jcollada.load_obj, load_obj)):
        jscene, jcam = jload(path)
        tscene, tcam = tload(path, "cpu")
        assert_equal_to_jax(tscene, jscene)
        assert_equal_to_jax(tcam, jcam)
        assert tscene.name == jscene.name == path.stem


@pytest.fixture(scope="module")
def atrium_lite_pair():
    jscene, _ = jcollada.load_scene_file(ATRIUM_LITE)
    tscene, tcam = load_scene_file(ATRIUM_LITE, "cpu")
    return jscene, tscene, tcam, dict(LAST_LOAD_PHASES)


def test_atrium_lite_imports_as_in_jax(atrium_lite_pair):
    """The repo's Collada file, its textures and its BVH, bit for bit."""
    jscene, tscene, _, phases = atrium_lite_pair
    assert tscene.geometry.n_triangles == 8098
    assert tscene.has_textures and tscene.textures.shape[0] == 2
    assert tscene.bvh is not None and tscene.bvh.builder == "native"
    assert_equal_to_jax(tscene, jscene)
    assert set(phases) == {"parse_build", "bvh_build"}
    assert all(v > 0 for v in phases.values())


def test_one_pt_iteration_of_the_imported_atrium_matches_jax(
        atrium_lite_pair):
    jscene, tscene, _, _ = atrium_lite_pair
    # the file carries no camera: Atrium's, as scripts/milestone4.py does
    jcam = jax_scene("Atrium:0.1")[1]
    tcam = get_scene_by_name("Atrium:0.1", "cpu")[1]
    cfg = dict(width=32, height=32)
    want = np.asarray(jrenderer.Renderer(jscene, jcam, JConfig(
        **cfg, use_pallas=False, iterations_per_dispatch=1,
        coherent_peel="off"), seed=7).render(1).mean_radiance())
    got = Renderer(tscene, tcam, RenderConfig(**cfg), seed=7).render(
        1).mean_radiance().numpy()
    assert np.isfinite(got).all() and want.mean() > 0.1
    agree = np.isclose(got, want, rtol=1e-4, atol=0.0).all(axis=-1)
    assert agree.mean() >= 0.995, agree.mean()
    assert got.mean() == pytest.approx(want.mean(), rel=1e-3)


def test_export_writes_jax_text(tmp_path):
    """The same scene exports to the same .dae and PNGs in both
    packages, with and without normals."""
    jscene, _ = jax_scene("Atrium:0.1")
    tscene, _ = get_scene_by_name("Atrium:0.1", "cpu")
    for normals in (True, False):
        (tmp_path / "j").mkdir(exist_ok=True)
        (tmp_path / "t").mkdir(exist_ok=True)
        a = jax_export(jscene, tmp_path / "j" / "s.dae",
                       write_normals=normals)
        b = export_collada(tscene, tmp_path / "t" / "s.dae",
                           write_normals=normals)
        assert a.read_text() == b.read_text()
        for t in range(int(tscene.textures.shape[0])):
            name = f"s_tex{t}.png"
            assert (a.parent / name).read_bytes() == \
                (b.parent / name).read_bytes()


def test_native_libraries_load():
    """All three native sources build and load where g++ is present."""
    for stem in native.STEMS:
        assert native.load(stem) is not None, stem
        assert native.library_path(stem).exists()
    assert (native.get_lib(), native.kdtree_lib(),
            native.text_scan_lib()) == tuple(native.load(s)
                                             for s in native.STEMS)


# ------------------------------------------------ tests/test_import.py
def test_collada_import(dae_file):
    scene, cam = load_collada(dae_file, "cpu")
    g = scene.geometry
    assert g.n_triangles == 5  # 2 quad + 1 tri + 2 lamp
    kinds = set(scene.materials.kind.tolist())
    assert DIFFUSE in kinds and GLASS in kinds and EMITTER in kinds
    kd = scene.materials.kd.numpy()
    assert any(np.allclose(row, [0.8, 0.7, 0.6]) for row in kd)
    # the emitter mesh became an area light
    assert scene.lights.n_lights == 1
    assert not bool(scene.lights.is_delta[0])
    # the translate moved the glass triangle to z = 1
    assert np.isclose(g.tri_v0[:, 2].max().item(), 1.0)


def test_collada_renders(dae_file):
    scene, _ = load_collada(dae_file, "cpu")
    cam = Camera.make((0.5, 1.2, 4.0), (0.5, 0.8, 0.0), hfov=50, vfov=50,
                      device="cpu")
    img = pt.render_iteration(scene, cam, RenderConfig(width=16, height=16),
                              0, make_root_key(0))
    assert bool(torch.isfinite(img).all()) and float(img.max()) > 0


def test_obj_import(obj_file):
    scene, _ = load_obj(obj_file, "cpu")
    assert scene.geometry.n_triangles == 4
    kinds = scene.materials.kind.tolist()
    assert DIFFUSE in kinds and GLOSSY in kinds and EMITTER in kinds
    assert np.isclose(scene.geometry.tri_uv1.max().item(), 1.0)
    assert scene.lights.n_lights == 1


def test_textured_material_renders():
    """A checkerboard texture modulates kd through the PT path."""
    checker = np.indices((8, 8)).sum(axis=0) % 2
    img = np.stack([checker] * 3, axis=-1).astype(np.float32)
    b = SceneBuilder()
    m = b.add_textured((1, 1, 1), b.add_texture_image(img))
    b.add_parallelogram((-2, 0, -2), (0, 0, 4), (4, 0, 0), m)
    b.add_light(make_point_light((50.0,) * 3, (0, 3, 0)))
    scene = b.build(device="cpu")
    assert scene.has_textures
    cam = Camera.make((0, 3, -3.0), (0, 0, 0), hfov=40, vfov=40,
                      device="cpu")
    out = pt.render_iteration(scene, cam, RenderConfig(
        width=32, height=32, pt_max_segments_nee=2), 0, make_root_key(1))
    lum = out.numpy().sum(-1)
    assert np.isfinite(lum).all()
    lit = (lum > lum.max() * 0.2).mean()
    assert 0.2 < lit < 0.9, lit


def test_factory_falls_through_to_file(tmp_path):
    f = tmp_path / "myscene.obj"
    (tmp_path / "test.mtl").write_text(MTL)
    f.write_text(OBJ)
    scene, cam = get_scene_by_name(str(f), "cpu")
    assert scene.geometry.n_triangles == 4
    assert cam.eye.device.type == "cpu"


def test_missing_file_raises():
    with pytest.raises(FileNotFoundError):
        get_scene_by_name("/nonexistent/scene.dae", "cpu")


# ------------------------------------- tests/test_collada_roundtrip.py
@pytest.fixture(scope="module")
def atrium_015():
    return get_scene_by_name("Atrium:0.15", "cpu")


def test_atrium_roundtrip_structure(tmp_path, atrium_015):
    scene, _ = atrium_015
    dae = export_collada(scene, tmp_path / "atrium_lite.dae")
    assert dae.exists() and dae.stat().st_size > 10_000
    scene2, _ = load_scene_file(dae, "cpu")
    assert scene2.geometry.n_triangles == scene.geometry.n_triangles

    def kinds(s):
        # GLOSSY re-imports as DIFFUSE (Collada's common profiles and the
        # reference's import rules carry no glossy class)
        k = s.materials.kind.numpy()
        k = np.where(k == GLOSSY, DIFFUSE, k)
        return {int(k[mi]) for mi in np.unique(s.geometry.tri_mat.numpy())}

    assert kinds(scene2) == kinds(scene)
    assert scene.has_textures and scene2.has_textures
    np.testing.assert_allclose(scene2.aabb_min.numpy(),
                               scene.aabb_min.numpy(), atol=0.2)
    np.testing.assert_allclose(scene2.aabb_max.numpy(),
                               scene.aabb_max.numpy(), atol=0.2)
    assert scene2.lights.n_lights >= 1


def test_roundtrip_renders(tmp_path, atrium_015):
    scene, cam = atrium_015
    scene2, _ = load_scene_file(
        export_collada(scene, tmp_path / "atrium_lite.dae"), "cpu")
    r = Renderer(scene2, cam, RenderConfig(width=24, height=24,
                                           pt_max_segments_nee=3), seed=0)
    img = r.render(1).mean_radiance().numpy()
    assert np.isfinite(img).all() and img.sum() > 0


def test_smooth_normal_generation(tmp_path):
    """Exported without normals, the importer generates smooth vertex
    normals (the aiProcess_GenSmoothNormals analog, Scene.cpp:96-108)."""
    scene, _ = get_scene_by_name("CornellSmallNoBlocks", "cpu")
    dae = export_collada(scene, tmp_path / "box.dae", write_normals=False)
    g = load_scene_file(dae, "cpu")[0].geometry
    for n in (g.tri_n0, g.tri_n1, g.tri_n2):
        np.testing.assert_allclose(np.linalg.norm(n.numpy(), axis=1), 1.0,
                                   atol=1e-4)
    fn = np.cross(g.tri_e1.numpy(), g.tri_e2.numpy())
    fn /= np.maximum(np.linalg.norm(fn, axis=1, keepdims=True), 1e-20)
    n0 = g.tri_n0.numpy()
    up = fn[:, 1] > 0.999
    assert up.any()
    assert (np.abs((n0[up] * fn[up]).sum(1)) > 0.9).mean() > 0.4


def test_generate_smooth_normals_sphere_like():
    """Shared vertices average the incident faces' normals; the port's
    function is the JAX package's, bit for bit."""
    tris = np.asarray([
        [[0, 0, 0], [1, 0, 0], [0.5, 1, 0.5]],
        [[1, 0, 0], [0, 0, 0], [0.5, 1, -0.5]],
    ], np.float32)
    n = generate_smooth_normals(tris)
    fn0 = np.cross(tris[0, 1] - tris[0, 0], tris[0, 2] - tris[0, 0])
    fn1 = np.cross(tris[1, 1] - tris[1, 0], tris[1, 2] - tris[1, 0])
    mean = (fn0 + fn1) / np.linalg.norm(fn0 + fn1)
    np.testing.assert_allclose(n[0, 0], mean, atol=1e-5)
    soup = np.random.default_rng(1).uniform(0, 3, (300, 3, 3)).astype(
        np.float32)
    soup[100:200, 0] = soup[:100, 1]          # shared vertices
    for t in (tris, soup):
        np.testing.assert_array_equal(generate_smooth_normals(t),
                                      jcollada.generate_smooth_normals(t))


# ---------------------------------------------- tests/test_scene.py:79
def test_native_text_scanner_matches_python():
    """native/text_scan.cpp against the exact Python parser."""
    assert native.scan_floats("1 2") is not None, "g++ could not build it"
    t = "1 2.5 -3e4 +0.125 1e-7 .5 7. -0.0 1E+3 2,3\n\t4\r\n5"
    ref = np.asarray([float(x) for x in t.replace(",", " ").split()],
                     np.float32)
    np.testing.assert_array_equal(native.scan_floats(t), ref)
    rng = np.random.default_rng(7)
    vals = (rng.standard_normal(5000)
            * 10.0 ** rng.integers(-8, 8, 5000)).astype(np.float32)
    text = " ".join(repr(float(v)) for v in vals)
    np.testing.assert_array_equal(native.scan_floats(text), vals)
    # a malformed token returns None: the caller takes the Python parser
    assert native.scan_floats("1 abc 2") is None
    assert native.scan_ints("1.5") is None
    assert native.scan_ints(" 4 -17 003 +9 ").tolist() == [4, -17, 3, 9]
    assert native.scan_floats("   ").shape == (0,)


def test_default_camera_frames_the_box(dae_file):
    """The default camera looks at the box's centre from outside it."""
    scene, cam = load_collada(dae_file, "cpu")
    assert torch.equal(cam.eye, default_camera_for(scene).eye)
    c = 0.5 * (scene.aabb_min + scene.aabb_max)
    assert bool(((cam.eye < scene.aabb_min) | (cam.eye > scene.aabb_max))
                .any())
    assert float(torch.dot(cam.lookdir, c - cam.eye)) > 0


# ------------------------------------------------------ the chip scripts
def test_chip_smoke_and_milestone_inputs_are_the_tests_and_jax_ones():
    """chip_smoke.py's import-parity DAE is tests/test_import.py's, and
    milestone4_torch.py renders the JAX package's default configuration
    at 1024^2, as scripts/milestone4.py does (its TPU dispatch fields
    aside, which the port does not have)."""
    import chip_smoke
    import milestone4_torch as m4

    from oppositerenderer_tpu.config import RenderMethod as JMethod
    assert chip_smoke.SMALL_DAE == DAE
    assert (m4.SIZE, m4.SCENES, m4.METHODS) == (
        1024, ("Atrium", "Conference"), ("ppm", "vcm"))
    for method, jmethod in (("ppm", JMethod.PROGRESSIVE_PHOTON_MAPPING),
                            ("vcm", JMethod.VCM_BIDIRECTIONAL_PATH_TRACING)):
        got = m4.method_config(method, m4.SIZE)
        want = JConfig(width=1024, height=1024, render_method=jmethod)
        for f in RenderConfig.__dataclass_fields__:
            g, w = getattr(got, f), getattr(want, f)
            assert (g.name if hasattr(g, "name") else g) == (
                w.name if hasattr(w, "name") else w), f
