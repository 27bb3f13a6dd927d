"""The port's entry points run on the CUDA card unless the caller asks for
the CPU: without a card, calling one without a device raises and names
``device="cpu"``; with ``"cpu"`` every tensor lies on the CPU. (The card's
side, where the default lands on ``cuda``, is in
``tests/test_torch_kernels_cuda.py``.)"""
import numpy as np
import pytest
import torch

from oppositerenderer_tpu_torch import devices, interop
from oppositerenderer_tpu_torch.camera import Camera
from oppositerenderer_tpu_torch.film import Film, load_checkpoint, \
    save_checkpoint
from oppositerenderer_tpu_torch.lights import build_light_table, \
    make_point_light
from oppositerenderer_tpu_torch.scene import SceneBuilder, get_scene_by_name
from oppositerenderer_tpu_torch.scene.atrium import make_atrium
from oppositerenderer_tpu_torch.scene.conference import make_conference
from oppositerenderer_tpu_torch.scene.cornell import make_cornell, \
    make_cornell_small
from oppositerenderer_tpu_torch.scene.texture import build_atlas


@pytest.fixture
def no_card(monkeypatch):
    """As on a machine without a CUDA device, whatever this one has."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def tiny_builder():
    b = SceneBuilder("tiny")
    white = b.add_diffuse((0.8, 0.8, 0.8))
    b.add_parallelogram((0, 0, 0), (0, 0, 1), (1, 0, 0), white)
    b.add_light(make_point_light((1.0, 1.0, 1.0), (0.5, 1.0, 0.5)))
    return b


ENTRY_POINTS = {
    "get_scene_by_name": lambda: get_scene_by_name("CornellSmall"),
    "make_cornell": make_cornell,
    "make_cornell_small": make_cornell_small,
    "make_atrium": lambda: make_atrium(0.1),
    "make_conference": lambda: make_conference(0.05),
    "SceneBuilder.build": lambda: tiny_builder().build(),
    "Camera.make": lambda: Camera.make((0, 0, -1), (0, 0, 0)),
    "build_light_table": lambda: build_light_table(
        [make_point_light((1.0, 1.0, 1.0), (0.0, 1.0, 0.0))]),
    "Film.create": lambda: Film.create(4, 4),
    "build_atlas": lambda: build_atlas([]),
    "photon_batch_from_numpy": lambda: interop.photon_batch_from_numpy(
        {f: np.zeros((2, 3), np.float32) if f != "valid"
         else np.ones(2, bool) for f in interop.PHOTON_BATCH_FIELDS}),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_without_a_device_raises_without_a_card(no_card, name):
    with pytest.raises(RuntimeError, match='device="cpu"'):
        ENTRY_POINTS[name]()


def test_load_checkpoint_without_a_device_raises_without_a_card(
        no_card, tmp_path):
    save_checkpoint(tmp_path / "ck.npz", Film.create(4, 4, "cpu"), (1, 2),
                    0.5)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        load_checkpoint(tmp_path / "ck.npz")
    film, key, _, _ = load_checkpoint(tmp_path / "ck.npz", "cpu")
    assert film.accum.device.type == "cpu" and key == (1, 2)


def test_resolve_device_passes_a_named_device_through(no_card):
    assert devices.resolve_device("cpu") == torch.device("cpu")
    assert devices.resolve_device(torch.device("cpu")).type == "cpu"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        devices.resolve_device(None)


@pytest.mark.parametrize("name", ["CornellSmall", "Cornell"])
def test_cpu_scene_has_cpu_tensors(name):
    scene, cam = get_scene_by_name(name, "cpu")
    assert scene.device.type == "cpu"
    tensors = [v for rec in (scene.geometry, scene.materials, scene.lights)
               for v in vars(rec).values() if torch.is_tensor(v)]
    tensors += [scene.aabb_min, scene.aabb_max, cam.eye, cam.camera_u]
    assert tensors and all(t.device.type == "cpu" for t in tensors)
