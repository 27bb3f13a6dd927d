"""The threefry kernel's wrappers (``accel/rng_kernels.py``) seen from the
CPU.

On CUDA tensors each Threefry call of ``core/rng.py`` (a ``LaneSampler``
draw, a key fold, ``uniform``) is one launch of ``csrc/rng.cu``; on CPU
tensors the int64 plain version runs and the wrappers are never reached.
The kernel itself runs only on the card (``test_torch_kernels_cuda.py``).
Here: CPU renders launch nothing; the wrappers refuse what the kernel does
not take before any launch; on fake CUDA tensors (the captured step's
audit of ``test_torch_capture_safe.py``) each draw and each device fold is
one launch with the operands the kernel reads, and a step launches once
for each tensor call its plain version makes.
"""
import pytest
import torch
from test_torch_capture_safe import (fake_cuda_indexing,  # noqa: F401
                                     fake_like)
from torch._subclasses.fake_tensor import FakeTensorMode

from oppositerenderer_tpu_torch.accel import cuda_build, kernel_wrappers
from oppositerenderer_tpu_torch.accel import rng_kernels as nk
from oppositerenderer_tpu_torch.accel.intersect import dense_tables
from oppositerenderer_tpu_torch.config import RenderConfig, RenderMethod
from oppositerenderer_tpu_torch.core import rng as trng
from oppositerenderer_tpu_torch.renderer import CapturedStep, Renderer
from oppositerenderer_tpu_torch.scene import get_scene_by_name

torch.set_num_threads(2)
pytestmark = pytest.mark.filterwarnings(
    "ignore:Accessing the data pointer of FakeTensor")

WRAPPERS = (nk.threefry_draw, nk.threefry_words, nk.threefry_uniform)
SIZE = 16
CONFIGS = {
    "pt": lambda: RenderConfig(width=SIZE, height=SIZE),
    "ppm": lambda: RenderConfig(
        width=SIZE, height=SIZE, photons_per_iteration=1 << 10,
        photon_grid_resolution=16,
        render_method=RenderMethod.PROGRESSIVE_PHOTON_MAPPING),
    "vcm": lambda: RenderConfig(
        width=SIZE, height=SIZE, vcm_max_path_length=4,
        render_method=RenderMethod.VCM_BIDIRECTIONAL_PATH_TRACING),
}


@pytest.fixture
def recorded(monkeypatch):
    """Each launch's entry point and arguments, in place of the card."""
    calls = []
    monkeypatch.setattr(cuda_build, "launch_on",
                        lambda device, name, *args: calls.append(
                            (name, args)))
    return calls


def test_the_wrappers_come_last_in_kernel_wrappers():
    names = [w.__name__ for w in kernel_wrappers()]
    assert names[:7] == ["closest_hit_tris", "occluded_tris",
                         "gather_photons_tiled", "merge_vertices_tiled",
                         "traverse", "traverse_any", "sum_rows"]
    assert kernel_wrappers()[7:] == WRAPPERS


@pytest.mark.parametrize("method", sorted(CONFIGS))
def test_a_cpu_render_never_reaches_the_kernel(method, recorded):
    before = [w.launches for w in WRAPPERS]
    scene, cam = get_scene_by_name("CornellSmall", "cpu")
    r = Renderer(scene, cam, CONFIGS[method](), seed=5)
    img = r.render(1).mean_radiance()
    assert bool(torch.isfinite(img).all()) and float(img.mean()) > 0.0
    assert [w.launches for w in WRAPPERS] == before and not recorded


def test_the_card_predicate():
    assert trng._on_card(torch.device("cuda"))
    assert trng._on_card(3, torch.device("cuda", 0))
    assert not trng._on_card(torch.device("cpu"), 3, torch.zeros(2),
                             torch.zeros((), dtype=torch.int64))


LANES = torch.arange(8, dtype=torch.int64)
REFUSED = {
    "cpu lanes": lambda: nk.threefry_draw(LANES, 1, 2, 0, 3),
    "int32 lanes": lambda: nk.threefry_draw(LANES.int(), 1, 2, 0, 3),
    "2-d lanes": lambda: nk.threefry_draw(LANES.reshape(2, 4), 1, 2, 0, 3),
    "strided lanes": lambda: nk.threefry_draw(LANES[::2], 1, 2, 0, 3),
    "no column": lambda: nk.threefry_draw(LANES, 1, 2, 0, 0),
    "short per-lane key": lambda: nk.threefry_draw(LANES, LANES[:7], 2, 0,
                                                   1),
    "float key": lambda: nk.threefry_draw(LANES, LANES.float(), 2, 0, 1),
    "2-d key": lambda: nk.threefry_words(LANES.reshape(2, 4), 1, 0, 5),
    "cpu words": lambda: nk.threefry_words(LANES, 1, 0, LANES),
    "no tensor word": lambda: nk.threefry_words(1, 2, 0, 5),
    "lengths that do not broadcast": lambda: nk.threefry_words(
        LANES, 1, 0, LANES[:5]),
    "int32 word": lambda: nk.threefry_words(1, 2, 0, LANES.int()),
    "cpu uniform": lambda: nk.threefry_uniform(1, 2, 9, "cpu"),
    "per-lane uniform key": lambda: nk.threefry_uniform(LANES, 2, 8, "cpu"),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_the_wrappers_refuse_before_launching(case, recorded):
    before = [w.launches for w in WRAPPERS]
    with pytest.raises(ValueError):
        REFUSED[case]()
    assert not recorded and [w.launches for w in WRAPPERS] == before


@pytest.mark.parametrize("key_form", ["host", "device", "per_lane"])
def test_a_draw_on_the_card_is_one_launch_with_its_operands(key_form,
                                                            recorded):
    """A LaneSampler on CUDA lanes: each draw one ``threefry_draw`` launch
    with the column counter the plain version would take, the key words
    as values (a host key), 0-d pointers (stride 0) or per-lane pointers
    (stride 1), and an output of [N, cols] float32."""
    host = trng.iteration_key(trng.make_root_key(9), 4, 1)
    with FakeTensorMode():
        lanes = torch.arange(6, dtype=torch.int64, device="cuda")
        key = {"host": host,
               "device": trng.device_key(host, "cuda"),
               "per_lane": trng.lane_key_words(
                   [trng.device_key(host, "cuda")] * 3, 2, "cuda")}[key_form]
        s = trng.LaneSampler(key, lanes)
        outs = [s.next2(), s.next1(), s.next3(), s.next1()]
    assert [o.shape for o in outs] == [(6, 2), (6,), (6, 3), (6,)]
    assert all(o.dtype == torch.float32 and o.device.type == "cuda"
               for o in outs)
    assert [name for name, _ in recorded] == ["threefry_draw"] * 4
    counters = [args[8] for _, args in recorded]
    cols = [args[9] for _, args in recorded]
    assert counters == [0, 1, 2, 4] and cols == [2, 1, 3, 1]
    for _, args in recorded:
        assert args[1] == 6 and args[10].shape == (6, args[9])
        for ptr, value, stride in (args[2:5], args[5:8]):
            if key_form == "host":
                assert ptr is None and stride == 0
            else:
                assert ptr is not None and value == 0
                assert stride == (1 if key_form == "per_lane" else 0)
        if key_form == "host":
            assert (args[3], args[6]) == host


def test_device_folds_and_uniform_are_one_launch_each(recorded):
    """``iteration_key`` on a device key is two ``threefry_words`` launches
    (0-d), ``fold_in_range`` one over its counters, a fold of a host key
    none; ``uniform`` on a CUDA device one ``threefry_uniform`` launch."""
    host = trng.make_root_key(21)
    with FakeTensorMode():
        dev = trng.device_key(host, "cuda")
        it = torch.full((), 3, dtype=torch.int64, device="cuda")
        key = trng.iteration_key(dev, it, 2)
        assert key[0].shape == () and key[0].dtype == torch.int64
        keys = trng.fold_in_range(key, 1000, 7)
        assert len(keys) == 7 and keys[0][1].shape == ()
        assert trng.fold_in(host, 5) == trng.fold_in(host, 5)
        u = trng.uniform(key, (3, 5), "cuda")
        v = trng.uniform(host, (4,), torch.device("cuda"))
    assert u.shape == (3, 5) and v.shape == (4,)
    assert [n for n, _ in recorded] == ["threefry_words"] * 3 + [
        "threefry_uniform"] * 2
    # fold_in_range: the key 0-d, the counters (0, start + i) 1-d
    args = recorded[2][1]
    assert [args[i] for i in (2, 5, 7, 8, 11)] == [0, 0, 0, 0, 1]
    assert args[12] == 7 and args[13].shape == (2, 7)
    assert recorded[3][1][4] == 15 and recorded[4][1][4] == 4
    assert recorded[4][1][1::2][:2] == tuple(w & trng.MASK32 for w in host)


@pytest.mark.parametrize("method", sorted(CONFIGS))
def test_a_captured_step_launches_once_a_tensor_threefry_call(
        method, recorded, monkeypatch):
    """The captured body on fake CUDA tensors (device keys, as a capture
    takes them): the kernel's launches equal the tensor calls the int64
    plain version makes in the same body, draws and folds alike."""
    scene, cam = get_scene_by_name("CornellSmall", "cpu")
    cfg = CONFIGS[method]()
    tables = dense_tables(scene)

    def body():
        with FakeTensorMode():
            s, c = fake_like(scene), fake_like(cam)
            s.dense_cache = (s.geometry, s.materials,
                             *map(fake_like, tables))
            r = Renderer(s, c, cfg, seed=3, ppm_initial_radius=0.05)
            step = CapturedStep(r._raw_step(), c, r.ppm_initial_radius,
                                cfg.ppm_alpha, SIZE, SIZE, r.device)
            step.prepare(c, r.root_key, 5, 1, 0.0025)
            step._body()

    body()
    launched = [n for n, _ in recorded if n.startswith("threefry")]
    plain_calls = []
    plain = trng.threefry2x32_plain

    def counted(*words):
        if any(torch.is_tensor(w) for w in words):
            plain_calls.append(words)
        return plain(*words)

    monkeypatch.setattr(trng, "_on_card", lambda *xs: False)
    monkeypatch.setattr(trng, "threefry2x32_plain", counted)
    del recorded[:]
    body()
    assert not [n for n, _ in recorded if n.startswith("threefry")]
    assert launched.count("threefry_words") >= 3
    assert len(launched) == len(plain_calls) > 20
