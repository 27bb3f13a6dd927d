"""The port's live viewer over HTTP: ``tests/test_viewer.py``'s ten tests at
its 24^2 configuration on the CPU, and the port's two departures from the
JAX viewer (ROADMAP queue C): a frame is encoded from a copy of
the film published between iterations, and the cached frame is keyed on
(that copy, the gamma), so a gamma change is never answered with a frame
of the old gamma.

Every wait polls the service's own state (iterations, sequence number,
idle turns of the render thread) against a deadline.
"""
import io
import json
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image

from oppositerenderer_tpu_torch import viewer
from oppositerenderer_tpu_torch.config import RenderConfig, RenderMethod
from oppositerenderer_tpu_torch.film import Film
from oppositerenderer_tpu_torch.parallel.distributed import \
    IterationScheduler
from oppositerenderer_tpu_torch.scene import get_scene_by_name
from oppositerenderer_tpu_torch.viewer import RenderService, make_server

CFG = dict(width=24, height=24, photons_per_iteration=1 << 10,
           photon_grid_resolution=8, gather_photon_budget=32,
           pt_max_segments_nee=3)
GAMMA_REPEATS = 20


def service(**kw) -> RenderService:
    scene, cam = get_scene_by_name("CornellSmall", "cpu")
    cfg = RenderConfig(render_method=RenderMethod.PATH_TRACING, **CFG)
    return RenderService(scene, cam, cfg, seed=3, **kw)


@pytest.fixture(scope="module")
def viewer_server():
    svc = service(preview_every=1)
    server = make_server(svc, port=0)
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    svc.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    yield svc, base
    svc.stop()
    server.shutdown()
    server.server_close()
    t.join(timeout=30)
    assert not t.is_alive() and not svc._thread.is_alive()


def _get(base, path):
    try:
        with urllib.request.urlopen(base + path, timeout=30) as r:
            return r.status, r.read(), dict(r.headers)
    except urllib.error.HTTPError as e:  # urllib raises on 4xx/5xx
        return e.code, e.read(), dict(e.headers)


def _wait_for(predicate, timeout=120.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(0.02)
    return False


def _stats(base):
    return json.loads(_get(base, "/stats")[1])


def _image(png: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(png)))


def test_page_and_frame(viewer_server):
    svc, base = viewer_server
    status, body, _ = _get(base, "/")
    assert status == 200 and b"opposite-tpu" in body

    assert _wait_for(lambda: _stats(base)["iterations"] >= 1)
    status, png, headers = _get(base, "/frame.png")
    assert status == 200 and png[:8] == b"\x89PNG\r\n\x1a\n"
    img = _image(png)
    assert img.shape == (24, 24, 3)
    assert img.max() > 0  # the box is lit
    assert int(headers["X-Iteration"]) >= 1


def test_stats_fields(viewer_server):
    svc, base = viewer_server
    assert _wait_for(lambda: _stats(base)["iterations"] >= 2)
    s = _stats(base)
    assert s["render_method"] in ("pt", "ppm", "vcm")
    assert s["resolution"] == "24x24"
    assert s["scene"]
    assert s["running_status"] == "RUNNING"
    assert s["render_seconds"] > 0
    assert s["device"] == "cpu"


def test_method_switch_restarts(viewer_server):
    svc, base = viewer_server
    assert _wait_for(lambda: _stats(base)["iterations"] >= 2)
    seq0 = _stats(base)["sequence_number"]
    _get(base, "/set?method=vcm")
    assert _wait_for(lambda: _stats(base)["render_method"] == "vcm")
    s = _stats(base)
    assert s["sequence_number"] == seq0 + 1
    # restart happened: the vcm film starts over
    assert _wait_for(lambda: 1 <= _stats(base)["iterations"])
    _get(base, "/set?method=pt")
    assert _wait_for(lambda: _stats(base)["render_method"] == "pt")


def test_camera_op_restarts_and_changes_view(viewer_server):
    svc, base = viewer_server
    assert _wait_for(lambda: _stats(base)["iterations"] >= 1)
    eye0 = svc.renderer.camera.eye.numpy().copy()
    status, _, _ = _get(base, "/camera?op=dolly&arg=0.3")
    assert status == 200
    assert _wait_for(
        lambda: not np.allclose(svc.renderer.camera.eye.numpy(), eye0))
    # orbit keeps distance to lookat
    cam = svc.renderer.camera
    d0 = float(np.linalg.norm((cam.lookat - cam.eye).numpy()))
    _get(base, "/camera?op=orbit&arg=0.5&arg=0.2")

    def orbited():
        c = svc.renderer.camera
        d = float(np.linalg.norm((c.lookat - c.eye).numpy()))
        return (not np.allclose(c.eye.numpy(), cam.eye.numpy())
                and abs(d - d0) < 1e-3 * max(d0, 1.0))
    assert _wait_for(orbited)


def test_pause_resume(viewer_server):
    svc, base = viewer_server
    _get(base, "/control?cmd=pause")
    assert _wait_for(lambda: _stats(base)["running_status"] == "PAUSE")
    # an iteration in flight when the flag flipped may still land: read
    # the count once the render thread has idled, then require it to hold
    # over three more idle turns
    idle0 = _stats(base)["idle_turns"]
    assert _wait_for(lambda: _stats(base)["idle_turns"] > idle0)
    s = _stats(base)
    it, idle1 = s["iterations"], s["idle_turns"]
    assert _wait_for(lambda: _stats(base)["idle_turns"] >= idle1 + 3)
    assert _stats(base)["iterations"] == it
    _get(base, "/control?cmd=resume")
    assert _wait_for(lambda: _stats(base)["iterations"] > it)


def test_gamma_changes_display_only(viewer_server):
    """JAX's test of the same name, 20 times with the render thread
    running: after a gamma change the frame served is the new gamma's
    (darker at gamma 1 than at 2.2), with no restart."""
    svc, base = viewer_server
    assert _wait_for(lambda: _stats(base)["iterations"] >= 1)
    for rep in range(GAMMA_REPEATS):
        seq0 = _stats(base)["sequence_number"]
        png1 = _get(base, "/frame.png")[1]
        _get(base, "/set?gamma=1.0")
        png2 = _get(base, "/frame.png")[1]
        assert _stats(base)["sequence_number"] == seq0, rep  # no restart
        assert png1 != png2, rep                    # but display changed
        assert _image(png2).mean() < _image(png1).mean(), rep
        _get(base, "/set?gamma=2.2")


def test_unknown_routes(viewer_server):
    svc, base = viewer_server
    assert _get(base, "/nope")[0] == 404
    assert _get(base, "/control?cmd=bogus")[0] == 400


def test_bad_camera_op_is_http_error_and_loop_survives(viewer_server):
    svc, base = viewer_server
    # an invalid op or missing arguments are refused at the handler (500),
    # never queued: the render loop keeps iterating
    assert _get(base, "/camera?op=bogus")[0] == 500
    assert _get(base, "/camera?op=orbit&arg=0.1")[0] == 500  # arity 2
    it = _stats(base)["iterations"]
    assert _wait_for(lambda: _stats(base)["iterations"] > it)


def test_scene_switch(viewer_server):
    svc, base = viewer_server
    seq0 = _stats(base)["sequence_number"]
    status, _, _ = _get(base, "/set?scene=Cornell")
    assert status == 200
    assert _wait_for(lambda: _stats(base)["scene"] == "Cornell"
                     and _stats(base)["sequence_number"] > seq0)
    assert _wait_for(lambda: _stats(base)["iterations"] >= 1)
    assert svc.renderer.scene.device.type == "cpu"
    # the loop survives a bad scene name too (the error shows in stats)
    _get(base, "/set?scene=NoSuchScene")
    assert _wait_for(lambda: "last_error" in _stats(base))
    assert _wait_for(lambda: _stats(base)["iterations"] >= 1)


def test_workers_endpoint(viewer_server):
    svc, base = viewer_server
    # no farm attached: empty list
    assert json.loads(_get(base, "/workers")[1]) == []
    sched = IterationScheduler(total_iterations=8, packet_size=2)
    seq, its = sched.acquire("w0")
    sched.complete(seq, its)
    seq, its2 = sched.acquire("w1")
    svc.farm_stats = sched.worker_stats
    rows = json.loads(_get(base, "/workers")[1])
    by = {r["worker"]: r for r in rows}
    assert by["w0"]["iterations"] == 2 and by["w0"]["packets"] == 1
    assert by["w1"]["pending"] == 2
    svc.farm_stats = None


def test_an_encode_under_an_older_gamma_never_replaces_a_newer_frame(
        monkeypatch):
    """The JAX viewer's race, made to happen: the gamma changes while the
    render thread encodes the new iteration's frame at the old gamma. The
    JAX viewer caches that frame (keyed on the iteration) and serves it
    after the change; the port's does not."""
    svc = service()
    assert svc.step()                        # iteration 1, encoded at 2.2
    encode = viewer.encode_png

    def racing(film, gamma):
        png = encode(film, gamma)
        svc.set_gamma(1.0)                   # arrives during the encode
        return png

    monkeypatch.setattr(viewer, "encode_png", racing)
    assert svc.step()                        # iteration 2, encoded at 2.2
    monkeypatch.setattr(viewer, "encode_png", encode)
    png, it = svc.frame_png()
    assert it == 2
    assert png == encode(svc.renderer.film, 1.0)
    assert png != encode(svc.renderer.film, 2.2)


def test_a_frame_is_encoded_from_the_published_film(monkeypatch):
    """A renderer that updates its film in place during an iteration: a
    frame encoded meanwhile is still the last finished iteration's."""
    svc = service()
    assert svc.step()
    film = svc.renderer.film
    done = Film(accum=film.accum.clone(), iterations=film.iterations)
    film.accum.mul_(0.5).add_(7.0)           # mid-update, in place
    svc.set_gamma(1.0)                       # force a new encode
    png, it = svc.frame_png()
    assert it == done.iterations == 1
    assert png == viewer.encode_png(done, 1.0)
    assert not torch.equal(film.accum, done.accum)
