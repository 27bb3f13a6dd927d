"""Live progressive viewer: the Gui layer's behaviours over HTTP.

The counterpart of ``oppositerenderer_tpu/viewer.py``. The reference's
interactive surface is a Qt GUI: ``RenderWidget`` displays the
accumulation buffer through a gamma shader (Gui/gui/RenderWidget.cpp:
75-200), ``MainWindowBase`` switches the render method, opens scenes and
pauses (Gui/gui/MainWindowBase.cpp:143-161), docks expose the output size,
gamma, PPM radius, camera and live statistics (Gui/gui/docks/*,
Gui/models/RenderStatisticsModel.hxx:73-105), every change bumps the
sequence number to restart accumulation (Gui/Application.cpp:119-127),
and mouse drags orbit, pan and dolly the camera (util/Mouse.cpp:316-460).

Here a render thread drives ``Renderer.render_next_iteration`` while a
stdlib HTTP server (the display transform is ``Film.to_display``, the
reference shader's pow(c / iterations, 1 / gamma)) serves:

* ``/``            one page: the live image, stats, settings, camera pad
* ``/frame.png``   the current film as a PNG (``X-Iteration`` header)
* ``/stats``       RenderStatisticsModel-style JSON
* ``/set``         method, gamma, radius, scene or size; all but gamma
                   restart accumulation
* ``/camera``      orbit / pan / dolly / fov, which restart
* ``/control``     pause / resume / restart
* ``/workers``     the render farm's per-worker table, if one is attached

Settings arrive on HTTP threads, but one thread drives the Renderer:
handlers queue a closure that the render loop applies between iterations
(the reference queues Qt signals into its render thread,
StandaloneApplication.cpp:22-27).

Two departures from the JAX package's viewer, which can serve a frame
encoded under the previous gamma after a gamma change (its cache is
keyed on the iteration alone, and an encode that read the old gamma can
store its frame after the change):

* After every iteration and every restart the render thread publishes a
  copy of the film under the service's lock, and a frame is encoded from
  that copy: it never mixes two iterations, even if a renderer updated
  its film in place.
* The cached frame is keyed on (the published film, the gamma), read and
  written under the lock; an encode stores its frame only if neither
  changed while it ran, so a frame of an older gamma or film never
  replaces a newer one.
"""
from __future__ import annotations

import io
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from .camera import Camera
from .config import RenderConfig, RenderMethod
from .film import Film
from .renderer import Renderer

_METHODS = {"pt": RenderMethod.PATH_TRACING,
            "ppm": RenderMethod.PROGRESSIVE_PHOTON_MAPPING,
            "vcm": RenderMethod.VCM_BIDIRECTIONAL_PATH_TRACING}
_METHOD_NAMES = {v: k for k, v in _METHODS.items()}
# seconds the render thread waits before looking again while paused, or
# once max_iterations are rendered
_IDLE_SECONDS = 0.05


def encode_png(film: Film, gamma: float) -> bytes:
    """The film's display image (``Film.to_display``) as PNG bytes."""
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(film.to_display(gamma).cpu().numpy()).save(buf, "PNG")
    return buf.getvalue()


class RenderService:
    """StandaloneRenderManager analog: one render thread, queued changes."""

    def __init__(self, scene, camera: Camera, cfg: RenderConfig,
                 seed: int = 0, preview_every: int = 1,
                 max_iterations: int | None = None,
                 ppm_initial_radius: float | None = None,
                 farm_stats=None):
        """``farm_stats``: optional zero-argument callable returning a list
        of per-worker stat dicts (the ConnectedServersTableModel analog,
        Client/gui_models/ConnectedServersTableModel.cpp), e.g.
        ``IterationScheduler.worker_stats``; served at ``/workers``."""
        self.renderer = Renderer(scene, camera, cfg, seed=seed,
                                 ppm_initial_radius=ppm_initial_radius)
        self.farm_stats = farm_stats
        self.preview_every = max(1, preview_every)
        self.max_iterations = max_iterations
        self.running_status = "RUNNING"   # RUNNING / PAUSE / STOPPED
        self.sequence_number = 0
        self.gamma = cfg.gamma
        self._pending: list = []          # queued closures from HTTP threads
        self._lock = threading.Lock()
        self._film: Film | None = None    # the published copy of the film
        self._film_version = 0            # advances with every publish
        self._frame: tuple | None = None  # ((version, gamma), png, iteration)
        self._metrics: dict = {}
        self._last_error: str | None = None
        self._render_seconds = 0.0
        self._idle_turns = 0              # turns that rendered nothing
        self._thread: threading.Thread | None = None
        self._publish()

    # ------------------------------------------------------------ control
    def start(self) -> None:
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def stop(self, join: bool = True) -> None:
        with self._lock:
            self.running_status = "STOPPED"
        if join and self._thread is not None:
            self._thread.join(timeout=60)

    def enqueue(self, fn) -> None:
        """Queue a change to run on the render thread between iterations."""
        with self._lock:
            self._pending.append(fn)

    # ----------------------------------------------- change ops (queued)
    def set_method(self, name: str) -> None:
        method = _METHODS[name]

        def apply(r: Renderer):
            r.restart(cfg=r.cfg.replace(render_method=method))
        self._bump_and_enqueue(apply)

    def set_gamma(self, gamma: float) -> None:
        """Display only (the RenderWidget shader's uniform): no restart;
        the cached frame's key no longer matches."""
        with self._lock:
            self.gamma = float(gamma)

    def set_ppm_radius(self, radius: float) -> None:
        def apply(r: Renderer):
            r.ppm_initial_radius = float(radius)
            r.restart()
        self._bump_and_enqueue(apply)

    def set_size(self, width: int, height: int) -> None:
        def apply(r: Renderer):
            r.restart(cfg=r.cfg.replace(width=int(width), height=int(height)))
        self._bump_and_enqueue(apply)

    # op name -> argument count, checked before queueing so that a bad
    # request is an HTTP error and never reaches the render thread
    _CAMERA_OPS = {"orbit": 2, "pan": 2, "dolly": 1, "fov": 1}

    def camera_op(self, op: str, *args: float) -> None:
        arity = self._CAMERA_OPS.get(op)
        if arity is None:
            raise ValueError(f"unknown camera op {op!r}")
        if len(args) < arity:
            raise ValueError(f"camera op {op!r} needs {arity} args, "
                             f"got {len(args)}")

        def apply(r: Renderer):
            cam = r.camera
            if op == "orbit":
                cam = cam.orbit(args[0], args[1])
            elif op == "pan":
                cam = cam.translate(args[0], args[1])
            elif op == "dolly":
                cam = cam.dolly(args[0])
            else:
                cam = cam.scale_fov(args[0])
            r.restart(camera=cam)
        self._bump_and_enqueue(apply)

    def set_scene(self, name: str) -> None:
        """Scene switch by factory name or file path (the MainWindowBase
        scene menu and file-open analog, MainWindowBase.cpp:143-161). The
        load runs on the render thread, on the renderer's device."""
        from .scene import get_scene_by_name

        def apply(r: Renderer):
            scene, cam = get_scene_by_name(name, r.device)
            r.restart(camera=cam, scene=scene)
        self._bump_and_enqueue(apply)

    def restart(self) -> None:
        self._bump_and_enqueue(lambda r: r.restart())

    def pause(self) -> None:
        with self._lock:
            if self.running_status == "RUNNING":
                self.running_status = "PAUSE"

    def resume(self) -> None:
        with self._lock:
            if self.running_status == "PAUSE":
                self.running_status = "RUNNING"

    def _bump_and_enqueue(self, fn) -> None:
        with self._lock:
            self.sequence_number += 1   # incrementSequenceNumber analog
            self._pending.append(fn)

    # -------------------------------------------------------- render loop
    def _loop(self) -> None:
        while self.step():
            pass

    def step(self) -> bool:
        """One turn of the render thread: apply the queued changes, then
        render one iteration unless paused or at ``max_iterations``.
        Returns False once the service is stopped."""
        with self._lock:
            status = self.running_status
            pending, self._pending = self._pending, []
        for fn in pending:
            try:
                fn(self.renderer)
            except Exception as e:   # keep the render thread alive
                with self._lock:
                    self._last_error = f"{type(e).__name__}: {e}"
        if pending:
            self._publish()
        if status == "STOPPED":
            return False
        idle = status == "PAUSE" or (
            self.max_iterations is not None
            and self.renderer.iteration >= self.max_iterations)
        if idle and not pending:
            with self._lock:
                self._idle_turns += 1
            time.sleep(_IDLE_SECONDS)
            return True
        t0 = time.perf_counter()
        metrics = self.renderer.render_next_iteration()
        with self._lock:
            self._render_seconds += time.perf_counter() - t0
            self._metrics = metrics
        self._publish()
        if self.renderer.iteration % self.preview_every == 0:
            self._encode_frame()
        return True

    def _publish(self) -> None:
        """Copy the renderer's film for the encoders (render thread only,
        between iterations)."""
        film = self.renderer.film
        copy = Film(accum=film.accum.clone(), iterations=film.iterations)
        with self._lock:
            self._film = copy
            self._film_version += 1

    def _encode_frame(self) -> tuple[bytes, int]:
        """Encode the published film at the current gamma; cache the frame
        unless the film or the gamma changed meanwhile."""
        with self._lock:
            film, gamma = self._film, self.gamma
            key = (self._film_version, gamma)
        png = encode_png(film, gamma)
        with self._lock:
            if key == (self._film_version, self.gamma):
                self._frame = (key, png, film.iterations)
        return png, film.iterations

    # ----------------------------------------------------------- queries
    def frame_png(self) -> tuple[bytes, int]:
        """(PNG, its iteration) of the published film at the current
        gamma."""
        with self._lock:
            frame = self._frame
            current = frame is not None and frame[0] == (self._film_version,
                                                         self.gamma)
        if current:
            return frame[1], frame[2]
        return self._encode_frame()

    def stats(self) -> dict:
        """RenderStatisticsModel analog (RenderStatisticsModel.hxx:73-105)."""
        r = self.renderer
        with self._lock:
            m = dict(self._metrics)
            seq = self.sequence_number
            status = self.running_status
            render_s = self._render_seconds
            idle_turns = self._idle_turns
            last_error = self._last_error
        cfg = r.cfg
        out = {
            "running_status": status,
            "sequence_number": seq,
            "render_method": _METHOD_NAMES[cfg.render_method],
            "iterations": int(r.iteration),
            "resolution": f"{cfg.width}x{cfg.height}",
            "render_seconds": round(render_s, 3),
            "idle_turns": idle_turns,
            "scene": r.scene.name,
            "ppm_initial_radius": r.ppm_initial_radius,
            "device": str(r.device),
        }
        for k in ("iteration_seconds", "ppm_radius", "photons_stored",
                  "light_vertices_stored"):
            if k in m:
                out[k] = float(m[k])
        if last_error is not None:
            out["last_error"] = last_error
        if cfg.render_method != RenderMethod.PATH_TRACING:
            out["photons_per_iteration"] = cfg.photons_per_iteration
            out["photons_emitted"] = (cfg.photons_per_iteration
                                      * int(r.iteration))
        return out


_PAGE = """<!doctype html><html><head><title>opposite-tpu</title><style>
body{font-family:sans-serif;background:#1c1c1e;color:#ddd;margin:1em}
img{image-rendering:pixelated;border:1px solid #444;max-width:70vmin}
table{border-collapse:collapse;font-size:13px}td{padding:1px 8px}
button,select,input{margin:2px;background:#333;color:#ddd;border:1px solid #555}
.row{display:flex;gap:2em;align-items:flex-start}
</style></head><body><div class=row><div>
<img id=frame src=/frame.png>
<div>
<button onclick="cam('orbit',-0.2,0)">&#8634;</button>
<button onclick="cam('orbit',0.2,0)">&#8635;</button>
<button onclick="cam('orbit',0,0.15)">&#8593;</button>
<button onclick="cam('orbit',0,-0.15)">&#8595;</button>
<button onclick="cam('dolly',0.15)">dolly+</button>
<button onclick="cam('dolly',-0.15)">dolly-</button>
<button onclick="cam('pan',-0.1,0)">&larr;</button>
<button onclick="cam('pan',0.1,0)">&rarr;</button>
<button onclick="cam('fov',1.1)">fov+</button>
<button onclick="cam('fov',0.9)">fov-</button>
</div></div><div>
<h3>opposite-tpu live render (PyTorch)</h3>
<div>
<select id=method onchange="setq('method',this.value)">
<option>pt</option><option>ppm</option><option>vcm</option></select>
<button onclick="ctl('pause')">pause</button>
<button onclick="ctl('resume')">resume</button>
<button onclick="ctl('restart')">restart</button>
gamma <input id=gamma size=4 value=2.2
 onchange="setq('gamma',this.value)">
r0 <input id=radius size=6 onchange="setq('ppm_radius',this.value)">
</div>
<div>scene <input id=scene size=24
 onchange="setq('scene',this.value)"
 placeholder="Cornell / CornellSmall:... / path.dae"></div>
<table id=stats></table>
<h4 id=wtitle style="display:none">workers</h4>
<table id=workers></table>
</div></div><script>
async function tick(){
 const s=await (await fetch('/stats')).json();
 document.getElementById('stats').innerHTML=Object.entries(s)
  .map(([k,v])=>`<tr><td>${k}</td><td>${v}</td></tr>`).join('');
 document.getElementById('frame').src='/frame.png?i='+s.iterations
  +'&seq='+s.sequence_number;
 const w=await (await fetch('/workers')).json();
 if(w.length){
  document.getElementById('wtitle').style.display='';
  const cols=Object.keys(w[0]);
  document.getElementById('workers').innerHTML=
   '<tr>'+cols.map(c=>`<td><b>${c}</b></td>`).join('')+'</tr>'
   +w.map(r=>'<tr>'+cols.map(c=>`<td>${r[c]}</td>`).join('')+'</tr>')
   .join('');
 }
}
function setq(k,v){fetch('/set?'+k+'='+encodeURIComponent(v));}
function cam(op,...a){fetch('/camera?op='+op+a.map(x=>'&arg='+x).join(''));}
function ctl(c){fetch('/control?cmd='+c);}
setInterval(tick,1000);tick();
</script></body></html>"""


class _Handler(BaseHTTPRequestHandler):
    service: RenderService = None  # set by make_server

    def log_message(self, *a):   # quiet
        pass

    def _send(self, code: int, body: bytes, ctype: str,
              headers: dict | None = None) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):  # noqa: N802
        try:
            self._route()
        except BrokenPipeError:
            pass
        except Exception as e:  # surface handler errors to the client
            self._send(500, f"{type(e).__name__}: {e}".encode(),
                       "text/plain")

    def _route(self):
        svc = self.service
        url = urlparse(self.path)
        q = {k: v[0] for k, v in parse_qs(url.query).items()}
        if url.path == "/":
            self._send(200, _PAGE.encode(), "text/html")
        elif url.path == "/frame.png":
            png, it = svc.frame_png()
            self._send(200, png, "image/png", {"X-Iteration": str(it)})
        elif url.path == "/stats":
            self._send(200, json.dumps(svc.stats()).encode(),
                       "application/json")
        elif url.path == "/set":
            if "method" in q:
                svc.set_method(q["method"])
            if "gamma" in q:
                svc.set_gamma(float(q["gamma"]))
            if "ppm_radius" in q:
                svc.set_ppm_radius(float(q["ppm_radius"]))
            if "scene" in q:
                svc.set_scene(q["scene"])
            if "width" in q or "height" in q:
                svc.set_size(int(q.get("width", q.get("height"))),
                             int(q.get("height", q.get("width"))))
            self._send(200, b"ok", "text/plain")
        elif url.path == "/workers":
            rows = svc.farm_stats() if svc.farm_stats is not None else []
            self._send(200, json.dumps(rows).encode(), "application/json")
        elif url.path == "/camera":
            args = [float(v) for v in
                    parse_qs(url.query).get("arg", [])]
            svc.camera_op(q.get("op", ""), *args)
            self._send(200, b"ok", "text/plain")
        elif url.path == "/control":
            cmd = q.get("cmd", "")
            if cmd == "pause":
                svc.pause()
            elif cmd == "resume":
                svc.resume()
            elif cmd == "restart":
                svc.restart()
            else:
                return self._send(400, b"unknown cmd", "text/plain")
            self._send(200, b"ok", "text/plain")
        else:
            self._send(404, b"not found", "text/plain")


def make_server(service: RenderService, port: int = 0,
                host: str = "127.0.0.1") -> ThreadingHTTPServer:
    """HTTP server bound to (host, port); port 0 picks a free one
    (``server.server_address[1]`` is the bound port)."""
    handler = type("Handler", (_Handler,), {"service": service})
    return ThreadingHTTPServer((host, port), handler)


def serve(scene, camera: Camera, cfg: RenderConfig, port: int = 8000,
          host: str = "127.0.0.1", seed: int = 0,
          preview_every: int = 1,
          ppm_initial_radius: float | None = None) -> None:
    """Blocking entry: render and serve until Ctrl-C."""
    svc = RenderService(scene, camera, cfg, seed=seed,
                        preview_every=preview_every,
                        ppm_initial_radius=ppm_initial_radius)
    server = make_server(svc, port, host)
    svc.start()
    print(f"viewing at http://{host}:{server.server_address[1]}/")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        svc.stop()
        server.server_close()
