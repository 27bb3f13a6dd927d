"""The plain reference's VCM: bidirectional path tracing with vertex
connection and no merging, written from the estimator the configuration
states (VC on, VM off, ``vcm_max_path_length`` L, one light path a
pixel), with none of the program's code or streams.

A path of n edges has the vertices y_0 .. y_n: y_0 on the area light,
y_n the eye. A strategy takes its first s vertices from a light subpath
and the other t = n + 1 - s, the eye among them, from a camera subpath.
The strategies, those of the upstream project's ``renderer/vcm/vcm.h``:

* s = 0: a camera vertex on an emitter's front (connectLightSourceS0,
  vcm.h:493-522);
* s = 1: next-event estimation, one uniform point of the area light for
  each camera vertex (connectLightSourceS1, vcm.h:406-488);
* s >= 2, t >= 2: vertex connection of every camera vertex with every
  stored vertex of a light subpath drawn for that camera path alone
  (connectVertices, vcm.h:315-400; the loop over the stored vertices,
  vcm.h:603-616);
* t = 1: every stored light vertex joined to the eye and splatted where
  it lands (connectCameraT1, vcm.h:65-161), from light subpaths of the
  reference's own, ``check["light_paths"]`` an iteration.

The caps, the program's:

* light vertices are stored at depths 1 .. L - 1, and a light subpath
  scatters on from depth L - 2 at the most (vcm.h:303-307);
* camera vertices lie at depths 1 .. L, and a camera subpath scatters on
  from depth L - 1 at the most (cameraHit, vcm.h:527-628);
* a connection's total length has no cap: a camera vertex at depth L
  joined to a light vertex at depth L - 1 makes a path of 2L edges;
* each scattering vertex goes on with its BSDF's continuation
  probability, Russian roulette from the first bounce (sampleScattering,
  vcm.h:166-204), max(kd) capped at 1 for a diffuse BSDF
  (VcmBSDF::AddBxDF, BSDF.h); the direction is cosine-distributed;
* an emitter ends a light subpath (DiffuseEmitter.cu:76-79), and a path
  that meets a surface from behind ends there (vcm.h:245-250).

The weights are the balance heuristic in Veach's explicit form (Veach,
1997, section 10.2), not the recursion of the "Implementing VCM" tech
report (Georgiev, 2012) that the program codes. For each path the
forward and reverse pdf of every vertex are taken in area measure from
its geometry alone: the light point's 1/area, the light's cosine
emission, the camera's per-pixel pdf (VCMCameraPass.cu:131-144), each
diffuse vertex's cos/pi in both directions times its continuation
probability. The split s has p_s = prod_{i<s} pf(y_i) prod_{i>=s}
pr(y_i), counted W H times for t = 1 (the light paths an iteration
against one camera path a pixel, OptixRenderer.cpp:675-696), and the
weight of the strategy's own split is its share of the sum over every
split s = 0 .. n, whether or not the caps let this estimator take it, as
the tech report's recursion implies. Left out is only s = t = 1, the
light's own point seen by the eye, which the upstream project never
splats: a camera ray that meets the light directly takes weight 1
(vcm.h:493-522).

Diffuse materials and one area light only, the scope of
``reference/scene.py``; a configuration with merging, uniform vertex
sampling, a technique switched off or a forced continuation probability
is refused.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from .scene import EPS_COSINE, Scene, camera_rays, cosine_direction, \
    intersect, occluded

# what this reference estimates; any other value is refused
SCOPE = {"vcm_use_vc": True, "vcm_use_vm": False,
         "vcm_connect_vertices": True, "vcm_connect_camera_t1": True,
         "vcm_connect_light_s0": True, "vcm_connect_light_s1": True,
         "vcm_force_continuation_prob": None,
         "vcm_uniform_vertex_sampling": False}


@dataclasses.dataclass
class Subpath:
    """The vertices of N subpaths by depth, [N, D] (depth d at index
    d - 1): where each lies, its normal, kd and continuation probability,
    the subpath's throughput arriving there, whether it is a diffuse
    vertex the path goes on from (``valid``) and whether it is an
    emitter's front (``on_light``). A light subpath also keeps its point
    on the light (``origin`` [N, 3])."""
    pos: torch.Tensor
    normal: torch.Tensor
    kd: torch.Tensor
    cont: torch.Tensor
    thr: torch.Tensor
    valid: torch.Tensor
    on_light: torch.Tensor
    origin: torch.Tensor | None = None


def _check_scope(fields: dict) -> None:
    for key, want in SCOPE.items():
        if fields[key] != want:
            raise ValueError(f"the VCM reference needs {key} = {want!r}, "
                             f"not {fields[key]!r}")


def continuation(kd: torch.Tensor) -> torch.Tensor:
    """A diffuse BSDF's continuation probability: its largest kd, at most
    1."""
    return torch.clamp_max(kd.amax(-1), 1.0)


def _rand(gen, dev, *shape):
    return torch.rand(shape, generator=gen, device=dev)


def _light_point(s: Scene, n: int, gen):
    u = _rand(gen, s.device, n, 2)
    return s.light_anchor + u[:, :1] * s.light_u + u[:, 1:] * s.light_v


def light_subpaths(s: Scene, n: int, max_len: int, gen) -> Subpath:
    """``n`` light subpaths: a uniform point of the area light, a
    cosine-distributed direction, the vertices at depths 1 .. L - 1."""
    origin = _light_point(s, n, gen)
    d = cosine_direction(s.light_normal.expand(n, 3),
                         _rand(gen, s.device, n, 2))
    thr = (s.light_radiance * math.pi * s.light_area).expand(n, 3)
    return _trace(s, origin, d, thr, max_len - 1, max_len - 2, gen,
                  origin=origin)


def _trace(s: Scene, o, d, thr, depths: int, last_scatter: int, gen,
           origin=None) -> Subpath:
    """The subpath's vertices at depths 1 .. ``depths``; from depth
    ``last_scatter`` at the most it goes on, by Russian roulette with the
    continuation probability, in a cosine-distributed direction."""
    n, dev = o.shape[0], s.device
    active = torch.ones((n,), dtype=torch.bool, device=dev)
    rows = {k: [] for k in ("pos", "normal", "kd", "cont", "thr", "valid",
                            "on_light")}
    for depth in range(1, depths + 1):
        t, idx, hit = intersect(s, o, d, s.eps, torch.where(
            active, torch.full_like(thr[:, 0], math.inf),
            torch.zeros_like(thr[:, 0])))
        t = torch.where(hit, t, torch.zeros_like(t))
        pos = o + t[:, None] * d
        normal = s.normal[idx]
        mat = s.material[idx]
        cos_in = (normal * -d).sum(1)
        live = active & hit
        is_em = s.emitter[mat]
        valid = live & ~is_em & (cos_in >= EPS_COSINE)
        kd = s.kd[mat]
        cont = continuation(kd)
        for k, v in (("pos", pos), ("normal", normal), ("kd", kd),
                     ("cont", cont), ("thr", thr), ("valid", valid),
                     ("on_light", live & is_em & (cos_in > 0))):
            rows[k].append(v)
        if depth > last_scatter:
            break
        survive = _rand(gen, dev, n) < cont
        d = cosine_direction(normal, _rand(gen, dev, n, 2))
        active = valid & survive & ((normal * d).sum(1) >= EPS_COSINE)
        thr = torch.where(active[:, None], thr * kd / torch.clamp_min(
            cont, 1e-20)[:, None], thr)
        o = pos
    return Subpath(origin=origin,
                   **{k: torch.stack(v, 1) for k, v in rows.items()})


# ---------------------------------------------------------------------------
# the explicit weights
# ---------------------------------------------------------------------------

def camera_pdf_w(s: Scene, direction, width: int, height: int):
    """The camera's pdf of directions from the eye [..., 3], per solid
    angle, for a ray drawn uniformly over one pixel; 0 behind the eye."""
    look_len = torch.linalg.vector_norm(s.look)
    cos = (direction * s.look).sum(-1) / look_len
    pixel_area = (2.0 * torch.linalg.vector_norm(s.cam_u) / width) \
        * (2.0 * torch.linalg.vector_norm(s.cam_v) / height)
    safe = torch.clamp_min(cos, 1e-20)
    return torch.where(cos > 0, (look_len / safe) ** 2 / safe / pixel_area,
                       torch.zeros_like(cos))


def vertex_pdfs(s: Scene, pos, normal, cont, n, width: int, height: int):
    """The forward (from the light) and reverse (from the eye) pdf, in
    area measure, of each vertex y_0 .. y_{n-1} of paths whose y_0 lies on
    the area light: ``pos`` [B, N + 1, 3] holds y_0 .. y_{n-1} and then the
    eye, ``normal`` and ``cont`` [B, N + 1] the vertices' normals and
    continuation probabilities, ``n`` [B] each path's n <= N. Returns
    (pf, pr), each [B, N], 1 past a path's last vertex."""
    N = pos.shape[1] - 1
    edge = pos[:, 1:] - pos[:, :-1]                    # y_i -> y_{i+1}
    d2 = (edge * edge).sum(-1)
    w = edge / torch.sqrt(torch.clamp_min(d2, 1e-30))[..., None]
    # the cosine at y_i toward y_{i+1}, and at y_{i+1} toward y_i
    cos_out = torch.clamp_min((normal[:, :N] * w).sum(-1), 0.0)
    cos_back = torch.clamp_min((normal[:, 1:N] * -w[:, :-1]).sum(-1), 0.0)
    g = cos_back / d2[:, :-1]
    lead = torch.full_like(d2[:, :1], 1.0 / s.light_area)
    pf = torch.cat([lead, cos_out[:, :1] / math.pi * g[:, :1],
                    cos_out[:, 1:-1] / math.pi * cont[:, 1:N - 1]
                    * g[:, 1:]], 1)
    pr = torch.cat([cos_back / math.pi * cont[:, 1:N] * cos_out[:, :-1]
                    / d2[:, :-1], torch.ones_like(d2[:, :1])], 1)
    # the vertex before the eye: the camera's per-pixel pdf
    pr_eye = camera_pdf_w(s, -w, width, height) * cos_out / d2
    i = torch.arange(N, device=pos.device)[None]
    pr = torch.where(i == n[:, None] - 1, pr_eye, pr)
    inside = i < n[:, None]
    one = torch.ones_like(pf)
    return torch.where(inside, pf, one), torch.where(inside, pr, one)


def split_log_pdfs(pf, pr, n, n_light_paths: int):
    """log(n_s p_s) of every split s = 0 .. N of paths [B, N] of ``n`` [B]
    vertices, -inf for s > n and for s = 1 where n = 1 (the light's own
    point seen by the eye is not a strategy)."""
    zero = torch.zeros_like(pf[:, :1])
    head = torch.cat([zero, torch.cumsum(torch.log(pf), 1)], 1)
    tail = torch.cat([torch.flip(torch.cumsum(torch.flip(torch.log(pr),
                                                         [1]), 1), [1]),
                      zero], 1)
    split = torch.arange(pf.shape[1] + 1, device=pf.device)[None]
    n = n[:, None]
    logp = head + tail + torch.where(split == n, math.log(n_light_paths),
                                     0.0)
    gone = (split > n) | ((n == 1) & (split == 1))
    return torch.where(gone, -math.inf, logp)


def mis_weight(s: Scene, pos, normal, cont, n, split, width: int,
               height: int, n_light_paths: int):
    """The balance heuristic's weight [B] of the split ``split`` [B] of
    paths (``vertex_pdfs``' arguments): n_split p_split over the sum of
    every split's n_s p_s."""
    logp = split_log_pdfs(
        *vertex_pdfs(s, pos, normal, cont, n, width, height), n,
        n_light_paths)
    own = torch.gather(logp, 1, split[:, None])[:, 0]
    return torch.exp(own - torch.logsumexp(logp, 1))


# ---------------------------------------------------------------------------
# the strategies
# ---------------------------------------------------------------------------

def _light_prefix(s: Scene, light: Subpath):
    """Each light subpath's possible first vertices y_0 .. y_{L-1} [N, L]:
    its point on the light, then its depths 1 .. L - 1."""
    n = light.origin.shape[0]
    return (torch.cat([light.origin[:, None], light.pos], 1),
            torch.cat([s.light_normal.expand(n, 1, 3), light.normal], 1),
            torch.cat([torch.ones_like(light.cont[:, :1]), light.cont], 1))


def join(s: Scene, prefix, n_prefix, cam: Subpath | None, lanes,
         cam_depth):
    """Paths [B, N + 1] as ``vertex_pdfs`` takes them: the first
    ``n_prefix`` [B] vertices of ``prefix`` (pos, normal, cont [B, P]),
    then the camera vertices z_d .. z_1 (d = ``cam_depth`` [B]) of the
    camera subpaths ``lanes`` [B], then the eye, repeated to the end (N =
    P + the camera's depths). Returns (pos, normal, cont, n)."""
    pre_pos, pre_nrm, pre_cont = prefix
    B, P = pre_cont.shape
    D = 0 if cam is None else cam.valid.shape[1]
    dev = pre_cont.device
    i = torch.arange(P + D + 1, device=dev)[None].expand(B, -1)
    k = n_prefix[:, None]
    n = n_prefix + cam_depth
    rows = torch.arange(B, device=dev)[:, None]
    pi = torch.clamp_max(i, P - 1)
    pos, nrm, cont = pre_pos[rows, pi], pre_nrm[rows, pi], pre_cont[rows, pi]
    if cam is not None:
        ci = torch.clamp(cam_depth[:, None] - 1 - (i - k), 0, D - 1)
        li = lanes[:, None].expand_as(ci)
        on_cam = (i >= k)[..., None]
        pos = torch.where(on_cam, cam.pos[li, ci], pos)
        nrm = torch.where(on_cam, cam.normal[li, ci], nrm)
        cont = torch.where(on_cam[..., 0], cam.cont[li, ci], cont)
    pos = torch.where((i >= n[:, None])[..., None], s.eye, pos)
    return pos, nrm, cont, n


def _visible(s: Scene, a, b):
    """Whether nothing lies between points a and b [N, 3], and the unit
    direction and distance from a to b."""
    to = b - a
    dist = torch.linalg.vector_norm(to, dim=1)
    w = to / torch.clamp_min(dist, 1e-20)[:, None]
    occ = occluded(s, a, w, s.eps, torch.clamp_min(dist - 2 * s.eps, s.eps))
    return ~occ, w, dist


def _one(s: Scene, pos):
    """One-vertex prefixes [B, 1] on the light at ``pos`` [B, 3]."""
    return (pos[:, None], s.light_normal.expand(pos.shape[0], 1, 3),
            torch.ones_like(pos[:, :1]))


def camera_values(s: Scene, px, py, fields: dict, gen):
    """Radiance [Q, 3] of one camera subpath for each pixel (px, py),
    every camera-side strategy weighted: s = 0, s = 1 and the vertex
    connections with a light subpath of its own."""
    W, H = fields["width"], fields["height"]
    L = fields["vcm_max_path_length"]
    n_lp = W * H
    q, dev = px.shape[0], px.device
    o, d = camera_rays(s, px, py, _rand(gen, dev, q, 2), W, H)
    cam = _trace(s, o, d, torch.ones((q, 3), device=dev), L, L - 1, gen)
    light = light_subpaths(s, q, L, gen)
    out = torch.zeros((q, 3), device=dev)

    def weight(prefix, n_prefix, lanes, depth, split):
        pos, nrm, cont, n = join(s, prefix, n_prefix, cam, lanes, depth)
        return mis_weight(s, pos, nrm, cont, n, split, W, H, n_lp)

    # s = 0: the camera subpath meets the light's front after its
    # vertices z_1 .. z_d (d = ``depth``, the hit's index)
    lanes, depth = torch.nonzero(cam.on_light, as_tuple=True)
    if lanes.numel():
        ones = torch.ones_like(lanes)
        w = weight(_one(s, cam.pos[lanes, depth]), ones, lanes, depth,
                   0 * ones)
        out.index_add_(0, lanes, w[:, None] * cam.thr[lanes, depth]
                       * s.light_radiance)
    lanes, depth = torch.nonzero(cam.valid, as_tuple=True)
    z_pos, z_nrm = cam.pos[lanes, depth], cam.normal[lanes, depth]
    z_kd, z_thr = cam.kd[lanes, depth], cam.thr[lanes, depth]
    # s = 1: one uniform point of the area light at each camera vertex
    y = _light_point(s, lanes.shape[0], gen)
    vis, w_dir, dist = _visible(s, z_pos, y)
    cos_z = (z_nrm * w_dir).sum(1)
    cos_l = -(w_dir * s.light_normal).sum(1)
    ok = vis & (cos_z >= EPS_COSINE) & (cos_l >= EPS_COSINE)
    ones = torch.ones_like(lanes)
    w = weight(_one(s, y), ones, lanes, depth + 1, ones)
    value = (z_thr * z_kd / math.pi * s.light_radiance
             * (cos_z * cos_l * s.light_area / dist ** 2)[:, None])
    out.index_add_(0, lanes, torch.where(ok[:, None], w[:, None] * value,
                                         torch.zeros_like(value)))
    # vertex connections: each camera vertex with each stored light
    # vertex of its lane's light subpath, a camera depth at a time
    prefix = _light_prefix(s, light)
    for b in range(L):
        lanes, a = torch.nonzero(cam.valid[:, b:b + 1] & light.valid,
                                 as_tuple=True)
        if not lanes.numel():
            continue
        z_pos, z_nrm = cam.pos[lanes, b], cam.normal[lanes, b]
        x_pos, x_nrm = light.pos[lanes, a], light.normal[lanes, a]
        vis, w_dir, dist = _visible(s, z_pos, x_pos)
        cos_z = (z_nrm * w_dir).sum(1)
        cos_x = -(x_nrm * w_dir).sum(1)
        ok = vis & (cos_z >= EPS_COSINE) & (cos_x >= EPS_COSINE)
        w = weight(tuple(x[lanes] for x in prefix), a + 2, lanes,
                   torch.full_like(a, b + 1), a + 2)
        value = (light.thr[lanes, a] * light.kd[lanes, a] / math.pi
                 * cam.kd[lanes, b] / math.pi * cam.thr[lanes, b]
                 * (cos_z * cos_x / dist ** 2)[:, None])
        out.index_add_(0, lanes, torch.where(
            ok[:, None], w[:, None] * value, torch.zeros_like(value)))
    return out


def splat_tiles(s: Scene, fields: dict, tile: int, n_paths: int, gen):
    """t = 1: the mean over ``n_paths`` light subpaths of what each splats
    into each tile of ``tile`` pixels square [T], over the tile's pixels
    (tiles row-major from the image's bottom row)."""
    W, H = fields["width"], fields["height"]
    L = fields["vcm_max_path_length"]
    tx = W // tile
    out = torch.zeros((tx * (H // tile),), device=s.device)
    light = light_subpaths(s, n_paths, L, gen)
    lanes, a = torch.nonzero(light.valid, as_tuple=True)
    if not lanes.numel():
        return out
    x, nrm = light.pos[lanes, a], light.normal[lanes, a]
    vis, w_dir, dist = _visible(s, x, s.eye.expand_as(x))
    cos_x = (nrm * w_dir).sum(1)
    look_len = torch.linalg.vector_norm(s.look)
    cos_cam = -(w_dir * s.look).sum(1) / look_len
    # where the ray from the eye crosses the image plane
    rel = -w_dir * (look_len / torch.clamp_min(cos_cam, 1e-6))[:, None] \
        - s.look
    fx = ((rel * s.cam_u).sum(1) / (s.cam_u * s.cam_u).sum() + 1) * 0.5 * W
    fy = ((rel * s.cam_v).sum(1) / (s.cam_v * s.cam_v).sum() + 1) * 0.5 * H
    ok = (vis & (cos_x >= EPS_COSINE) & (cos_cam > 1e-6) & (fx >= 0)
          & (fx < W) & (fy >= 0) & (fy < H))
    pos, normal, cont, n = join(s, tuple(v[lanes] for v in _light_prefix(
        s, light)), a + 2, None, lanes, torch.zeros_like(a))
    w = mis_weight(s, pos, normal, cont, n, n, W, H, W * H)
    cam_pdf_a = camera_pdf_w(s, -w_dir, W, H) * cos_x / dist ** 2
    value = (light.thr[lanes, a] * light.kd[lanes, a] / math.pi).sum(1) \
        * cam_pdf_a * w
    t_idx = (torch.clamp(fy, 0, H - 1).long() // tile * tx
             + torch.clamp(fx, 0, W - 1).long() // tile)
    out.index_add_(0, t_idx, torch.where(ok, value, torch.zeros_like(value)))
    return out / (n_paths * tile * tile)


def iteration_tiles(s: Scene, fields: dict, check: dict, iteration: int,
                    gen):
    """One iteration's value for each tile of ``check["tile"]`` pixels
    square (row-major from the image's bottom row): the mean over
    ``check["queries"]`` pixels drawn uniformly in it of the camera-side
    strategies' radiance, plus what ``check["light_paths"]`` light
    subpaths splat into it over its pixels, each summed over its channels
    [T]; and no ray counts."""
    _check_scope(fields)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    W, H, tile = fields["width"], fields["height"], check["tile"]
    tx, ty = W // tile, H // tile
    q = check["queries"]
    dev = s.device
    T = tx * ty
    cols = torch.arange(T, device=dev) % tx
    rows = torch.arange(T, device=dev) // tx
    px = (cols[:, None] * tile + torch.randint(
        tile, (T, q), generator=gen, device=dev)).reshape(-1)
    py = (rows[:, None] * tile + torch.randint(
        tile, (T, q), generator=gen, device=dev)).reshape(-1)
    with torch.no_grad():
        cam = camera_values(s, px, py, fields, gen)
        splat = splat_tiles(s, fields, tile, int(check["light_paths"]), gen)
    return cam.sum(1).reshape(T, q).mean(1) + splat, None
