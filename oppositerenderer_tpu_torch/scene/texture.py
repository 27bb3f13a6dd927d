"""Texture atlas, sampling and normal mapping.

The counterpart of ``oppositerenderer_tpu/scene/texture.py`` (reference
``material/Texture.{h,cu}``). Textures live in one dense ``[n_tex, R, R, 3]``
float32 atlas: every image is resized to the atlas resolution when the
scene is built. Sampling is bilinear with repeat wrapping
(Texture.cu:83-116), and normal maps perturb the shading normal in the
per-triangle tangent frame.

The JAX package resizes with PIL's ``Image.resize(..., BILINEAR)`` on the
8-bit image. The port's atlas does not depend on PIL (only
:func:`load_image`, which reads scene files' textures, does):
:func:`_resize_bilinear_u8`
is that resize written out in numpy, PIL's two separable passes with its
22-bit fixed-point weights and its 8-bit intermediate, so the atlases are
equal to the JAX package's.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.math import Tensor, normalize
from ..devices import resolve_device

_PRECISION_BITS = 32 - 8 - 2   # PIL Resample.c, 8 bits per channel


def _pil_coeffs(in_size: int, out_size: int):
    """PIL's ``precompute_coeffs`` for the bilinear filter over the whole
    input, then ``normalize_coeffs_8bpc``: (xmin [out], weights [out, k]
    int64 fixed point, with 0 beyond each output's window)."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    ksize = int(np.ceil(support)) * 2 + 1
    xmins = np.zeros(out_size, np.int64)
    kk = np.zeros((out_size, ksize), np.float64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        ss = 1.0 / filterscale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        x = np.arange(xmax)
        w = np.maximum(1.0 - np.abs((x + xmin - center + 0.5) * ss), 0.0)
        ww = w.sum()
        if ww != 0.0:
            w = w / ww
        kk[xx, :xmax] = w
        xmins[xx] = xmin
    fixed = np.where(kk < 0, np.trunc(-0.5 + kk * (1 << _PRECISION_BITS)),
                     np.trunc(0.5 + kk * (1 << _PRECISION_BITS)))
    return xmins, fixed.astype(np.int64)


def _resample_axis(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One PIL pass (``ImagingResampleHorizontal_8bpc`` on axis 1,
    ``..Vertical_8bpc`` on axis 0) of a uint8 image."""
    xmins, k = _pil_coeffs(img.shape[axis], out_size)
    src = np.moveaxis(img, axis, 0).astype(np.int64)     # [in, other, 3]
    n_in = src.shape[0]
    acc = np.full((out_size,) + src.shape[1:], 1 << (_PRECISION_BITS - 1),
                  np.int64)
    for j in range(k.shape[1]):
        idx = np.minimum(xmins + j, n_in - 1)   # weight 0 past the window
        acc += src[idx] * k[:, j].reshape(-1, 1, 1)
    out = np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def _resize_bilinear_u8(img: np.ndarray, size: int) -> np.ndarray:
    """PIL ``Image.resize((size, size), Image.BILINEAR)`` of an RGB uint8
    image [H, W, 3]: the horizontal pass, then the vertical one, each only
    where the size changes."""
    if img.shape[1] != size:
        img = _resample_axis(img, size, axis=1)
    if img.shape[0] != size:
        img = _resample_axis(img, size, axis=0)
    return img


def load_image(path) -> np.ndarray:
    """RGB float32 image [H, W, 3] in [0, 1], read with PIL (PNG, JPG, TGA;
    the reference vendors libtga for TGA). Scene import is the one caller,
    so PIL is imported only here."""
    from PIL import Image
    img = Image.open(str(path)).convert("RGB")
    return np.asarray(img, np.float32) / 255.0


def build_atlas(images: list[np.ndarray], resolution: int = 256,
                device: torch.device | str | None = None) -> Tensor:
    """Stack images ([H, W, 3] in [0, 1]) into [n, R, R, 3] float32, through
    the JAX package's 8-bit round trip and resize, on ``device`` (None: the
    CUDA card)."""
    device = resolve_device(device)
    if not images:
        return torch.zeros((0, 1, 1, 3), dtype=torch.float32, device=device)
    out = []
    for img in images:
        u8 = (np.clip(img, 0, 1) * 255).astype(np.uint8)
        out.append(np.asarray(_resize_bilinear_u8(u8, resolution),
                              np.float32) / 255.0)
    return torch.as_tensor(np.stack(out), device=device)


def sample_bilinear(atlas: Tensor, tex_id: Tensor, uv: Tensor) -> Tensor:
    """Bilinear lookup with repeat wrap. atlas [n,H,W,3]; tex_id [...] int
    (the caller masks invalid ids); uv [...,2] with v up (texture row 0 at
    v=1, the image convention). ``uv % 1`` is the floor modulo."""
    n, h, w, _ = atlas.shape
    u = torch.remainder(uv[..., 0], 1.0)
    v = 1.0 - torch.remainder(uv[..., 1], 1.0)
    x = u * (w - 1)
    y = v * (h - 1)
    x0 = torch.floor(x).long()
    y0 = torch.floor(y).long()
    x1 = torch.clamp_max(x0 + 1, w - 1)
    y1 = torch.clamp_max(y0 + 1, h - 1)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    tid = torch.clamp(tex_id.long(), 0, max(n - 1, 0))
    c00 = atlas[tid, y0, x0]
    c01 = atlas[tid, y0, x1]
    c10 = atlas[tid, y1, x0]
    c11 = atlas[tid, y1, x1]
    top = c00 * (1 - fx) + c01 * fx
    bot = c10 * (1 - fx) + c11 * fx
    return top * (1 - fy) + bot * fy


def apply_normal_map(ns: Tensor, tangent: Tensor, bitangent: Tensor,
                     rgb: Tensor) -> Tensor:
    """Tangent-space normal perturbation (Texture.cu normal mapping)."""
    tn = rgb * 2.0 - 1.0
    return normalize(tn[..., 0:1] * tangent + tn[..., 1:2] * bitangent
                     + tn[..., 2:3] * ns)


def compute_triangle_tangents(v0, v1, v2, uv0, uv1, uv2):
    """Per-triangle tangent/bitangent from the UV parameterisation
    (Scene.cpp:438-470 per-vertex tangent generation, flat per-face here).
    Host-side numpy, identical to the JAX package's builder."""
    e1 = v1 - v0
    e2 = v2 - v0
    du1 = uv1[..., 0] - uv0[..., 0]
    dv1 = uv1[..., 1] - uv0[..., 1]
    du2 = uv2[..., 0] - uv0[..., 0]
    dv2 = uv2[..., 1] - uv0[..., 1]
    det = du1 * dv2 - du2 * dv1
    inv = np.where(np.abs(det) > 1e-12, 1.0 / np.where(det == 0, 1, det),
                   0.0)
    tangent = (e1 * dv2[..., None] - e2 * dv1[..., None]) * inv[..., None]
    bitangent = (e2 * du1[..., None] - e1 * du2[..., None]) * inv[..., None]
    norm = lambda a: a / np.maximum(
        np.linalg.norm(a, axis=-1, keepdims=True), 1e-12)
    return norm(tangent), norm(bitangent)
