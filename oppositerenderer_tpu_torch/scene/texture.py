"""Per-triangle tangent frames (part of ``oppositerenderer_tpu/scene/
texture.py``).

Every scene carries per-face tangents for normal mapping, so the builder
needs them now; the texture atlas, bilinear sampling and normal-map
perturbation arrive with the texture slice.
"""
from __future__ import annotations

import numpy as np


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
