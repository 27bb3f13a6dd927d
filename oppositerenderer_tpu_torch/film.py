"""Film: accumulation buffer, display transform, image IO, checkpointing.

The counterpart of ``oppositerenderer_tpu/film.py``. Checkpoints use the
JAX package's npz format (the key's words stored as uint32), so a
checkpoint written by either package resumes in the other.
"""
from __future__ import annotations

import dataclasses
import struct as pystruct
from pathlib import Path

import numpy as np
import torch

from .core.rng import Key, key_data
from .devices import resolve_device
from .interop import key_from_numpy

Tensor = torch.Tensor


@dataclasses.dataclass
class Film:
    """Accumulated radiance; display divides by the iteration count."""

    accum: Tensor    # [H,W,3] f32 sum over iterations
    iterations: int  # completed iterations

    @classmethod
    def create(cls, width: int, height: int,
               device: torch.device | str | None = None) -> "Film":
        """An empty film on ``device`` (None: the CUDA card)."""
        return cls(accum=torch.zeros((height, width, 3), dtype=torch.float32,
                                     device=resolve_device(device)),
                   iterations=0)

    def add_iteration(self, radiance: Tensor) -> "Film":
        """Accumulate one iteration's [H,W,3] radiance, NaN/inf-guarded like
        RayGeneratorPT.cu:127-131."""
        safe = torch.where(torch.isfinite(radiance), radiance, 0.0)
        return Film(accum=self.accum + safe, iterations=self.iterations + 1)

    def add_iterations(self, radiance_sum: Tensor, n: int) -> "Film":
        """Accumulate a pre-summed [H,W,3] radiance of ``n`` iterations
        (each already guarded before summing)."""
        return Film(accum=self.accum + radiance_sum,
                    iterations=self.iterations + n)

    def mean_radiance(self) -> Tensor:
        return self.accum / float(max(self.iterations, 1))

    def to_display(self, gamma: float = 2.2) -> Tensor:
        """[H,W,3] uint8 with the RenderWidget gamma transform. Buffer row 0
        is the bottom scanline, so rows are flipped for raster order."""
        img = torch.clamp_min(self.mean_radiance(), 0.0)
        img = torch.pow(img, 1.0 / gamma)
        return torch.clamp(img * 255.0 + 0.5, 0, 255).to(torch.uint8).flip(0)


# ---------------------------------------------------------------------------
# image IO
# ---------------------------------------------------------------------------

def save_png(film_or_img, path: str | Path, gamma: float = 2.2) -> None:
    from PIL import Image
    Image.fromarray(_as_display(film_or_img, gamma), "RGB").save(str(path))


def save_tga(film_or_img, path: str | Path, gamma: float = 2.2) -> None:
    """Uncompressed 24-bit TGA (reference export format, util/libtga)."""
    img = _as_display(film_or_img, gamma)
    h, w, _ = img.shape
    header = pystruct.pack("<BBBHHBHHHHBB", 0, 0, 2, 0, 0, 0, 0, 0, w, h,
                           24, 0x20)  # top-left origin
    Path(path).write_bytes(header + img[:, :, ::-1].tobytes())


def _as_display(film_or_img, gamma: float) -> np.ndarray:
    if isinstance(film_or_img, Film):
        return film_or_img.to_display(gamma).cpu().numpy()
    img = np.asarray(film_or_img.cpu() if torch.is_tensor(film_or_img)
                     else film_or_img)
    if img.dtype != np.uint8:
        img = np.clip(np.power(np.clip(img, 0, None), 1.0 / gamma) * 255.0
                      + 0.5, 0, 255).astype(np.uint8)
    return img


# ---------------------------------------------------------------------------
# checkpoint / resume
# ---------------------------------------------------------------------------

def save_checkpoint(path: str | Path, film: Film, rng_key: Key,
                    ppm_radius_sq: float = 0.0,
                    extra: dict | None = None) -> None:
    data = dict(accum=film.accum.cpu().numpy(),
                iterations=np.asarray(film.iterations, np.int32),
                rng_key=key_data(rng_key),
                ppm_radius_sq=np.asarray(ppm_radius_sq))
    for k, v in (extra or {}).items():
        data["x_" + k] = np.asarray(v)
    np.savez(str(path), **data)


def load_checkpoint(path: str | Path,
                    device: torch.device | str | None = None):
    """Returns (film, rng_key, ppm_radius_sq, extra), the film on ``device``
    (None: the CUDA card)."""
    device = resolve_device(device)
    with np.load(str(path)) as z:
        film = Film(accum=torch.as_tensor(z["accum"], device=device),
                    iterations=int(z["iterations"]))
        key = key_from_numpy(z["rng_key"])
        extra = {k[2:]: np.asarray(z[k]) for k in z.files
                 if k.startswith("x_")}
        return film, key, float(z["ppm_radius_sq"]), extra
