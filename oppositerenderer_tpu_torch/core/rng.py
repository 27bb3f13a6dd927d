"""Counter-based RNG, bit-identical to ``oppositerenderer_tpu/core/rng.py``.

A key is a pair of 32-bit words ``(k0, k1)`` held as Python ints. JAX's
``PRNGKey(seed)`` is ``(0, seed mod 2**32)``, and ``fold_in(key, data)`` is
one Threefry-2x32 block on the counter ``(0, data)``, so the repo's own
``threefry2x32`` reproduces every key the JAX package derives.

torch has no unsigned 32-bit arithmetic on every device, so 32-bit words
live in int64 tensors and are masked to 32 bits after each add and shift.
Multiplications by a constant split it into 16-bit halves so that no int64
product overflows (``_mul32``). The same functions run on Python ints,
which is how keys are derived on the host.
"""
from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

MASK32 = 0xFFFFFFFF

Key = tuple[int, int]


def make_root_key(seed: int) -> Key:
    """``jax.random.PRNGKey(seed)`` words: the seed is taken mod 2**32."""
    return (0, int(seed) & MASK32)


def fold_in(key: Key, data: int) -> Key:
    """``jax.random.fold_in``: one Threefry block on the counter (0, data)."""
    return tuple(int(w) for w in threefry2x32(key[0], key[1], 0,
                                              int(data) & MASK32))


def iteration_key(root: Key, iteration: int, pass_id: int) -> Key:
    """Key for one (iteration, pass)."""
    return fold_in(fold_in(root, pass_id), iteration)


def key_data(key: Key) -> np.ndarray:
    """The key's two words as ``uint32[2]`` (``jax.random.key_data``)."""
    return np.asarray(key, np.uint32)


def lane_key_words(keys: Sequence[Key], lanes_per_key: int,
                   device: torch.device | str) -> tuple[torch.Tensor,
                                                        torch.Tensor]:
    """Per-lane (k0, k1) words where lane ``l`` uses key
    ``keys[l // lanes_per_key]``: G independent iterations stacked in one
    wavefront draw exactly the streams the separate iterations would."""
    words = torch.tensor(list(keys), dtype=torch.int64, device=device)
    return (torch.repeat_interleave(words[:, 0], lanes_per_key),
            torch.repeat_interleave(words[:, 1], lanes_per_key))


def _mul32(x, c: int):
    """``x * c mod 2**32`` for a 32-bit word ``x`` and a constant ``c``,
    without an int64 product that overflows."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def _lowbias32(x):
    """32-bit integer hash (lowbias32, Chris Wellons)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7feb352d)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846ca68b)
    x = x ^ (x >> 16)
    return x


_TF_ROTS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r: int):
    return ((x << r) & MASK32) | (x >> (32 - r))


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 (20 rounds) on 32-bit words held as Python ints or
    int64 tensors (broadcasting). Returns the two output words."""
    ks = (k0 & MASK32, k1 & MASK32, (k0 ^ k1 ^ 0x1BD11BDA) & MASK32)
    x0 = (x0 + ks[0]) & MASK32
    x1 = (x1 + ks[1]) & MASK32
    for d in range(5):
        for r in _TF_ROTS[d % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(d + 1) % 3]) & MASK32
        x1 = (x1 + ks[(d + 2) % 3] + (d + 1)) & MASK32
    return x0, x1


def uniform(key: Key, shape, device: torch.device | str) -> torch.Tensor:
    """``jax.random.uniform(key, shape)``: float32 in [0, 1), bit for bit,
    under the partitionable Threefry (``jax_threefry_partitionable``,
    JAX's default). Element i of the row-major flattened shape takes the
    block on the counter (i >> 32, i mod 2**32) and XORs its two words;
    the top 23 bits of that become the mantissa of a float in [1, 2), less
    one."""
    i = torch.arange(math.prod(shape), dtype=torch.int64, device=device)
    b0, b1 = threefry2x32(key[0], key[1], i >> 32, i & MASK32)
    bits = ((b0 ^ b1) >> 9) | 0x3F800000
    return (bits.to(torch.int32).view(torch.float32) - 1.0).reshape(shape)


def _bits_to_uniform(bits: torch.Tensor) -> torch.Tensor:
    """Top 24 bits -> [0, 1) float32."""
    return (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))


class LaneSampler:
    """Per-lane counter-based sampler: draw *i* for lane *l* is a pure
    function of ``(key, lane_id, i)``, bit-identical to the JAX package's
    ``LaneSampler``.

    ``key`` is a :data:`Key` or a pair of per-lane int64 word tensors
    (:func:`lane_key_words`). ``cheap`` selects the integer-hash stream
    (``RenderConfig.use_cheap_random``) instead of Threefry.
    """

    def __init__(self, key, lane_ids: torch.Tensor, cheap: bool = False):
        self._cheap = bool(cheap)
        lanes = lane_ids.to(torch.int64) & MASK32
        self._device = lanes.device
        k0, k1 = key
        if self._cheap:
            base = k0 ^ _mul32(k1, 0x9E3779B9)
            self._lane_base = _lowbias32(_mul32(lanes, 0x85ebca6b) ^ base)
        else:
            # per-lane words broadcast over the column axis
            self._k0 = k0[:, None] if torch.is_tensor(k0) else k0
            self._k1 = k1[:, None] if torch.is_tensor(k1) else k1
            self._lanes = lanes
        self._n = 0  # column counter; draw i = f(key, lane, column)

    def _tf_uniform(self, cols: int) -> torch.Tensor:
        """One Threefry block per two columns."""
        n_pairs = (cols + 1) // 2
        ctr = torch.arange(n_pairs, dtype=torch.int64,
                           device=self._device) + self._n
        self._n += n_pairs
        b0, b1 = threefry2x32(self._k0, self._k1, self._lanes[:, None],
                              ctr[None, :])
        bits = torch.stack([b0, b1], dim=-1).reshape(self._lanes.shape[0],
                                                     2 * n_pairs)
        return _bits_to_uniform(bits[:, :cols])

    def _cheap_uniform(self, cols: int) -> torch.Tensor:
        ctr = torch.arange(cols, dtype=torch.int64,
                           device=self._device) + self._n
        self._n += cols
        bits = _lowbias32(self._lane_base[:, None]
                          ^ _mul32(ctr & MASK32, 0x9E3779B9))
        return _bits_to_uniform(bits)

    def _uniform(self, cols: int) -> torch.Tensor:
        return self._cheap_uniform(cols) if self._cheap \
            else self._tf_uniform(cols)

    def next1(self) -> torch.Tensor:
        return self._uniform(1)[:, 0]

    def next2(self) -> torch.Tensor:
        return self._uniform(2)

    def next3(self) -> torch.Tensor:
        return self._uniform(3)
