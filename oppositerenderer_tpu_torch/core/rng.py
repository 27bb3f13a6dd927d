"""Counter-based RNG, bit-identical to ``oppositerenderer_tpu/core/rng.py``.

A key is a pair of 32-bit words ``(k0, k1)``: Python ints (a host key),
or 0-d int64 tensors (a device key, :func:`device_key`). JAX's
``PRNGKey(seed)`` is ``(0, seed mod 2**32)``, and ``fold_in(key, data)`` is
one Threefry-2x32 block on the counter ``(0, data)``, so the repo's own
``threefry2x32`` reproduces every key the JAX package derives. The same
functions take either form and give the same words: a device key, or an
iteration held as an int64 tensor, keeps every derived key on the device,
so a step that takes them as operands reads nothing from the host and can
be captured in a CUDA graph (``renderer.py``).

On CUDA tensors each Threefry call (a ``LaneSampler`` draw, a key fold,
``uniform``) is one launch of the hand-written kernel of ``csrc/rng.cu``
(``accel/rng_kernels.py``), which computes the same words. Everywhere
else the plain version runs: torch has no unsigned 32-bit arithmetic on
every device, so 32-bit words live in int64 tensors and are masked to 32
bits after each add and shift (``threefry2x32_plain``,
``lane_uniform_plain``, ``uniform_plain``). Multiplications by a constant
split it into 16-bit halves so that no int64 product overflows
(``_mul32``). The same functions run on Python ints, which is how keys are
derived on the host.
"""
from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

MASK32 = 0xFFFFFFFF

Key = tuple  # (k0, k1): two Python ints, or two 0-d int64 tensors


def make_root_key(seed: int) -> Key:
    """``jax.random.PRNGKey(seed)`` words: the seed is taken mod 2**32."""
    return (0, int(seed) & MASK32)


def device_key(key: Key, device: torch.device | str) -> Key:
    """A host key's words as 0-d int64 tensors on ``device``, each set by a
    fill (no host-to-device copy)."""
    return tuple(torch.full((), int(w) & MASK32, dtype=torch.int64,
                            device=device) for w in key)


def _words(w0, w1) -> Key:
    """Two Threefry output words as a key: Python ints stay ints."""
    if torch.is_tensor(w0) or torch.is_tensor(w1):
        return (w0, w1)
    return (int(w0), int(w1))


def fold_in(key: Key, data) -> Key:
    """``jax.random.fold_in``: one Threefry block on the counter (0, data).
    ``data`` is an int or an int64 tensor (its low 32 bits count); the key
    is a device key when the key or the data is a tensor (the data's shape
    broadcasts)."""
    if not torch.is_tensor(data):
        data = int(data) & MASK32
    return _words(*threefry2x32(key[0], key[1], 0, data))


def fold_in_range(key: Key, start: int, count: int) -> list[Key]:
    """``[fold_in(key, start + i) for i in range(count)]``. For a device key
    the ``count`` blocks run as one vector of counters, and each key is a
    view of its element."""
    if not torch.is_tensor(key[0]):
        return [fold_in(key, start + i) for i in range(count)]
    data = torch.arange(start, start + count, dtype=torch.int64,
                        device=key[0].device)
    w0, w1 = fold_in(key, data)
    return list(zip(w0.unbind(), w1.unbind()))


def iteration_key(root: Key, iteration, pass_id: int) -> Key:
    """Key for one (iteration, pass). ``iteration`` is an int or a 0-d
    int64 tensor (then the key is a device key)."""
    return fold_in(fold_in(root, pass_id), iteration)


def key_data(key: Key) -> np.ndarray:
    """The key's two words as ``uint32[2]`` (``jax.random.key_data``)."""
    return np.asarray([int(w) for w in key], np.uint32)


def lane_key_words(keys: Sequence[Key], lanes_per_key: int,
                   device: torch.device | str) -> tuple[torch.Tensor,
                                                        torch.Tensor]:
    """Per-lane (k0, k1) words where lane ``l`` uses key
    ``keys[l // lanes_per_key]``: G independent iterations stacked in one
    wavefront draw exactly the streams the separate iterations would.
    Device keys are stacked on the device; host keys are copied there."""
    if torch.is_tensor(keys[0][0]):
        words = torch.stack([torch.stack(k) for k in keys])
    else:
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


def _on_card(*xs) -> bool:
    """Whether a Threefry call runs the kernel: some operand is a CUDA
    tensor or device."""
    return any(x.type == "cuda" if isinstance(x, torch.device)
               else torch.is_tensor(x) and x.is_cuda for x in xs)


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 (20 rounds) on 32-bit words held as Python ints or
    int64 tensors. Returns the two output words. On CUDA tensors, whose
    shapes broadcast to 0-d or 1-d, one launch of the kernel; otherwise
    :func:`threefry2x32_plain`."""
    if _on_card(k0, k1, x0, x1):
        from ..accel.rng_kernels import threefry_words
        return threefry_words(k0, k1, x0, x1)
    return threefry2x32_plain(k0, k1, x0, x1)


def threefry2x32_plain(k0, k1, x0, x1):
    """Threefry-2x32 (20 rounds) on 32-bit words held as Python ints or
    int64 tensors (broadcasting), masked to 32 bits after each step: the
    kernel's plain version. Returns the two output words. The low 32 bits
    of each operand count."""
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
    one. On a CUDA device one launch of the kernel."""
    n = math.prod(shape)
    if _on_card(key[0], key[1], torch.device(device)):
        from ..accel.rng_kernels import threefry_uniform
        return threefry_uniform(key[0], key[1], n, device).reshape(shape)
    return uniform_plain(key, n, device).reshape(shape)


def uniform_plain(key: Key, n: int, device: torch.device | str
                  ) -> torch.Tensor:
    """float32 ``[n]``: :func:`uniform`'s flat form by the plain
    version."""
    i = torch.arange(n, dtype=torch.int64, device=device)
    b0, b1 = threefry2x32_plain(key[0], key[1], i >> 32, i & MASK32)
    bits = ((b0 ^ b1) >> 9) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0


def _bits_to_uniform(bits: torch.Tensor) -> torch.Tensor:
    """Top 24 bits -> [0, 1) float32."""
    return (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))


def lane_uniform_plain(k0, k1, lanes: torch.Tensor, counter: int,
                       cols: int) -> torch.Tensor:
    """float32 ``[N, cols]``: a :class:`LaneSampler` draw by the plain
    version. Lane ``l`` takes the blocks ``(lanes[l], counter + j)`` under
    the key ``(k0, k1)`` (ints, 0-d tensors or ``[N]`` per-lane words);
    block j gives column 2j its first word and 2j + 1 its second."""
    k0 = k0[:, None] if torch.is_tensor(k0) and k0.dim() else k0
    k1 = k1[:, None] if torch.is_tensor(k1) and k1.dim() else k1
    n_pairs = (cols + 1) // 2
    ctr = torch.arange(n_pairs, dtype=torch.int64,
                       device=lanes.device) + counter
    b0, b1 = threefry2x32_plain(k0, k1, lanes[:, None], ctr[None, :])
    bits = torch.stack([b0, b1], dim=-1).reshape(lanes.shape[0],
                                                 2 * n_pairs)
    return _bits_to_uniform(bits[:, :cols])


class LaneSampler:
    """Per-lane counter-based sampler: draw *i* for lane *l* is a pure
    function of ``(key, lane_id, i)``, bit-identical to the JAX package's
    ``LaneSampler``.

    ``key`` is a :data:`Key` (host or device) or a pair of per-lane int64
    word tensors (:func:`lane_key_words`). ``cheap`` selects the
    integer-hash stream (``RenderConfig.use_cheap_random``) instead of
    Threefry.
    """

    def __init__(self, key, lane_ids: torch.Tensor, cheap: bool = False):
        self._cheap = bool(cheap)
        lanes = lane_ids.to(torch.int64)
        self._device = lanes.device
        k0, k1 = key
        if self._cheap:
            base = k0 ^ _mul32(k1, 0x9E3779B9)
            self._lane_base = _lowbias32(_mul32(lanes & MASK32, 0x85ebca6b)
                                         ^ base)
        else:
            # Threefry takes the ids' low 32 bits itself
            self._k0, self._k1 = k0, k1
            self._lanes = lanes.contiguous()
        self._n = 0  # column counter; draw i = f(key, lane, column)

    def _tf_uniform(self, cols: int) -> torch.Tensor:
        """One Threefry block per two columns: on CUDA lanes one launch of
        the kernel, whose counter is baked into a capture as the host's
        ``_n``."""
        start = self._n
        self._n += (cols + 1) // 2
        if _on_card(self._lanes):
            from ..accel.rng_kernels import threefry_draw
            return threefry_draw(self._lanes, self._k0, self._k1, start,
                                 cols)
        return lane_uniform_plain(self._k0, self._k1, self._lanes, start,
                                  cols)

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
