"""Counter-based random bits: threefry2x32, bit for bit ``jax.random``'s.

The port's counterpart of the three ``jax.random`` calls the JAX
package's candidate generator makes (``optimize/ranking.py:44-60``):
``PRNGKey(seed)``, ``split(key, k)`` and ``uniform(key, shape)`` for
float32 in [0, 1), under ``jax_threefry_partitionable=True`` (the
default since jax 0.5; the JAX package runs with it). Under that flag
``split`` hashes the counters ``(0, i)`` and ``uniform`` hashes the
flattened element index ``(hi, lo)`` of the output, then keeps
``bits1 ^ bits2``. The bits depend on the flag, so these functions
reproduce the partitionable layout only.

Keys are ``(..., 2)`` int64 tensors holding uint32 words: torch has no
full uint32 arithmetic on every device, so every word is kept below
2**32 by masking after each add and rotate. Everything runs on the
device of the key tensor.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_ONE_F32_BITS = 0x3F800000
_F32_MANTISSA = 23


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k1: torch.Tensor, k2: torch.Tensor, x0: torch.Tensor,
                 x1: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32, 20 rounds, on int64 tensors of uint32 words that
    broadcast together → the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for block in range(5):
        for r in _ROTATIONS[block % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(block + 1) % 3]) & _MASK
        x1 = (x1 + ks[(block + 2) % 3] + block + 1) & _MASK
    return x0, x1


def prng_key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for a 32-bit seed (the JAX package
    runs without x64): ``[0, seed mod 2**32]``."""
    return torch.tensor([0, int(seed) & _MASK], dtype=torch.int64,
                        device=device)


def split(key: torch.Tensor, num: int) -> torch.Tensor:
    """``jax.random.split(key, num)`` → ``(num, 2)`` keys."""
    lo = torch.arange(num, dtype=torch.int64, device=key.device)
    b1, b2 = threefry2x32(key[0], key[1], torch.zeros_like(lo), lo)
    return torch.stack([b1, b2], dim=-1)


def uniform(keys: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.uniform(key, shape)`` (float32, [0, 1)) for each key
    of ``keys`` (``(2,)`` or ``(K, 2)``) → ``shape`` or ``(K, *shape)``.

    The element at flat index ``i`` hashes the counter pair
    ``(i >> 32, i & 0xFFFFFFFF)``; its 23 high bits become the mantissa
    of a float in [1, 2), minus 1.
    """
    shape = tuple(int(s) for s in shape)
    count = 1
    for s in shape:
        count *= s
    idx = torch.arange(count, dtype=torch.int64, device=keys.device)
    k = keys.reshape(-1, 2)
    b1, b2 = threefry2x32(k[:, :1], k[:, 1:], idx >> 32, idx & _MASK)
    bits = b1 ^ b2
    fbits = ((bits >> (32 - _F32_MANTISSA)) | _ONE_F32_BITS).to(torch.int32)
    out = fbits.view(torch.float32) - 1.0
    return out.reshape(tuple(keys.shape[:-1]) + shape)
