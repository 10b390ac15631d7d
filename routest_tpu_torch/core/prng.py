"""Counter-based random bits: threefry2x32, bit for bit ``jax.random``'s.

The port's counterpart of the ``jax.random`` calls the JAX package makes
in its candidate generator (``optimize/ranking.py:44-60``) and its model
inits: ``PRNGKey(seed)``, ``split(key, k)``, ``uniform(key, shape)`` for
float32 in [0, 1) and ``normal(key, shape)`` for float32, under
``jax_threefry_partitionable=True`` (the default since jax 0.5; the JAX
package runs with it). Under that flag ``split`` hashes the counters
``(0, i)`` and ``uniform`` hashes the flattened element index
``(hi, lo)`` of the output, then keeps
``bits1 ^ bits2``. The bits depend on the flag, so these functions
reproduce the partitionable layout only.

Keys are ``(..., 2)`` int64 tensors holding uint32 words: torch has no
full uint32 arithmetic on every device, so every word is kept below
2**32 by masking after each add and rotate. Everything runs on the
device of the key tensor.

``normal`` takes ``uniform``'s bits through ``jax.random.normal``'s
transform and XLA's float32 ``erf_inv`` polynomial (M. Giles,
"Approximating the erfinv function"), with each multiply-add rounded
once, as the fused multiply-adds of XLA's CPU code are. XLA's own
``log1p`` is not torch's, so a draw may differ from the JAX package's
in its last bits (``tests/test_torch_train.py`` holds it within 4 ulp).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
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


# XLA's ErfInv32 coefficients, for w = -log1p(-x²) below 5 and from 5 up.
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once (the f32 product is exact in
    float64)."""
    return (a.double() * b.double() + c.double()).float()


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``erf_inv``: a degree-8 polynomial in
    ``w = -log1p(-x²)``, shifted by 2.5 below 5 and ``sqrt(w) - 3``
    from 5 up; ±1 map to ±inf."""
    w = -torch.log1p(-(x * x))
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)

    def coeff(i: int) -> torch.Tensor:
        lo = torch.tensor(_ERFINV_LT5[i], dtype=torch.float32,
                          device=x.device)
        hi = torch.tensor(_ERFINV_GE5[i], dtype=torch.float32,
                          device=x.device)
        return torch.where(lt, lo, hi)

    p = coeff(0)
    for i in range(1, len(_ERFINV_LT5)):
        p = _fma(p, w, coeff(i))
    return torch.where(x.abs() == 1.0, x * float("inf"), p * x)


def normal(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.normal(key, shape)`` (float32): a uniform on
    ``[nextafter(-1, 0), 1)`` from the same bits as :func:`uniform`,
    then ``sqrt(2) · erf_inv``."""
    lo = torch.tensor(np.nextafter(np.float32(-1.0), np.float32(0.0)),
                      device=key.device)
    # uniform(lo, 1): floats · (1 - lo) + lo, where 1 - lo rounds to 2.
    u = torch.maximum(lo, uniform(key, shape) * 2.0 + lo)
    return torch.tensor(np.float32(np.sqrt(2.0)), device=key.device) \
        * erf_inv(u)
