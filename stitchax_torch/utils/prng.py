"""The noise stitchax draws, reproduced on the host with numpy.

stitchax's SD inpainter draws its initial latent noise with
`jax.random.normal(jax.random.PRNGKey(seed), shape, float32)`
(stitchax/models/sd_pipeline.py:69,83). This module gives the same values:

  * the key of `PRNGKey(seed)` for a 32-bit seed is the word pair
    (0, seed);
  * the bits are threefry-2x32 (20 rounds) in JAX's partitionable layout
    (`jax_threefry_partitionable`, the default since JAX 0.5): the counter
    of element i (row-major) is the 64-bit i split into its high and low
    32-bit words, and the 32-bit output is the xor of the two threefry
    words;
  * the uniform draw on [nextafter(-1, 0), 1) keeps the top 23 bits as the
    mantissa of a float in [1, 2), subtracts 1, scales by 2 and shifts by
    the lower bound, clamped to it;
  * the normal is sqrt(2) * erfinv(u) with XLA's float32 ErfInv
    polynomial (xla/client/lib/math.cc, ErfInv32).

All arithmetic is float32 or uint32 as in XLA; XLA's log1p inside ErfInv
may differ from numpy's by an ulp, so the normals agree within a few
float32 ulps (tests/test_torch_sd.py), the bits exactly.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
# ErfInv32's coefficients, for w < 5 and w >= 5
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def prng_key(seed: int) -> Tuple[int, int]:
    """The two key words of `jax.random.PRNGKey(seed)` for a 32-bit seed."""
    if not -2 ** 31 <= seed < 2 ** 32:
        raise ValueError(f"seed {seed} is not a 32-bit integer")
    return 0, seed & 0xFFFFFFFF


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key: Tuple[int, int], x0: np.ndarray, x1: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Threefry-2x32 with 20 rounds on uint32 counter words."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    x = [x0.astype(np.uint32) + ks[0], x1.astype(np.uint32) + ks[1]]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = x[0] + x[1]
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = x[0] + ks[(i + 1) % 3]
        x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def random_bits(seed: int, shape: Sequence[int]) -> np.ndarray:
    """`jax.random.bits(PRNGKey(seed), shape, uint32)`."""
    n = int(np.prod(shape, dtype=np.int64))
    idx = np.arange(n, dtype=np.uint64)
    hi = (idx >> np.uint64(32)).astype(np.uint32)
    lo = (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    with np.errstate(over="ignore"):
        b0, b1 = threefry2x32(prng_key(seed), hi, lo)
    return (b0 ^ b1).reshape(tuple(shape))


def erfinv_f32(x: np.ndarray) -> np.ndarray:
    """XLA's float32 ErfInv polynomial."""
    f32 = np.float32
    x = np.asarray(x, f32)
    w = -np.log1p(-x * x)
    lt = w < f32(5.0)
    w = np.where(lt, w - f32(2.5), np.sqrt(w) - f32(3.0)).astype(f32)
    p = np.where(lt, f32(_ERFINV_LT5[0]), f32(_ERFINV_GE5[0]))
    for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = np.where(lt, f32(a), f32(b)) + p * w
    return np.where(np.abs(x) == f32(1.0), x * np.finfo(f32).max,
                    p * x).astype(f32)


def normal(seed: int, shape: Sequence[int]) -> np.ndarray:
    """`jax.random.normal(PRNGKey(seed), shape, float32)`, float32."""
    f32 = np.float32
    bits = random_bits(seed, shape)
    floats = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(f32) \
        - f32(1.0)
    lo = np.nextafter(f32(-1.0), f32(0.0))
    span = f32(1.0) - lo                       # rounds to 2.0 in float32
    u = np.maximum(lo, floats * span + lo).astype(f32)
    return (f32(np.sqrt(2.0)) * erfinv_f32(u)).astype(f32)
