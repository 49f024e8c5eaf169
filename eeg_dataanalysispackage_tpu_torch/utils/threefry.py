"""JAX's threefry random streams, rebuilt in torch integer arithmetic.

The JAX package draws every random number it needs from
``jax.random`` under the default threefry2x32 implementation with
``jax_threefry_partitionable`` on: the SGD engine's mini-batch masks
(``models/sgd.py``), flax's initial weights and dropout masks, and the
neural network's denoising and CD-1 masks (``models/nn.py``). This
module computes the same numbers, so the port's runs follow the JAX
package's trajectories:

- a key is a pair of uint32 words; ``prng_key(seed)`` is ``(0, seed)``;
- ``fold_in(key, d)`` is ``threefry2x32(key, (0, d))``;
- the 32 bits at flat index ``i`` of a shape are ``x0 ^ x1`` of
  ``threefry2x32(key, (i >> 32, i & 0xffffffff))``;
- ``uniform`` puts the top 23 bits into the mantissa of a float in
  [1, 2), subtracts 1, scales and shifts it in one fused multiply-add
  (XLA contracts the two on the CPU) and clamps below at ``minval``;
- ``normal`` and ``truncated_normal`` map uniforms through XLA's
  float32 ``erf_inv`` polynomial (and ``erf`` for the truncation
  bounds), written out as torch float32 operations;
- ``fold_in_static`` is flax's rule for deriving a module's key from
  its path: the first four bytes (big-endian) of the SHA-1 of the path's
  names and counters, concatenated with no separator, folded in.

Keys are plain Python integers, so deriving one costs no device work;
the bits are computed with int64 tensors whose values stay below 2**32
(torch has no unsigned 32-bit shift or rotate on every backend), on the
device of the request. A key may also be a pair of int64 tensors of one
shape ``K`` (:func:`prng_keys`, :func:`fold_in` of a tensor): a batch of
keys, whose draws of ``shape`` come back as one ``K + shape`` tensor in
a single pass, each row equal to that key's own draw (a population's
members draw their masks this way). ``bits``, ``uniform`` and ``bernoulli`` are equal
bit for bit to ``jax.random``'s on every device; the transcendental
maps of ``normal`` and ``truncated_normal`` agree within a few ulp
(``tests/test_torch_threefry.py`` states the bound).
"""

from __future__ import annotations

import hashlib
import math
from typing import Tuple, Union

import numpy as np
import torch

#: a threefry key: two uint32 words
Key = Tuple[int, int]

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
# float32 bit pattern of 1.0: the exponent of [1, 2)
_ONE_BITS = 0x3F800000


def _rotl(x, d: int):
    return ((x << d) | (x >> (32 - d))) & _MASK


def threefry2x32(key: Key, x0, x1):
    """The threefry2x32 block cipher (20 rounds) of the counter pair
    ``(x0, x1)`` under ``key``: Python ints or int64 tensors holding
    uint32 values (the key's words too, broadcast against the counters);
    returns the pair in the same form."""
    k0, k1 = (k if isinstance(k, torch.Tensor) else int(k) & _MASK for k in key)
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x0, x1


def prng_key(seed: int) -> Key:
    """``jax.random.PRNGKey(seed)`` for a 32-bit seed: ``(0, seed)``."""
    return 0, int(seed) & _MASK


def prng_keys(seeds: torch.Tensor) -> Key:
    """:func:`prng_key` of each of an int64 tensor of 32-bit seeds: a
    batch of keys of the seeds' shape."""
    seeds = seeds.to(torch.int64) & _MASK
    return torch.zeros_like(seeds), seeds


def fold_in(key: Key, data) -> Key:
    """``jax.random.fold_in(key, data)``: ``data`` (an int, or an int64
    tensor broadcast against a batch of keys) taken as a uint32."""
    data = data & _MASK if isinstance(data, torch.Tensor) else int(data) & _MASK
    return threefry2x32(key, 0, data)


def static_hash(*data: Union[str, int]) -> int:
    """The uint32 that flax's ``_fold_in_static`` folds in for a path
    ``data``: the first four bytes (big-endian) of its SHA-1."""
    m = hashlib.sha1()
    for x in data:
        if isinstance(x, str):
            m.update(x.encode("utf-8"))
        elif isinstance(x, int):
            m.update(x.to_bytes((x.bit_length() + 7) // 8, byteorder="big"))
        else:
            raise ValueError(f"Expected int or string, got: {x}")
    return int.from_bytes(m.digest()[:4], byteorder="big")


def fold_in_static(key: Key, *data: Union[str, int]) -> Key:
    """flax's ``_fold_in_static``: fold the SHA-1 of the path ``data``
    (strings as UTF-8, ints as their minimal big-endian bytes, nothing
    between them) into ``key``; no data returns ``key``."""
    if not data:
        return key
    return fold_in(key, static_hash(*data))


def _shape(shape) -> Tuple[int, ...]:
    return (int(shape),) if isinstance(shape, int) else tuple(int(s) for s in shape)


def random_bits(key: Key, shape, device=None) -> torch.Tensor:
    """``jax.random.bits(key, shape)`` (uint32) as an int64 tensor on
    ``device`` (default: the CPU); a batch of keys of shape ``K`` gives
    ``K + shape`` on the keys' device."""
    shape = _shape(shape)
    n = math.prod(shape)
    lead: Tuple[int, ...] = ()
    if isinstance(key[0], torch.Tensor):
        lead, device = tuple(key[0].shape), key[0].device
        key = (key[0].reshape(lead + (1,)), key[1].reshape(lead + (1,)))
    idx = torch.arange(n, dtype=torch.int64, device=device)
    out0, out1 = threefry2x32(key, idx >> 32, idx & _MASK)
    return (out0 ^ out1).reshape(lead + shape)


def _f32(x) -> float:
    return float(np.float32(x))


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once, as XLA's contracted
    multiply-add: the float32 product is exact in float64, so only the
    sum rounds there before the cast back."""
    if isinstance(b, torch.Tensor):
        b = b.to(torch.float64)
    if isinstance(c, torch.Tensor):
        c = c.to(torch.float64)
    return (a.to(torch.float64) * b + c).to(torch.float32)


def uniform(key: Key, shape, minval=0.0, maxval=1.0, device=None) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)`` on
    ``device``; ``minval``/``maxval`` are scalars."""
    bits = random_bits(key, shape, device)
    floats = ((bits >> 9) | _ONE_BITS).to(torch.int32).view(torch.float32) - 1.0
    lo = _f32(minval)
    span = _f32(np.float32(maxval) - np.float32(minval))
    return torch.clamp(_fma(floats, span, lo), min=lo)


def bernoulli(key: Key, p, shape=None, device=None) -> torch.Tensor:
    """``jax.random.bernoulli(key, p, shape)``: bool, ``uniform < p`` in
    float32. ``p`` is a scalar or a float32 tensor (then ``shape``
    defaults to its shape and the draw lies on its device)."""
    if isinstance(p, torch.Tensor):
        shape = tuple(p.shape) if shape is None else shape
        device = p.device
        return uniform(key, shape, device=device) < p.to(torch.float32)
    return uniform(key, shape, device=device) < _f32(p)


# XLA's float32 erf_inv (M. Giles, "Approximating the erfinv function"),
# highest-order coefficient first
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
               0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
               0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)
# XLA's float32 erf: x * P(x^2) / Q(x^2) on [-4, 4]
_ERF_ALPHA = (-2.72614225801306e-10, 2.77068142495902e-08, -2.10102402082508e-06,
              -5.69250639462346e-05, -7.34990630326855e-04, -2.95459980854025e-03,
              -1.60960333262415e-02)
_ERF_BETA = (-1.45660718464996e-05, -2.13374055278905e-04, -1.68282697438203e-03,
             -7.37332916720468e-03, -1.42647390514189e-02)


# XLA's float32 log1p below sqrt(2) - 1: the Cephes rational
# approximation, highest-order coefficient first
_LOG1P_NUM = (4.5270000862445199635215E-5, 4.9854102823193375972212E-1,
              6.5787325942061044846969E0, 2.9911919328553073277375E1,
              6.0949667980987787057556E1, 5.7112963590585538103336E1,
              2.0039553499201281259648E1)
_LOG1P_DEN = (1.0, 1.5062909083469192043167E1, 8.3047565967967209469434E1,
              2.2176239823732856465394E2, 3.0909872225312059774938E2,
              2.1642788614495947685003E2, 6.0118660497603843919306E1)


def _log1p(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``log1p``: the Cephes rational form (bit-equal on
    the CPU) below ``sqrt(2) - 1``, ``log(x + 1)`` above (XLA's ``log``
    and torch's differ there in the last ulp)."""

    def poly(coeffs):
        p = torch.zeros_like(x)
        for c in coeffs:
            p = _fma(p, x, _f32(c))
        return p

    x2 = x * x
    small = (x * x2) * (poly(_LOG1P_NUM) / poly(_LOG1P_DEN))
    small = x + _fma(x2, -0.5, small)
    return torch.where(x.abs() < _f32(0.41421356237309504880), small, torch.log(x + 1.0))


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``erf_inv`` polynomial as torch float32 operations."""
    x = x.to(torch.float32)
    w = -_log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    p = torch.where(lt, torch.full_like(x, _f32(_ERFINV_LT5[0])),
                    torch.full_like(x, _f32(_ERFINV_GE5[0])))
    for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        c = torch.where(lt, torch.full_like(x, _f32(a)), torch.full_like(x, _f32(b)))
        p = _fma(p, w, c)
    return torch.where(x.abs() == 1.0, x * float("inf"), p * x)


def _erf_f32(x: float) -> float:
    """XLA's float32 ``erf`` of one scalar, in numpy float32."""
    x = np.clip(np.float32(x), np.float32(-4.0), np.float32(4.0))
    x2 = x * x
    num = np.float32(_ERF_ALPHA[0])
    for a in _ERF_ALPHA[1:]:
        num = num * x2 + np.float32(a)
    den = np.float32(_ERF_BETA[0])
    for b in _ERF_BETA[1:]:
        den = den * x2 + np.float32(b)
    return float(np.clip(x * num / den, np.float32(-1.0), np.float32(1.0)))


_SQRT2 = _f32(np.sqrt(2))


def normal(key: Key, shape, device=None) -> torch.Tensor:
    """``jax.random.normal(key, shape, float32)``."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0), dtype=np.float32)
    u = uniform(key, shape, lo, 1.0, device)
    return _SQRT2 * erf_inv(u)


def truncated_normal(key: Key, lower: float, upper: float, shape,
                     device=None) -> torch.Tensor:
    """``jax.random.truncated_normal(key, lower, upper, shape, float32)``."""
    lower, upper = np.float32(lower), np.float32(upper)
    sqrt2 = np.float32(_SQRT2)
    a = _erf_f32(lower / sqrt2)
    b = _erf_f32(upper / sqrt2)
    u = uniform(key, shape, a, b, device)
    out = _SQRT2 * erf_inv(u)
    lo = float(np.nextafter(lower, np.float32(np.inf), dtype=np.float32))
    hi = float(np.nextafter(upper, np.float32(-np.inf), dtype=np.float32))
    return torch.clamp(out, lo, hi)
