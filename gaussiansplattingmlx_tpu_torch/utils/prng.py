"""The JAX package's random stream in torch: threefry2x32 keys, ``split``,
``bits``, ``uniform`` and ``normal`` as ``jax.random`` computes them with its
default implementation (threefry2x32, ``jax_threefry_partitionable`` on).

A key is a numpy ``uint32[2]``, as ``np.asarray(jax.random.PRNGKey(seed))``.
Key arithmetic (seed, split) runs on the host in numpy; draws run on the
tensor's device as plain torch ops on 32-bit words held in int64, so the CPU
and a CUDA card give the same words.  ``normal`` follows XLA's CPU lowering of
``sqrt(2) * erf_inv(u)`` step by step (its ``log1p``, Giles's single-precision
``erfinv`` and the multiply-adds its compiler fuses), so its floats equal
``jax.random.normal`` on the CPU to the bit almost everywhere and within a few
ulp elsewhere, on either device.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA


def _threefry2x32(k1: int, k2: int, x0, x1):
    """Threefry-2x32, 20 rounds (``jax._src.prng._threefry2x32_lowering``),
    on 32-bit words held in numpy uint64 or torch int64 arrays."""
    ks = (k1, k2, k1 ^ k2 ^ _KS_PARITY)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = x0 ^ (((x1 << r) | (x1 >> (32 - r))) & _M32)
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def _words(key) -> tuple[int, int]:
    key = np.asarray(key)
    if key.shape != (2,):
        raise ValueError(f"a threefry2x32 key is uint32[2], got shape {key.shape}")
    return int(key[0]) & _M32, int(key[1]) & _M32


def prng_key(seed: int) -> np.ndarray:
    """``np.asarray(jax.random.PRNGKey(seed))`` with 64-bit types off (JAX's
    default): the seed taken modulo 2^32, under a zero high word."""
    return np.array([0, int(seed) & _M32], np.uint32)


def split(key, num: int = 2) -> np.ndarray:
    """``jax.random.split(key, num)`` (the partitionable form): uint32[num, 2]."""
    k1, k2 = _words(key)
    lo = np.arange(num, dtype=np.uint64)
    b1, b2 = _threefry2x32(k1, k2, np.zeros_like(lo), lo)
    return np.stack([b1, b2], axis=1).astype(np.uint32)


def random_bits(key, shape, device="cpu") -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)`` as an int64 tensor of 32-bit
    words: the hash of each entry's row-major index, split into (hi, lo)."""
    k1, k2 = _words(key)
    shape = tuple(int(s) for s in shape)
    idx = torch.arange(math.prod(shape), dtype=torch.int64, device=device)
    b1, b2 = _threefry2x32(k1, k2, idx >> 32, idx & _M32)
    return (b1 ^ b2).reshape(shape)


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once, as a fused multiply-add.

    The float64 product of two float32 values is exact; the float64 sum is
    rounded to odd (TwoSum's error picks the neighbour), so its rounding to
    float32 is the single rounding of the exact result."""
    b, c = (x.double() if isinstance(x, torch.Tensor) else float(x) for x in (b, c))
    p = a.double() * b
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    bits = s.view(torch.int64)
    nudge = (err != 0) & ((bits & 1) == 0)
    step = torch.where((err > 0) == (s > 0), 1, -1)
    return torch.where(nudge, bits + step, bits).view(torch.float64).float()


def _f32(values) -> np.ndarray:
    return np.asarray(values, np.float64).astype(np.float32)


# XLA's float32 log (a Cephes logf), its log1p's rational for |x| < sqrt(2) - 1
# (Cephes log1p, rounded to float32), and Giles's erfinv for w < 5 / w >= 5.
_LOG_P = _f32([7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1,
               -1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1,
               2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1])
_LOG_Q1, _LOG_Q2 = _f32([-2.12194440e-4, 0.693359375])
_SQRTHF = _f32(0.707106781186547524)
_LOG1P_SMALL = _f32(0.41421356237309504880)
_LOG1P_NUM = _f32([4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
                   6.5787325942061044846969e0, 2.9911919328553073277375e1,
                   6.0949667980987787057556e1, 5.7112963590585538103336e1,
                   2.0039553499201281259648e1])
_LOG1P_DEN = _f32([1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
                   2.2176239823732856465394e2, 3.0909872225312059774938e2,
                   2.1642788614495947685003e2, 6.0118660497603843919306e1])
_ERFINV_LT5 = _f32([2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                    -4.39150654e-06, 0.00021858087, -0.00125372503,
                    -0.00417768164, 0.246640727, 1.50140941])
_ERFINV_GE5 = _f32([-0.000200214257, 0.000100950558, 0.00134934322,
                    -0.00367342844, 0.00573950773, -0.0076224613,
                    0.00943887047, 1.00167406, 2.83297682])
_SQRT2 = _f32(np.sqrt(2.0))


def _log(a: torch.Tensor) -> torch.Tensor:
    """XLA's float32 log of normal positive finite ``a``, fused steps as
    XLA's CPU code fuses them."""
    bits = a.view(torch.int32)
    e = ((bits >> 23) - 127).float() + 1.0
    mant = ((bits & 0x7FFFFF) | 0x3F000000).view(torch.float32)
    low = mant < float(_SQRTHF)
    t = (mant - 1.0) + torch.where(low, mant, torch.zeros_like(mant))
    e = e - low.float()
    z = t * t
    t3 = z * t
    p = _LOG_P
    ca = _fma(_fma(t, p[0], p[1]), t, p[2])
    cb = _fma(ca, t3, _fma(_fma(t, p[3], p[4]), t, p[5]))
    cc = _fma(cb, t3, _fma(_fma(t, p[6], p[7]), t, p[8]))
    y = _fma(cc, t3, e * float(_LOG_Q1))
    s = y + _fma(z, -0.5, t)
    return _fma(e, float(_LOG_Q2), s)


def _log1p(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 log1p of ``x`` in (-1, 0]."""
    x2 = x * x
    num = torch.full_like(x, float(_LOG1P_NUM[0]))
    den = torch.ones_like(x)
    for n, d in zip(_LOG1P_NUM[1:], _LOG1P_DEN[1:]):
        num = _fma(num, x, n)
        den = _fma(den, x, d)
    ratio = (num.double() / den.double()).float()
    small = x + _fma(x2, -0.5, (x * x2) * ratio)
    return torch.where(x.abs() < float(_LOG1P_SMALL), small, _log(x + 1.0))


def _erfinv(u: torch.Tensor) -> torch.Tensor:
    """XLA's single-precision erfinv (Giles) of ``u`` in (-1, 1)."""
    log = _log1p(u * -u)
    lt5 = log > -5.0
    w = torch.where(lt5, -2.5 - log, torch.sqrt(-log.double()).float() - 3.0)
    coef = [torch.where(lt5, float(a), float(b)) for a, b in zip(_ERFINV_LT5, _ERFINV_GE5)]
    p = coef[0]
    for c in coef[1:]:
        p = _fma(p, w, c)
    return u * p


def uniform(key, shape, minval=0.0, maxval=1.0, device="cpu") -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``: 23 random
    mantissa bits under exponent 0, minus one, scaled (one rounding), then
    ``max(minval, .)``."""
    bits = random_bits(key, shape, device)
    floats = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    lo, hi = np.float32(minval), np.float32(maxval)
    scaled = _fma(floats, float(hi - lo), float(lo))
    return torch.clamp(scaled, min=float(lo))


def normal(key, shape, device="cpu") -> torch.Tensor:
    """``jax.random.normal(key, shape, float32)``: sqrt(2) erfinv(u) with u
    uniform in [nextafter(-1, 0), 1)."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    return _erfinv(uniform(key, shape, lo, 1.0, device)) * float(_SQRT2)


def ulp_distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Units in the last place between two float32 tensors (int64)."""
    def ordered(x):
        bits = x.float().contiguous().view(torch.int32).long()
        return torch.where(bits < 0, -(bits & 0x7FFFFFFF), bits)
    return (ordered(a) - ordered(b)).abs()
