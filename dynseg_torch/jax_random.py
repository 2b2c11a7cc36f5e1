"""The part of `jax.random` that Flax's `model.init` reaches, in numpy.

The threefry2x32 generator with `jax_threefry_partitionable` on (the
default from jax 0.5, and what `jax>=0.9` gives the reference): `key`,
`split`, `fold_in` and 32-bit `random_bits` are integer arithmetic and
equal JAX's words bit for bit. `uniform` and `truncated_normal` follow
the float32 program that XLA compiles for them on an x86-64 CPU with FMA:
the same operations in the same order, with the multiply-adds that LLVM
contracts into fused multiply-adds done as one rounding (`_fma`), and
XLA's own polynomials for `erf`, `log1p` and `erf_inv` in place of libm.

Every floating-point step is an IEEE-754 float32 add, multiply, divide or
square root, or a float64 product and sum rounded once to float32, none
of which numpy may compute differently on another CPU; no libm or SIMD
transcendental is called. So the draw gives the same bits on any host.
XLA on another backend (a TPU, a CPU without FMA) may round a few values
differently by an ulp or two; the integer words are the same everywhere.
"""

from __future__ import annotations

import hashlib
import math
from typing import Sequence, Tuple

import numpy as np

_F32 = np.float32
_U32 = np.uint32


# ----------------------------------------------------------------------- #
# threefry2x32
# ----------------------------------------------------------------------- #
def _rotl(v: np.ndarray, r: int) -> np.ndarray:
    return (v << _U32(r)) | (v >> _U32(32 - r))


def threefry2x32(key: np.ndarray, x0: np.ndarray, x1: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Mirrors `jax._src.prng._threefry2x32_lowering`: the Threefry-2x32
    hash (20 rounds) of the count pairs (x0, x1) under a (2,) uint32 key."""
    k0, k1 = (np.asarray(k, _U32).reshape(1) for k in key)
    ks = [k0, k1, k0 ^ k1 ^ _U32(0x1BD11BDA)]
    rotations = ((13, 15, 26, 6), (17, 29, 16, 24))
    x = [np.asarray(x0, _U32) + ks[0], np.asarray(x1, _U32) + ks[1]]
    for i in range(5):
        for r in rotations[i % 2]:
            x[0] = x[0] + x[1]
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = x[0] + ks[(i + 1) % 3]
        x[1] = x[1] + ks[(i + 2) % 3] + _U32(i + 1)
    return x[0], x[1]


def key(seed: int) -> np.ndarray:
    """Mirrors `jax.random.key(seed)` (`prng.threefry_seed`) for a seed that
    fits int32, as JAX takes it without x64: the key words are the high and
    low 32 bits, and a logical shift of an int32 by 32 gives 0."""
    seed = int(seed)
    if not -2 ** 31 <= seed < 2 ** 31:
        raise OverflowError(f"seed {seed} does not fit int32")
    return np.array([0, seed & 0xFFFFFFFF], _U32)


def _iota_2x32(shape: Sequence[int]) -> Tuple[np.ndarray, np.ndarray]:
    """Mirrors `prng.iota_2x32_shape`: a uint64 iota over `shape` in C
    order, as (high, low) uint32 words."""
    n = math.prod(shape)
    counts = np.arange(n, dtype=np.uint64)
    return ((counts >> np.uint64(32)).astype(_U32),
            (counts & np.uint64(0xFFFFFFFF)).astype(_U32))


def split(k: np.ndarray, num: int = 2) -> np.ndarray:
    """Mirrors `jax.random.split` (`prng._threefry_split_foldlike`): key i
    is the hash of the count pair (0, i); shape (num, 2)."""
    hi, lo = _iota_2x32((num,))
    b0, b1 = threefry2x32(k, hi, lo)
    return np.stack([b0, b1], axis=-1)


def fold_in(k: np.ndarray, data: int) -> np.ndarray:
    """Mirrors `jax.random.fold_in` (`prng._threefry_fold_in`): the hash of
    the uint32 `data`'s seed words (0, data), under `k`."""
    b0, b1 = threefry2x32(k, np.zeros(1, _U32), np.array([int(data) & 0xFFFFFFFF], _U32))
    return np.array([b0[0], b1[0]], _U32)


def random_bits(k: np.ndarray, shape: Sequence[int]) -> np.ndarray:
    """Mirrors `jax.random.bits(k, shape, uint32)`
    (`prng._threefry_random_bits_partitionable`, 32-bit): the hash of
    each element's (high, low) iota words, the two outputs xor-ed."""
    shape = tuple(int(s) for s in shape)
    hi, lo = _iota_2x32(shape)
    b0, b1 = threefry2x32(k, hi, lo)
    return (b0 ^ b1).reshape(shape)


# ----------------------------------------------------------------------- #
# float32 arithmetic as XLA's CPU program does it
# ----------------------------------------------------------------------- #
def _fma(a, b, c) -> np.ndarray:
    """float32 fused multiply-add, a * b + c rounded once. The product of
    two float32 values is exact in float64; the float64 sum's error is
    recovered (two-sum), and the one case where rounding the float64 sum
    to float32 differs from rounding the exact sum (a float32 halfway
    point with a non-zero error) is moved to the error's side."""
    with np.errstate(invalid="ignore", over="ignore"):
        p = np.asarray(a, _F32).astype(np.float64) * np.asarray(b, _F32)
        c = np.asarray(c, _F32).astype(np.float64)
        p, c = np.broadcast_arrays(p, c)
        s = p + c
        r = s.astype(_F32)
    # A normal float32's halfway points have the low 29 mantissa bits of a
    # float64 equal to 1 << 28; float32 subnormals are checked in full.
    low = s.view(np.uint64) & np.uint64(0x1FFFFFFF)
    maybe = (low == np.uint64(0x10000000)) | ((np.abs(s) < 2.0 ** -126) & (s != 0))
    if maybe.any():
        i = np.flatnonzero(maybe)
        pi, ci, si, ri = (np.ravel(v)[i] for v in (p, c, s, r))
        bb = si - pi
        err = (pi - (si - bb)) + (ci - bb)
        r64 = ri.astype(np.float64)
        other = np.nextafter(ri, np.where(si > r64, _F32(np.inf), _F32(-np.inf)))
        halfway = (si != r64) & (si == (r64 + other.astype(np.float64)) * 0.5) & (err != 0)
        side = np.where(err > 0, np.maximum(ri, other), np.minimum(ri, other))
        r = np.array(r)  # a copy, and an array where r was a scalar
        np.put(r, i, np.where(halfway, side, ri))
    return r


def _c(*values: str) -> Tuple[np.float32, ...]:
    return tuple(_F32(v) for v in values)


# XLA's f32 erf (elemental_ir_emitter EmitErfF32): x * P(x^2) / Q(x^2) on x
# clamped to +-3.7439213, both polynomials by fma.
_ERF_CLAMP = _F32("3.7439213")
_ERF_P = _c("0.00022905065", "0.003408291", "0.050955694", "0.18520832", "1.1283791")
_ERF_Q = _c("-1.1791603e-07", "2.3547966e-05", "0.0010179626", "0.01407047",
            "0.11098505", "0.49746925", "1.0")


def erf(x) -> np.ndarray:
    """Mirrors XLA's float32 `erf` on the CPU (`lax.erf`)."""
    x = np.clip(np.asarray(x, _F32), -_ERF_CLAMP, _ERF_CLAMP)
    x2 = x * x
    p = _fma(_ERF_P[0], x2, _ERF_P[1])
    for c in _ERF_P[2:]:
        p = _fma(p, x2, c)
    q = _fma(_ERF_Q[0], x2, _ERF_Q[1])
    for c in _ERF_Q[2:]:
        q = _fma(q, x2, c)
    return (x * p) / q


# Cephes logf, as XLA's CPU emitter inlines it (mantissa in [0.5, 1), the
# polynomial in three interleaved chains).
_LOG_P = _c("0.070376836", "-0.1151461", "-0.12420141", "0.14249323",
            "0.20000714", "-0.24999994", "0.116769984", "-0.16668057", "0.3333333")
_LOG_C1 = _F32("-0.00021219444")
_LOG_C2 = _F32("0.6933594")
_SQRT_HALF = _F32("0.70710677")
_F32_MIN_NORMAL = _F32("1.1754944e-38")


def _log_f32(y: np.ndarray) -> np.ndarray:
    """Mirrors the float32 `log` that XLA's CPU backend inlines."""
    bits = np.maximum(y, _F32_MIN_NORMAL).view(np.int32)
    e = ((bits >> 23) - 127).astype(_F32) + _F32(1)
    m = ((bits & 0x7FFFFF) | 0x3F000000).view(_F32)
    small = m < _SQRT_HALF
    x = (m - _F32(1)) + np.where(small, m, _F32(0))
    e = e - np.where(small, _F32(1), _F32(0))
    x2 = x * x
    x3 = x2 * x
    p = _LOG_P
    q1 = _fma(_fma(x, p[0], p[1]), x, p[6])
    q2 = _fma(_fma(x, p[2], p[3]), x, p[7])
    q3 = _fma(_fma(x, p[4], p[5]), x, p[8])
    r = _fma(_fma(q1, x3, q2), x3, q3)
    tail = _fma(r, x3, e * _LOG_C1)
    out = _fma(e, _LOG_C2, (x - x2 * _F32(0.5)) + tail)
    with np.errstate(invalid="ignore"):
        out = np.where(y == _F32(np.inf), _F32(np.inf), out)
        out = np.where(y == 0, _F32(-np.inf), out)
        out = np.where(~(y >= 0), _F32(np.nan), out)
    return out


# Cephes log1p's rational approximation for |x| < sqrt(2) - 1, in float32.
_LOG1P_SMALL = _F32("0.41421357")
_LOG1P_NUM = _c("4.527e-05", "0.49854103", "6.5787325", "29.911919", "60.94967",
                "57.112965", "20.039553")
_LOG1P_DEN = _c("15.062909", "83.04757", "221.7624", "309.09872", "216.42789",
                "60.11866")


def log1p(x) -> np.ndarray:
    """Mirrors XLA's float32 `log1p` on the CPU (`lax.log1p`): log(1 + x)
    for large |x|, else x - x^2/2 + x^3 P(x)/Q(x)."""
    x = np.asarray(x, _F32)
    large = _log_f32(x + _F32(1))
    zero = x * _F32(0)
    den = _F32(1) + zero
    for c in _LOG1P_DEN:
        den = _fma(den, x, c)
    num = zero + _LOG1P_NUM[0]
    for c in _LOG1P_NUM[1:]:
        num = _fma(num, x, c)
    x2 = x * x
    small = x + _fma(x2, _F32(-0.5), (x * x2) * (num / den))
    return np.where(np.abs(x) < _LOG1P_SMALL, small, large)


# XLA's float32 ErfInv (Giles' single-precision approximation): two
# degree-8 polynomials in w = -log1p(-x^2), split at w < 5.
_ERFINV_LT5 = _c("2.8102264e-08", "3.4327394e-07", "-3.5233877e-06", "-4.3915065e-06",
                 "0.00021858087", "-0.001253725", "-0.0041776816", "0.24664073",
                 "1.5014094")
_ERFINV_GE5 = _c("-0.00020021426", "0.00010095056", "0.0013493432", "-0.0036734284",
                 "0.0057395077", "-0.0076224613", "0.0094388705", "1.001674",
                 "2.8329768")


def erf_inv(x) -> np.ndarray:
    """Mirrors XLA's float32 `erf_inv` on the CPU (`lax.erf_inv`)."""
    x = np.asarray(x, _F32)
    lg = log1p(x * -x)
    lt = lg > _F32(-5)
    with np.errstate(invalid="ignore"):
        w = np.where(lt, _F32(-2.5) - lg, np.sqrt(-lg) + _F32(-3))
    coef = [np.where(lt, a, b) for a, b in zip(_ERFINV_LT5, _ERFINV_GE5)]
    p = _fma(coef[0], w, coef[1])
    for c in coef[2:]:
        p = _fma(w, p, c)
    return x * np.where(np.abs(x) == _F32(1), _F32(np.inf), p)


_SQRT2 = _F32(np.sqrt(2))
_INV_SQRT2 = _F32(1) / _SQRT2


def uniform(k: np.ndarray, shape: Sequence[int], minval=0.0, maxval=1.0) -> np.ndarray:
    """Mirrors float32 `jax.random.uniform` (`random._uniform`): 23 random
    mantissa bits give f in [1, 2), then max(minval, (f - 1) * (maxval -
    minval) + minval) with the multiply-add fused."""
    minval, maxval = _F32(minval), _F32(maxval)
    bits = random_bits(k, shape)
    f = ((bits >> _U32(9)) | _U32(0x3F800000)).view(_F32) - _F32(1)
    return np.maximum(minval, _fma(maxval - minval, f, minval))


def truncated_normal(k: np.ndarray, lower, upper, shape: Sequence[int]) -> np.ndarray:
    """Mirrors float32 `jax.random.truncated_normal`
    (`random._truncated_normal`): sqrt(2) erf_inv(u) for u uniform on
    [erf(lower / sqrt 2), erf(upper / sqrt 2)), clipped to the open
    interval. XLA rewrites the division by sqrt 2 as a product with its
    float32 reciprocal."""
    lower, upper = _F32(lower), _F32(upper)
    a = erf(np.array([lower * _INV_SQRT2]))[0]
    b = erf(np.array([upper * _INV_SQRT2]))[0]
    u = uniform(k, shape, a, b)
    out = erf_inv(u) * _SQRT2
    lo = np.nextafter(lower, _F32(np.inf))
    hi = np.nextafter(upper, _F32(-np.inf))
    return np.minimum(hi, np.maximum(lo, out))


def lecun_normal(k: np.ndarray, shape: Sequence[int]) -> np.ndarray:
    """Mirrors `jax.nn.initializers.lecun_normal()` (`variance_scaling(1,
    "fan_in", "truncated_normal")`) for a float32 kernel whose last axis
    is the output and the one before it the input: a standard normal
    truncated to (-2, 2) times sqrt(1 / fan_in) / 0.87962566103423978,
    each factor rounded to float32 as JAX does."""
    fan_in = math.prod(shape[:-1])
    variance = _F32(1.0 / fan_in)
    stddev = np.sqrt(variance) / _F32(0.87962566103423978)
    return truncated_normal(k, -2, 2, shape) * stddev


# ----------------------------------------------------------------------- #
# Flax's key derivation
# ----------------------------------------------------------------------- #
def fold_in_static(k: np.ndarray, path: Sequence) -> np.ndarray:
    """Mirrors `flax.core.scope._fold_in_static` with
    `flax_fix_rng_separator` off (flax's default): the first four bytes
    (big-endian) of the SHA-1 of the path's names (UTF-8) and counters
    (minimal big-endian bytes), folded into `k`."""
    if not path:
        return k
    m = hashlib.sha1()
    for x in path:
        if isinstance(x, str):
            m.update(x.encode("utf-8"))
        elif isinstance(x, int):
            m.update(x.to_bytes((x.bit_length() + 7) // 8, byteorder="big"))
        else:
            raise ValueError(f"Expected int or string, got: {x}")
    return fold_in(k, int.from_bytes(m.digest()[:4], byteorder="big"))

