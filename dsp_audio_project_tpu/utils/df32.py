"""Double-float32 ("df32") compensated arithmetic.

The traced programs run in float32 (JAX's 64-bit mode is off), but
coefficient construction *inside* a traced graph (ops/eq_dynamic.py) needs
more than float32: the peaking-EQ pole
geometry amplifies realization rounding by ~1/dist(pole, unit circle), which
for a 40 Hz band at 44.1 kHz is ~350x.  A df32 value represents a real
number as an unevaluated sum hi + lo of two float32s (|lo| <= ulp(hi)/2),
giving ~48 bits of significand — double-ish precision from pure f32 ops.

Classic error-free transformations (Dekker 1971, Knuth TAOCP v2, Bailey's
ddfun): TwoSum, Dekker split/TwoProd, and the usual add/mul/div/sqrt built
on them.  These identities require IEEE round-to-nearest f32 semantics and
no reassociation.  TwoProd multiplies only split halves, whose products are
exact, so a backend that contracts a*b+c into a fused multiply-add cannot
change its values (see _two_prod); chip_smoke.py's gate on the traced
builder checks the whole construction on the card.  Verified against numpy
float64 in tests/test_utils.py.

All functions are elementwise and jit/vmap-compatible; a df32 number is just
a (hi, lo) tuple of equal-shaped f32 arrays.
"""
from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

DF = Tuple[jnp.ndarray, jnp.ndarray]

# Two defenses keep the compiler from breaking the error-free transforms:
#  1. optimization_barrier (_pin) around TwoSum intermediates, so no HLO
#     pass can reassociate (a + b) - a style expressions;
#  2. all EFT multiplies use exactly-representable partial products
#     (see _split/_two_prod), so LLVM's FMA contraction — which rewrites
#     round(x*y) +/- z into fma(x, y, z) with the UNROUNDED product, and
#     measurably collapsed df32 matmuls to plain-f32 accuracy inside
#     XLA:CPU fusions — cannot change any value.
# The barrier also blocks fusion, but df32 is used for tiny
# coefficient/operator construction, never on the data path.
_pin = jax.lax.optimization_barrier


def df(hi, lo=0.0) -> DF:
    """Build a df32 from f32 (or python) values. No normalization."""
    return jnp.float32(hi), jnp.float32(lo)


def from_f64(x: float) -> DF:
    """Host-side: split a python/numpy float64 into an exact df32 pair."""
    import numpy as np

    hi = np.float32(x)
    lo = np.float32(np.float64(x) - np.float64(hi))
    return jnp.float32(hi), jnp.float32(lo)


def to_f32(x: DF) -> jnp.ndarray:
    return x[0] + x[1]


def _two_sum(a, b):
    s = _pin(a + b)
    bb = _pin(s - a)
    err = _pin(a - _pin(s - bb)) + _pin(b - bb)
    return s, err


def _fast_two_sum(a, b):
    """Requires |a| >= |b| (or a == 0)."""
    s = _pin(a + b)
    err = b - _pin(s - a)
    return s, err


def _split(a):
    """Truncating 12-bit significand split via integer masking.

    Dekker's multiplicative split (c = 4097a; hi = c - (c - a)) depends on
    the *rounding* of c — and LLVM's FMA contraction inside XLA:CPU fusions
    replaces rounded products with exact ones (`c - a` -> fma(4097, a, -a)),
    silently breaking it.  Masking the low 12 mantissa bits is contraction-
    proof: integer ops cannot be fused, and `a - hi` is exact (Sterbenz).
    Both halves carry <= 12 significand bits, so every partial product
    below is exactly representable in f32.
    """
    bits = jax.lax.bitcast_convert_type(a, jnp.uint32)
    hi = jax.lax.bitcast_convert_type(bits & jnp.uint32(0xFFFFF000), jnp.float32)
    return hi, a - hi


def _two_prod(a, b):
    """a*b as (p, err) with p + err == a*b to ~2e-13 relative.

    Every multiply here is EXACT in f32 (12-bit x 12-bit significands), so
    FMA contraction — which rewrites round(x*y) +/- z into fma(x, y, z) and
    destroyed the classic `a*b - p` Dekker residual under XLA:CPU fusion
    (measured: whole df32 matmuls collapsed to f32 accuracy) — cannot
    change any value: contracting an exact product is a no-op.
    """
    ah, al = _split(a)
    bh, bl = _split(b)
    p1 = ah * bh                    # exact
    s2, e2 = _two_sum(ah * bl, al * bh)   # both exact; sum compensated
    p, e = _two_sum(p1, s2)
    return p, e + (e2 + al * bl)


def add(x: DF, y: DF) -> DF:
    s, e = _two_sum(x[0], y[0])
    e = e + (x[1] + y[1])
    return _fast_two_sum(s, e)


def sub(x: DF, y: DF) -> DF:
    return add(x, neg(y))


def neg(x: DF) -> DF:
    return -x[0], -x[1]


def mul(x: DF, y: DF) -> DF:
    p, e = _two_prod(x[0], y[0])
    e = e + (x[0] * y[1] + x[1] * y[0])
    return _fast_two_sum(p, e)


def div(x: DF, y: DF) -> DF:
    q1 = x[0] / y[0]
    # r = x - q1*y, computed in df32; q2 refines, q3 polishes the tail.
    r = sub(x, mul(y, df(q1)))
    q2 = (r[0] + r[1]) / y[0]
    return _fast_two_sum(q1, q2)


def sqrt(x: DF) -> DF:
    """df32 square root (x >= 0). Newton step on the f32 seed."""
    s = jnp.sqrt(x[0])
    # guard s == 0 to avoid 0/0
    safe = jnp.where(s > 0, s, jnp.float32(1.0))
    e = sub(x, mul(df(s), df(s)))
    corr = (e[0] + e[1]) / (2.0 * safe)
    corr = jnp.where(s > 0, corr, jnp.float32(0.0))
    return _fast_two_sum(s, corr)


def scale(x: DF, c) -> DF:
    """Multiply by an exactly-representable f32 scalar (e.g. 0.5, -2.0)."""
    return mul(x, df(c))


# ---- small dense linear algebra (df32 matrices as (hi, lo) array pairs) ----
#
# Contractions loop over the (tiny, static) contraction axis in Python, so
# each term is an elementwise compensated product and the accumulation is a
# df32 addition chain — exact enough that the only error left when rounding
# a result to f32 is the final-store rounding.  Used for in-graph IIR block
# operator construction (ops/eq_dynamic.py) where the contraction axis is
# the cascade state dimension (~12).


def mmul(X: DF, Y: DF) -> DF:
    """df32 matmul over the last two axes: (..., m, k) @ (..., k, n)."""
    Xh, Xl = X
    Yh, Yl = Y
    k = Xh.shape[-1]
    acc = None
    for i in range(k):
        xh = Xh[..., :, i:i + 1]
        xl = Xl[..., :, i:i + 1]
        yh = Yh[..., i:i + 1, :]
        yl = Yl[..., i:i + 1, :]
        p, e = _two_prod(xh, yh)
        term = _fast_two_sum(p, e + (xh * yl + xl * yh))
        acc = term if acc is None else add(acc, term)
    return acc


def mvec(X: DF, v: DF) -> DF:
    """df32 matrix @ vector: (..., m, k) @ (..., k)."""
    r = mmul(X, (v[0][..., :, None], v[1][..., :, None]))
    return r[0][..., 0], r[1][..., 0]


def vecmat(v: DF, X: DF) -> DF:
    """df32 vector @ matrix: (..., k) @ (..., k, n)."""
    r = mmul((v[0][..., None, :], v[1][..., None, :]), X)
    return r[0][..., 0, :], r[1][..., 0, :]


def dot(u: DF, v: DF) -> DF:
    """df32 dot product over the last axis (operands broadcast first)."""
    r = mmul(
        (u[0][..., None, :], u[1][..., None, :]),
        (v[0][..., :, None], v[1][..., :, None]),
    )
    return r[0][..., 0, 0], r[1][..., 0, 0]


def outer(u: DF, v: DF) -> DF:
    """df32 outer product of vectors: (..., m) x (..., n) -> (..., m, n)."""
    uh = u[0][..., :, None]
    ul = u[1][..., :, None]
    vh = v[0][..., None, :]
    vl = v[1][..., None, :]
    p, e = _two_prod(uh, vh)
    return _fast_two_sum(p, e + (uh * vl + ul * vh))

