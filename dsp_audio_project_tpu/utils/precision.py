"""Contraction precision, stated explicitly.

Every numerically critical contraction goes through these wrappers, which
pin ``Precision.HIGHEST`` (full float32) and a float32 accumulator: a
default-precision float32 matmul may run in TF32 on a GPU, whose 10-bit
mantissa caps the pipeline far below the 60 dB gate.

"Fast" mode names its algorithm instead of asking for ``Precision.HIGH``
(whose meaning differs between backends — TF32 on a GPU):
``BF16_BF16_F32_X3`` splits each operand into a bf16 hi/lo pair and sums
three bf16 products with float32 accumulation, ~16 mantissa bits.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

_HIGHEST = jax.lax.Precision.HIGHEST
FAST = jax.lax.DotAlgorithmPreset.BF16_BF16_F32_X3


def dot_precision(fast: bool):
    """The precision argument of a contraction in fast or full mode."""
    return FAST if fast else _HIGHEST


def einsum_prec(subscripts: str, *operands: jnp.ndarray,
                fast: bool = False) -> jnp.ndarray:
    """float32 einsum at ``dot_precision(fast)``."""
    return jnp.einsum(
        subscripts,
        *operands,
        precision=dot_precision(fast),
        preferred_element_type=jnp.float32,
    )


def einsum_f32(subscripts: str, *operands: jnp.ndarray) -> jnp.ndarray:
    return einsum_prec(subscripts, *operands)


def matmul_f32(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    return jnp.matmul(a, b, precision=_HIGHEST, preferred_element_type=jnp.float32)


def matvec_f32(m: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """(..., i, j) x (..., j) -> (..., i) at full precision."""
    return jnp.matmul(m, v[..., None], precision=_HIGHEST,
                      preferred_element_type=jnp.float32)[..., 0]


def vecmat_f32(v: jnp.ndarray, m: jnp.ndarray) -> jnp.ndarray:
    """(..., i) x (i, j) -> (..., j) at full precision."""
    return jnp.matmul(v, m, precision=_HIGHEST, preferred_element_type=jnp.float32)
