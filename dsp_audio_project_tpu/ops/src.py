"""Sample-rate conversion as a polyphase matmul.

The reference converts rate by zero-stuffing to the full L*N intermediate
rate, convolving a 40*max(L,M)+1-tap sinc-Blackman LPF with centered 'same'
alignment, and decimating by M (dsp_core.py:133-173).  For 44.1k->48k that is
a 6401-tap FIR evaluated at 7 MHz — never materialized here.

Matmul restructuring
--------------------
With T taps (odd), center C = T//2, the reference output is exactly

    y[n] = sum_q x[q] * h[n*M + C - L*q]                      (*)

Group outputs by phase class c = n mod P where P = L/gcd(L,M).  Within a
class, n = c + k*P walks the input in constant strides s = M/gcd(L,M):

    y[c + k*P] = sum_t  bank[r_c, t] * x[b_c + k*s - t]

with r_c = (c*M + C) mod L, b_c = (c*M + C) // L, and bank the L-branch
polyphase decomposition of h.  Stacking all P classes turns the whole SRC
into ONE dense matmul:  frames F[k, w] = x[k*s + lo + w] (a strided window
of width W ~ s + T/L) times a host-precomputed (W, P) matrix G whose column
c is the class-c branch scattered at offset b_c.  F @ G is a dense GEMM;
interleaving the class columns back to time order is a reshape.

Output length is ceil(N*L/M) and sample values match (*) — i.e. match the
reference's 'same' centering — exactly, verified against the golden oracle.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import SRCConfig
from ..design.sinc import lowpass_sinc
from ..utils.precision import einsum_f32, einsum_prec


# eq=False: identity hash (instances are lru_cache singletons per config;
# the ndarray field would otherwise break hashing in downstream caches).
@dataclasses.dataclass(frozen=True, eq=False)
class PolyphasePlan:
    """Host-side geometry + operator for one (L, M, taps) configuration.

    Attributes:
      G:  (W, P) float64 operator matrix (cast to f32 at use).
      lo: frame offset — frame k covers x[k*s + lo : k*s + lo + W].
      s:  frame stride in input samples.
      P:  number of phase classes (outputs per frame).
      W:  frame width.
      taps: FIR length T (odd).
      halo_left/halo_right: input samples a time-shard needs from its
        neighbors for seamless overlap-save processing (derived from lo/W).
    """

    G: np.ndarray
    lo: int
    s: int
    P: int
    W: int
    taps: int
    L: int
    M: int

    @property
    def halo_left(self) -> int:
        return max(0, -self.lo)

    @property
    def halo_right(self) -> int:
        # Rightmost input sample touched by the frame that produces the last
        # in-shard output, relative to that frame's base.
        return max(0, self.lo + self.W - 1)


@functools.lru_cache(maxsize=None)
def make_plan(
    L: int, M: int, taps_rule_factor: int = 40, center: int | None = None
) -> PolyphasePlan:
    """``center`` is the 'same'-mode alignment offset.  numpy's 'same' takes
    the middle max(len(a), len(v)) of the full convolution, i.e. offset
    (min(len(a), len(v)) - 1) // 2 — for the common case of signals longer
    than the filter that is T//2; short signals pass their own center."""
    cfg = SRCConfig(L=L, M=M, taps_rule_factor=taps_rule_factor)
    T = cfg.num_taps
    C = T // 2 if center is None else center
    h = lowpass_sinc(cfg.cutoff_norm, T) * L  # gain compensation, dsp_core.py:162

    g = math.gcd(L, M)
    P = L // g
    s = M // g

    # Per-class residue/base and branch taps.
    n_c = np.arange(P)
    phi = n_c * M + C
    r_c = phi % L
    b_c = phi // L
    Tb = int(np.ceil(T / L))  # max taps per polyphase branch

    lo = int(b_c.min()) - (Tb - 1)
    hi = int(b_c.max())
    W = hi - lo + 1

    G = np.zeros((W, P), dtype=np.float64)
    for c in range(P):
        for t in range(Tb):
            hidx = int(r_c[c]) + L * t
            if hidx < T:
                G[int(b_c[c]) - t - lo, c] = h[hidx]
    return PolyphasePlan(G=G, lo=lo, s=s, P=P, W=W, taps=T, L=L, M=M)


def _frame_indices(num_frames: int, plan: PolyphasePlan, pad_left: int) -> np.ndarray:
    k = np.arange(num_frames, dtype=np.int32)[:, None]
    w = np.arange(plan.W, dtype=np.int32)[None, :]
    return k * plan.s + w + (plan.lo + pad_left)


def resample(
    x: jnp.ndarray, fs: int, cfg: SRCConfig
) -> Tuple[jnp.ndarray, int]:
    """L/M sample-rate conversion matching the reference bit-for-behavior.

    ``x``: (..., N) float32.  Returns (..., ceil(N*L/M)) and the new rate
    int(fs*L/M) (truncating, as dsp_core.py:172).  Jit-compiled per
    (config, shape); the polyphase matmul runs at full float32.
    """
    fs_out = fs if cfg.bypass else cfg.output_rate(fs)
    return _resample_jit(x, cfg), fs_out


@functools.partial(jax.jit, static_argnames=('cfg',))
def _resample_jit(x: jnp.ndarray, cfg: SRCConfig) -> jnp.ndarray:
    if cfg.bypass:
        return x
    n = x.shape[-1]
    n_up = n * cfg.L
    T = cfg.num_taps
    if n_up >= T:
        plan = make_plan(cfg.L, cfg.M, cfg.taps_rule_factor)
        n_out = cfg.output_length(n)
    else:
        # Signal shorter than the filter: numpy 'same' convolution returns
        # max(n_up, T) samples centered at (n_up - 1) // 2.
        plan = make_plan(cfg.L, cfg.M, cfg.taps_rule_factor, (n_up - 1) // 2)
        n_out = -(-T // cfg.M)
    return _resample_frames(x, plan, n_out)


# Frame granule of the frame-major path: one EQ block holds this many
# frames (ops/eq.equalize_frames' groups_per_block), so padded frame counts
# are multiples of it and the EQ regroups them with a free reshape.
FRAME_GRANULE = 128


def shifted_frames_matmul(
    x: jnp.ndarray, plan: PolyphasePlan, num_frames: int, pad_left: int,
    op=None, fast: bool = False,
) -> jnp.ndarray:
    """Polyphase frames via J = ceil(W/s) shifted matmuls (the s >= 8 regime).

    ``x`` is the raw (..., N) signal; after left-padding by ``pad_left``
    its index 0 must be frame 0's window start (k*s + lo + pad_left == 0
    for k = 0).  ``op`` is the (W, V) frame operator (default ``plan.G``;
    the cat path passes the folded ``G @ w_cat``).  Returns
    (..., num_frames, V).  Shared by the unsharded op and the shard-local
    paths (parallel/pipeline.py, streaming.py), which hand in halo-extended
    local signals.
    """
    if pad_left < 0:  # window start lies inside x: drop the lead instead
        x = x[..., -pad_left:]
        pad_left = 0
    lead = x.shape[:-1]
    n = x.shape[-1]
    g_mat = jnp.asarray(plan.G if op is None else op, dtype=jnp.float32)
    J = -(-plan.W // plan.s)
    groups_total = num_frames + J
    total_len = groups_total * plan.s
    pad_right = max(0, total_len - pad_left - n)
    xp = jnp.pad(
        x, [(0, 0)] * (x.ndim - 1) + [(pad_left, pad_right)]
    )[..., :total_len]
    x2 = xp.reshape(lead + (groups_total, plan.s))
    g_pad = jnp.pad(g_mat, ((0, J * plan.s - plan.W), (0, 0)))
    acc = None
    for j in range(J):
        chunk = jax.lax.slice_in_dim(x2, j, j + num_frames, axis=x2.ndim - 2)
        term = einsum_prec(
            "...ks,sp->...kp", chunk, g_pad[j * plan.s : (j + 1) * plan.s],
            fast=fast,
        )
        acc = term if acc is None else acc + term
    return acc


def _gather_frames_matmul(
    x: jnp.ndarray, plan: PolyphasePlan, num_frames: int, pad_left: int,
    op=None, fast: bool = False,
) -> jnp.ndarray:
    """shifted_frames_matmul's contract for small strides: with s < 8, J
    would approach W and degenerate into rank-s updates, so one explicit
    (..., K, W) frame gather feeds a single matmul instead."""
    if pad_left < 0:
        x = x[..., -pad_left:]
        pad_left = 0
    n = x.shape[-1]
    pad_right = max(0, (num_frames - 1) * plan.s + plan.W - pad_left - n)
    xp = jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(pad_left, pad_right)])
    k = np.arange(num_frames, dtype=np.int32)[:, None]
    w = np.arange(plan.W, dtype=np.int32)[None, :]
    frames = jnp.take(xp, jnp.asarray(k * plan.s + w), axis=-1)  # (..., K, W)
    g_mat = jnp.asarray(plan.G if op is None else op, dtype=jnp.float32)
    return einsum_prec("...kw,wp->...kp", frames, g_mat, fast=fast)


def frame_count(plan: PolyphasePlan, n_out: int, pad_frames: bool) -> int:
    """Frames that carry ``n_out`` outputs, rounded up to FRAME_GRANULE
    when ``pad_frames`` (the EQ block grid of the frame-major path)."""
    f = -(-n_out // plan.P)
    if pad_frames:
        f = -(-f // FRAME_GRANULE) * FRAME_GRANULE
    return f


def resample_frames(
    x: jnp.ndarray,
    plan: PolyphasePlan,
    n_out: int,
    *,
    op=None,
    fast: bool = False,
    pad_frames: bool = False,
    num_frames: int | None = None,
    pad_left: int | None = None,
) -> jnp.ndarray:
    """Resample (..., N) -> frame-major (..., F, P): y = frames.reshape(...,
    F*P)[..., :n_out] equals ``resample``'s flat output.

    ``F`` is ceil(n_out / P), rounded up to FRAME_GRANULE with
    ``pad_frames`` (tail frames hold convolution of zero padding), or
    ``num_frames`` when given.  ``pad_left`` (default -lo) is the zero
    extension that puts frame 0's window start at index 0; shard-local
    callers pass -(lo + halo_left) for halo-extended inputs.  ``op``
    replaces plan.G (see resample_frames_cat); ``fast`` runs the matmul as
    bf16x3 (utils.precision.FAST) instead of full float32.
    """
    if num_frames is None:
        num_frames = frame_count(plan, n_out, pad_frames)
    if pad_left is None:
        pad_left = -plan.lo
    frames_fn = (
        shifted_frames_matmul if plan.s >= 8 else _gather_frames_matmul
    )
    return frames_fn(x.astype(jnp.float32), plan, num_frames, pad_left,
                     op=op, fast=fast)


def fold_operator(plan: PolyphasePlan, w_cat):
    """The cat path's frame operator  G @ w_cat  (W, P+d).

    The EQ's first matmul (frames @ [group_fir^T | group_in], see
    ops/eq.eq_cat_weights) has frame-independent weights, so it folds into
    the SRC operator:  frames @ w_cat = x_windows @ (G @ w_cat).  A host
    (numpy) ``w_cat`` is composed in float64 and quantized to float32
    once; a traced one (dynamic gains) is folded on device at HIGHEST.
    """
    if isinstance(w_cat, np.ndarray):
        return (plan.G.astype(np.float64) @ w_cat.astype(np.float64)).astype(
            np.float32
        )
    return einsum_f32("wp,pv->wv", jnp.asarray(plan.G, jnp.float32), w_cat)


def resample_frames_cat(
    x: jnp.ndarray, plan: PolyphasePlan, n_out: int, op, **kw,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """SRC with the EQ's first matmul folded in (``op`` = fold_operator):
    returns (y0 (..., F, P), inj (..., F, d)) — the EQ's zero-state group
    output and state injection per frame; the frames tensor itself is
    never formed.  Keyword arguments as for resample_frames."""
    cat = resample_frames(x, plan, n_out, op=op, **kw)
    return cat[..., : plan.P], cat[..., plan.P :]


def _resample_frames(
    x: jnp.ndarray, plan: PolyphasePlan, n_out: int,
) -> jnp.ndarray:
    """Flat (..., n_out) output of the frame computation (shapes static,
    geometry host-computed).  Frame k of the zero-extended input covers
    x[k*s + lo : k*s + lo + W]; y[k*P + c] = frame_k @ G[:, c]."""
    classes = resample_frames(x, plan, n_out)
    out = classes.reshape(x.shape[:-1] + (classes.shape[-2] * plan.P,))
    return out[..., :n_out]


def resample_rows(
    x: jnp.ndarray,
    plan: PolyphasePlan,
    r0: int,
    r1: int,
    precision=jax.lax.Precision.HIGHEST,
) -> jnp.ndarray:
    """Frames [r0, r1) of the resampled signal, computed directly from x.

    A tiny (r1-r0, W) @ (W, P) matmul over statically-sliced input windows
    — the fused cat chain (models/chain._forward_cat_spectra) uses it to
    produce the y-spectrum's ~13 frame rows without materializing the full
    resampled signal anywhere (the cat SRC emits the EQ's [y0 | inj]
    instead of raw frames).  Matches resample's frame semantics: frame k
    covers x[k*s + lo : k*s + lo + W] with zero extension outside x.
    """
    s, W = plan.s, plan.W
    a = r0 * s + plan.lo          # window span in x coordinates
    b = (r1 - 1) * s + plan.lo + W
    n = x.shape[-1]
    lpad = max(0, -a)
    rpad = max(0, b - n)
    seg = x[..., max(0, a) : min(n, b)]
    seg = jnp.pad(
        seg.astype(jnp.float32),
        [(0, 0)] * (x.ndim - 1) + [(lpad, rpad)],
    )
    win = jnp.stack(
        [seg[..., i * s : i * s + W] for i in range(r1 - r0)], axis=-2
    )
    return jnp.einsum(
        "...rw,wp->...rp", win, jnp.asarray(plan.G, dtype=jnp.float32),
        precision=precision, preferred_element_type=jnp.float32,
    )
