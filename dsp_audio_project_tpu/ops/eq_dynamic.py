"""Dynamic-gain EQ: band gains as TRACED values — no recompile per change.

The static path (ops/eq.py) treats gains as compile-time constants: best
numerics (host float64 design, Schur form) and best speed, but every new
gain vector costs a ~4 s compile.  Serving scenarios — the reference's UI
sliders, per-request EQ — need gain changes at zero compile cost.  This
module rebuilds the whole design pipeline *inside* the traced graph:

1.  **Analytic pole geometry.**  Computing poles from the quantized
    (a1, a2) cancels catastrophically in float32 (disc = a1^2 - 4a2 is a
    ~1e-4 difference of ~4-magnitude terms).  In closed form the peaking
    biquad's discriminant is

        disc = sin^2(w0) (1/A^2 - 4) / (1 + alpha/A)^2        (Q = 1)

    — a product of well-scaled factors, exact to relative eps.  Poles are
    complex for A > 1/2 (gain > -12.04 dB) and real below.

2.  **Per-band 2x2 realizations with benign quantization.**  Complex pair:
    the rotation (modal) block [[m, q], [-q, m]] stores Re/Im directly.
    Real pair: the quasi-triangular [[l1, 1], [0, l2]] block (the unit
    coupling keeps the input/output maps bounded as l1 -> l2, where a
    diagonal form's residues diverge).  Both branches of a lax.cond share
    shapes.

3.  **In-graph cascade composition** of the six always-active bands into
    one order-12 system (a band at 0 dB is exactly identity in exact
    arithmetic — b == a — so the reference's skip-small-gains rule costs
    only rounding here; see semantics note below).

4.  **In-graph block operators.**  The group tables (C A^u, A^{U-1-v} B,
    the group FIR Toeplitz, the within-block group Toeplitz) come from one
    associative cumulative product of U copies of A composed with cumulative
    products of A^U — log-depth everywhere; the data path itself is the same
    scan-free four-matmul structure as the static ops/eq path.

Semantics vs the reference: the static path reproduces the reference's
|gain| <= 0.1 dB band-skip and the all-flat bypass *exactly*; here a small
gain is applied as a (numerically ~1e-6) near-identity filter and the
output is always clipped.  Both differences are far below the 60 dB gate
(verified in tests/test_eq_dynamic.py).
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..config import EQConfig
from ..utils import df32
from ..utils.precision import einsum_f32, einsum_prec, matmul_f32
from .eq import _state_solve

_HI = jax.lax.Precision.HIGHEST

# Dense-carry ceiling: below this K*d the block-carry solve ships as ONE
# (K d, K d) triangle matmul built in-graph (mirrors ops/eq's host-built
# _carry_weights); above it the log-depth scan costs less HBM than the
# triangle's K^2 d^2 table.  2048 -> a 16 MB f32 table at the ceiling.
_CARRY_DENSE_MAX_KD = 2048


class DynOperators(NamedTuple):
    """Traced-gains block operators — the jit-transparent pytree handed from
    ``build_dynamic_operators`` (run when gains change) to the apply-side
    data path (run per batch).  Same algebra as design.biquad.BlockOperators,
    with the group FIR pre-transposed for the output matmul and the carry
    triangle materialized (ops/eq builds it on host; here A^block is traced).
    """

    group_in: jnp.ndarray    # (U, d)   A^{U-1-v} B
    group_out: jnp.ndarray   # (d, U)   (C A^u)^T columns
    fir_t: jnp.ndarray       # (U, U)   group_fir^T
    toe: jnp.ndarray         # (G d, G d) within-block group Toeplitz
    pows_g: jnp.ndarray      # (G, d, d)  A^{gU}
    A_blk: jnp.ndarray       # (d, d)   A^block
    carry_w: Optional[jnp.ndarray]  # (K d, K d) dense carry triangle or None


def _band_realization(w0: float, gain_db: jnp.ndarray):
    """One peaking biquad (Q=1) as (A 2x2, B 2, C 2, D), gain traced.

    All intermediate arithmetic runs in df32 (utils/df32): the pole geometry
    amplifies realization rounding by ~1/dist(pole, unit circle) (~350x for
    the 40 Hz band), so plain-f32 construction caps the whole dynamic path at
    ~70 dB SNR.  With compensated construction the only f32 rounding left is
    the final (A, B, C, D) store — measured ~108 dB vs the oracle.  w0 is
    static: sin/cos are exact host-side float64 split into df32 constants.
    """
    import numpy as np

    f32 = jnp.float32
    sin_w0 = df32.from_f64(np.sin(np.float64(w0)))
    cos_w0 = df32.from_f64(np.cos(np.float64(w0)))
    g = gain_db.astype(f32)
    # amp's own relative error only moves the pole radius by ~alpha*eps —
    # harmless — so the f32 exp seed is promoted as-is to df32.
    amp = df32.df(10.0 ** (g / 40.0))
    one = df32.df(1.0)
    alpha = df32.scale(sin_w0, 0.5)
    al_over = df32.div(alpha, amp)     # alpha / A
    al_times = df32.mul(alpha, amp)    # alpha * A
    a0 = df32.add(one, al_over)
    a1 = df32.div(df32.scale(cos_w0, -2.0), a0)
    a2 = df32.div(df32.sub(one, al_over), a0)
    b0 = df32.div(df32.add(one, al_times), a0)
    # b1 == a1 for the peaking EQ; numerator residual c(z) = c1 z + c0 with
    # c1 = b1 - b0 a1 = a1 (1 - b0), c0 = b2 - b0 a2.  1 - b0 in closed form
    # avoids cancellation: alpha (1/A - A) / a0.
    one_minus_b0 = df32.div(
        df32.mul(alpha, df32.sub(df32.div(one, amp), amp)), a0
    )
    c1 = df32.mul(a1, one_minus_b0)
    b2 = df32.div(df32.sub(one, al_times), a0)
    c0 = df32.sub(b2, df32.mul(b0, a2))

    m = df32.scale(a1, -0.5)
    # disc/4 in closed form: (sin w0)^2 (1/A^2 - 4) / (4 a0^2) — exact sign.
    disc4 = df32.div(
        df32.mul(
            df32.mul(sin_w0, sin_w0),
            df32.sub(df32.div(one, df32.mul(amp, amp)), df32.df(4.0)),
        ),
        df32.scale(df32.mul(a0, a0), 4.0),
    )
    is_complex = df32.to_f32(disc4) < 0.0
    neg_disc = jnp.signbit(disc4[0])
    abs_disc = (
        jnp.where(neg_disc, -disc4[0], disc4[0]),
        jnp.where(neg_disc, -disc4[1], disc4[1]),
    )
    root = df32.sqrt(abs_disc)

    def pack(a00, a01, a10, a11, b0v, b1v, c0v, c1v):
        """Stack df scalars into df (2x2), (2,), (2,) matrices."""
        A_hi = jnp.stack([jnp.stack([a00[0], a01[0]]),
                          jnp.stack([a10[0], a11[0]])])
        A_lo = jnp.stack([jnp.stack([a00[1], a01[1]]),
                          jnp.stack([a10[1], a11[1]])])
        B_hi = jnp.stack([b0v[0], b1v[0]])
        B_lo = jnp.stack([b0v[1], b1v[1]])
        C_hi = jnp.stack([c0v[0], c1v[0]])
        C_lo = jnp.stack([c0v[1], c1v[1]])
        return A_hi, A_lo, B_hi, B_lo, C_hi, C_lo

    zero = df32.df(0.0)
    one_c = df32.df(1.0)

    def complex_branch(_):
        # adj(zI-A) B with B=[1,0] is [z - m, -q]^T, so
        # C adj B = g1 z - g1 m - g2 q  =>  g1 = c1, g2 = -(c0 + c1 m)/q.
        num = df32.add(c0, df32.mul(c1, m))
        q_safe = (jnp.maximum(root[0], jnp.float32(1e-30)), root[1])
        g2 = df32.neg(df32.div(num, q_safe))
        return pack(m, root, df32.neg(root), m, one_c, zero, c1, g2)

    def real_branch(_):
        l1 = df32.add(m, root)
        l2 = df32.sub(m, root)
        # [[l1, 1], [0, l2]], B = [1, 1], C = [g_1, g_2]:
        #   g1 (z - l2) + g1 + g2 (z - l1) = (g1 + g2) z + (g1(1 - l2) - g2 l1)
        #   => g1 (1 - l2) - g2 l1 = c0 with g2 = c1 - g1
        #   => g1 (1 - l2 + l1) = c0 + c1 l1
        denom = df32.add(df32.sub(one, l2), l1)
        g1 = df32.div(df32.add(c0, df32.mul(c1, l1)), denom)
        g2 = df32.sub(c1, g1)
        return pack(l1, one_c, zero, l2, one_c, one_c, g1, g2)

    A_hi, A_lo, B_hi, B_lo, C_hi, C_lo = jax.lax.cond(
        is_complex, complex_branch, real_branch, None
    )
    return (A_hi, A_lo), (B_hi, B_lo), (C_hi, C_lo), b0


def _compose_cascade(bands):
    """Series composition of df32 (A, B, C, D) 2-state bands -> order-2n.

    Same convention as design.biquad: y = C s_prev + D x, s = A s_prev + Bx.
    All arithmetic compensated (df32): the block-operator algebra downstream
    assumes the tables are *consistent* views of one exact system — ~1e-6 of
    independent rounding noise per table entry gets amplified by the
    resonant state magnitudes into ~1e-4 output error (measured), which is
    what capped the dynamic path at ~73 dB before.
    """
    A_acc, B_acc, C_acc, D_acc = bands[0]
    for A2, B2, C2, D2 in bands[1:]:
        d1 = A_acc[0].shape[0]
        d2 = A2[0].shape[0]
        zeros = jnp.zeros((d1, d2), jnp.float32)
        BC = df32.outer(B2, C_acc)
        A_acc = tuple(
            jnp.concatenate(
                [
                    jnp.concatenate([A_acc[i], zeros], axis=1),
                    jnp.concatenate([BC[i], A2[i]], axis=1),
                ],
                axis=0,
            )
            for i in range(2)
        )
        B_tail = df32.mul(B2, (D_acc[0][None], D_acc[1][None]))
        B_acc = tuple(jnp.concatenate([B_acc[i], B_tail[i]]) for i in range(2))
        C_head = df32.mul(C_acc, (D2[0][None], D2[1][None]))
        C_acc = tuple(jnp.concatenate([C_head[i], C2[i]]) for i in range(2))
        D_acc = df32.mul(D_acc, D2)
    return A_acc, B_acc, C_acc, D_acc


def _cumulative_powers(A, count: int):
    """df32 [I, A, A^2, ..., A^{count-1}] via log-depth associative scan."""
    d = A[0].shape[0]
    hi = jnp.broadcast_to(A[0], (count - 1, d, d))
    lo = jnp.broadcast_to(A[1], (count - 1, d, d))

    def combine(x, y):
        return df32.mmul(y, x)

    ph, pl = jax.lax.associative_scan(combine, (hi, lo))  # A^1..A^{count-1}
    eye = jnp.eye(d, dtype=jnp.float32)[None]
    zeros = jnp.zeros((1, d, d), jnp.float32)
    return (
        jnp.concatenate([eye, ph], axis=0),
        jnp.concatenate([zeros, pl], axis=0),
    )


def _dynamic_operators(gains_db: jnp.ndarray, fs: int, cfg: EQConfig,
                       U: int, G: int, K: Optional[int] = None) -> DynOperators:
    """In-graph (traced-gains) block operators for a (U, G[, K]) geometry.

    All tables are f32-rounded views of one df32-exact system (see module
    docstring).  With ``K`` given and small enough, the dense block-carry
    triangle (K d, K d) is materialized too, so the apply side solves the
    cross-block recurrence in one matmul exactly like the static path.
    """
    import numpy as np

    f32 = jnp.float32
    gains_db = jnp.asarray(gains_db, f32)
    # Reference band-skip semantics (dsp_core.py:234): |gain| <= 0.1 dB acts
    # as identity.  A zero gain IS the identity filter (b == a), so masking
    # reproduces the skip to float rounding.
    gains_db = jnp.where(
        jnp.abs(gains_db) > cfg.bypass_threshold_db, gains_db, 0.0
    )

    # Static per-band geometry (centers + Nyquist clamp are fs-dependent but
    # fs is static); gains are traced.
    centers = []
    ceiling = (fs / 2.0) * cfg.nyquist_safety
    for name, fc in cfg.band_centers:
        fc_eff = ceiling if fc >= ceiling else fc
        centers.append(fc_eff)
    w0s = [2.0 * np.pi * fc / fs for fc in centers]

    bands = [
        _band_realization(float(w0s[i]), gains_db[i])
        for i in range(len(w0s))
    ]
    # Entire operator construction in df32; only the final tables round to
    # f32, so they are f32-rounded views of ONE consistent exact system.
    A, Bv, Cv, D = _compose_cascade(bands)
    d = A[0].shape[0]
    f32 = jnp.float32

    pu = _cumulative_powers(A, U + 1)                # df (U+1, d, d)
    A_U_df = (pu[0][U], pu[1][U])
    pu_head = (pu[0][:U], pu[1][:U])
    C_b = (jnp.broadcast_to(Cv[0], (U, d)), jnp.broadcast_to(Cv[1], (U, d)))
    CA_u = df32.vecmat(C_b, pu_head)                 # df (U, d): C A^u
    group_out = df32.to_f32(CA_u).T                  # (d, U)
    pu_rev = (pu[0][U - 1::-1], pu[1][U - 1::-1])
    B_b = (jnp.broadcast_to(Bv[0], (U, d)), jnp.broadcast_to(Bv[1], (U, d)))
    group_in = df32.to_f32(df32.mvec(pu_rev, B_b))   # (U, d): A^{U-1-v} B
    # group FIR: T[u, v] = C A^{u-1-v} B (v < u), D on diagonal.
    seq = df32.to_f32(df32.dot(CA_u, B_b))           # (U,): C A^u B
    uu = jnp.arange(U)
    idx = uu[:, None] - 1 - uu[None, :]
    fir = jnp.where(idx >= 0, jnp.take(seq, jnp.clip(idx, 0, U - 1)), 0.0)
    fir = fir + df32.to_f32(D) * jnp.eye(U, dtype=f32)

    pg = _cumulative_powers(A_U_df, G + 1)           # df (G+1, d, d): (A^U)^g
    A_blk_df = (pg[0][G], pg[1][G])
    A_blk = pg[0][G] + pg[1][G]                      # A^block
    # (A^U)^g maps a block's true initial state onto group g's entry state
    # (the fused-state apply of ops/eq: s_true = s_in + A^{gU} sigma).
    pows_g = pg[0][:G] + pg[1][:G]                        # (G, d, d) f32

    # In-graph block Toeplitz (same scan-free structure as ops/eq): block
    # (v, r) holds ((A^U)^{r-v})^T; built by gathering the df-exact powers.
    toe = _lower_triangle(pows_g, G, d)

    carry_w = None
    if K is not None and 1 < K and K * d <= _CARRY_DENSE_MAX_KD:
        pk = _cumulative_powers(A_blk_df, K)              # df (K, d, d)
        carry_w = _lower_triangle(pk[0] + pk[1], K, d)    # (K d, K d)
    return DynOperators(
        group_in=group_in, group_out=group_out, fir_t=fir.T, toe=toe,
        pows_g=pows_g, A_blk=A_blk, carry_w=carry_w,
    )


def _lower_triangle(pows: jnp.ndarray, n: int, d: int) -> jnp.ndarray:
    """(n d, n d) block-Toeplitz with block (v, r) = pows[r-v]^T for v <= r.

    Row-vector convention: vecs_flat @ result accumulates pows[r-v] vecs[v]
    into slot r — the expanded lower-triangular recurrence solve.

    Construction: the tile-rotation trick.  Row group i holds, for every v,
    the band vector band_i[(r-v)*d + j] = pows[r-v][j, i] — a rotation of
    one zero-extended (2 n d)-vector by v*d.  Tiling that vector with row
    stride 2 n d - d realizes ALL n rotations as one contiguous reshape
    (f = v*stride + m  =>  f mod 2nd = m - v*d), so the whole triangle is
    plain contiguous copies plus one leading-dim transpose — no gather.
    """
    nd = n * d
    # band[i, k*d + j] = pows[k][j, i]
    band = jnp.transpose(pows, (2, 0, 1)).reshape(d, nd)
    q = jnp.concatenate([band, jnp.zeros_like(band)], axis=1)   # (d, 2nd)
    stride = 2 * nd - d
    b = jnp.tile(q, (1, n))[:, : n * stride].reshape(d, n, stride)
    t = b[:, :, :nd]                            # [i, v, (r, j)] = pows[r-v][j, i]
    return jnp.transpose(t, (1, 0, 2)).reshape(nd, nd)


def dyn_block_carry(
    e_states: jnp.ndarray,
    carry_w: Optional[jnp.ndarray],
    A_blk: jnp.ndarray,
) -> jnp.ndarray:
    """Zero-init cross-block carry sigma_{k+1} = A_blk sigma_k + e_k.

    The ONE implementation shared by the dynamic frames path, the dynamic
    cat path and the streaming super-step (a divergence between them would
    silently break the parity gates): dense-triangle matmul when the
    builder materialized ``carry_w``, else the log-depth associative scan.
    """
    f32 = jnp.float32
    d = e_states.shape[-1]
    k_axis = e_states.ndim - 2
    K = e_states.shape[k_axis]
    blead = e_states.shape[:-2]
    if K == 1:
        return jnp.zeros_like(e_states)
    if carry_w is not None:
        vecs = jnp.concatenate(
            [
                jnp.zeros(blead + (1, d), f32),
                jax.lax.slice_in_dim(e_states, 0, K - 1, axis=k_axis),
            ],
            axis=k_axis,
        )
        return einsum_f32(
            "...x,xy->...y", vecs.reshape(blead + (K * d,)), carry_w
        ).reshape(blead + (K, d))
    head = jnp.broadcast_to(jnp.eye(d, dtype=f32), blead + (1, d, d))
    tails = jnp.broadcast_to(A_blk, blead + (K - 1, d, d))
    mats = jnp.concatenate([head, tails], axis=k_axis)
    vecs = jnp.concatenate(
        [
            jnp.zeros(blead + (1, d), f32),
            jax.lax.slice_in_dim(e_states, 0, K - 1, axis=k_axis),
        ],
        axis=k_axis,
    )

    def combine(lhs, rhs):
        m1, v1 = lhs
        m2, v2 = rhs
        return (
            matmul_f32(m2, m1),
            jnp.matmul(m2, v1[..., None], precision=_HI,
                       preferred_element_type=f32)[..., 0] + v2,
        )

    _, sigma = jax.lax.associative_scan(combine, (mats, vecs), axis=k_axis)
    return sigma


def _dynamic_grouped(
    x_g: jnp.ndarray, ops: DynOperators, fast: bool = False
) -> jnp.ndarray:
    """Scan-free data path on grouped input (..., K, G, U), traced operators.

    Structurally identical to the static path (ops/eq._grouped_parts +
    _carry_states + _grouped_finish): dense-triangle carry solve where the
    builder materialized it.  Returns the corrected (unclipped) output in
    grouped form; ``fast`` runs the FIR/injection and state-solve matmuls
    at bf16x3.
    """
    y0, inj = _dyn_cat_matmul(x_g, ops, fast)
    s_in, e_states = _state_solve(inj, ops.toe, fast=fast)

    # Cross-block carry: sigma_{k+1} = A^block sigma_k + e_k, sigma_0 = 0.
    sigma = dyn_block_carry(e_states, ops.carry_w, ops.A_blk)

    # Fused-state apply: the carry rides the group_out matmul via the
    # group-entry states; FIR and state readout are split matmuls whose
    # add fuses into the second's epilogue.
    s_true = s_in + einsum_f32("gef,...kf->...kge", ops.pows_g, sigma)
    return y0 + einsum_f32("...gd,du->...gu", s_true, ops.group_out)


def dyn_cat_weights(ops: DynOperators) -> jnp.ndarray:
    """(U, U+d) traced weight concat [group_fir^T | group_in] — the
    dynamic twin of ops/eq.eq_cat_weights."""
    return jnp.concatenate([ops.fir_t, ops.group_in], axis=1)


def _dyn_cat_matmul(x_g: jnp.ndarray, ops: DynOperators, fast: bool):
    """(y0, inj) per group with traced operators (ops/eq._cat_matmul):
    one shared bf16x3 matmul in fast mode, split full-precision ones
    otherwise."""
    U = ops.group_in.shape[0]
    if fast:
        cat = einsum_prec("...gu,uv->...gv", x_g, dyn_cat_weights(ops),
                          fast=True)
        return cat[..., :U], cat[..., U:]
    return (einsum_f32("...gu,uv->...gv", x_g, ops.fir_t),
            einsum_f32("...gu,ud->...gd", x_g, ops.group_in))


@functools.partial(
    jax.jit, static_argnames=("fs", "cfg", "block", "unroll", "fast")
)
def equalize_dynamic(
    x: jnp.ndarray,
    gains_db: jnp.ndarray,
    fs: int,
    cfg: EQConfig = EQConfig(),
    block: int = 8192,
    unroll: int = 128,
    fast: bool = False,
) -> jnp.ndarray:
    """EQ with traced gains: one compile serves every gain vector.

    ``gains_db``: (n_bands,) float array, ordered like cfg.band_centers.
    Matches the static path / golden oracle to f32 rounding (tests gate
    110 dB); ``fast`` trades the output matmul to bf16x3 (~100 dB).

    Semantics vs the static ``equalize`` (see module docstring): gains with
    |g| <= 0.1 dB become ~1e-6 near-identity filters instead of the
    reference's exact skip, and the output is ALWAYS clipped to [-1, 1]
    (the static path returns the input unclipped on all-flat bypass).
    """
    assert block % unroll == 0
    f32 = jnp.float32
    x = x.astype(f32)
    U, G = unroll, block // unroll

    n = x.shape[-1]
    K = -(-n // block)
    ops = _dynamic_operators(gains_db, fs, cfg, U, G, K)
    pad = K * block - n
    xb = jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, pad)])
    x_g = xb.reshape(x.shape[:-1] + (K, G, U))
    y = _dynamic_grouped(x_g, ops, fast=fast)
    y = y.reshape(x.shape[:-1] + (K * block,))[..., :n]
    return jnp.clip(y, -1.0, 1.0)


@functools.partial(
    jax.jit, static_argnames=("fs", "cfg", "groups_per_block", "fast")
)
def equalize_dynamic_frames(
    frames: jnp.ndarray,
    gains_db: jnp.ndarray,
    fs: int,
    cfg: EQConfig = EQConfig(),
    groups_per_block: int = 128,
    fast: bool = False,
) -> jnp.ndarray:
    """Traced-gains EQ on frame-major input (..., F, P) -> frames, clipped.

    The serving fast path: combined with ops/src.resample_frames
    (AudioPipeline.jit_forward_frames_dynamic) it serves per-request gain
    changes at zero compile cost.

    Same semantics drift as ``equalize_dynamic``: no exact small-gain skip
    (near-identity filter instead) and the output is always clipped.
    """
    F = frames.shape[-2]
    G = groups_per_block
    K = -(-F // G)
    ops = _dynamic_operators(
        gains_db, fs, cfg, frames.shape[-1], G, K
    )
    return _apply_dynamic_frames(frames, ops, G, fast)


def _apply_dynamic_frames(
    frames: jnp.ndarray, ops: DynOperators, G: int, fast: bool
) -> jnp.ndarray:
    f32 = jnp.float32
    P = frames.shape[-1]
    F = frames.shape[-2]
    lead = frames.shape[:-2]
    if P != ops.group_in.shape[0]:
        raise ValueError(
            f"operators built for unroll {ops.group_in.shape[0]}, frames are {P} wide"
        )
    K = -(-F // G)
    pad = K * G - F
    x_g = jnp.pad(
        frames.astype(f32), [(0, 0)] * len(lead) + [(0, pad), (0, 0)]
    ).reshape(lead + (K, G, P))
    y = _dynamic_grouped(x_g, ops, fast=fast)
    y = y.reshape(lead + (K * G, P))[..., :F, :]
    return jnp.clip(y, -1.0, 1.0)


@functools.partial(
    jax.jit,
    static_argnames=("fs", "cfg", "unroll", "groups_per_block", "num_blocks"),
)
def build_dynamic_operators(
    gains_db: jnp.ndarray,
    fs: int,
    cfg: EQConfig = EQConfig(),
    unroll: int = 128,
    groups_per_block: int = 128,
    num_blocks: Optional[int] = None,
) -> DynOperators:
    """Traced-gains operator builder, separately jitted from the data path.

    The serving split: operator construction depends only on the gain
    vector + geometry, so run THIS when
    gains change and feed its pytree to ``equalize_dynamic_frames_ops`` per
    batch — the per-batch path is then structurally identical to the static
    fused path.  One compile serves every gain vector.

    ``num_blocks``: pass K = ceil(F / groups_per_block) to also materialize
    the dense carry triangle (required by the matmul carry solve; without
    it the apply side falls back to the associative scan).
    """
    gains_db = jnp.asarray(gains_db, jnp.float32)
    return _dynamic_operators(
        gains_db, fs, cfg, unroll, groups_per_block, num_blocks
    )


def _host_powers(A, count: int):
    """[I, A, ..., A^{count-1}] float64 via batched doubling (host numpy).

    log2(count) batched einsums instead of a count-step Python loop — the
    whole serving builder's host side stays well under a millisecond.
    """
    import numpy as np

    d = A.shape[0]
    out = np.eye(d)[None]
    while out.shape[0] < count:
        m = out.shape[0]
        take = min(m, count - m)
        head = out[-1] @ A                       # A^m
        out = np.concatenate(
            [out, np.einsum("ab,jbc->jac", head, out[:take])]
        )
    return out


@jax.jit
def _expand_dyn_operators(group_in, group_out, fir_t, pows_g, A_blk, pk):
    """Device half of the host builder: materialize the two big triangles.

    Everything else in DynOperators is a few hundred KB of host-built
    tables; only the (G d, G d) group Toeplitz and the (K d, K d) carry
    triangle are worth building on device (21 MB of redundant upload
    otherwise).  One compile serves every gain change.
    """
    d = pows_g.shape[-1]
    toe = _lower_triangle(pows_g, pows_g.shape[0], d)
    carry_w = None
    if pk is not None:
        carry_w = _lower_triangle(pk, pk.shape[0], d)
    return DynOperators(
        group_in=group_in, group_out=group_out, fir_t=fir_t, toe=toe,
        pows_g=pows_g, A_blk=A_blk, carry_w=carry_w,
    )


def build_dynamic_operators_host(
    gains_db,
    fs: int,
    cfg: EQConfig = EQConfig(),
    unroll: int = 128,
    groups_per_block: int = 128,
    num_blocks: Optional[int] = None,
) -> DynOperators:
    """Host-float64 DynOperators for CONCRETE gains — the serving builder.

    The traced builder (``build_dynamic_operators``) exists so gains can be
    jit inputs; a serving request carries concrete slider values
    (/root/reference/app.py:158-167), so the design can run as exact float64
    numpy like the static path — no df32 machinery, no device scans.  Per
    gain change this costs ~0.5 ms of small host matmuls, a ~0.5 MB upload,
    and one jitted triangle expansion on device (``_expand_dyn_operators``).

    Semantics match ``build_dynamic_operators``: all bands are kept so the
    pytree shapes — and therefore the apply-side compile — are gain-
    independent (|g| <= bypass threshold masked to an exact-identity 0 dB
    band; output always clipped by the apply).  Numerics match the static
    path: tables are consistent float64 views of the f32-quantized Schur
    system (design.biquad.block_operators' convention).

    Cost structure (bench.py decomposes it): (1) host float64 numpy table
    build (``host_dyn_tables``), (2) ~0.5 MB f32 upload, (3) one jitted
    triangle expansion on device (``_expand_dyn_operators``).
    """
    tabs = host_dyn_tables(gains_db, fs, cfg, unroll, groups_per_block,
                           num_blocks)
    return _expand_dyn_operators(*upload_dyn_tables(tabs))


def host_dyn_tables(
    gains_db,
    fs: int,
    cfg: EQConfig = EQConfig(),
    unroll: int = 128,
    groups_per_block: int = 128,
    num_blocks: Optional[int] = None,
):
    """Host-float64 half of the serving builder: the small numpy tables.

    Returns (group_in (U, d), group_out_T (d, U), fir_T (U, U),
    pows_g (G, d, d), A_blk (d, d), pk (K, d, d) | None) as float64 numpy —
    everything ``_expand_dyn_operators`` needs.  Split out so the serving
    cycle's host-compute, upload and device-dispatch costs can be measured
    independently.
    """
    import numpy as np

    from ..design.biquad import cascade_state_space, peaking_coeffs, schur_form

    g = np.asarray(gains_db, np.float64).reshape(-1).copy()
    g[np.abs(g) <= cfg.bypass_threshold_db] = 0.0
    ceiling = (fs / 2.0) * cfg.nyquist_safety
    sections = []
    for (name, fc), gain in zip(cfg.band_centers, g):
        fc_eff = ceiling if fc >= ceiling else fc
        sections.append(peaking_coeffs(fc_eff, fs, float(gain), cfg.q))
    ss = schur_form(cascade_state_space(sections))

    A32 = ss.A.astype(np.float32).astype(np.float64)
    B32 = ss.B.astype(np.float32).astype(np.float64)
    C32 = ss.C.astype(np.float32).astype(np.float64)
    D32 = float(np.float32(ss.D))
    d = ss.order
    U, G, K = unroll, groups_per_block, num_blocks

    pu = _host_powers(A32, U + 1)                       # (U+1, d, d)
    group_in = pu[U - 1 :: -1] @ B32                    # (U, d): A^{U-1-v} B
    CA_u = np.einsum("a,uab->ub", C32, pu[:U])          # (U, d): C A^u
    seq = CA_u @ B32                                    # (U,):  C A^u B
    uu = np.arange(U)
    idx = uu[:, None] - 1 - uu[None, :]
    fir = np.where(idx >= 0, seq[np.clip(idx, 0, U - 1)], 0.0)
    fir = fir + D32 * np.eye(U)
    pg = _host_powers(pu[U], G + 1)                     # (G+1, d, d): (A^U)^g
    pk = None
    if K is not None and 1 < K and K * d <= _CARRY_DENSE_MAX_KD:
        pk = _host_powers(pg[G], K)                     # (K, d, d)
    return (group_in, CA_u.T, fir.T, pg[:G], pg[G], pk)


def upload_dyn_tables(tabs):
    """f32-cast + device_put of host_dyn_tables' output (the upload phase)."""
    import jax

    f32 = jnp.float32
    group_in, out_t, fir_t, pows_g, A_blk, pk = tabs
    return (
        jax.device_put(jnp.asarray(group_in, f32)),
        jax.device_put(jnp.asarray(out_t, f32)),
        jax.device_put(jnp.asarray(fir_t, f32)),
        jax.device_put(jnp.asarray(pows_g, f32)),
        jax.device_put(jnp.asarray(A_blk, f32)),
        None if pk is None else jax.device_put(jnp.asarray(pk, f32)),
    )


class DynStreamOperators(NamedTuple):
    """DynOperators + the sharded-streaming carry tables, all traced arrays.

    ``ShardedStreamProcessor``'s super-step needs, beyond the block tables,
    the cross-shard / cross-step carry algebra of streaming.py:
      pk[k]      = (A^block)^k                   k in [0, K_loc)
      weights    = (nb, nb, d, d) cross-shard map: weights[dst, src] =
                   A_shard^{dst-1-src} for src < dst (A_shard = A^{block*K_loc})
      w_out[i]   = A_shard^{nb-1-i} — the replicated outgoing-carry weights
      pow_nb[k]  = A_shard^k for k in [0, nb] (incoming-carry propagation;
                   pow_nb[nb] feeds the outgoing carry)
    Passing THIS pytree as a jit argument (instead of baking the tables as
    compile-time constants) is what makes a mid-stream gain change free of
    recompilation: one compiled super-step serves every gain vector.
    """

    ops: DynOperators
    pk: jnp.ndarray        # (K_loc, d, d)
    weights: jnp.ndarray   # (nb, nb, d, d)
    w_out: jnp.ndarray     # (nb, d, d)
    pow_nb: jnp.ndarray    # (nb + 1, d, d)
    carry_loc: Optional[jnp.ndarray]  # (K_loc d, K_loc d) local carry
    #   triangle mapping [0, e_0..e_{K-2}] -> [sigma_0..sigma_{K-1}]
    #   (ops/eq._carry_weights layout); None when K_loc == 1.


def build_dynamic_stream_operators_host(
    gains_db,
    fs: int,
    cfg: EQConfig = EQConfig(),
    unroll: int = 128,
    groups_per_block: int = 128,
    num_blocks: int = 1,
    num_shards: int = 1,
) -> DynStreamOperators:
    """Host-float64 streaming operators for CONCRETE gains.

    The serving model (/root/reference/app.py:158-167 generalized to
    long-form): a slider move mid-stream builds THIS pytree (~ms of host
    float64 numpy + a small upload).  ``ShardedStreamProcessor.set_gains``
    is the public entry point — it calls this builder and swaps the
    operators at the next super-step boundary with no recompile; the carry
    state sigma passes through the change un-reset (the live-lfilter
    semantics: filter state persists across a coefficient change; see
    streaming.py).

    ``num_blocks`` = K_loc (EQ blocks per shard), ``num_shards`` = nb
    (block-axis mesh size).  All tables are float64-exact views of the
    f32-quantized Schur system, like ``build_dynamic_operators_host``.
    """
    import numpy as np

    from ..design.biquad import cascade_state_space, peaking_coeffs, schur_form

    g = np.asarray(gains_db, np.float64).reshape(-1).copy()
    g[np.abs(g) <= cfg.bypass_threshold_db] = 0.0
    ceiling = (fs / 2.0) * cfg.nyquist_safety
    sections = []
    for (name, fc), gain in zip(cfg.band_centers, g):
        fc_eff = ceiling if fc >= ceiling else fc
        sections.append(peaking_coeffs(fc_eff, fs, float(gain), cfg.q))
    ss = schur_form(cascade_state_space(sections))

    A32 = ss.A.astype(np.float32).astype(np.float64)
    B32 = ss.B.astype(np.float32).astype(np.float64)
    C32 = ss.C.astype(np.float32).astype(np.float64)
    D32 = float(np.float32(ss.D))
    d = ss.order
    U, G, K, nb = unroll, groups_per_block, num_blocks, num_shards

    pu = _host_powers(A32, U + 1)
    group_in = pu[U - 1 :: -1] @ B32
    CA_u = np.einsum("a,uab->ub", C32, pu[:U])
    seq = CA_u @ B32
    uu = np.arange(U)
    idx = uu[:, None] - 1 - uu[None, :]
    fir = np.where(idx >= 0, seq[np.clip(idx, 0, U - 1)], 0.0)
    fir = fir + D32 * np.eye(U)
    pg = _host_powers(pu[U], G + 1)                     # (A^U)^0..G
    A_blk = pg[G]                                       # A^block
    pk = _host_powers(A_blk, K)                         # (K, d, d)
    A_shard = np.linalg.matrix_power(A_blk, K)          # A^{block*K}
    pow_nb = _host_powers(A_shard, nb + 1)              # (nb+1, d, d)
    weights = np.zeros((nb, nb, d, d))
    for dst in range(nb):
        for srcd in range(dst):
            weights[dst, srcd] = pow_nb[dst - 1 - srcd]
    w_out = np.stack([pow_nb[nb - 1 - i] for i in range(nb)])
    carry_loc = None
    if K > 1:
        WT = np.zeros((K, d, K, d))
        for k in range(K):
            for j in range(k + 1):
                WT[j, :, k, :] = pk[k - j].T
        carry_loc = WT.reshape(K * d, K * d)

    f32 = jnp.float32
    ops = _expand_dyn_operators(
        jnp.asarray(group_in, f32),
        jnp.asarray(CA_u.T, f32),
        jnp.asarray(fir.T, f32),
        jnp.asarray(pg[:G], f32),
        jnp.asarray(A_blk, f32),
        None,
    )
    return DynStreamOperators(
        ops=ops,
        pk=jnp.asarray(pk, f32),
        weights=jnp.asarray(weights, f32),
        w_out=jnp.asarray(w_out, f32),
        pow_nb=jnp.asarray(pow_nb, f32),
        carry_loc=None if carry_loc is None else jnp.asarray(carry_loc, f32),
    )


@functools.partial(jax.jit, static_argnames=("groups_per_block", "fast"))
def equalize_dynamic_frames_ops(
    frames: jnp.ndarray,
    ops: DynOperators,
    groups_per_block: int = 128,
    fast: bool = False,
) -> jnp.ndarray:
    """Frame-major EQ apply with prebuilt dynamic operators — the per-batch
    half of the serving split (see build_dynamic_operators).  Matches
    equalize_dynamic_frames(frames, gains, ...) exactly when ``ops`` came
    from the same gains/geometry — including its semantics drift vs the
    static path (no exact small-gain skip; output always clipped).
    """
    return _apply_dynamic_frames(frames, ops, groups_per_block, fast)


# ---- dynamic-gains cat serving ---------------------------------------------
#
# The static chain folds the EQ's weight-concat matmul into the SRC operator
# on the host (ops/src.fold_operator).  With traced gains the same fold runs
# on device once per gain change — G (W, P) @ dyn_cat_weights (P, P+d), a
# few hundred KB — and per batch the chain runs the static cat structure.


def equalize_dynamic_cat_ops(
    y0_frames: jnp.ndarray,
    inj_frames: jnp.ndarray,
    ops: DynOperators,
    fast: bool = False,
) -> jnp.ndarray:
    """EQ finish on the cat SRC's emission with TRACED operators.

    The dynamic twin of ops/eq.equalize_frames_cat: y0 (..., F, U) and inj
    (..., F, d) come straight off ops/src.resample_frames_cat with the
    operator folded from the SAME DynOperators, so only the group-Toeplitz
    solve + carry + readout run here.  Semantics match
    equalize_dynamic_frames_ops on the raw frames (gated in
    tests/test_cat_chain.py).
    """
    d = ops.group_in.shape[-1]
    U = ops.group_in.shape[0]
    G = ops.toe.shape[0] // d
    F = y0_frames.shape[-2]
    if F % G:
        raise ValueError(f"frame count {F} not a multiple of {G}")
    K = F // G
    if inj_frames.shape[-2:] != (F, d):
        raise ValueError(f"inj shape {inj_frames.shape[-2:]} != {(F, d)}")
    lead = y0_frames.shape[:-2]
    y0 = y0_frames.reshape(lead + (K, G, U))
    s_in, e_states = _state_solve(
        inj_frames.reshape(lead + (K, G, d)), ops.toe, fast=fast
    )
    sigma = dyn_block_carry(e_states, ops.carry_w, ops.A_blk)
    s_true = s_in + einsum_f32("gef,...kf->...kge", ops.pows_g, sigma)
    z = y0 + einsum_f32("...gd,du->...gu", s_true, ops.group_out)
    return jnp.clip(z.reshape(lead + (F, U)), -1.0, 1.0)
