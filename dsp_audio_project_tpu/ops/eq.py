"""6-band biquad EQ as a block-parallel state-space recurrence.

The reference applies each active band through ``scipy.signal.lfilter`` — a
strictly sequential per-sample recurrence — six times in series
(dsp_core.py:216-254).  A sample-sequential loop is the worst program shape
for a data-parallel accelerator, so the cascade is restructured:

1.  **Design time (host, float64).**  The active bands (after the reference's
    bypass/Nyquist-clamp rules, encoded in ``EQConfig.active_bands``) are
    composed into ONE order-2*n_bands state-space system
        s[n] = A s[n-1] + B x[n],   y[n] = C s[n-1] + D x[n]
    (``design.biquad``), so the six serial passes become one.

2.  **Block parallelism (device).**  The signal is cut into K blocks of
    ``block`` samples.  Every block runs the recurrence from a ZERO initial
    state simultaneously — vectorized across the K blocks — producing
    provisional outputs y0 and per-block end states e_k.

3.  **Carry fix-up.**  True block-initial states obey the *block-level*
    recurrence sigma_{k+1} = A^block sigma_k + e_k, solved with a log-depth
    associative scan over K tiny (d,d)+(d,) elements.  Because A^block is
    strongly contracting for audio-rate poles, this scan is well-conditioned
    where a naive per-sample companion-matrix scan is not (SURVEY.md §7
    "hard parts" #1).

4.  **Correction.**  y[k, j] += (C A^j) sigma_k — one (K,d) x (d,block)
    matmul, using host-precomputed correction rows.

The result equals the sequential recurrence to float32 rounding (no
associative-scan-over-samples cancellation), and every stage is a large,
static-shaped, fusable XLA op.  Final hard clip to [-1, 1] per
dsp_core.py:254; whole-EQ bypass returns the input untouched *and unclipped*
per dsp_core.py:222-223.
"""
from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import EQConfig
from ..utils.precision import (
    einsum_f32, einsum_prec, matmul_f32, matvec_f32, vecmat_f32,
)
from ..design.biquad import (
    schur_form,
    BlockOperators,
    block_operators,
    cascade_state_space,
    peaking_coeffs,
)


@functools.lru_cache(maxsize=None)
def make_block_operators(
    bands: Tuple[Tuple[float, float], ...], fs: int, q: float, block: int,
    unroll: int = 16,
) -> BlockOperators:
    """Compose active (fc, gain_db) bands at rate fs into block operators."""
    sections = [peaking_coeffs(fc, fs, gain, q) for fc, gain in bands]
    ss = schur_form(cascade_state_space(sections))
    return block_operators(ss, block, unroll)


def _cat_matmul(
    x_g: jnp.ndarray, ops: BlockOperators, fast: bool = False
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """(y0, inj) per group of (..., K, G, U) input: the zero-state group
    output x_g @ group_fir^T and the state injection x_g @ group_in.

    In fast mode both share ONE bf16x3 matmul against the weight concat
    [group_fir^T | group_in] (eq_cat_weights), so the input is read once.
    Full precision keeps them split: inj must stay full float32, and a
    full-precision concat would widen the FIR matmul for nothing.
    """
    f32 = jnp.float32
    U = ops.unroll
    if fast:
        cat = einsum_prec("...gu,uv->...gv", x_g,
                          jnp.asarray(eq_cat_weights(ops), dtype=f32),
                          fast=True)
        return cat[..., :U], cat[..., U:]
    inj = einsum_f32("...gu,ud->...gd", x_g,
                     jnp.asarray(ops.group_in, dtype=f32))
    y0 = einsum_f32("...gu,uv->...gv", x_g,
                    jnp.asarray(ops.group_fir.T, dtype=f32))
    return y0, inj


def _state_solve(
    inj: jnp.ndarray, toe: jnp.ndarray, fast: bool = False
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Zero-init group-entry states from per-group injections.

    ``inj`` (..., K, G, d); ``toe`` the (G d, G d) group Toeplitz.  Returns
    (s_in (..., K, G, d): the state entering each group from a zero block
    start, end_states (..., K, d)).  The solve is one matmul; in fast mode
    it runs bf16x3 — unlike operator CONSTRUCTION (where rounding is
    resonance-amplified) this application matmul is numerically benign.
    """
    f32 = jnp.float32
    G, d = inj.shape[-2:]
    lead = inj.shape[:-2]
    s_tail = einsum_prec(
        "...x,xy->...y", inj.reshape(lead + (G * d,)),
        jnp.asarray(toe, dtype=f32), fast=fast,
    ).reshape(lead + (G, d))                                  # s_1..s_G
    end_states = s_tail[..., G - 1, :]
    s_in = jnp.concatenate(
        [jnp.zeros(lead + (1, d), f32), s_tail[..., : G - 1, :]], axis=-2
    )
    return s_in, end_states


def _grouped_parts(
    x_g: jnp.ndarray, ops: BlockOperators, fast: bool = False
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """State pass on grouped input (..., K, G, U): (y0, s_in, end_states).

    Split BEFORE the carry solve, for callers that must inject a
    cross-shard sigma0 between the passes (parallel/pipeline, streaming).
    """
    y0, inj = _cat_matmul(x_g, ops, fast=fast)
    s_in, end_states = _state_solve(inj, ops.group_toeplitz, fast=fast)
    return y0, s_in, end_states


def _grouped_run(
    x_g: jnp.ndarray,
    ops: BlockOperators,
    sigma0: jnp.ndarray | None = None,
    fast: bool = False,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """One full grouped EQ pass: (y unclipped, end_states, sigma)."""
    y0, s_in, end_states = _grouped_parts(x_g, ops, fast=fast)
    sigma = _carry_states(end_states, ops, sigma0)
    return _grouped_finish(y0, s_in, sigma, ops), end_states, sigma


def _grouped_finish(
    y0: jnp.ndarray,
    s_in: jnp.ndarray,
    sigma: jnp.ndarray,
    ops: BlockOperators,
) -> jnp.ndarray:
    """Output pass once the true block-initial states sigma are known.

    The true state entering group g of block k is s_in[k,g] + A^{gU}
    sigma[k], so y = y0 + s_true @ group_out.
    """
    gPows = jnp.asarray(ops.group_pows, dtype=jnp.float32)
    s_true = s_in + einsum_f32("gef,...kf->...kge", gPows, sigma)
    return y0 + einsum_f32(
        "...gd,du->...gu", s_true,
        jnp.asarray(ops.group_out, dtype=jnp.float32),
    )


def eq_cat_weights(ops: BlockOperators) -> np.ndarray:
    """(U, U+d) float64 weight concat [group_fir^T | group_in].

    cat = x_g @ w_cat yields [y0 | inj] per group.  The fused chain folds
    it into the SRC operator (ops/src.fold_operator); float64 so that the
    host composition G @ w_cat is exact before the single quantization.
    """
    return np.concatenate(
        [ops.group_fir.T.astype(np.float64),
         ops.group_in.astype(np.float64)], axis=1
    )


def equalize_frames_cat(
    y0_frames: jnp.ndarray,
    inj_frames: jnp.ndarray,
    fs: int,
    cfg: EQConfig,
    unroll: int,
    groups_per_block: int = 128,
    fast: bool = False,
    rows: Tuple[int, int] | None = None,
):
    """EQ finish on the cat SRC's emission (ops/src.resample_frames_cat).

    ``y0_frames`` (..., F, U) = frames @ group_fir^T and ``inj_frames``
    (..., F, d) = frames @ group_in.  Only the group-Toeplitz state solve,
    the block carry and the readout remain here; the output equals
    equalize_frames on the raw frames (gated in tests/test_cat_chain.py).
    F must be a multiple of ``groups_per_block`` (resample_frames with
    pad_frames guarantees it).

    ``rows=(r0, r1)``: also return the clipped output rows [r0, r1) as a
    small side tensor recomputed from row slices of y0 and the states —
    the spectra consumer's path, so the full-size output fusion is never
    sliced.
    """
    bands = cfg.active_bands(fs)
    if cfg.bypass or not bands:
        raise ValueError("cat path requires an active EQ "
                         "(fold happens against its operators)")
    U = unroll
    G = groups_per_block
    F = y0_frames.shape[-2]
    if F % G:
        raise ValueError(f"frame count {F} not a multiple of {G}")
    K = F // G
    d = 2 * len(bands)
    if y0_frames.shape[-1] != U:
        raise ValueError(f"y0 width {y0_frames.shape[-1]} != unroll {U}")
    if inj_frames.shape[-2:] != (F, d):
        raise ValueError(
            f"inj shape {inj_frames.shape[-2:]} != {(F, d)}"
        )
    ops = make_block_operators(bands, int(fs), cfg.q, G * U, U)
    f32 = jnp.float32
    lead = y0_frames.shape[:-2]
    y0 = y0_frames.reshape(lead + (K, G, U))
    s_in, end_states = _state_solve(
        inj_frames.reshape(lead + (K, G, d)), ops.group_toeplitz, fast=fast
    )
    sigma = _carry_states(end_states, ops)
    z = jnp.clip(
        _grouped_finish(y0, s_in, sigma, ops), -1.0, 1.0
    ).reshape(lead + (F, U))
    if rows is None:
        return z
    # Side rows for the spectra consumer.  Recompute the ~13 rows' states
    # from s_in/end_states slices + tiny sigma gathers instead of slicing
    # s_true, which would force the full (K, G, d) s_true out of the final
    # fusion as a copy.
    r0, r1 = rows
    idx = np.arange(r0, r1)
    y0_rows = y0_frames[..., r0:r1, :]
    # Flat s_tail rows: s_in[k, 1:] are s_tail[k, :G-1]; end_states close
    # each block — together they reconstruct s_tail without new compute.
    st_flat = jnp.concatenate(
        [s_in[..., 1:, :], end_states[..., None, :]], axis=-2
    ).reshape(lead + (F, d))
    lo = max(r0 - 1, 0)
    sin_rows = st_flat[..., lo : r1 - 1, :]
    if r0 == 0:
        sin_rows = jnp.concatenate(
            [jnp.zeros(lead + (1, d), f32), sin_rows], axis=-2
        )
    # s_in semantics: zero at block starts (r % G == 0).
    mask = jnp.asarray(1.0 - (idx % G == 0).astype(np.float32))[:, None]
    sin_rows = sin_rows * mask
    sig_rows = jnp.take(sigma, jnp.asarray((idx // G).astype(np.int32)),
                        axis=-2)
    gp_rows = jnp.asarray(ops.group_pows[idx % G].astype(np.float32))
    st_rows = sin_rows + einsum_f32("ref,...rf->...re", gp_rows, sig_rows)
    gOut = jnp.asarray(ops.group_out, dtype=f32)
    z_rows = jnp.clip(
        y0_rows + einsum_f32("...gd,du->...gu", st_rows, gOut), -1.0, 1.0
    )
    return z, z_rows


# Below this K the carry solve is ONE dense (K d, K d) matmul against a
# host-precomputed weight triangle; above it, the log-depth scan.  The scan
# compiles to dozens of tiny (d, d) ops, each paying a fixed per-op cost,
# while the matmul is one op and the weight table stays small (K=512,
# d=12 -> 151 MB is the ceiling; typical chains sit at K<=352 / d<=10 ->
# <50 MB).
_CARRY_ALLPAIRS_MAX = 512
_carry_weight_cache: dict = {}


def _carry_weights(ops: BlockOperators, K: int) -> jnp.ndarray:
    """(K d, K d) float32 map from [sigma0, e_0..e_{K-2}] to [sigma_0..sigma_{K-1}].

    WT[(j, jj), (k, dd)] = (A^block)^{k-j}[dd, jj] for j <= k, else 0 — the
    expanded block recurrence sigma_k = A^{bk} sigma0 + sum A^{b(k-1-i)} e_i.
    Cached per (ops, K); BlockOperators instances are lru-cache singletons
    (make_block_operators), so id() is a stable key.
    """
    key = (id(ops), K)
    w = _carry_weight_cache.get(key)
    if w is None:
        d = ops.A.shape[0]
        Ab = ops.state_corr.astype(np.float64)
        pows = np.zeros((K, d, d))
        acc = np.eye(d)
        for p in range(K):
            pows[p] = acc
            acc = acc @ Ab
        WT = np.zeros((K, d, K, d))
        for k in range(K):
            for j in range(k + 1):
                WT[j, :, k, :] = pows[k - j].T
        w = np.asarray(WT.reshape(K * d, K * d), dtype=np.float32)
        _carry_weight_cache[key] = w
    return w


def _carry_states(
    end_states: jnp.ndarray,
    ops: BlockOperators,
    sigma0: jnp.ndarray | None = None,
) -> jnp.ndarray:
    """True initial state per block: sigma_{k+1} = A^block sigma_k + e_k.

    sigma_0 = sigma0 (zero by default).  For K <= _CARRY_ALLPAIRS_MAX the
    whole triangular solve is one matmul (see _carry_weights); larger K
    falls back to a log-depth associative scan over (M, v) pairs under
    (M2,v2)o(M1,v1) = (M2 M1, M2 v1 + v2), scanning inclusively over
    [(I, sigma0), (A^block, e_0), ..., (A^block, e_{K-2})] so position k
    yields sigma_k directly — which is also how a shard's incoming carry
    state enters the sharded pipeline.
    """
    d = end_states.shape[-1]
    k_axis = end_states.ndim - 2
    K = end_states.shape[k_axis]
    A_blk = jnp.asarray(ops.state_corr, dtype=jnp.float32)
    if sigma0 is None:
        sigma0 = jnp.zeros(end_states.shape[:-2] + (d,), dtype=jnp.float32)

    if K <= _CARRY_ALLPAIRS_MAX:
        lead = end_states.shape[:-2]
        vecs = jnp.concatenate(
            [
                sigma0[..., None, :],
                jax.lax.slice_in_dim(end_states, 0, K - 1, axis=k_axis),
            ],
            axis=k_axis,
        )
        w = jnp.asarray(_carry_weights(ops, K))
        sig = einsum_f32("...x,xy->...y", vecs.reshape(lead + (K * d,)), w)
        return sig.reshape(lead + (K, d))

    head_mat = jnp.broadcast_to(
        jnp.eye(d, dtype=jnp.float32), end_states.shape[:-2] + (1, d, d)
    )
    tail_mats = jnp.broadcast_to(
        A_blk, end_states.shape[:-2] + (K - 1, d, d)
    )
    mats = jnp.concatenate([head_mat, tail_mats], axis=k_axis)
    vecs = jnp.concatenate(
        [sigma0[..., None, :], jax.lax.slice_in_dim(end_states, 0, K - 1, axis=k_axis)],
        axis=k_axis,
    )

    def combine(left, right):
        m1, v1 = left
        m2, v2 = right
        return matmul_f32(m2, m1), matvec_f32(m2, v1) + v2

    _, sig = jax.lax.associative_scan(combine, (mats, vecs), axis=k_axis)
    return sig


@functools.partial(
    jax.jit, static_argnames=('fs', 'cfg', 'block', 'unroll', 'fast')
)
def equalize(x: jnp.ndarray, fs: int, cfg: EQConfig, block: int = 8192,
             unroll: int = 128, fast: bool = False) -> jnp.ndarray:
    """Apply the EQ cascade to (..., N) float32 signals.

    Matches the golden oracle (sequential lfilter cascade) to float32
    rounding; see tests/test_eq.py for the SNR gate.  Jit-compiled per
    (fs, config, block, unroll, shape).  ``fast`` trades the output FIR
    and state-solve matmuls down to bf16x3 (utils.precision.FAST).
    """
    if cfg.bypass:
        return x
    bands = cfg.active_bands(fs)
    if not bands:
        # Active request but every band clamped away: reference still clips.
        return jnp.clip(x, -1.0, 1.0)
    ops = make_block_operators(bands, int(fs), cfg.q, block, unroll)
    y = _equalize_blocks(x.astype(jnp.float32), ops, fast=fast)
    return jnp.clip(y, -1.0, 1.0)


def equalize_frames(
    frames: jnp.ndarray,
    fs: int,
    cfg: EQConfig,
    groups_per_block: int = 128,
    fast: bool = False,
) -> jnp.ndarray:
    """EQ on frame-major input (..., F, P) -> frame-major output, clipped.

    The fused SRC->EQ handoff: ops/src.resample_frames emits P-wide frames,
    and this path consumes them with unroll = P and block = G*P so that
    every reshape between the two stages (and inside the EQ) is a free
    leading-axis regroup — no relayout anywhere.  The flat signal is frames.reshape(..., F*P) — a zero-cost view on host.

    Semantics identical to ``equalize`` on the flattened signal (same
    operators, same carry algebra; zero-padded tail blocks sliced off).
    """
    if cfg.bypass:
        return frames
    P = frames.shape[-1]
    F = frames.shape[-2]
    bands = cfg.active_bands(fs)
    if not bands:
        return jnp.clip(frames, -1.0, 1.0)
    G = groups_per_block
    ops = make_block_operators(bands, int(fs), cfg.q, G * P, P)
    lead = frames.shape[:-2]
    K = -(-F // G)
    pad = K * G - F
    x_g = jnp.pad(
        frames.astype(jnp.float32),
        [(0, 0)] * len(lead) + [(0, pad), (0, 0)],
    ).reshape(lead + (K, G, P))
    y, _, _ = _grouped_run(x_g, ops, fast=fast)
    y = y.reshape(lead + (K * G, P))[..., :F, :]
    return jnp.clip(y, -1.0, 1.0)


def _equalize_blocks(
    x: jnp.ndarray,
    ops: BlockOperators,
    sigma0: jnp.ndarray | None = None,
    with_state: bool = False,
    fast: bool = False,
):
    """Block-parallel recurrence over (..., N).

    ``sigma0``: optional incoming state (..., d) — a shard's carry.
    ``with_state``: also return the state after sample N.  Requires N to be a
    multiple of ``ops.block`` (zero-pad blocks would corrupt the carry);
    callers in the sharded path align shard lengths accordingly.
    """
    n = x.shape[-1]
    block = ops.block
    K = -(-n // block)
    pad = K * block - n
    if with_state and pad:
        raise ValueError(
            f"state carry requires length {n} to be a multiple of block {block}"
        )
    xb = jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, pad)])
    U = ops.unroll
    G = block // U
    x_g = xb.reshape(x.shape[:-1] + (K, G, U))

    y, end_states, sigma = _grouped_run(x_g, ops, sigma0, fast=fast)
    y = y.reshape(x.shape[:-1] + (K * block,))[..., :n]
    if not with_state:
        return y
    A_blk = jnp.asarray(ops.state_corr, dtype=jnp.float32)
    s_end = matvec_f32(A_blk, sigma[..., -1, :]) + end_states[..., -1, :]
    return y, s_end


@functools.partial(jax.jit, static_argnames=('fs', 'cfg', 'block'))
def equalize_stream(
    x: jnp.ndarray,
    fs: int,
    cfg: EQConfig,
    state: jnp.ndarray | None = None,
    block: int = 1024,
):
    """Streaming EQ: process a chunk, return (y, carry_state).

    Feeding chunks of any sizes through this function produces the same
    samples as one ``equalize`` call on the concatenation — the carry is the
    cascade's full internal state (2 values per active band), which together
    with a stream offset makes long-form processing checkpointable/resumable
    (SURVEY.md §5).  Note the chunk outputs are clipped per-call exactly like
    the one-shot path clips once; clipping is memoryless so the results agree.

    The carry lives in the (Schur) realization basis of this config — treat
    it as opaque: serialize and hand it back, don't interpret it.
    """
    if cfg.bypass:
        return x, jnp.zeros(x.shape[:-1] + (0,), dtype=jnp.float32)
    bands = cfg.active_bands(fs)
    if not bands:
        return jnp.clip(x, -1.0, 1.0), jnp.zeros(
            x.shape[:-1] + (0,), dtype=jnp.float32
        )
    ops = make_block_operators(bands, int(fs), cfg.q, block)
    d = ops.A.shape[0]
    if state is None:
        state = jnp.zeros(x.shape[:-1] + (d,), dtype=jnp.float32)
    x = x.astype(jnp.float32)
    n = x.shape[-1]
    K_full = n // block
    y_parts = []
    if K_full:
        head = x[..., : K_full * block]
        y_head, state = _equalize_blocks(head, ops, sigma0=state, with_state=True)
        y_parts.append(y_head)
    tail = x[..., K_full * block :]
    if tail.shape[-1]:
        # Ragged remainder: exact sequential propagation (short by design).
        A = jnp.asarray(ops.A.T, dtype=jnp.float32)
        B = jnp.asarray(ops.B, dtype=jnp.float32)
        C = jnp.asarray(ops.C, dtype=jnp.float32)
        D = jnp.float32(ops.D)

        def step(s, x_j):
            y = vecmat_f32(s, C[:, None])[..., 0] + D * x_j
            return vecmat_f32(s, A) + x_j[..., None] * B, y

        state, y_t = jax.lax.scan(step, state, jnp.moveaxis(tail, -1, 0))
        y_parts.append(jnp.moveaxis(y_t, 0, -1))
    y = y_parts[0] if len(y_parts) == 1 else jnp.concatenate(y_parts, axis=-1)
    return jnp.clip(y, -1.0, 1.0), state


def final_state(x: jnp.ndarray, fs: int, cfg: EQConfig, block: int = 1024):
    """End state of the cascade after consuming ``x`` (see equalize_stream)."""
    _, s = equalize_stream(x, fs, cfg, None, block)
    return s
