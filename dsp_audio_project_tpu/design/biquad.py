"""Peaking-EQ biquad design and state-space machinery (host-side, float64).

The coefficient recipe matches the reference's bilinear-transform peaking EQ
(dsp_core.py:179-203): w0 = 2*pi*fc/fs, alpha = sin(w0)/(2*Q) with Q fixed at
1.0, A = 10^(gain_db/40), b = [1+aA, -2cos w0, 1-aA], a = [1+a/A, -2cos w0,
1-a/A], normalized to a0 = 1.

The reference runs each biquad through ``scipy.signal.lfilter`` — a strictly
sequential direct-form-II-transposed recurrence (dsp_core.py:205-214).  Here
the whole 6-band cascade is restructured here as a single order-2*n_bands
state-space system:

    s[n] = A s[n-1] + B x[n]        y[n] = C s[n-1] + D x[n]

(the C-on-previous-state convention falls straight out of DF2T and composes
cleanly).  ``block_operators`` then precomputes everything the device's
block-parallel recurrence needs: the in-block correction rows C A^j and the
block-to-block transition A^block.  All of it is float64 on host; the device
only ever sees float32 constants.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np


def peaking_coeffs(
    fc: float, fs: float, gain_db: float, q: float = 1.0
) -> Tuple[np.ndarray, np.ndarray]:
    """RBJ-style peaking-EQ biquad (b, a), a0 normalized to 1 (float64)."""
    w0 = 2.0 * np.pi * fc / fs
    alpha = np.sin(w0) / (2.0 * q)
    amp = 10.0 ** (gain_db / 40.0)
    cos_w0 = np.cos(w0)
    b = np.array([1.0 + alpha * amp, -2.0 * cos_w0, 1.0 - alpha * amp])
    a = np.array([1.0 + alpha / amp, -2.0 * cos_w0, 1.0 - alpha / amp])
    b = b / a[0]
    a = a / a[0]
    return b, a


@dataclasses.dataclass(frozen=True)
class StateSpace:
    """y[n] = C s[n-1] + D x[n];  s[n] = A s[n-1] + B x[n].  All float64."""

    A: np.ndarray  # (d, d)
    B: np.ndarray  # (d,)
    C: np.ndarray  # (d,)
    D: float

    @property
    def order(self) -> int:
        return self.A.shape[0]


def biquad_state_space(b: np.ndarray, a: np.ndarray) -> StateSpace:
    """DF2T realization of one normalized biquad as a 2-state system.

    DF2T recurrence (what scipy.signal.lfilter computes with zero zi):
        y[n]  = b0 x[n] + z1[n-1]
        z1[n] = b1 x[n] - a1 y[n] + z2[n-1]
        z2[n] = b2 x[n] - a2 y[n]
    Substituting y[n] gives the state form used here.
    """
    b0, b1, b2 = (float(v) for v in b)
    _, a1, a2 = (float(v) for v in a)
    A = np.array([[-a1, 1.0], [-a2, 0.0]])
    B = np.array([b1 - a1 * b0, b2 - a2 * b0])
    C = np.array([1.0, 0.0])
    return StateSpace(A=A, B=B, C=C, D=b0)


def identity_state_space() -> StateSpace:
    """Order-0 pass-through (used when the EQ has no active bands)."""
    z = np.zeros((0, 0))
    v = np.zeros((0,))
    return StateSpace(A=z, B=v, C=v, D=1.0)


def series(first: StateSpace, second: StateSpace) -> StateSpace:
    """Series composition: x -> first -> second -> y (same conventions)."""
    d1, d2 = first.order, second.order
    A = np.zeros((d1 + d2, d1 + d2))
    A[:d1, :d1] = first.A
    A[d1:, d1:] = second.A
    A[d1:, :d1] = np.outer(second.B, first.C)
    B = np.concatenate([first.B, second.B * first.D])
    C = np.concatenate([second.D * first.C, second.C])
    return StateSpace(A=A, B=B, C=C, D=second.D * first.D)


def cascade_state_space(
    sections: Sequence[Tuple[np.ndarray, np.ndarray]]
) -> StateSpace:
    """Fold a list of (b, a) biquads (in application order) into one system."""
    ss = identity_state_space()
    for b, a in sections:
        ss = series(ss, biquad_state_space(b, a))
    return ss


def schur_form(ss: StateSpace) -> StateSpace:
    """Orthogonally-similar realization with a quasi-triangular A.

    Why: the DF2T companion form is float32-hostile — quantizing
    a1 = -2 cos(w0) perturbs low-frequency pole pairs by
    ~eps * |a1| / (2 sqrt|disc|) (a ~100x amplification for a 40 Hz band at
    44.1 kHz), which alone costs ~45 dB of output SNR near resonance.  A real
    Schur decomposition A = Q T Q^T stores every pole on a standardized 2x2
    diagonal block where quantization moves eigenvalues by a *relative* eps,
    and the orthogonal basis change leaves B/C magnitudes untouched.
    """
    if ss.order == 0:
        return ss
    import scipy.linalg as sla

    T, Q = sla.schur(ss.A, output="real")
    return StateSpace(A=T, B=Q.T @ ss.B, C=ss.C @ Q, D=ss.D)


@dataclasses.dataclass(frozen=True, eq=False)
class BlockOperators:
    """Precomputed operators for the block-parallel IIR recurrence.

    For block length L and state dim d (all float64, cast to f32 at the op):
      * ``A``, ``B``, ``C``, ``D``  — the per-sample system.
      * ``corr``      (L, d): row j is C A^j — output correction for a block
        whose true initial state is sigma: y_true[j] = y_zeroinit[j] + corr[j] @ sigma.
      * ``state_corr`` (d, d): A^L — propagates a block's initial state to its
        contribution to the end state: s_end = A^L sigma + s_end_zeroinit.

    Group (unrolled) operators — U consecutive samples advance in ONE set of
    small matmuls instead of U scan steps (each sequential step pays a fixed
    per-step cost on an accelerator, so shrinking step count B -> B/U is the
    single biggest IIR latency lever):
      * ``unroll``  U  (divides ``block``).
      * ``group_A`` (d, d):  A^U.
      * ``group_in`` (U, d): row v is (A^{U-1-v} B)^T — state injection.
      * ``group_out`` (d, U): column u is (C A^u)^T — state readout.
      * ``group_fir`` (U, U): [u, v] = C A^{u-1-v} B for v < u, D on the
        diagonal — the within-group input->output (FIR) coupling.
    Exactness: y[u] = C A^u s + sum_{v<u} C A^{u-1-v} B x_v + D x_u and
    s' = A^U s + sum_v A^{U-1-v} B x_v are identities of the recurrence.
    """

    A: np.ndarray
    B: np.ndarray
    C: np.ndarray
    D: float
    corr: np.ndarray
    state_corr: np.ndarray
    block: int
    unroll: int
    group_A: np.ndarray
    group_in: np.ndarray
    group_out: np.ndarray
    group_fir: np.ndarray
    # (G*d, G*d) with G = block//unroll: block-Toeplitz map from the G group
    # injections inj_v to the states [s_1..s_G] — block (v, r) is
    # (A^U)^{r-v} for v <= r, zero above.  Lets the within-block state
    # evolution run as ONE matmul instead of a G-step lax.scan (whose
    # per-step while-loop overhead would dominate the EQ).
    group_toeplitz: np.ndarray
    # (G, d, d): A^{g*U} for g = 0..G-1 — maps a block's true initial state
    # onto each group's entry state (s_true[g] = s_in[g] + A^{gU} sigma), so
    # the block correction rides the SAME group_out matmul as the zero-init
    # term instead of a second full-width (block, d) correction matmul.
    group_pows: np.ndarray


def block_operators(ss: StateSpace, block: int, unroll: int = 16) -> BlockOperators:
    """Build block operators from the float32-QUANTIZED system.

    The device propagates states with float32 A/B/C/D; computing the
    correction operators in float64 from those same quantized values keeps
    the fix-up exactly consistent with the in-block recurrence — the realized
    filter is then "the f32-rounded system", whose response deviation from
    ideal is a benign relative-eps pole shift (given a Schur-form A).
    """
    A32 = ss.A.astype(np.float32).astype(np.float64)
    B32 = ss.B.astype(np.float32).astype(np.float64)
    C32 = ss.C.astype(np.float32).astype(np.float64)
    D32 = float(np.float32(ss.D))
    d = ss.order
    corr = np.zeros((block, d))
    Apow = np.eye(d)
    pows = []  # A^j for j = 0..block
    for j in range(block):
        corr[j] = C32 @ Apow  # C A^j
        pows.append(Apow)
        Apow = Apow @ A32

    while block % unroll:
        unroll //= 2
    U = max(1, unroll)
    group_A = pows[U] if U < block else Apow
    group_in = np.stack([pows[U - 1 - v] @ B32 for v in range(U)])  # (U, d)
    group_out = np.stack([C32 @ pows[u] for u in range(U)], axis=1)  # (d, U)
    group_fir = np.zeros((U, U))
    for u in range(U):
        group_fir[u, u] = D32
        for v in range(u):
            group_fir[u, v] = C32 @ pows[u - 1 - v] @ B32

    # Row-vector convention (device computes inj_flat @ toe): block (v, r)
    # holds (A^{U(r-v)})^T so that S[r] = sum_v A^{U(r-v)} inj_v = s_{r+1}.
    G = block // U
    toe = np.zeros((G * d, G * d))
    for r in range(G):
        for v in range(r + 1):
            toe[v * d:(v + 1) * d, r * d:(r + 1) * d] = pows[(r - v) * U].T
    group_pows = np.stack([pows[g * U] for g in range(G)])  # (G, d, d)
    return BlockOperators(
        A=A32, B=B32, C=C32, D=D32, corr=corr, state_corr=Apow, block=block,
        unroll=U, group_A=group_A, group_in=group_in, group_out=group_out,
        group_fir=group_fir, group_toeplitz=toe, group_pows=group_pows,
    )
