"""The headline configuration, its seeded signals and its oracle checks.

Shared by ``chip_smoke.py`` (every entry point, gated) and ``bench.py``
(the timed program): 44.1 -> 48 kHz SRC with L=160/M=147, five active EQ
bands and magnitude spectra of x, y and z, on 60 s signals in batches of 8.
Outputs are gated at ``GATE_DB`` SNR against the golden oracle (oracle.py);
a miss raises.
"""
from __future__ import annotations

import subprocess

import numpy as np

FS = 44100
SECONDS = 60.0
BATCH = 8
GAINS = {"Sub-Bass": 6, "Bass": -3, "High Mids": 12, "Presence": -15,
         "Brilliance": 4}
GAINS_2 = {"Sub-Bass": -9, "Bass": 4, "Low Mids": 3, "High Mids": -6,
           "Presence": 10}
GATE_DB = 60.0
SEED = 20261016


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    """`name, power.limit` of every card, read without JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0 or not out.stdout.strip():
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip()


def headline_config(fast: bool, gains=None):
    from .config import EQConfig, KernelConfig, PipelineConfig, SRCConfig

    return PipelineConfig(
        src=SRCConfig(L=160, M=147),
        eq=EQConfig.from_gains(GAINS if gains is None else gains),
        kernels=KernelConfig(eq_fast=fast, src_fast=fast),
    )


def make_signals(channels: int, seconds: float, seed: int = SEED):
    """Seeded test program material: tones across the EQ bands + noise."""
    rng = np.random.default_rng(seed)
    n = int(seconds * FS)
    t = np.arange(n) / FS
    out = np.empty((channels, n), np.float32)
    for c in range(channels):
        f = rng.uniform(0.8, 1.25, size=4)
        x = (0.35 * np.sin(2 * np.pi * 440.0 * f[0] * t)
             + 0.25 * np.sin(2 * np.pi * 40.0 * f[1] * t)
             + 0.15 * np.sin(2 * np.pi * 3000.0 * f[2] * t)
             + 0.1 * np.sin(2 * np.pi * 9800.0 * f[3] * t)
             + 0.15 * rng.standard_normal(n))
        out[c] = x / np.max(np.abs(x))
    return out


def gains_vector(cfg, gains) -> np.ndarray:
    """``gains`` (band name -> dB) ordered like cfg.eq.band_centers."""
    return np.asarray([float(gains.get(nm, 0.0))
                       for nm, _ in cfg.eq.band_centers])


def min_snr(want: np.ndarray, got: np.ndarray) -> float:
    """Worst per-channel SNR (dB) of ``got`` against ``want``."""
    from .oracle import snr_db

    return min(snr_db(w, g) for w, g in zip(want, got))


def gate(name: str, q: float, limit: float = GATE_DB, out=log) -> None:
    """Report ``q`` beside its limit through ``out``; raise when it falls
    below."""
    out(f"  {name}: {q:.2f} dB (gate {limit:.0f})")
    if not q >= limit:
        raise RuntimeError(f"{name}: {q:.2f} dB below the {limit} dB gate")


def flat(frames, n_out: int) -> np.ndarray:
    """Frame-major (..., F, P) output -> the flat (..., n_out) signal."""
    a = np.asarray(frames)
    return a.reshape(a.shape[:-2] + (-1,))[..., :n_out]


class Oracle:
    """Golden-oracle outputs for a batch, per gain setting (cached)."""

    def __init__(self, x: np.ndarray, cfg):
        from .oracle import resample_oracle

        self.x, self.cfg = x, cfg
        self._z = {}
        self.y = np.stack([resample_oracle(c, FS, cfg.src, engine="fast")[0]
                           for c in x])

    def z(self, gains) -> np.ndarray:
        from .config import EQConfig
        from .oracle import equalize_oracle

        key = tuple(sorted(gains.items()))
        if key not in self._z:
            eq = EQConfig.from_gains(gains)
            fs_out = self.cfg.src.output_rate(FS)
            self._z[key] = np.stack([equalize_oracle(c, fs_out, eq)
                                     for c in self.y])
        return self._z[key]
