"""End-to-end tier: full SRC->EQ chain + spectra vs the golden oracle.

This is the minimum-slice gate of SURVEY.md §7: one signal through
SRC -> EQ -> FFT matching the oracle at >= 60 dB on the BASELINE.json
headline configs.
"""
import numpy as np
import jax.numpy as jnp

from dsp_audio_project_tpu import (
    AudioPipeline,
    EQConfig,
    PipelineConfig,
    SRCConfig,
    process,
)
from dsp_audio_project_tpu.oracle import (
    pipeline_oracle,
    snr_db,
    spectrum_oracle,
)

GAINS = {"Sub-Bass": 6, "Bass": -3, "High Mids": 12, "Presence": -15,
         "Brilliance": 4}


def test_full_chain_headline(audio_44k):
    """BASELINE configs 1-3: 44.1k->48k SRC + 6-band EQ + 2048-pt spectrum."""
    x, fs = audio_44k
    cfg = PipelineConfig(
        src=SRCConfig(L=160, M=147), eq=EQConfig.from_gains(GAINS)
    )
    pipe = AudioPipeline(cfg)
    out = pipe(x, fs, with_spectra=True)
    assert out.fs_out == 48000

    want_z, _ = pipeline_oracle(x, fs, cfg.src, cfg.eq)
    z = np.asarray(out.output)
    assert z.shape == want_z.shape == (48000,)
    assert snr_db(want_z, z) > 60.0

    # Spectrum of the chain output matches the oracle spectrum of the
    # oracle output (full-stack parity, app.py:203-205 semantics).
    fw, mw = spectrum_oracle(want_z[:100000], 48000)
    fg, mg = out.spectra["output"]
    np.testing.assert_allclose(fg, fw)
    # mixed error: op fft (1e-5ish) + chain SNR; compare in dB-energy terms
    assert snr_db(mw, np.asarray(mg)) > 40.0


def test_process_convenience(audio_short):
    x, fs = audio_short
    z, fs_out = process(x, fs)
    # default config: L=M=1 bypass + flat EQ bypass -> identity
    assert fs_out == fs
    np.testing.assert_array_equal(np.asarray(z), x)


def test_chain_src_only(audio_short):
    x, fs = audio_short
    cfg = PipelineConfig(src=SRCConfig(L=2, M=3))
    z, fs_out = process(x, fs, cfg)
    want, fs_want = pipeline_oracle(x, fs, cfg.src, cfg.eq)
    assert fs_out == fs_want
    assert snr_db(want, np.asarray(z)) > 60.0


def test_chain_eq_only(audio_short):
    x, fs = audio_short
    cfg = PipelineConfig(eq=EQConfig.from_gains({"Low Mids": 8}))
    z, fs_out = process(x, fs, cfg)
    want, _ = pipeline_oracle(x, fs, cfg.src, cfg.eq)
    assert fs_out == fs
    assert snr_db(want, np.asarray(z)) > 60.0


def test_chain_batched_channels(audio_short):
    x, fs = audio_short
    xs = np.stack([x, 0.3 * x, -x])
    cfg = PipelineConfig(src=SRCConfig(L=3, M=4),
                         eq=EQConfig.from_gains({"Bass": 5}))
    pipe = AudioPipeline(cfg)
    out = pipe(xs, fs)
    z = np.asarray(out.output)
    for c in range(3):
        want, _ = pipeline_oracle(xs[c], fs, cfg.src, cfg.eq)
        assert snr_db(want, z[c]) > 60.0


def test_wav_roundtrip_through_chain(tmp_path, audio_short):
    """I/O + chain: load -> process -> export, reference conventions end-to-end."""
    from dsp_audio_project_tpu import export_wav, load_signal, read_wav
    from dsp_audio_project_tpu.io.wavio import write_wav

    x, fs = audio_short
    p = str(tmp_path / "in.wav")
    write_wav(p, fs, (x * 32767).astype(np.int16))
    sig, fs_in = load_signal(p)
    cfg = PipelineConfig(src=SRCConfig(L=1, M=2),
                         eq=EQConfig.from_gains({"Presence": -6}))
    z, fs_out = process(sig, fs_in, cfg)
    data = export_wav(np.asarray(z), fs_out)
    y, fs_read = read_wav(data)
    assert fs_read == fs_out == fs // 2
    assert len(y) == len(z)
    assert np.max(np.abs(y)) <= 1.0


def test_chain_fast_flags_match_full_precision(audio_short):
    """src_fast/eq_fast (bf16x3 matmuls) on the flat route match the
    full-precision chain."""
    from dsp_audio_project_tpu.config import KernelConfig

    x, fs = audio_short
    base = dict(src=SRCConfig(L=3, M=2), eq=EQConfig.from_gains({"Bass": 6}))
    full_cfg = PipelineConfig(**base)
    fast_cfg = PipelineConfig(**base, kernels=KernelConfig(
        src_fast=True, eq_fast=True))
    z1, fs1 = process(x, fs, full_cfg)
    z2, fs2 = process(x, fs, fast_cfg)
    assert fs1 == fs2
    assert z1.shape == z2.shape
    assert snr_db(np.asarray(z1), np.asarray(z2)) > 80.0


def test_gain_space_property_sweep():
    """Random points across the UI's full gain space stay above the gate."""
    from dsp_audio_project_tpu.config import DEFAULT_BAND_NAMES
    from conftest import make_test_signal

    fs = 44100
    x = make_test_signal(20000, fs, seed=17)
    r = np.random.default_rng(99)
    for _ in range(4):
        gains = {n: int(r.integers(-15, 16)) for n in DEFAULT_BAND_NAMES}
        cfg = PipelineConfig(src=SRCConfig(L=2, M=3),
                             eq=EQConfig.from_gains(gains))
        z, _ = process(x, fs, cfg)
        want, _ = pipeline_oracle(x, fs, cfg.src, cfg.eq, engine="fast")
        q = snr_db(want, np.asarray(z))
        assert q > 60.0, f"gains={gains}: {q:.1f} dB"


def test_long_form_minutes():
    """Memory + correctness at production scale: minutes of audio.

    (Two minutes on the CPU test backend.)"""
    from conftest import make_test_signal

    fs = 44100
    n = 120 * fs  # 5.3M samples
    x = make_test_signal(n, fs, seed=23)
    cfg = PipelineConfig(src=SRCConfig(L=160, M=147),
                         eq=EQConfig.from_gains({"Bass": 6, "Presence": -4}))
    z, fs_out = process(x, fs, cfg)
    assert fs_out == 48000
    z = np.asarray(z)
    assert z.shape == (int(np.ceil(n * 160 / 147)),)
    # Spot-check SNR on a 2-second window (full oracle at this size is slow).
    w0 = 2_000_000
    want, _ = pipeline_oracle(x, fs, cfg.src, cfg.eq, engine="fast")
    assert snr_db(want[w0 : w0 + 96000], z[w0 : w0 + 96000]) > 60.0


def test_fused_frames_chain_matches_flat_path(audio_44k):
    """jit_forward_frames == jit_forward (flattened), and matches oracle."""
    from dsp_audio_project_tpu.config import KernelConfig

    x, fs = audio_44k
    cfg = PipelineConfig(src=SRCConfig(L=160, M=147),
                         eq=EQConfig.from_gains({"Bass": 6.0, "Presence": -4.0}),
                         kernels=KernelConfig())
    pipe = AudioPipeline(cfg)
    assert pipe.frames_supported(len(x))
    n_out = cfg.src.output_length(len(x))
    zf, yf = pipe.jit_forward_frames()(jnp.asarray(x), fs)
    z_flat = np.asarray(zf).reshape(-1)[:n_out]
    z_ref, _ = pipe.jit_forward()(jnp.asarray(x), fs)
    assert snr_db(np.asarray(z_ref), z_flat) > 110.0
    want, _ = pipeline_oracle(x, fs, cfg.src, cfg.eq, engine="fast")
    assert snr_db(want, z_flat) > 60.0


def test_fused_frames_dynamic_matches_static(audio_44k):
    """jit_forward_frames_dynamic(gains) == jit_forward_frames with the same
    gains baked in, and one compile serves multiple gain vectors."""
    from dsp_audio_project_tpu.config import KernelConfig

    x, fs = audio_44k
    gains = {"Bass": 6.0, "Presence": -4.0}
    cfg = PipelineConfig(src=SRCConfig(L=160, M=147),
                         eq=EQConfig.from_gains(gains),
                         kernels=KernelConfig())
    pipe = AudioPipeline(cfg)
    n_out = cfg.src.output_length(len(x))
    fwd = pipe.jit_forward_frames_dynamic()
    g = jnp.asarray([gains.get(name, 0.0) for name, _ in cfg.eq.band_centers],
                    jnp.float32)
    zf, _ = fwd(jnp.asarray(x), g, fs)
    z_dyn = np.asarray(zf).reshape(-1)[:n_out]
    zs, _ = pipe.jit_forward_frames()(jnp.asarray(x), fs)
    z_static = np.asarray(zs).reshape(-1)[:n_out]
    assert snr_db(z_static, z_dyn) > 110.0
    # A second gain vector reuses the same compiled executable.
    n0 = fwd._cache_size()
    fwd(jnp.asarray(x), g.at[0].add(-9.0), fs)
    assert fwd._cache_size() == n0


def test_full_chain_spectra_forwards(audio_44k):
    """jit_forward_frames_spectra / jit_forward_spectra: the benchmark's
    one-program SRC+EQ+FFT chain matches the per-stage APIs and the oracle
    (app.py:202-205 computes spectra of x, y AND z per render)."""
    from dsp_audio_project_tpu.config import KernelConfig
    from dsp_audio_project_tpu.ops.spectrum import spectrum_freqs

    x, fs = audio_44k
    cfg = PipelineConfig(src=SRCConfig(L=160, M=147),
                         eq=EQConfig.from_gains(GAINS),
                         kernels=KernelConfig())
    pipe = AudioPipeline(cfg)
    n_out = cfg.src.output_length(len(x))
    fs_out = cfg.src.output_rate(fs)

    zf, yf, (mx, my, mz) = pipe.jit_forward_frames_spectra()(
        jnp.asarray(x), fs
    )
    z2, y2, (mx2, my2, mz2) = pipe.jit_forward_spectra()(jnp.asarray(x), fs)

    # Fused and flat full-chain programs agree.
    z_flat = np.asarray(zf).reshape(-1)[:n_out]
    assert snr_db(np.asarray(z2), z_flat) > 110.0
    np.testing.assert_allclose(np.asarray(mx), np.asarray(mx2), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(my), np.asarray(my2), rtol=1e-3,
                               atol=1e-3)
    np.testing.assert_allclose(np.asarray(mz), np.asarray(mz2), rtol=1e-3,
                               atol=1e-3)

    # And the spectra match the reference oracle's per-render math.
    cap = cfg.spectrum.analysis_limit
    want_z, _ = pipeline_oracle(x, fs, cfg.src, cfg.eq, engine="fast")
    _, want_mx = spectrum_oracle(x[:cap], fs)
    _, want_mz = spectrum_oracle(want_z[:cap], fs_out)
    assert snr_db(want_mx, np.asarray(mx)) > 60.0
    assert snr_db(want_mz, np.asarray(mz)) > 60.0
    assert spectrum_freqs(len(x), fs).shape == np.asarray(mx).shape
    assert spectrum_freqs(n_out, fs_out).shape == np.asarray(mz).shape
