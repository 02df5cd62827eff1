"""Route tier: the frame-major SRC, the cat fold, the routing rule, the
precision each route asks for, and the rFFT engine — all plain JAX (XLA),
checked against the golden oracle, numpy or each other.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp

from dsp_audio_project_tpu import (
    AudioPipeline, EQConfig, PipelineConfig, SRCConfig,
)
from dsp_audio_project_tpu.config import KernelConfig
from dsp_audio_project_tpu.ops.eq import (
    _carry_states, _grouped_finish, _grouped_parts, eq_cat_weights,
    equalize, equalize_frames, make_block_operators,
)
from dsp_audio_project_tpu.ops.fft import rfft_magnitude
from dsp_audio_project_tpu.ops.src import (
    FRAME_GRANULE, _gather_frames_matmul, fold_operator, frame_count,
    make_plan, resample, resample_frames, resample_frames_cat,
    shifted_frames_matmul,
)
from dsp_audio_project_tpu.oracle import (
    equalize_oracle, pipeline_oracle, resample_oracle, snr_db,
    spectrum_oracle,
)
from dsp_audio_project_tpu.routing import ROUTES, choose_route
from dsp_audio_project_tpu.utils.precision import FAST

from conftest import make_test_signal

GAINS = {"Sub-Bass": 6, "Bass": -3, "High Mids": 12, "Presence": -15,
         "Brilliance": 4}


def _flat(frames, n_out):
    a = np.asarray(frames)
    return a.reshape(a.shape[:-2] + (-1,))[..., :n_out]


@pytest.mark.parametrize("L,M", [(3, 2), (2, 3), (160, 147), (1, 4)])
def test_frames_src_matches_oracle(L, M):
    fs = 44100
    x = make_test_signal(20000, fs, seed=3)
    cfg = SRCConfig(L=L, M=M)
    plan = make_plan(L, M)
    n_out = cfg.output_length(len(x))
    got = _flat(resample_frames(jnp.asarray(x), plan, n_out), n_out)
    want, _ = resample_oracle(x, fs, cfg, engine="fast")
    assert got.shape == want.shape
    assert snr_db(want, got) > 60.0


def test_frames_src_batched():
    fs = 48000
    xs = np.stack([make_test_signal(8192, fs, seed=s) for s in range(3)])
    cfg = SRCConfig(L=2, M=3)
    plan = make_plan(2, 3)
    n_out = cfg.output_length(8192)
    got = _flat(resample_frames(jnp.asarray(xs), plan, n_out), n_out)
    for c in range(3):
        want, _ = resample_oracle(xs[c], fs, cfg, engine="fast")
        assert snr_db(want, got[c]) > 60.0


def _ops_for(gains, fs, block, unroll=16):
    cfg = EQConfig.from_gains(gains)
    return make_block_operators(cfg.active_bands(fs), fs, cfg.q, block,
                                unroll), cfg


def test_eq_grouped_passes_match_oracle():
    """State pass + carry + finish (the split the sharded paths use)
    reproduce the sequential cascade."""
    fs = 44100
    x = make_test_signal(16384, fs, seed=5)
    block = 256
    ops, cfg = _ops_for({"Sub-Bass": 6, "Bass": -3, "High Mids": 12}, fs,
                        block)
    K = len(x) // block
    x_g = jnp.asarray(x.reshape(1, K, block // ops.unroll, ops.unroll))
    y0, s_in, e = _grouped_parts(x_g, ops)
    sigma = _carry_states(e, ops)
    y = np.asarray(_grouped_finish(y0, s_in, sigma, ops)).reshape(-1)
    want = equalize_oracle(x, fs, cfg)
    assert snr_db(want, np.clip(y, -1.0, 1.0)) > 60.0


def test_eq_end_states_match_sequential():
    """Per-block zero-state end states (the carry solve's input) equal the
    per-sample recurrence s[n] = A s[n-1] + B x[n], on a ragged K."""
    fs = 44100
    block, K = 128, 37
    x = make_test_signal(K * block, fs, seed=8)
    ops, _ = _ops_for({"Bass": 5}, fs, block)
    x_g = jnp.asarray(x.reshape(1, K, block // ops.unroll, ops.unroll))
    _, _, e = _grouped_parts(x_g, ops)
    xb = x.reshape(K, block).astype(np.float64)
    s = np.zeros((K, ops.A.shape[0]))
    for n in range(block):
        s = s @ ops.A.T + xb[:, n : n + 1] * ops.B[None, :]
    np.testing.assert_allclose(np.asarray(e)[0], s, atol=2e-5)


@pytest.mark.parametrize("n", [8, 256, 2048])
def test_rfft_magnitude_matches_numpy(n, rng):
    x = rng.standard_normal((5, n)).astype(np.float32)
    got = np.asarray(rfft_magnitude(jnp.asarray(x)))
    want = np.abs(np.fft.rfft(x, axis=-1))
    assert got.shape == want.shape
    assert np.max(np.abs(got - want)) / np.max(want) < 1e-5


def test_rfft_magnitude_odd_batch(rng):
    x = rng.standard_normal((7, 3, 512)).astype(np.float32)
    got = np.asarray(rfft_magnitude(jnp.asarray(x)))
    want = np.abs(np.fft.rfft(x, axis=-1))
    assert got.shape == (7, 3, 257)
    assert np.max(np.abs(got - want)) / np.max(want) < 1e-5


@pytest.mark.parametrize("nfft", [256, 1024, 2048])
def test_stft_matches_numpy(nfft, rng):
    from dsp_audio_project_tpu.ops.spectrum import _hann, stft

    hop = nfft // 4
    x = rng.standard_normal((2, 5 * nfft)).astype(np.float32)
    got = np.asarray(stft(jnp.asarray(x), nfft=nfft, hop=hop, pad_end=False))
    frames = (x.shape[-1] - nfft) // hop + 1
    idx = np.arange(frames)[:, None] * hop + np.arange(nfft)[None, :]
    want = np.fft.rfft(x[:, idx] * _hann(nfft), axis=-1)
    assert got.shape == want.shape
    assert np.max(np.abs(got - want)) / np.max(np.abs(want)) < 1e-5


def test_stft_planes_recombine(rng):
    from dsp_audio_project_tpu.ops.spectrum import stft, stft_planes

    x = jnp.asarray(rng.standard_normal((3, 6000)).astype(np.float32))
    s = np.asarray(stft(x, nfft=1024, hop=256))
    p = np.asarray(stft_planes(x, nfft=1024, hop=256))
    assert p.dtype == np.float32
    np.testing.assert_array_equal(p[..., 0, :, :] + 1j * p[..., 1, :, :], s)


def test_frames_src_fast_matches_oracle():
    """bf16x3 SRC on the headline plan, batch + both channels vs oracle."""
    fs = 44100
    xs = np.stack([make_test_signal(20000, fs, seed=s) for s in range(2)])
    cfg = SRCConfig(L=160, M=147)
    plan = make_plan(160, 147)
    n_out = cfg.output_length(20000)
    got = _flat(resample_frames(jnp.asarray(xs), plan, n_out, fast=True),
                n_out)
    for c in range(2):
        want, _ = resample_oracle(xs[c], fs, cfg, engine="fast")
        assert snr_db(want, got[c]) > 60.0


def test_resample_frames_matches_flat_resample():
    """Frame-major output flattened == ops/src.resample: both rate
    directions, batch, and the granule-padded frame grid."""
    rng = np.random.default_rng(3)
    for L, M, n in [(160, 147, 44100), (147, 160, 30011)]:
        cfg = SRCConfig(L=L, M=M)
        plan = make_plan(L, M)
        n_out = cfg.output_length(n)
        x = (0.3 * rng.standard_normal((2, n))).astype(np.float32)
        want = np.asarray(resample(jnp.asarray(x), 44100, cfg)[0])
        got = resample_frames(jnp.asarray(x), plan, n_out, pad_frames=True)
        assert got.shape[-2] % FRAME_GRANULE == 0
        assert np.max(np.abs(_flat(got, n_out) - want)) < 1e-5


def test_resample_frames_fast_close():
    """bf16x3 polyphase matmul holds ~1e-5 relative vs full precision."""
    cfg = SRCConfig(L=160, M=147)
    plan = make_plan(160, 147)
    x = (0.4 * np.random.default_rng(0).standard_normal(44100)).astype(
        np.float32)
    n_out = cfg.output_length(len(x))
    full = _flat(resample_frames(jnp.asarray(x), plan, n_out), n_out)
    fast = _flat(resample_frames(jnp.asarray(x), plan, n_out, fast=True),
                 n_out)
    assert np.max(np.abs(fast - full)) / np.max(np.abs(full)) < 5e-5


def test_frame_count_granule():
    """Frame-granule padding: frame counts and output shapes."""
    plan = make_plan(160, 147)
    assert frame_count(plan, 160 * 128, pad_frames=False) == 128
    assert frame_count(plan, 160 * 128 + 1, pad_frames=False) == 129
    assert frame_count(plan, 160 * 128 + 1, pad_frames=True) == 256
    assert frame_count(plan, 1, pad_frames=True) == FRAME_GRANULE
    x = jnp.zeros((3, 10000), jnp.float32)
    n_out = SRCConfig(L=160, M=147).output_length(10000)
    assert resample_frames(x, plan, n_out).shape == (3, -(-n_out // 160), 160)
    assert resample_frames(x, plan, n_out, pad_frames=True).shape == (
        3, FRAME_GRANULE, 160)
    assert resample_frames(x, plan, n_out, num_frames=77).shape == (3, 77, 160)


def test_routes_narrow_stride_to_flat():
    from dsp_audio_project_tpu.config import MeshConfig
    from dsp_audio_project_tpu.parallel.mesh import build_mesh
    from dsp_audio_project_tpu.parallel.pipeline import build_sharded_pipeline

    cfg = PipelineConfig(src=SRCConfig(L=8, M=7),
                         eq=EQConfig.from_gains({"Bass": 3}))
    assert choose_route(cfg, 48000, 44100) == "flat"
    mesh = build_mesh(MeshConfig(channel_devices=1, block_devices=1))
    _, sp = build_sharded_pipeline(mesh, cfg, 44100, 48000, 1)
    assert sp.route == "flat"
    assert sp.iir_block != FRAME_GRANULE * make_plan(8, 7).P


def test_gather_and_shifted_frames_agree():
    """The two frame evaluations (shifted matmuls / explicit gather) are
    the same math on a wide-stride plan."""
    plan = make_plan(160, 147)
    x = jnp.asarray((0.3 * np.random.default_rng(5).standard_normal(
        (2, 30000))).astype(np.float32))
    a = np.asarray(shifted_frames_matmul(x, plan, 190, -plan.lo))
    b = np.asarray(_gather_frames_matmul(x, plan, 190, -plan.lo))
    assert np.max(np.abs(a - b)) < 1e-5


def _dot_precisions(jaxpr):
    out = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            out.append(eqn.params["precision"])
        for v in eqn.params.values():
            for sub in (v if isinstance(v, (list, tuple)) else [v]):
                if hasattr(sub, "jaxpr") and hasattr(sub.jaxpr, "eqns"):
                    out += _dot_precisions(sub.jaxpr)
                elif hasattr(sub, "eqns"):
                    out += _dot_precisions(sub)
    return out


@pytest.mark.parametrize("route", ["cat", "frames"])
def test_precision_preset_in_fast_mode(route):
    """Fast mode passes the BF16_BF16_F32_X3 preset object — never
    Precision.HIGH/DEFAULT or a TF32 algorithm — and full precision pins
    HIGHEST on every matmul of the route."""
    hi = (jax.lax.Precision.HIGHEST, jax.lax.Precision.HIGHEST)
    x = jnp.zeros((2, 44100), jnp.float32)
    for fast in (True, False):
        pipe = AudioPipeline(PipelineConfig(
            src=SRCConfig(L=160, M=147), eq=EQConfig.from_gains(GAINS),
            kernels=KernelConfig(eq_fast=fast, src_fast=fast),
        ))
        fwd = (pipe._forward_cat if route == "cat" else pipe._forward_frames)
        precs = _dot_precisions(
            jax.make_jaxpr(lambda v: fwd(v, 44100))(x).jaxpr)
        assert precs
        for p in precs:
            assert "TF32" not in str(p)
            assert p == hi or (fast and p is FAST), p
        assert (FAST in precs) == fast


def test_resample_frames_shard_style_call():
    """num_frames/pad_left contract on a halo-extended shard input equals
    the same frames of the unsharded computation."""
    plan = make_plan(160, 147)
    rng = np.random.default_rng(9)
    n = 147 * 1024
    x = (0.3 * rng.standard_normal(n)).astype(np.float32)
    full = np.asarray(resample_frames(jnp.asarray(x), plan, 1024 * 160,
                                      num_frames=1024))
    k0 = 512                       # shard starts at frame k0
    a = k0 * plan.s + plan.lo      # its first window start in x
    x_ext = x[a : a + 256 * plan.s + plan.W]
    got = np.asarray(resample_frames(jnp.asarray(x_ext), plan, 256 * 160,
                                     num_frames=256, pad_left=0))
    assert np.max(np.abs(got - full[k0 : k0 + 256])) < 1e-5


@pytest.mark.parametrize("backend", ["cpu", "gpu", "other"])
def test_route_never_pallas(backend, monkeypatch):
    """The routing rule answers from the plan and config alone: the same
    XLA route on every backend, never a kernel route."""
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    cases = {
        (160, 147, True): "cat", (160, 147, False): "frames",
        (3, 2, True): "flat", (1, 1, True): "flat",
    }
    for (L, M, need_z_only), want in cases.items():
        cfg = PipelineConfig(src=SRCConfig(L=L, M=M),
                             eq=EQConfig.from_gains(GAINS))
        got = choose_route(cfg, 44100, 44100, need_y=not need_z_only)
        assert got in ROUTES and got == want, (L, M, got)


def test_cat_fold_emission_matches_float64():
    """resample_frames_cat's (y0, inj) equal frames @ w_cat computed in
    float64, and the fold itself is G @ w_cat quantized once."""
    plan = make_plan(160, 147)
    fs_out = 48000
    cfg = EQConfig.from_gains(GAINS)
    ops = make_block_operators(cfg.active_bands(fs_out), fs_out, cfg.q,
                               128 * plan.P, plan.P)
    w_cat = eq_cat_weights(ops)
    d = ops.A.shape[0]
    fold = fold_operator(plan, w_cat)
    assert fold.dtype == np.float32 and fold.shape == (plan.W, plan.P + d)
    np.testing.assert_array_equal(
        fold, (plan.G.astype(np.float64) @ w_cat).astype(np.float32))
    x = make_test_signal(20000, 44100, seed=9)
    n_out = SRCConfig(L=160, M=147).output_length(len(x))
    y0, inj = resample_frames_cat(jnp.asarray(x), plan, n_out, fold,
                                  pad_frames=True)
    F = y0.shape[-2]
    xp = np.pad(x.astype(np.float64), (-plan.lo, F * plan.s + plan.W))
    idx = np.arange(F)[:, None] * plan.s + np.arange(plan.W)[None, :]
    ref = (xp[idx] @ plan.G) @ w_cat
    assert y0.shape == (F, plan.P) and inj.shape == (F, d)
    assert snr_db(ref[:, : plan.P].ravel(), np.asarray(y0).ravel()) > 120
    assert snr_db(ref[:, plan.P :].ravel(), np.asarray(inj).ravel()) > 120


def test_rfft_magnitude_large_n(rng):
    n = 16384
    x = rng.standard_normal((3, n)).astype(np.float32)
    want = np.abs(np.fft.rfft(x, axis=-1))
    got = np.asarray(rfft_magnitude(jnp.asarray(x)))
    assert np.max(np.abs(got - want)) / np.max(want) < 1e-5


def test_spectrum_mag_frames_matches_flat():
    from dsp_audio_project_tpu.ops.spectrum import (
        spectrum_mag, spectrum_mag_frames,
    )

    plan = make_plan(160, 147)
    x = make_test_signal(30000, 44100, seed=4)
    n_out = SRCConfig(L=160, M=147).output_length(len(x))
    frames = resample_frames(jnp.asarray(x), plan, n_out, pad_frames=True)
    a = np.asarray(spectrum_mag_frames(frames, n_out))
    b = np.asarray(spectrum_mag(jnp.asarray(_flat(frames, n_out))))
    np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


def test_choose_route_cases():
    """cat needs an active EQ and a caller that does not need y; short
    signals and bypassed SRC take the flat route."""
    base = dict(src=SRCConfig(L=160, M=147))
    act = PipelineConfig(**base, eq=EQConfig.from_gains(GAINS))
    flat_eq = PipelineConfig(**base, eq=EQConfig())
    assert choose_route(act, 44100, 44100) == "cat"
    assert choose_route(act, 44100, 44100, need_y=True) == "frames"
    assert choose_route(flat_eq, 44100, 44100) == "frames"
    assert choose_route(act, 10, 44100) == "flat"       # shorter than filter
    floored = PipelineConfig(
        **base, eq=EQConfig.from_gains({"Bass": 6}, min_center_hz=1000.0))
    assert choose_route(floored, 44100, 44100) == "frames"  # no active band
    bypass = PipelineConfig(eq=EQConfig.from_gains(GAINS))
    assert choose_route(bypass, 44100, 44100) == "flat"


@pytest.mark.parametrize("n", [65536, 131072, 262144])
def test_rfft_magnitude_large_sizes(n, rng):
    x = rng.standard_normal((2, n)).astype(np.float32)
    want = np.abs(np.fft.rfft(x, axis=-1))
    got = np.asarray(rfft_magnitude(jnp.asarray(x)))
    assert got.shape == want.shape
    assert np.max(np.abs(got - want)) / np.max(want) < 2e-5


def test_resample_fast_flag_flat():
    """The flat route's SRC runs at full f32 in fast mode too: every dot
    of ops/src.resample pins HIGHEST, while its EQ takes the preset."""
    cfg = PipelineConfig(
        src=SRCConfig(L=160, M=147), eq=EQConfig.from_gains(GAINS),
        kernels=KernelConfig(eq_fast=True, src_fast=True),
    )
    hi = (jax.lax.Precision.HIGHEST, jax.lax.Precision.HIGHEST)
    x = jnp.zeros((2, 40000), jnp.float32)
    src = _dot_precisions(jax.make_jaxpr(
        lambda v: resample(v, 44100, cfg.src)[0])(x).jaxpr)
    assert src and all(p == hi for p in src), src
    pipe = AudioPipeline(cfg)
    chain = _dot_precisions(jax.make_jaxpr(
        lambda v: pipe._forward(v, 44100))(x).jaxpr)
    assert FAST in chain and hi in chain


def test_equalize_frames_matches_equalize():
    fs = 48000
    cfg = EQConfig.from_gains(
        {"Sub-Bass": 6, "Bass": -3, "High Mids": 12, "Presence": -15})
    x = make_test_signal(160 * 700, fs, seed=5)
    for fast in (False, True):
        zf = np.asarray(equalize_frames(jnp.asarray(x.reshape(700, 160)),
                                        fs, cfg, fast=fast)).reshape(-1)
        z = np.asarray(equalize(jnp.asarray(x), fs, cfg, fast=fast))
        assert snr_db(z, zf) > 100.0
        assert snr_db(equalize_oracle(x, fs, cfg), zf) > 60.0


def test_pipeline_flat_path_matches_oracle(rng):
    """AudioPipeline flat route (flat SRC -> flat EQ -> spectra)."""
    fs, n = 44100, 60000
    x = make_test_signal(n, fs, seed=1)
    cfg = PipelineConfig(
        src=SRCConfig(L=160, M=147),
        eq=EQConfig.from_gains({"Sub-Bass": 6, "Bass": -3, "High Mids": 12}),
    )
    pipe = AudioPipeline(cfg)
    n_out = cfg.src.output_length(n)
    fs_out = cfg.src.output_rate(fs)
    z, y, (mx, my, mz) = pipe.jit_forward_spectra()(jnp.asarray(x), fs)
    assert z.shape[-1] == n_out and y.shape[-1] == n_out
    want, _ = pipeline_oracle(x, fs, cfg.src, cfg.eq, engine="fast")
    assert snr_db(want, np.asarray(z)) > 100.0
    cap = cfg.spectrum.analysis_limit
    assert snr_db(spectrum_oracle(want[:cap], fs_out)[1],
                  np.asarray(mz)) > 60.0
    assert snr_db(spectrum_oracle(x[:cap], fs)[1], np.asarray(mx)) > 60.0


def test_sharded_and_stream_auto_route():
    """run_sharded / ShardedStreamProcessor take their route from the
    routing rule alone: cat with a wide stride and an active EQ (frames
    when y is needed or no band filters), flat with a narrow stride."""
    from dsp_audio_project_tpu.config import MeshConfig
    from dsp_audio_project_tpu.parallel.mesh import build_mesh
    from dsp_audio_project_tpu.parallel.pipeline import build_sharded_pipeline
    from dsp_audio_project_tpu.streaming import ShardedStreamProcessor

    mesh = build_mesh(MeshConfig(channel_devices=1, block_devices=1))
    wide = PipelineConfig(src=SRCConfig(L=160, M=147),
                          eq=EQConfig.from_gains(GAINS))
    narrow = PipelineConfig(src=SRCConfig(L=3, M=2),
                            eq=EQConfig.from_gains(GAINS))
    assert ShardedStreamProcessor(wide, 44100, mesh, 1)._route == "cat"
    assert ShardedStreamProcessor(wide, 44100, mesh, 1,
                                  gains_db=[0.0] * 6)._cat_dyn
    assert ShardedStreamProcessor(narrow, 44100, mesh, 1)._route == "flat"
    _, sp = build_sharded_pipeline(mesh, wide, 44100, 44100, 1)
    assert sp.route == "cat"
    assert sp.iir_block == FRAME_GRANULE * 160      # frame-major EQ geometry
    assert sp.frames_local % FRAME_GRANULE == 0
    _, sp = build_sharded_pipeline(mesh, wide, 44100, 44100, 1, need_y=True)
    assert sp.route == "frames"
    flat_eq = PipelineConfig(src=wide.src, eq=EQConfig())
    _, sp = build_sharded_pipeline(mesh, flat_eq, 44100, 44100, 1)
    assert sp.route == "frames"
    _, sp = build_sharded_pipeline(mesh, narrow, 44100, 44100, 1)
    assert sp.route == "flat"


def test_call_takes_frames_route_and_matches_flat():
    """AudioPipeline.__call__ runs the frame-major route where it applies
    (it needs y, so never cat) and agrees with the flat route."""
    fs = 44100
    x = make_test_signal(30000, fs, seed=12)
    cfg = PipelineConfig(src=SRCConfig(L=160, M=147),
                         eq=EQConfig.from_gains(GAINS))
    pipe = AudioPipeline(cfg)
    assert pipe.route(len(x), fs, need_y=True) == "frames"
    out = pipe(x, fs)
    z_flat, y_flat = pipe.jit_forward()(jnp.asarray(x), fs)
    assert out.output.shape == z_flat.shape
    assert snr_db(np.asarray(z_flat), np.asarray(out.output)) > 110.0
    assert snr_db(np.asarray(y_flat), np.asarray(out.resampled)) > 110.0
