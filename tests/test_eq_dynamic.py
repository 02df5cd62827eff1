"""Dynamic-gain EQ: traced gains vs the static path and the oracle."""
import numpy as np
import pytest
import jax
import jax.numpy as jnp

from dsp_audio_project_tpu import EQConfig, equalize
from dsp_audio_project_tpu.ops.eq_dynamic import equalize_dynamic
from dsp_audio_project_tpu.oracle import equalize_oracle, snr_db

from conftest import make_test_signal

GAIN_SETS = [
    (6.0, -3.0, 0.0, 12.0, -15.0, 4.0),
    (15.0, 15.0, 15.0, 15.0, 15.0, 15.0),
    (-15.0, -14.0, -13.0, -12.5, -3.0, 0.0),   # real-pole regime bands
    (0.0, 0.0, 0.0, 0.0, 0.0, 0.0),
    (0.05, -0.05, 0.0, 0.0, 0.0, 0.0),          # below the static skip threshold
]


@pytest.mark.parametrize("gains", GAIN_SETS)
def test_dynamic_matches_oracle(gains):
    fs = 44100
    x = make_test_signal(30000, fs, seed=13)
    names = [n for n, _ in EQConfig().band_centers]
    cfg = EQConfig.from_gains(dict(zip(names, gains)))
    want = equalize_oracle(x, fs, cfg)
    got = np.asarray(equalize_dynamic(jnp.asarray(x), jnp.asarray(gains), fs))
    assert got.shape == want.shape
    q = snr_db(want, np.clip(got, -1, 1))
    assert q > 110.0, f"gains={gains}: {q:.1f} dB"


def test_dynamic_no_recompile():
    """One compiled executable serves every gain vector."""
    fs = 48000
    x = jnp.asarray(make_test_signal(8192, fs, seed=3))
    with jax.log_compiles(False):
        pass
    n0 = equalize_dynamic._cache_size()
    for g in GAIN_SETS:
        equalize_dynamic(x, jnp.asarray(g), fs)
    assert equalize_dynamic._cache_size() == n0 + 1


def test_dynamic_matches_static_path():
    fs = 44100
    x = make_test_signal(20000, fs, seed=4)
    gains = (9.0, 0.0, -6.0, 3.0, 0.0, -9.0)
    names = [n for n, _ in EQConfig().band_centers]
    cfg = EQConfig.from_gains(dict(zip(names, gains)))
    stat = np.asarray(equalize(jnp.asarray(x), fs, cfg))
    dyn = np.asarray(equalize_dynamic(jnp.asarray(x), jnp.asarray(gains), fs))
    assert snr_db(stat, dyn) > 95.0


def test_dynamic_batched():
    fs = 44100
    xs = np.stack([make_test_signal(8192, fs, seed=s) for s in range(2)])
    gains = (6.0, -6.0, 0.0, 0.0, 3.0, 0.0)
    got = np.asarray(equalize_dynamic(jnp.asarray(xs), jnp.asarray(gains), fs))
    names = [n for n, _ in EQConfig().band_centers]
    cfg = EQConfig.from_gains(dict(zip(names, gains)))
    for c in range(2):
        want = equalize_oracle(xs[c], fs, cfg)
        assert snr_db(want, got[c]) > 110.0


def test_dynamic_frames_matches_flat():
    """Frame-major traced-gains EQ equals the flat dynamic path."""
    from dsp_audio_project_tpu.ops.eq_dynamic import equalize_dynamic_frames

    fs = 48000
    P, F = 160, 301
    rng = np.random.default_rng(5)
    x = (0.4 * rng.standard_normal(F * P)).astype(np.float32)
    gains = (6.0, -3.0, 0.0, 12.0, -15.0, 4.0)
    want = np.asarray(equalize_dynamic(jnp.asarray(x), jnp.asarray(gains), fs))
    got = np.asarray(
        equalize_dynamic_frames(
            jnp.asarray(x.reshape(F, P)), jnp.asarray(gains), fs
        )
    ).reshape(-1)
    assert snr_db(want, got) > 110.0


def test_dynamic_frames_no_recompile():
    from dsp_audio_project_tpu.ops.eq_dynamic import equalize_dynamic_frames

    fs = 48000
    fr = jnp.asarray(
        make_test_signal(160 * 130, fs, seed=9).reshape(130, 160)
    )
    n0 = equalize_dynamic_frames._cache_size()
    for g in GAIN_SETS[:3]:
        equalize_dynamic_frames(fr, jnp.asarray(g), fs)
    assert equalize_dynamic_frames._cache_size() == n0 + 1


def test_dynamic_ops_split_matches_inline():
    """build_dynamic_operators + equalize_dynamic_frames_ops == the inline
    traced-gains path (the serving split runs the same algebra)."""
    from dsp_audio_project_tpu.ops.eq_dynamic import (
        build_dynamic_operators,
        equalize_dynamic_frames,
        equalize_dynamic_frames_ops,
    )

    fs = 48000
    P, F, G = 160, 301, 128
    rng = np.random.default_rng(11)
    frames = jnp.asarray(
        (0.4 * rng.standard_normal((F, P))).astype(np.float32)
    )
    gains = jnp.asarray((6.0, -3.0, 0.0, 12.0, -15.0, 4.0))
    want = np.asarray(equalize_dynamic_frames(frames, gains, fs))
    K = -(-F // G)
    ops = build_dynamic_operators(
        gains, fs, EQConfig(), unroll=P, groups_per_block=G, num_blocks=K
    )
    assert ops.carry_w is not None and ops.carry_w.shape[0] == K * 12
    got = np.asarray(equalize_dynamic_frames_ops(frames, ops))
    assert snr_db(want, got) > 140.0


def test_dynamic_ops_split_no_recompile():
    """One builder compile + one apply compile serve every gain vector."""
    from dsp_audio_project_tpu.ops.eq_dynamic import (
        build_dynamic_operators,
        equalize_dynamic_frames_ops,
    )

    fs = 48000
    P, F, G = 160, 260, 128
    frames = jnp.asarray(
        make_test_signal(F * P, fs, seed=17).reshape(F, P)
    )
    K = -(-F // G)
    ops0 = build_dynamic_operators(
        jnp.asarray(GAIN_SETS[0]), fs, EQConfig(),
        unroll=P, groups_per_block=G, num_blocks=K,
    )
    equalize_dynamic_frames_ops(frames, ops0)
    # Cache counts after the first call; further gain vectors add none.
    n0b = build_dynamic_operators._cache_size()
    n0a = equalize_dynamic_frames_ops._cache_size()
    for g in GAIN_SETS[1:3]:
        ops = build_dynamic_operators(
            jnp.asarray(g), fs, EQConfig(),
            unroll=P, groups_per_block=G, num_blocks=K,
        )
        equalize_dynamic_frames_ops(frames, ops)
    assert build_dynamic_operators._cache_size() == n0b
    assert equalize_dynamic_frames_ops._cache_size() == n0a


def test_pipeline_dynamic_ops_matches_inline():
    """AudioPipeline serving split == jit_forward_frames_dynamic inline."""
    from dsp_audio_project_tpu import AudioPipeline, PipelineConfig, SRCConfig
    from dsp_audio_project_tpu.config import KernelConfig

    fs = 44100
    x = make_test_signal(30000, fs, seed=23)
    cfg = PipelineConfig(
        src=SRCConfig(L=160, M=147), eq=EQConfig(),
        kernels=KernelConfig(),
    )
    pipe = AudioPipeline(cfg)
    gains = jnp.asarray((5.0, 0.0, -7.0, 2.0, 0.0, 9.0))
    z_inline, _ = pipe.jit_forward_frames_dynamic()(jnp.asarray(x), gains, fs)
    # builder='traced' pins the df32 in-graph builder: identical algebra to
    # the inline path, so the match is exact to accumulation order (~140 dB).
    # The default 'auto' picks the host-float64 builder for concrete gains —
    # a different (Schur) realization, equal only to f32 rounding; it gets
    # its own oracle-level test below.
    ops = pipe.dynamic_eq_operators(gains, fs, len(x), builder="traced")
    z_split, _ = pipe.jit_forward_frames_dynamic_ops()(jnp.asarray(x), ops, fs)
    n_out = cfg.src.output_length(len(x))
    a = np.asarray(z_inline).reshape(-1)[:n_out]
    b = np.asarray(z_split).reshape(-1)[:n_out]
    assert snr_db(a, b) > 140.0


def test_lower_triangle_matches_reference():
    """Slice-stack block-Toeplitz == the direct numpy construction."""
    from dsp_audio_project_tpu.ops.eq_dynamic import _lower_triangle

    rng = np.random.default_rng(5)
    n, d = 7, 4
    pows = rng.standard_normal((n, d, d)).astype(np.float32)
    got = np.asarray(_lower_triangle(jnp.asarray(pows), n, d))
    want = np.zeros((n * d, n * d), np.float32)
    for v in range(n):
        for r in range(v, n):
            want[v * d:(v + 1) * d, r * d:(r + 1) * d] = pows[r - v].T
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("gains", GAIN_SETS)
def test_host_builder_matches_oracle(gains):
    """Host-float64 serving builder + frames apply vs the golden oracle."""
    from dsp_audio_project_tpu.ops.eq_dynamic import (
        build_dynamic_operators_host,
        equalize_dynamic_frames_ops,
    )

    fs = 48000
    P, G = 160, 64
    F = 301                                   # K = 5: exercises the carry
    x = make_test_signal(F * P, fs, seed=29)
    frames = jnp.asarray(x.reshape(F, P))
    K = -(-F // G)
    ops = build_dynamic_operators_host(
        gains, fs, EQConfig(), unroll=P, groups_per_block=G, num_blocks=K
    )
    assert ops.carry_w is not None and ops.carry_w.shape[0] == K * 12
    got = np.asarray(equalize_dynamic_frames_ops(frames, ops,
                                                 groups_per_block=G))
    names = [n for n, _ in EQConfig().band_centers]
    cfg_g = EQConfig.from_gains(dict(zip(names, gains)))
    want = equalize_oracle(x, fs, cfg_g)
    # The host builder masks sub-threshold gains to exact 0 dB (identity),
    # like the traced builder; always-clip matches the oracle's clip.
    # Oracle gate ~ the static path's own f32 rounding floor (~109 dB at
    # this geometry); the sharp gate is vs the static path below, which
    # uses the same Schur realization + quantization (match to
    # accumulation order).
    q = snr_db(want, got.reshape(-1))
    assert q > 100.0, f"gains={gains}: {q:.1f} dB"
    stat = np.asarray(equalize(jnp.asarray(x), fs, cfg_g, block=G * P,
                               unroll=P))
    q_stat = snr_db(stat, got.reshape(-1))
    assert q_stat > 140.0, f"gains={gains}: {q_stat:.1f} dB vs static"


def test_host_builder_pytree_compatible_with_traced():
    """Host and traced builders emit structurally identical pytrees, so ONE
    apply-side compile serves both (the serving split's contract)."""
    from dsp_audio_project_tpu.ops.eq_dynamic import (
        build_dynamic_operators,
        build_dynamic_operators_host,
    )

    fs = 48000
    P, G, K = 160, 128, 3
    gains = (6.0, -3.0, 0.0, 12.0, -15.0, 4.0)
    a = build_dynamic_operators_host(
        gains, fs, EQConfig(), unroll=P, groups_per_block=G, num_blocks=K
    )
    b = build_dynamic_operators(
        jnp.asarray(gains), fs, EQConfig(),
        unroll=P, groups_per_block=G, num_blocks=K,
    )
    la, ta = jax.tree_util.tree_flatten(a)
    lb, tb = jax.tree_util.tree_flatten(b)
    assert ta == tb
    assert [(x.shape, x.dtype) for x in la] == [(x.shape, x.dtype) for x in lb]


def test_pipeline_host_builder_matches_oracle():
    """AudioPipeline serving split with the default (host) builder."""
    from dsp_audio_project_tpu import AudioPipeline, PipelineConfig, SRCConfig
    from dsp_audio_project_tpu.config import KernelConfig
    from dsp_audio_project_tpu.oracle import pipeline_oracle

    fs = 44100
    x = make_test_signal(30000, fs, seed=31)
    src = SRCConfig(L=160, M=147)
    cfg = PipelineConfig(
        src=src, eq=EQConfig(), kernels=KernelConfig(),
    )
    pipe = AudioPipeline(cfg)
    gains = (5.0, 0.0, -7.0, 2.0, 0.0, 9.0)
    ops = pipe.dynamic_eq_operators(np.asarray(gains), fs, len(x))
    z, _ = pipe.jit_forward_frames_dynamic_ops()(jnp.asarray(x), ops, fs)
    n_out = src.output_length(len(x))
    names = [n for n, _ in EQConfig().band_centers]
    want, _ = pipeline_oracle(
        x, fs, src, EQConfig.from_gains(dict(zip(names, gains))),
        engine="fast",
    )
    q = snr_db(want, np.asarray(z).reshape(-1)[:n_out])
    assert q > 95.0, f"{q:.1f} dB"


def test_stream_operators_host_tables():
    """DynStreamOperators: block tables equal the plain host builder's and
    the carry tables equal float64 matrix-power references."""
    from dsp_audio_project_tpu.ops.eq_dynamic import (
        build_dynamic_operators_host, build_dynamic_stream_operators_host,
    )

    fs = 48000
    gains = np.array([6.0, -3.0, 2.0, 5.0, -7.0, 4.0])
    U, G, K, nb = 160, 16, 4, 4
    dso = build_dynamic_stream_operators_host(
        gains, fs, EQConfig(), unroll=U, groups_per_block=G,
        num_blocks=K, num_shards=nb,
    )
    ops = build_dynamic_operators_host(
        gains, fs, EQConfig(), unroll=U, groups_per_block=G, num_blocks=None,
    )
    for name in ("group_in", "group_out", "fir_t", "toe", "pows_g", "A_blk"):
        np.testing.assert_array_equal(
            np.asarray(getattr(dso.ops, name)), np.asarray(getattr(ops, name)),
            err_msg=name,
        )
    d = dso.ops.A_blk.shape[0]
    A_blk = np.asarray(dso.ops.A_blk, np.float64)
    pk = np.asarray(dso.pk)
    assert pk.shape == (K, d, d)
    np.testing.assert_allclose(pk[1], np.asarray(dso.ops.A_blk), atol=0)
    A_sh = np.linalg.matrix_power(A_blk, K)
    pow_nb = np.asarray(dso.pow_nb)
    np.testing.assert_allclose(pow_nb[1], A_sh.astype(np.float32), atol=1e-6)
    w = np.asarray(dso.weights)
    assert w.shape == (nb, nb, d, d)
    np.testing.assert_allclose(w[2, 1], np.eye(d), atol=0)   # dst-1-src == 0
    np.testing.assert_allclose(w[3, 1], pow_nb[1], atol=0)
    assert np.all(w[0] == 0.0)                               # no src < dst=0
    w_out = np.asarray(dso.w_out)
    np.testing.assert_allclose(w_out[nb - 1], np.eye(d), atol=0)
    # carry_loc maps [0, e_0 .. e_{K-2}] -> sigma_k = sum pk[k-1-i] e_i
    cl = np.asarray(dso.carry_loc)
    rng = np.random.default_rng(0)
    e = rng.standard_normal((K, d)).astype(np.float32)
    vecs = np.concatenate([np.zeros((1, d), np.float32), e[: K - 1]])
    got = (vecs.reshape(-1) @ cl).reshape(K, d)
    want = np.zeros((K, d))
    for k in range(K):
        for i in range(k):
            want[k] += pk[k - 1 - i] @ e[i]
    np.testing.assert_allclose(got, want.astype(np.float32), atol=1e-4)
