"""Utility tier: precision wrappers, profiling helpers, mesh construction."""
import numpy as np
import pytest
import jax
import jax.numpy as jnp

from dsp_audio_project_tpu.config import MeshConfig, SRCConfig
from dsp_audio_project_tpu.parallel.mesh import build_mesh, signal_sharding, single_device_mesh
from dsp_audio_project_tpu.utils.precision import (
    einsum_f32, matmul_f32, matvec_f32, vecmat_f32,
)


def test_precision_wrappers(rng):
    a = jnp.asarray(rng.standard_normal((5, 7)).astype(np.float32))
    b = jnp.asarray(rng.standard_normal((7, 3)).astype(np.float32))
    v = jnp.asarray(rng.standard_normal(7).astype(np.float32))
    np.testing.assert_allclose(np.asarray(matmul_f32(a, b)),
                               np.asarray(a) @ np.asarray(b), atol=1e-5)
    np.testing.assert_allclose(np.asarray(vecmat_f32(v, b)),
                               np.asarray(v) @ np.asarray(b), atol=1e-5)
    m = jnp.asarray(rng.standard_normal((4, 7)).astype(np.float32))
    np.testing.assert_allclose(np.asarray(matvec_f32(m, v)),
                               np.asarray(m) @ np.asarray(v), atol=1e-5)
    np.testing.assert_allclose(
        np.asarray(einsum_f32("ij,jk->ik", a, b)),
        np.asarray(a) @ np.asarray(b), atol=1e-5)


def test_df32_compensated_arithmetic(rng):
    """df32 ops must hold ~45+ bits under jit — i.e. XLA's reassociation of
    the error-free transforms is successfully blocked (utils/df32.py)."""
    from dsp_audio_project_tpu.utils import df32

    a64 = rng.uniform(0.5, 2.0, 64)
    b64 = rng.uniform(0.5, 2.0, 64)

    def split(x):
        hi = np.float32(x)
        return jnp.asarray(hi), jnp.asarray(np.float32(x - np.float64(hi)))

    @jax.jit
    def probe(ah, al, bh, bl):
        x, y = (ah, al), (bh, bl)
        return (df32.mul(x, y), df32.add(x, y), df32.sub(x, y),
                df32.div(x, y), df32.sqrt(x))

    m, s, d, q, r = probe(*split(a64), *split(b64))

    def relerr(v, truth):
        got = np.float64(np.asarray(v[0])) + np.float64(np.asarray(v[1]))
        return np.max(np.abs(got - truth) / np.abs(truth))

    assert relerr(m, a64 * b64) < 1e-12
    assert relerr(s, a64 + b64) < 1e-12
    assert relerr(d, a64 - b64) < 1e-10   # subtraction may cancel
    assert relerr(q, a64 / b64) < 1e-11
    assert relerr(r, np.sqrt(a64)) < 1e-12

    # the cancellation-amplification chain that broke before the barriers:
    # 1 + tiny must keep the tiny part to df precision.
    @jax.jit
    def chain(t_hi, t_lo):
        return df32.add(df32.df(1.0), (t_hi, t_lo))

    tiny = 2.849501721230871e-3
    got = chain(*split(np.float64(tiny)))
    err = abs(np.float64(got[0]) + np.float64(got[1]) - (1.0 + tiny))
    assert err < 1e-12

    # small dense linalg: df32 matmul of ill-scaled mats vs float64
    A = rng.uniform(-1, 1, (12, 12))
    B = rng.uniform(-1, 1, (12, 12))

    @jax.jit
    def pm(Ah, Al, Bh, Bl):
        return df32.mmul((Ah, Al), (Bh, Bl))

    Ph, Pl = pm(*split(A), *split(B))
    got = np.float64(np.asarray(Ph)) + np.float64(np.asarray(Pl))
    assert np.max(np.abs(got - A @ B)) < 1e-12


def test_mesh_construction():
    mesh = build_mesh(MeshConfig(channel_devices=2, block_devices=4))
    assert mesh.shape == {"channel": 2, "block": 4}
    sh = signal_sharding(mesh)
    assert sh.spec == ("channel", "block")
    m1 = single_device_mesh()
    assert m1.shape == {"channel": 1, "block": 1}


def test_mesh_too_many_devices():
    with pytest.raises(ValueError, match="devices"):
        build_mesh(MeshConfig(channel_devices=4, block_devices=4))


def test_stage_timer():
    from dsp_audio_project_tpu.utils.profiling import StageTimer

    t = StageTimer()
    with t.stage("a"):
        sum(range(1000))
    with t.stage("b"):
        pass
    assert set(t.timings_s) == {"a", "b"}
    assert "a:" in t.report()


def test_roofline_helper():
    from dsp_audio_project_tpu.utils import profiling

    kind = "NVIDIA H100 80GB HBM3"
    frac = profiling.roofline_fraction(3.35e12 / 2, 1.0, kind=kind)
    assert abs(frac - 0.5) < 1e-12
    t, bound = profiling.bound_seconds(2e12, 1e9, 1e12, 1e12)
    assert (t, bound) == (2.0, "compute")
    t, bound = profiling.bound_seconds(1e9, 4e12, 1e12, 1e12)
    assert (t, bound) == (4.0, "memory")
    # A device with no row in the peak table is an error, not a default.
    with pytest.raises(KeyError, match="no peak rates"):
        profiling.device_peaks("Some Unknown Accelerator")
    with pytest.raises(ValueError):
        profiling.roofline_fraction(1.0, 0.0, kind=kind)


def test_src_config_validation():
    with pytest.raises(ValueError):
        SRCConfig(L=0, M=1)
    cfg = SRCConfig(L=160, M=147)
    assert cfg.num_taps == 6401
    assert cfg.output_rate(44100) == 48000
    assert cfg.output_length(44100) == 48000


def test_measure_helpers_run():
    from dsp_audio_project_tpu.utils.benchmarking import time_calls

    f = jax.jit(lambda v: jnp.sum(v * 2))
    first, times = time_calls(f, jnp.ones(64), reps=5, warmup=2)
    assert first > 0 and len(times) == 5 and all(t > 0 for t in times)
    with pytest.raises(ValueError):
        time_calls(f, jnp.ones(4), reps=0)


@pytest.mark.parametrize("env_dir", [True, False])
def test_compcache_honours_env_var(env_dir, tmp_path):
    """JAX_COMPILATION_CACHE_DIR wins when set; otherwise the fixed
    <repo>/.jax_cache — never a per-run path."""
    import subprocess
    import sys

    env = {k: v for k, v in __import__("os").environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    if env_dir:
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / "cc")
    code = ("from dsp_audio_project_tpu.utils.compcache import enable, "
            "DEFAULT_DIR; import jax; p = enable(); "
            "print(p); print(jax.config.jax_compilation_cache_dir); "
            "print(DEFAULT_DIR)")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    path, configured, default = out.stdout.split()
    want = str(tmp_path / "cc") if env_dir else default
    assert path == configured == want
    assert default.endswith(".jax_cache")


def _fake_plane(name, lines):
    from types import SimpleNamespace as NS

    return NS(name=name, lines=[
        NS(name=ln, events=[
            NS(name=en, start_ns=s0, duration_ns=d,
               stats=[("hlo_op", en), ("hlo_module", "jit_step")])
            for en, s0, d in evs])
        for ln, evs in lines])


def test_deviceprof_reduction_on_trace_fixture():
    """Busy time is the union of device intervals (overlaps once, summary
    lines ignored, host planes ignored); idle share over the window."""
    from dsp_audio_project_tpu.utils.deviceprof import reduce_device_events

    planes = [
        _fake_plane("/host:CPU", [("python", [("host_work", 0, 1000)])]),
        _fake_plane("/device:GPU:0", [
            ("Stream #13(compute)", [("fusion.1", 100, 50),
                                     ("dot.2", 120, 80)]),
            ("Stream #14(compute)", [("fusion.3", 300, 100)]),
            ("XLA Ops", [("fusion.1", 100, 50)]),
        ]),
        _fake_plane("/device:GPU:1", [("Stream #13(compute)",
                                       [("fusion.1", 100, 20)])]),
    ]
    prof = reduce_device_events(planes)
    assert prof.busy_ns == 200.0            # [100,200) + [300,400)
    assert prof.window_ns == 300.0
    assert abs(prof.idle_share - 1 / 3) < 1e-12
    assert prof.ops_ns == {"fusion.1": 70.0, "dot.2": 80.0, "fusion.3": 100.0}
    assert prof.modules_ns == {"jit_step": 250.0}
    assert prof.device_busy_ns == {"/device:GPU:0": 200.0,
                                   "/device:GPU:1": 20.0}
    assert prof.top_ops(1) == [("fusion.3", 100.0)]


def test_deviceprof_raises_without_device_events():
    """A trace with no GPU device events (e.g. a CPU run) raises instead of
    reporting 0 device time."""
    from dsp_audio_project_tpu.utils.deviceprof import (
        reduce_device_events, trace_device,
    )

    with pytest.raises(RuntimeError, match="no device events"):
        reduce_device_events([_fake_plane("/host:CPU", [
            ("python", [("x", 0, 10)])])])
    if jax.default_backend() != "gpu":
        f = jax.jit(lambda v: v @ v)
        with pytest.raises(RuntimeError, match="no device events"):
            trace_device(lambda: f(jnp.ones((64, 64))))


def test_chip_smoke_fails_without_gpu(tmp_path):
    """chip_smoke.py exits non-zero and prints no result line where there
    is no GPU — and from a directory holding nothing else of the repo."""
    import os
    import shutil
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    lone = tmp_path / "lone"
    lone.mkdir()
    shutil.copy(os.path.join(root, "chip_smoke.py"), lone)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    for cwd, script in ((root, "chip_smoke.py"),
                        (str(lone), str(lone / "chip_smoke.py"))):
        out = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                             capture_output=True, text=True, timeout=600)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
