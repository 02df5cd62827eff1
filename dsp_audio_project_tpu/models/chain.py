"""The flagship pipeline model: x --SRC--> y --EQ--> z (+ analysis spectra).

This is the framework's equivalent of the reference's processing cascade
(app.py:162-167) plus its spectrum fan-out (app.py:203-205): one jittable,
shardable function per static configuration.  SRC changes the sample rate,
the EQ runs at the *output* rate, and the FFT is analysis-only — the layer
boundary the reference fixes (SURVEY.md §1).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from jax.experimental.layout import Format, Layout

from ..config import PipelineConfig
from ..ops.eq import (
    eq_cat_weights, equalize, equalize_frames, equalize_frames_cat,
    make_block_operators,
)
from ..ops.eq_dynamic import (
    build_dynamic_operators, build_dynamic_operators_host, dyn_cat_weights,
    equalize_dynamic_cat_ops, equalize_dynamic_frames,
    equalize_dynamic_frames_ops,
)
from ..ops.spectrum import (
    magnitude_spectrum, spectra_mag_stacked, spectrum_rows_needed,
    spectrum_window, spectrum_window_frames, spectrum_window_rows,
)
from ..ops.src import (
    FRAME_GRANULE, fold_operator, frame_count, make_plan, resample,
    resample_frames, resample_frames_cat, resample_rows,
)
from ..routing import cat_supported, choose_route, frames_supported
from ..utils.profiling import trace_stage


@dataclasses.dataclass(frozen=True)
class PipelineOutputs:
    """Device results of one pipeline invocation."""

    output: jnp.ndarray          # z[n] at the output rate
    resampled: Optional[jnp.ndarray]  # y[n], the SRC intermediate (None
                                      # where the cat route never formed it)
    fs_out: int
    spectra: Optional[Dict[str, Tuple[np.ndarray, jnp.ndarray]]] = None


class AudioPipeline:
    """Configured SRC->EQ chain, jit-compiled per (config, input length).

    Usage:
        pipe = AudioPipeline(PipelineConfig(src=SRCConfig(L=160, M=147),
                                            eq=EQConfig.from_gains({"Bass": 6})))
        out = pipe(x, fs)          # x: (..., N) float32 on host or device
    """

    def __init__(self, config: PipelineConfig = PipelineConfig()):
        self.config = config
        # One jax.jit wrapper per forward, built on first use; fs is static
        # everywhere (it feeds filter design and rate arithmetic on host).
        self._jit_cache: Dict[str, object] = {}

    def _forward(self, x: jnp.ndarray, fs: int) -> Tuple[jnp.ndarray, jnp.ndarray]:
        """Flat route: (x, fs) -> (z, y); its SRC runs at full f32."""
        cfg = self.config
        kc = cfg.kernels
        with trace_stage("src"):
            y, fs_out = resample(x, fs, cfg.src)
        with trace_stage("eq"):
            z = equalize(y, fs_out, cfg.eq, block=kc.iir_block,
                         unroll=kc.iir_unroll, fast=kc.eq_fast)
        return z, y

    def output_rate(self, fs: int) -> int:
        return self.config.src.output_rate(fs)

    def route(self, n: int, fs: int, need_y: bool = False) -> str:
        """The route (routing.choose_route) for ``n``-sample inputs."""
        return choose_route(self.config, n, fs, need_y=need_y)

    def __call__(
        self, x, fs: int, *, with_spectra: bool = False
    ) -> PipelineOutputs:
        x = jnp.asarray(x, dtype=jnp.float32)
        fs_out = self.output_rate(fs)
        # The caller gets y, so the cat route (which never forms y) is out.
        if self.route(x.shape[-1], fs, need_y=True) == "frames":
            z, y = self._cached_jit("frames_flat", self._forward_frames_flat,
                                    static_argnums=(1,))(x, fs)
        else:
            z, y = self.jit_forward()(x, fs)
        spectra = None
        if with_spectra:
            scfg = self.config.spectrum
            spectra = {
                "input": magnitude_spectrum(x, fs, scfg),
                "resampled": magnitude_spectrum(y, fs_out, scfg),
                "output": magnitude_spectrum(z, fs_out, scfg),
            }
        return PipelineOutputs(output=z, resampled=y, fs_out=fs_out, spectra=spectra)

    def jit_forward(self):
        """The raw jitted flat-route (x, fs) -> (z, y) function."""
        return self._cached_jit("flat", self._forward, static_argnums=(1,))

    # ---- frame-major route ----------------------------------------------
    #
    # ops/src.resample_frames emits (..., F, P) frames (F a multiple of
    # FRAME_GRANULE) and equalize_frames consumes them at unroll = P.  The
    # flat signal is frames.reshape(..., F*P)[..., :n_out], a free view
    # once fetched to host.

    def _plan(self):
        src = self.config.src
        return make_plan(src.L, src.M, src.taps_rule_factor)

    def frames_supported(self, n: int) -> bool:
        """True when the frame-major route covers this input."""
        return frames_supported(self.config, n)

    def _src_frames(self, x: jnp.ndarray) -> jnp.ndarray:
        cfg = self.config
        n_out = cfg.src.output_length(x.shape[-1])
        with trace_stage("src"):
            return resample_frames(x, self._plan(), n_out, pad_frames=True,
                                   fast=cfg.kernels.src_fast)

    def _forward_frames(self, x: jnp.ndarray, fs: int):
        """(x, fs) -> (z_frames, y_frames): frame-major SRC->EQ.

        z/y flat = frames.reshape(..., -1)[..., :output_length(n)].
        """
        cfg = self.config
        fs_out = cfg.src.output_rate(fs)
        y_frames = self._src_frames(x)
        with trace_stage("eq"):
            z_frames = equalize_frames(y_frames, fs_out, cfg.eq,
                                       fast=cfg.kernels.eq_fast)
        return z_frames, y_frames

    def _forward_frames_flat(self, x: jnp.ndarray, fs: int):
        """Frame-major route with the flat crop inside the jit boundary."""
        zf, yf = self._forward_frames(x, fs)
        n_out = self.config.src.output_length(x.shape[-1])
        z = zf.reshape(zf.shape[:-2] + (-1,))[..., :n_out]
        y = yf.reshape(yf.shape[:-2] + (-1,))[..., :n_out]
        return z, y

    def jit_forward_frames(self):
        """Jitted frame-major (x, fs) -> (z_frames, y_frames); see
        frames_supported."""
        return self._cached_jit("frames", self._forward_frames,
                                static_argnums=(1,))

    # ---- full chain: SRC -> EQ -> spectra of x, y, z ---------------------
    #
    # The reference's per-render work is the cascade PLUS a magnitude
    # spectrum of all three signals (app.py:202-205); these forwards fold
    # the spectra into the same jitted program.

    def _forward_frames_spectra(self, x: jnp.ndarray, fs: int):
        """(x, fs) -> (z_frames, y_frames, (mag_x, mag_y, mag_z)); the
        three spectra run as ONE batched rFFT (spectra_mag_stacked)."""
        zf, yf = self._forward_frames(x, fs)
        cfg = self.config
        n_out = cfg.src.output_length(x.shape[-1])
        scfg = cfg.spectrum
        with trace_stage("spectra"):
            mx, my, mz = spectra_mag_stacked([
                spectrum_window(x, scfg),
                spectrum_window_frames(yf, n_out, scfg),
                spectrum_window_frames(zf, n_out, scfg),
            ])
        return zf, yf, (mx, my, mz)

    def _forward_spectra(self, x: jnp.ndarray, fs: int):
        """Flat-route full chain: (x, fs) -> (z, y, (mag_x, mag_y, mag_z))."""
        z, y = self._forward(x, fs)
        scfg = self.config.spectrum
        with trace_stage("spectra"):
            mx, my, mz = spectra_mag_stacked([
                spectrum_window(x, scfg), spectrum_window(y, scfg),
                spectrum_window(z, scfg),
            ])
        return z, y, (mx, my, mz)

    # ---- EQ-fused cat route ---------------------------------------------
    #
    # The EQ's first matmul, frames @ [group_fir^T | group_in], has
    # frame-independent weights, so it folds into the SRC operator on the
    # host (float64 G @ w_cat, ops/src.fold_operator): the SRC emits the
    # EQ's y0 and state injections directly and the frames tensor never
    # exists.  The EQ keeps only the group-Toeplitz state solve + readout
    # (ops/eq.equalize_frames_cat).  The y/z analysis rows come out as tiny
    # side tensors (y recomputed from x with resample_rows, z from row
    # slices of y0 and the states).

    def cat_supported(self, n: int, fs: int) -> bool:
        """True when the EQ-fused cat route covers this (config, input)."""
        return cat_supported(self.config, n, fs)

    def _cat_pieces(self, x: jnp.ndarray, fs: int):
        """Shared cat-route front end: ((y0, inj), plan, n_out, fs_out)."""
        cfg = self.config
        kc = cfg.kernels
        plan = self._plan()
        n_out = cfg.src.output_length(x.shape[-1])
        fs_out = cfg.src.output_rate(fs)
        bands = cfg.eq.active_bands(fs_out)
        ops = make_block_operators(
            bands, int(fs_out), cfg.eq.q, FRAME_GRANULE * plan.P, plan.P
        )
        with trace_stage("src"):
            pair = resample_frames_cat(
                x, plan, n_out, fold_operator(plan, eq_cat_weights(ops)),
                pad_frames=True, fast=kc.src_fast and kc.eq_fast,
            )
        return pair, plan, n_out, fs_out

    def _forward_cat(self, x: jnp.ndarray, fs: int) -> jnp.ndarray:
        """(x, fs) -> z_frames through the EQ-fused cat route.

        z flat = z_frames.reshape(..., -1)[..., :output_length(n)]; the
        SRC intermediate y is never materialized (use the frames route
        when you need it as a tensor).
        """
        cfg = self.config
        (y0, inj), plan, n_out, fs_out = self._cat_pieces(x, fs)
        with trace_stage("eq"):
            return equalize_frames_cat(
                y0, inj, fs_out, cfg.eq, unroll=plan.P,
                fast=cfg.kernels.eq_fast,
            )

    def _forward_cat_spectra(self, x: jnp.ndarray, fs: int):
        """(x, fs) -> (z_frames, (mag_x, mag_y, mag_z)) — the full-chain
        headline program on the cat route.  The y spectrum's ~13 frame
        rows are recomputed from x (ops/src.resample_rows, full-precision
        design matmul); the z rows ride out of the EQ as a side tensor."""
        cfg = self.config
        scfg = cfg.spectrum
        (y0, inj), plan, n_out, fs_out = self._cat_pieces(x, fs)
        r0, r1 = spectrum_rows_needed(n_out, plan.P, scfg)
        with trace_stage("eq"):
            z, z_rows = equalize_frames_cat(
                y0, inj, fs_out, cfg.eq, unroll=plan.P,
                fast=cfg.kernels.eq_fast, rows=(r0, r1),
            )
        with trace_stage("spectra"):
            y_rows = resample_rows(x.astype(jnp.float32), plan, r0, r1)
            mx, my, mz = spectra_mag_stacked([
                spectrum_window(x, scfg),
                spectrum_window_rows(y_rows, r0, n_out, scfg),
                spectrum_window_rows(z_rows, r0, n_out, scfg),
            ])
        return z, (mx, my, mz)

    def _cached_jit(self, name: str, fun, **kw):
        """The jax.jit wrapper of forward ``name``, built on first use."""
        hit = self._jit_cache.get(name)
        if hit is None:
            hit = self._jit_cache[name] = jax.jit(fun, **kw)
        return hit

    def jit_forward_cat(self):
        """Jitted cat-route (x, fs) -> z_frames; see cat_supported.

        AUTO output layout: the caller fetches z, and XLA's native layout
        fetches bit-identically without a normalizing copy of z."""
        return self._cached_jit(
            "cat", self._forward_cat, static_argnums=(1,),
            out_shardings=Format(Layout.AUTO),
        )

    def jit_forward_cat_spectra(self):
        """Jitted cat-route full chain (x, fs) -> (z_frames, (mx, my, mz))."""
        return self._cached_jit("cat_spectra", self._forward_cat_spectra,
                                static_argnums=(1,))

    def jit_forward_frames_spectra(self):
        """Jitted frame-major full chain (x, fs) -> (z_f, y_f, (mx, my, mz)).

        Frequency axes are host constants: ops.spectrum.spectrum_freqs(n, fs)
        for x and spectrum_freqs(output_length(n), output_rate(fs)) for y/z.
        """
        return self._cached_jit("frames_spectra",
                                self._forward_frames_spectra,
                                static_argnums=(1,))

    def jit_forward_spectra(self):
        """Jitted flat full chain (x, fs) -> (z, y, (mx, my, mz))."""
        return self._cached_jit("spectra", self._forward_spectra,
                                static_argnums=(1,))

    # ---- dynamic gains: gains as traced inputs ---------------------------

    def jit_forward_frames_dynamic(self):
        """Jitted frame-major (x, gains_db, fs) -> (z_frames, y_frames).

        Traced gains: ONE compile serves every gain vector (per-request EQ
        at zero compile cost).  Band geometry/config comes from
        self.config.eq; gains_db overrides the gains, ordered like
        EQConfig.band_centers.  The jit wrapper is cached on the pipeline,
        so calling this per request shares one compile cache.
        """
        cfg = self.config

        def forward(x, gains_db, fs):
            y_frames = self._src_frames(x)
            z_frames = equalize_dynamic_frames(
                y_frames, gains_db, cfg.src.output_rate(fs), cfg.eq,
                fast=cfg.kernels.eq_fast,
            )
            return z_frames, y_frames

        return self._cached_jit("frames_dynamic", forward,
                                static_argnums=(2,))

    # ---- serving split: build operators on gain change, apply per batch --
    #
    # In-graph operator construction inside jit_forward_frames_dynamic
    # runs on every batch whether or not gains changed.  The split
    # amortizes it: dynamic_eq_operators builds the operators when a
    # request carries new gains; jit_forward_frames_dynamic_ops is the
    # per-batch path, structurally identical to the static frame route.

    def dynamic_eq_geometry(self, fs: int, n: int,
                            groups_per_block: int = FRAME_GRANULE):
        """(unroll, groups_per_block, num_blocks) the dynamic builders use
        for ``n``-sample inputs — exposed so harnesses can call the builder
        phases (host tables / upload / expand) with the exact serving
        geometry."""
        plan = self._plan()
        F = frame_count(plan, self.config.src.output_length(n),
                        pad_frames=True)
        return plan.P, groups_per_block, -(-F // groups_per_block)

    def dynamic_eq_operators(self, gains_db, fs: int, n: int,
                             groups_per_block: int = FRAME_GRANULE,
                             builder: str = "auto"):
        """Build dynamic-gains EQ operators for ``n``-sample inputs.

        The result is a DynOperators pytree to pass to
        jit_forward_frames_dynamic_ops()(x, ops, fs).

        ``builder``: 'host' runs the exact float64 numpy design (the serving
        path — a request's gains are concrete values); 'traced' runs the
        in-graph df32 builder (gains may be tracers/device arrays; one
        compile serves every gain vector); 'auto' picks 'host' for concrete
        gains and 'traced' under a trace.
        """
        cfg = self.config
        fs_out = cfg.src.output_rate(fs)
        U, G, K = self.dynamic_eq_geometry(fs, n, groups_per_block)
        if builder == "auto":
            builder = (
                "traced" if isinstance(gains_db, jax.core.Tracer) else "host"
            )
        if builder == "host":
            return build_dynamic_operators_host(
                gains_db, fs_out, cfg.eq, unroll=U,
                groups_per_block=G, num_blocks=K,
            )
        return build_dynamic_operators(
            jnp.asarray(gains_db, jnp.float32), fs_out, cfg.eq,
            unroll=U, groups_per_block=G, num_blocks=K,
        )

    def dynamic_cat_tables(self, dyn_ops):
        """The cat route's folded SRC operator G @ [fir^T | group_in]
        (W, P+d), computed on device from prebuilt DynOperators — once per
        gain change, a few hundred KB.  Pass it to
        jit_forward_cat_dynamic_ops() alongside the same dyn_ops."""
        plan = self._plan()
        fold = self._cached_jit(
            "cat_fold", lambda o: fold_operator(plan, dyn_cat_weights(o))
        )
        return fold(dyn_ops)

    def jit_forward_cat_dynamic_ops(self):
        """Jitted cat (x, dyn_ops, fold, fs) -> z_frames: dynamic gains on
        the cat route.

        Per gain change, fold the operator on device (dynamic_cat_tables)
        from the same DynOperators the EQ finish consumes; per batch, the
        chain is structurally identical to the static cat route.  Requires
        cat_supported geometry.
        """
        cfg = self.config
        kc = cfg.kernels

        def forward(x, dops, fold, fs):
            n_out = cfg.src.output_length(x.shape[-1])
            with trace_stage("src"):
                y0, inj = resample_frames_cat(
                    x, self._plan(), n_out, fold, pad_frames=True,
                    fast=kc.src_fast and kc.eq_fast,
                )
            with trace_stage("eq"):
                return equalize_dynamic_cat_ops(y0, inj, dops,
                                                fast=kc.eq_fast)

        return self._cached_jit("cat_dynamic_ops", forward,
                                static_argnums=(3,))

    def jit_forward_frames_dynamic_ops(self):
        """Jitted frame-major (x, ops, fs) -> (z_frames, y_frames) with
        prebuilt EQ operators — no in-graph operator construction, so the
        per-batch cost matches the static frame route.
        """
        cfg = self.config

        def forward(x, ops, fs):
            y_frames = self._src_frames(x)
            with trace_stage("eq"):
                z_frames = equalize_dynamic_frames_ops(
                    y_frames, ops, fast=cfg.kernels.eq_fast,
                )
            return z_frames, y_frames

        return self._cached_jit("frames_dynamic_ops", forward,
                                static_argnums=(2,))
