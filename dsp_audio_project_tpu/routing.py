"""The one rule that picks the path a configuration runs on.

Every entry point (``AudioPipeline``, ``run_sharded``,
``ShardedStreamProcessor``, the benchmarks) asks ``choose_route``; the
answer depends on the plan and the configuration alone, never on the
backend.  All routes are plain JAX compiled by XLA:

* ``'cat'``    — frame-major SRC whose operator has the EQ's first matmul
  folded in (ops/src.resample_frames_cat), then the EQ's state solve and
  readout (ops/eq.equalize_frames_cat).  The SRC intermediate y is never
  formed, so it serves callers that need z only.
* ``'frames'`` — frame-major SRC (ops/src.resample_frames) feeding the EQ
  at unroll = P (ops/eq.equalize_frames): every reshape between the
  stages is a free leading-axis regroup.
* ``'flat'``   — flat SRC (ops/src.resample) and flat EQ (ops/eq.equalize
  at KernelConfig.iir_block / iir_unroll): narrow strides, short signals
  and the bypasses.
"""
from __future__ import annotations

from typing import Optional

from .config import PipelineConfig

ROUTES = ("cat", "frames", "flat")

# The frame-major routes want wide strides: the SRC runs J = ceil(W/s)
# shifted matmuls of depth s, and the EQ groups P outputs per frame.
MIN_FRAME_STRIDE = 8


def frames_supported(config: PipelineConfig, n: Optional[int] = None) -> bool:
    """True when the frame-major route covers this configuration (and an
    ``n``-sample input, when given: shorter than the filter, the 'same'
    centering differs and the flat route handles it)."""
    src = config.src
    if src.bypass:
        return False
    from .ops.src import make_plan

    plan = make_plan(src.L, src.M, src.taps_rule_factor)
    if plan.s < MIN_FRAME_STRIDE:
        return False
    return n is None or n * src.L >= src.num_taps


def cat_supported(config: PipelineConfig, n: Optional[int] = None,
                  fs: Optional[int] = None, dynamic: bool = False) -> bool:
    """True when the EQ-fused cat route covers this configuration: the
    frame-major geometry plus an active EQ at the output rate (the fold
    happens against its operators; ``fs`` None skips that check).  With
    ``dynamic`` gains (traced inputs) every band filters, whatever the
    configured gains."""
    if not frames_supported(config, n):
        return False
    if dynamic:
        return True
    if config.eq.bypass:
        return False
    return fs is None or bool(
        config.eq.active_bands(config.src.output_rate(fs))
    )


def choose_route(config: PipelineConfig, n: Optional[int] = None,
                 fs: Optional[int] = None, need_y: bool = False,
                 dynamic: bool = False) -> str:
    """'cat' | 'frames' | 'flat' for this configuration and input.

    ``need_y``: the caller needs the SRC intermediate y as a tensor, which
    the cat route never forms.  ``dynamic``: the EQ gains are traced
    inputs (see cat_supported).
    """
    if not need_y and cat_supported(config, n, fs, dynamic):
        return "cat"
    if frames_supported(config, n):
        return "frames"
    return "flat"
