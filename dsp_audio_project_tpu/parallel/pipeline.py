"""Sharded SRC -> EQ pipeline over a (channel, block) mesh.

Long-form and multichannel scale-out (SURVEY.md §5 "long-context"): the
reference processes a whole signal in one serial pass on one CPU
(app.py:162-167); here multichannel long-form audio shards across devices
with two — and only two — cross-device exchanges per step:

  1. **FIR halo (overlap-save).**  Each time-shard's polyphase frames read a
     few edge samples owned by its neighbors (left: max(0,-lo), right:
     max(0, W+lo-s) — ~20 samples for the 44.1k->48k plan).  Exchanged with
     `jax.lax.ppermute` shift-by-one; edge devices receive zeros, which is
     exactly numpy's 'same' zero extension, so sharding is bit-consistent
     with the unsharded op.

  2. **IIR carry.**  Each shard runs the block-parallel EQ from a zero
     state, exposing its local end state e_d (2 states per band — tiny).
     One `all_gather` over 'block' plus a host-precomputed weight tensor
     W[dst, src] = A^{(dst-1-src)*Nl_out} reconstructs every shard's true
     incoming state sigma_d = sum_{i<d} W e_i, and the standard block
     correction applies it locally.  No sequential chain ever crosses the
     mesh.

Geometry is host-side and static: shard lengths are rounded so each device
owns an integral number of polyphase frames AND an integral number of IIR
blocks; global zero-padding is cropped after gather (harmless: 'same'
zero-extension + causal IIR ⇒ prefix-exact).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.experimental.layout import Format, Layout
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import PipelineConfig, SRCConfig
from ..design.biquad import BlockOperators
from ..ops import eq as eq_ops
from ..ops import src as src_ops
from .mesh import BLOCK_AXIS, CHANNEL_AXIS
from ..routing import choose_route
from ..utils.precision import einsum_f32


@dataclasses.dataclass(frozen=True)
class ShardPlan:
    """Static geometry for one (config, input shape, mesh shape)."""

    n: int                 # true input length
    n_out: int             # true output length
    c: int                 # true channel count
    c_pad: int             # padded channel count (multiple of mesh channel dim)
    n_in_local: int        # input samples per block-shard
    n_out_local: int       # output samples per block-shard
    frames_local: int      # polyphase frames per shard
    halo_left: int
    halo_right: int
    iir_block: int         # IIR block length used inside shards
    route: str             # routing.choose_route's answer: cat | frames | flat


def _plan_shards(
    n: int, c: int, mesh_channel: int, mesh_block: int,
    src_cfg: SRCConfig, iir_block_hint: int, route: str,
) -> Tuple[ShardPlan, src_ops.PolyphasePlan | None]:
    if src_cfg.bypass:
        # Identity SRC: no filter, no halo — shards carry raw samples and
        # the local path skips the polyphase pass entirely (plan=None).
        plan = None
        s, Pcls = 1, 1
    else:
        plan = src_ops.make_plan(src_cfg.L, src_cfg.M, src_cfg.taps_rule_factor)
        s, Pcls = plan.s, plan.P

    # Frames per IIR block (IIR blocks must tile the per-shard output).
    # fpb is rounded up to a multiple of 16 so iir_block keeps a power-of-2
    # factor: block_operators halves its unroll until it divides the block,
    # and an odd block (e.g. P=3 with the default 8192 hint -> 8193) would
    # collapse unroll to 1 and build a (G*d)^2 Toeplitz in the gigabytes.
    # The frame-major routes pin fpb = FRAME_GRANULE — the same EQ geometry
    # as the unsharded equalize_frames (groups_per_block = FRAME_GRANULE).
    if route != "flat":
        fpb = src_ops.FRAME_GRANULE
    else:
        fpb = max(1, -(-iir_block_hint // Pcls))
        fpb = -(-fpb // 16) * 16
    iir_block = fpb * Pcls

    # Every shard holds a whole number of EQ blocks.  The pad frames land
    # in the LAST shard (global signal tail), so cross-shard carries stay
    # exact.
    frames_total = -(-n // (s * mesh_block * fpb)) * fpb * mesh_block
    frames_local = frames_total // mesh_block
    n_in_local = frames_local * s
    n_out_local = frames_local * Pcls

    # With a single block-shard there are no neighbors: the halo is pure
    # zero-extension, which resample_frames' own padding already provides.
    # Skipping it statically removes a full-signal concat.
    halo_left = plan.halo_left if plan is not None and mesh_block > 1 else 0
    halo_right = plan.halo_right if plan is not None and mesh_block > 1 else 0
    if max(halo_left, halo_right) > n_in_local and mesh_block > 1:
        raise ValueError(
            f"shard too small for filter halo: local={n_in_local}, "
            f"halo=({halo_left},{halo_right})"
        )
    c_pad = -(-c // mesh_channel) * mesh_channel
    sp = ShardPlan(
        n=n,
        n_out=src_cfg.output_length(n),
        c=c,
        c_pad=c_pad,
        n_in_local=n_in_local,
        n_out_local=n_out_local,
        frames_local=frames_local,
        halo_left=halo_left,
        halo_right=halo_right,
        iir_block=iir_block,
        route=route,
    )
    return sp, plan


def _halo_extend(x_loc: jnp.ndarray, sp: ShardPlan) -> jnp.ndarray:
    """ppermute halo exchange: [left tail | x_loc | right head].

    Edge devices receive zeros (the ppermute has no wrap link), which is
    exactly numpy's 'same' zero extension.
    """
    hl, hr = sp.halo_left, sp.halo_right
    nb = jax.lax.axis_size(BLOCK_AXIS)
    parts = [x_loc]
    if hl:
        left = jax.lax.ppermute(
            x_loc[..., -hl:], BLOCK_AXIS,
            [(i, i + 1) for i in range(nb - 1)],
        )
        parts.insert(0, left)
    if hr:
        right = jax.lax.ppermute(
            x_loc[..., :hr], BLOCK_AXIS,
            [(i + 1, i) for i in range(nb - 1)],
        )
        parts.append(right)
    return jnp.concatenate(parts, axis=-1) if len(parts) > 1 else x_loc


def _local_frames(
    x_loc: jnp.ndarray, plan: src_ops.PolyphasePlan, sp: ShardPlan,
    op=None, fast: bool = False,
) -> jnp.ndarray:
    """Shard-local polyphase frames (..., frames_local, V) after the
    ppermute halo exchange: frame 0's window starts at index lo + hl of the
    halo-extended signal (resample_frames zero-extends both edges itself,
    which is exactly the single-block-shard case where sp's halos are 0).
    ``op`` is the cat route's folded operator (default plan.G)."""
    x_ext = _halo_extend(x_loc.astype(jnp.float32), sp)
    return src_ops.resample_frames(
        x_ext, plan, sp.n_out_local, op=op, fast=fast,
        num_frames=sp.frames_local, pad_left=-(plan.lo + sp.halo_left),
    )


def _cross_shard_sigma(
    e_loc: jnp.ndarray, ops: BlockOperators, n_out_local: int
) -> jnp.ndarray:
    """Incoming IIR state for this shard from every shard's local end state.

    sigma_d = sum_{i<d} A^{(d-1-i)*n_out_local} e_i, evaluated with one
    all_gather of the tiny (d,)-state and a host-precomputed weight stack.
    """
    d = ops.A.shape[0]
    nb = jax.lax.axis_size(BLOCK_AXIS)
    my = jax.lax.axis_index(BLOCK_AXIS)
    # Host: A^{k * n_out_local} for k = 0..nb-1, in float64 then cast.
    n_blocks = n_out_local // ops.block
    A_shard = np.linalg.matrix_power(ops.state_corr, n_blocks)  # A^{n_out_local}
    powers = np.zeros((nb, d, d))
    acc = np.eye(d)
    for k_i in range(nb):
        powers[k_i] = acc
        acc = acc @ A_shard
    weights = np.zeros((nb, nb, d, d), dtype=np.float32)
    for dst in range(nb):
        for srcd in range(dst):
            weights[dst, srcd] = powers[dst - 1 - srcd]
    w_all = jnp.asarray(weights)  # (nb, nb, d, d)

    gathered = jax.lax.all_gather(e_loc, BLOCK_AXIS)  # (nb, ..., d)
    w_my = jnp.take(w_all, my, axis=0)  # (nb, d, d)
    return einsum_f32("sij,s...j->...i", w_my, gathered)


def build_sharded_pipeline(
    mesh: Mesh,
    config: PipelineConfig,
    fs: int,
    n: int,
    channels: int,
    need_y: bool = False,
):
    """Compile a sharded processor for fixed (fs, N, C).

    Returns ``(fn, shard_plan)`` where ``fn`` is jitted over the mesh and
    takes x of shape (c_pad, mesh_block * n_in_local); it returns z_padded
    on the cat route and (z_padded, y_padded) on the others.  Use
    ``run_sharded`` for the pad/crop wrapping.

    Each shard runs the route routing.choose_route picks
    (``shard_plan.route``): 'cat' (EQ-fused SRC, z only) unless
    ``need_y``; else 'frames' (frame-major SRC -> grouped EQ at
    unroll = P, the sharded twin of AudioPipeline.jit_forward_frames);
    'flat' for narrow strides and a bypassed SRC.
    """
    mesh_channel = mesh.shape[CHANNEL_AXIS]
    mesh_block = mesh.shape[BLOCK_AXIS]
    src_cfg, eq_cfg = config.src, config.eq
    kc = config.kernels

    # The route shapes the shard plan (EQ geometry), so resolve it first.
    route = choose_route(config, n, fs, need_y=need_y)
    fused = route != "flat"
    sp, plan = _plan_shards(
        n, channels, mesh_channel, mesh_block, src_cfg, kc.iir_block, route,
    )
    fs_out = src_cfg.output_rate(fs)
    bands = eq_cfg.active_bands(fs_out)
    eq_active = not eq_cfg.bypass and bool(bands)
    ops = (
        eq_ops.make_block_operators(
            bands, int(fs_out), eq_cfg.q, sp.iir_block,
            **({"unroll": plan.P} if fused else {}),
        )
        if eq_active
        else None
    )

    # Host tables for the one-pass carry composition: (A^block)^k maps the
    # shard's incoming state onto block k's correction (carry linearity:
    # sigma_k(sigma0) = sigma_k(0) + (A^block)^k sigma0).
    if eq_active:
        d = ops.A.shape[0]
        K_loc = sp.n_out_local // ops.block
        pows_k = np.zeros((K_loc, d, d))
        acc = np.eye(d)
        for k_i in range(K_loc):
            pows_k[k_i] = acc
            acc = acc @ ops.state_corr
        pows_k_dev = jnp.asarray(pows_k, dtype=jnp.float32)

    def _shard_sigma(e, sigma_local):
        """True per-block incoming states from local + cross-shard carries."""
        A_blk = jnp.asarray(ops.state_corr, dtype=jnp.float32)
        e_shard = (
            einsum_f32("ij,...j->...i", A_blk, sigma_local[..., -1, :])
            + e[..., -1, :]
        )
        sigma0 = _cross_shard_sigma(e_shard, ops, sp.n_out_local)
        return sigma_local + einsum_f32("kij,...j->...ki", pows_k_dev, sigma0)

    def _eq_finish(y0, s_in, e):
        sigma = _shard_sigma(e, eq_ops._carry_states(e, ops))
        return eq_ops._grouped_finish(y0, s_in, sigma, ops)

    def local_fn(x_loc):
        # x_loc: (C_local, n_in_local)
        if plan is None:  # SRC bypass: identity, no halo, zero FIR work
            y_fr = x_loc.astype(jnp.float32)[..., None]
        else:
            # The flat route's SRC runs at full f32, as ops/src.resample.
            y_fr = _local_frames(x_loc, plan, sp,
                                 fast=fused and kc.src_fast)
        lead = y_fr.shape[:-2]
        y_loc = y_fr.reshape(lead + (sp.n_out_local,))
        if not eq_active:
            z_loc = jnp.clip(y_loc, -1.0, 1.0) if not eq_cfg.bypass else y_loc
            return z_loc, y_loc
        # ONE local block pass: zero-init states + local carries; the
        # cross-shard state folds into the group-entry states (no second
        # full-width pass).  Fused: frames regroup along the leading axis
        # only (U = P); flat: the flat signal regroups at ops.unroll.
        U = ops.unroll
        x_g = y_loc.reshape(lead + (K_loc, ops.block // U, U))
        y0, s_in, e = eq_ops._grouped_parts(x_g, ops, fast=kc.eq_fast)
        z = _eq_finish(y0, s_in, e)
        return jnp.clip(z.reshape(y_loc.shape), -1.0, 1.0), y_loc

    spec = P(CHANNEL_AXIS, BLOCK_AXIS)
    if route == "cat":
        fold = src_ops.fold_operator(plan, eq_ops.eq_cat_weights(ops))
        fpb = ops.block // plan.P

        def local_fn_cat(x_loc):
            cat = _local_frames(x_loc, plan, sp, op=fold,
                                fast=kc.src_fast and kc.eq_fast)
            y0f, inj = cat[..., : plan.P], cat[..., plan.P :]
            lead = y0f.shape[:-2]
            d = inj.shape[-1]
            s_in, e = eq_ops._state_solve(
                inj.reshape(lead + (K_loc, fpb, d)), ops.group_toeplitz,
                fast=kc.eq_fast,
            )
            z = _eq_finish(y0f.reshape(lead + (K_loc, fpb, plan.P)), s_in, e)
            return jnp.clip(
                z.reshape(lead + (sp.n_out_local,)), -1.0, 1.0
            )

        sharded = shard_map(
            local_fn_cat, mesh=mesh,
            in_specs=(spec,), out_specs=spec,
            check_vma=False,
        )
        return _auto_layout_jit(sharded, 1), sp

    sharded = shard_map(
        local_fn, mesh=mesh,
        in_specs=(spec,), out_specs=(spec, spec),
        check_vma=False,
    )
    return _auto_layout_jit(sharded, 2), sp


def _auto_layout_jit(fun, n_out: int):
    """jit with AUTO output layouts: the caller fetches the outputs, and
    XLA's native layout fetches bit-identically without a normalizing
    copy of the full output."""
    auto = Format(Layout.AUTO)
    return jax.jit(
        fun, out_shardings=auto if n_out == 1 else (auto,) * n_out
    )


_sharded_cache: dict = {}


def run_sharded(
    x: np.ndarray,
    fs: int,
    config: PipelineConfig,
    mesh: Mesh,
    need_y: bool = False,
) -> Tuple[jax.Array, jax.Array | None, int, ShardPlan]:
    """Pad, shard, process, crop: the host-facing sharded entry point.

    ``x``: (C, N) float32.  Returns (z, y, fs_out, plan) with z cropped to
    the true (C, n_out).  y is None on the cat route, which never forms
    it; pass ``need_y`` when the caller needs it (see
    build_sharded_pipeline).
    """
    if x.ndim == 1:
        x = x[None, :]
    c, n = x.shape
    # One compile per (mesh, config, geometry): repeated calls reuse the
    # jitted executable (a fresh build per call would retrace every time —
    # Mesh, PipelineConfig and the ints are all hashable).
    key = (mesh, config, fs, n, c, need_y)
    hit = _sharded_cache.get(key)
    if hit is None:
        hit = build_sharded_pipeline(mesh, config, fs, n, c, need_y=need_y)
        _sharded_cache[key] = hit
    fn, sp = hit
    mesh_block = mesh.shape[BLOCK_AXIS]
    n_padded = sp.n_in_local * mesh_block
    xp = np.zeros((sp.c_pad, n_padded), dtype=np.float32)
    xp[:c, :n] = x
    sharding = NamedSharding(mesh, P(CHANNEL_AXIS, BLOCK_AXIS))
    xd = jax.device_put(xp, sharding)
    fs_out = config.src.output_rate(fs)
    if sp.route == "cat":
        z = fn(xd)
        return z[:c, : sp.n_out], None, fs_out, sp
    z, y = fn(xd)
    return z[:c, : sp.n_out], y[:c, : sp.n_out], fs_out, sp
