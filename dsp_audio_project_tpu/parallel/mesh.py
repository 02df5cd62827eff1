"""Device-mesh construction for the (channel, block) logical topology.

The workload's natural parallel axes (SURVEY.md §2.4):
  * ``channel`` — independent audio channels: pure data parallelism, no
    cross-device math.
  * ``block``   — contiguous time spans: this domain's sequence parallelism.
    FIR overlap-save halos and IIR state carries cross these boundaries as
    collectives (ppermute / all_gather).

The cards of one host reach each other all to all at one rate, so the mesh
follows the algorithm alone.  Across hosts, keep ``block`` within a host so
halo/carry traffic stays on the card-to-card links; ``channel`` traffic is
nil, so it can span hosts freely.
"""
from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec

from ..config import MeshConfig

CHANNEL_AXIS = "channel"
BLOCK_AXIS = "block"


def build_mesh(
    cfg: Optional[MeshConfig] = None,
    devices: Optional[Sequence[jax.Device]] = None,
) -> Mesh:
    """Create a (channel, block) mesh over the given (or all) devices."""
    devs = list(devices if devices is not None else jax.devices())
    if cfg is None:
        cfg = MeshConfig(channel_devices=1, block_devices=len(devs))
    n = cfg.channel_devices * cfg.block_devices
    if n > len(devs):
        raise ValueError(
            f"mesh needs {n} devices, have {len(devs)}"
        )
    grid = np.array(devs[:n]).reshape(cfg.channel_devices, cfg.block_devices)
    return Mesh(grid, (cfg.channel_axis, cfg.block_axis))


def single_device_mesh() -> Mesh:
    """1x1 mesh — the single-chip path runs the same shard_map code."""
    return Mesh(
        np.array(jax.devices()[:1]).reshape(1, 1), (CHANNEL_AXIS, BLOCK_AXIS)
    )


def signal_sharding(mesh: Mesh) -> NamedSharding:
    """(C, N) arrays: channels over 'channel', time over 'block'."""
    return NamedSharding(mesh, PartitionSpec(CHANNEL_AXIS, BLOCK_AXIS))
