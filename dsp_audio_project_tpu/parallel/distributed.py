"""Multi-host (multi-process) execution support.

The reference is single-process (SURVEY.md §2.4); several hosts each drive
their local cards and JAX's runtime links them (`jax.distributed`).  Design
rules for this workload:

* The ``block`` (time) axis carries the halo/carry collectives — lay it
  along a host's local devices (contiguous on it) so `ppermute` /
  `all_gather` traffic stays on the host's card-to-card links.  With B
  block-shards per host, only the two host-boundary halos per step cross
  the network between hosts.
* The ``channel`` axis has zero cross-device math, so it can span hosts
  freely — put the host dimension there when channels >= hosts.

``initialize()`` wraps ``jax.distributed.initialize``; ``multihost_mesh``
builds the (channel, block) mesh over all global devices with the layout
above.  The same shard_map pipeline (parallel/pipeline.py) runs unchanged —
collective layout is a mesh property, not a code path.

CI has one process: multi-process wiring is smoke-tested by spawning
coordinator+worker subprocesses on the CPU backend (tests/test_distributed.py)
and the collective code paths themselves are covered by the 8-virtual-device
tests.
"""
from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh

from ..config import MeshConfig


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Join the distributed runtime (no-op when already initialized).

    Pass coordinator_address (``host:port``), num_processes and process_id
    explicitly unless the cluster environment provides them.
    """
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    except RuntimeError as e:  # already initialized
        if "already" not in str(e).lower():
            raise


def multihost_mesh(
    channel_hosts: Optional[int] = None,
    cfg: Optional[MeshConfig] = None,
) -> Mesh:
    """(channel, block) mesh over ALL processes' devices.

    Layout: devices are ordered host-major by jax.devices(); the block axis
    is laid within each host's local devices (ICI) and the channel axis
    across hosts (DCN), per the module docstring.  ``channel_hosts`` groups
    that many hosts onto the channel axis (default: all of them).
    """
    cfg = cfg or MeshConfig()
    devs = jax.devices()
    n_local = jax.local_device_count()
    n_hosts = max(1, len(devs) // n_local)
    ch = channel_hosts if channel_hosts is not None else n_hosts
    if n_hosts % ch:
        raise ValueError(f"channel_hosts={ch} must divide host count {n_hosts}")
    block = len(devs) // ch
    grid = np.array(devs).reshape(ch, block)
    return Mesh(grid, (cfg.channel_axis, cfg.block_axis))


def process_count() -> int:
    return jax.process_count()


def is_primary() -> bool:
    """True on the process that should do I/O and logging."""
    return jax.process_index() == 0
