"""Host-clock timing of device calls.

JAX dispatches asynchronously, so every timed call ends in
``block_until_ready``; the first call of each shape compiles and is
reported apart from the steady-state times.
"""
from __future__ import annotations

import time
from typing import Callable, List, Tuple


def time_calls(fn: Callable, *args, reps: int = 10,
               warmup: int = 1) -> Tuple[float, List[float]]:
    """(first-call seconds, steady-state seconds per call) of ``fn(*args)``.

    The first call includes compilation; ``warmup - 1`` further untimed
    calls precede the ``reps`` timed ones.
    """
    import jax

    if reps < 1 or warmup < 1:
        raise ValueError("reps and warmup must be >= 1")
    t0 = time.perf_counter()
    jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    for _ in range(warmup - 1):
        jax.block_until_ready(fn(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return first, times
