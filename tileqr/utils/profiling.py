"""Tracing/profiling utilities (SURVEY.md §5 tracing row).

The reference's observability is CUDA-event timing; the equivalents here: a
profiler trace contextmanager (``jax.profiler``, which traces the GPU), a
warm timer that waits with ``block_until_ready``, and an HLO dump helper for
inspecting what XLA scheduled.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable

import jax


@contextlib.contextmanager
def trace(dirname: str):
    """Capture a profiler trace of the enclosed block into ``dirname``
    (``plugins/profile/<time>/*.xplane.pb``; read it with
    ``jax.profiler.ProfileData.from_file`` or TensorBoard)."""
    jax.profiler.start_trace(dirname)
    try:
        yield dirname
    finally:
        jax.profiler.stop_trace()


def warm_time(fn: Callable, *args, reps: int = 3):
    """Time ``fn(*args)``, waiting for each call with ``block_until_ready``.

    Returns (seconds of the first call, which includes compilation, best
    seconds over ``reps`` warm calls, the last result)."""
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    best = float("inf")
    for _ in range(max(1, reps)):
        del out
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return first, best, out


def dump_hlo(fn, *args, stage: str = "stablehlo") -> str:
    """Lowered/compiled text of ``fn(*args)`` for schedule inspection."""
    lowered = jax.jit(fn).lower(*args)
    if stage == "stablehlo":
        return lowered.as_text()
    return lowered.compile().as_text()
