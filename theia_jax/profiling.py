"""Profiling utilities (SURVEY aux §5.1).

The reference profiles via Vulkan timestamp queries around each command
batch; the equivalents here are (a) XLA's profiler — one call produces a
TensorBoard/Perfetto trace with per-HLO timing on the device — and (b)
simple steady-state wall-clock statistics with the compile excluded,
which is what bench.py and chip_smoke.py are built on.
"""

from __future__ import annotations

import contextlib
import subprocess
import time

import jax
import numpy as np

__all__ = ["trace_profile", "profile_batch", "batch_timings", "card_info"]


def card_info() -> str:
    """Name and power limit of each NVIDIA card, one line per card, as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    prints them. Read by a child process, so it never touches JAX's hold
    on the card; raises when ``nvidia-smi`` is missing or fails."""
    out = subprocess.run(
        [
            "nvidia-smi",
            "--query-gpu=name,power.limit",
            "--format=csv,noheader",
        ],
        capture_output=True,
        text=True,
        check=True,
        timeout=60,
    )
    return out.stdout.strip()


@contextlib.contextmanager
def trace_profile(logdir: str, *, annotate: str | None = None):
    """Capture an XLA profiler trace into ``logdir`` (open with
    TensorBoard's profile plugin or Perfetto). Wrap the region to
    profile::

        with trace_profile("/tmp/prof"):
            tracer.run()
    """
    with jax.profiler.trace(str(logdir)):
        if annotate is None:
            yield
        else:
            with jax.profiler.TraceAnnotation(annotate):
                yield


def batch_timings(tracer, *, runs: int = 5, warmup: int = 1) -> dict:
    """Steady-state per-batch wall-clock stats (seconds), compile
    excluded; the RNG advances per run so the device cannot serve a
    cached result."""
    ts = []
    for i in range(warmup + runs):
        t0 = time.perf_counter()
        out = tracer.run()
        jax.block_until_ready(jax.tree_util.tree_leaves(out))
        if i >= warmup:
            ts.append(time.perf_counter() - t0)
    arr = np.asarray(ts)
    return {
        "min": float(arr.min()),
        "median": float(np.median(arr)),
        "mean": float(arr.mean()),
        "max": float(arr.max()),
        "runs": runs,
        "batch_size": tracer.batchSize,
        "bounces_per_s": tracer.batchSize
        * getattr(tracer, "maxPathLength", getattr(tracer, "pathLength", 1))
        / float(arr.min()),
    }


def profile_batch(tracer, logdir: str, *, runs: int = 2) -> dict:
    """Profile ``runs`` steady-state batches into ``logdir`` (after one
    unprofiled warmup/compile run) and return their wall-clock stats."""
    tracer.run()  # compile outside the trace
    with trace_profile(logdir, annotate="theia_jax.batch"):
        stats = batch_timings(tracer, runs=runs, warmup=0)
    return stats
