"""Compilation settings of the repository's programs.

The persistent XLA compilation cache directory is
``JAX_COMPILATION_CACHE_DIR`` when that is set, and otherwise
``.jax_cache`` under the directory the caller names (the checkout). No
other path is set in code.

:func:`jit` compiles the tracers' programs with :data:`COMPILER_OPTIONS`.
"""

from __future__ import annotations

import os
from pathlib import Path

__all__ = ["COMPILER_OPTIONS", "cache_dir", "enable", "jit"]

#: XLA options of every tracer program. XLA:GPU's autotuner stalled for
#: more than 12 minutes on the scene tracer's 10-segment step on an H100;
#: with autotuning off that step compiles in about half a minute. The
#: option is given per program, so the other programs of a process keep
#: autotuning, and it works whenever JAX's backend was started. XLA:CPU
#: ignores it.
COMPILER_OPTIONS = {"xla_gpu_autotune_level": 0}


def jit(fn, **kwargs):
    """``jax.jit`` with :data:`COMPILER_OPTIONS`; use it for a tracer's
    step and for any program built around ``trace_fn()``."""
    import jax

    return jax.jit(fn, compiler_options=COMPILER_OPTIONS, **kwargs)


def cache_dir(root) -> str:
    """The cache directory for a checkout rooted at ``root``."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or str(
        Path(root) / ".jax_cache"
    )


def enable(root, *, min_compile_secs: float = 0.5) -> str:
    """Point JAX's persistent compilation cache at :func:`cache_dir` and
    return that directory. Call before the first compilation."""
    import jax

    path = cache_dir(root)
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update(
        "jax_persistent_cache_min_compile_time_secs", min_compile_secs
    )
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return path
