"""The persistent compilation cache goes where JAX_COMPILATION_CACHE_DIR
says, and otherwise to .jax_cache in the checkout."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

from theia_jax import compile_cache

ROOT = Path(__file__).resolve().parents[1]


def test_env_var_wins(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.cache_dir(ROOT) == str(tmp_path)


@pytest.mark.parametrize("value", [None, ""])
def test_default_is_in_the_checkout(monkeypatch, value):
    if value is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    else:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", value)
    assert compile_cache.cache_dir(ROOT) == str(ROOT / ".jax_cache")


_PROGRAM = """
import sys
from theia_jax import compile_cache
path = compile_cache.enable(sys.argv[1], min_compile_secs=0.0)
import jax, jax.numpy as jnp
jax.block_until_ready(jax.jit(lambda x: jnp.sin(x) * 3.0 + 1.0)(jnp.arange(7.0)))
print(path)
"""


@pytest.mark.parametrize("with_env", [True, False])
def test_cache_lands_in_the_chosen_directory(tmp_path, with_env):
    """A fresh process compiles one function; its cache entry appears in
    the env var's directory, or in <root>/.jax_cache without it."""
    env = dict(os.environ, PYTHONPATH=str(ROOT), JAX_PLATFORMS="cpu")
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    root = tmp_path / "checkout"
    want = tmp_path / "env_cache" if with_env else root / ".jax_cache"
    if with_env:
        env["JAX_COMPILATION_CACHE_DIR"] = str(want)
    out = subprocess.run(
        [sys.executable, "-c", _PROGRAM, str(root)],
        env=env, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == str(want)
    assert want.is_dir() and any(want.iterdir())


def test_jit_passes_the_compiler_options(monkeypatch):
    """compile_cache.jit hands COMPILER_OPTIONS to XLA: an option XLA does
    not know is refused, the real ones compile and run."""
    import jax.numpy as jnp

    f = lambda x: jnp.sin(x) * 3.0
    monkeypatch.setattr(compile_cache, "COMPILER_OPTIONS", {"xla_no_such_option": 0})
    with pytest.raises(Exception, match="xla_no_such_option"):
        compile_cache.jit(f)(jnp.arange(3.0))
    monkeypatch.undo()
    assert compile_cache.COMPILER_OPTIONS == {"xla_gpu_autotune_level": 0}
    assert float(compile_cache.jit(f)(jnp.float32(0.5))) == pytest.approx(3.0 * 0.479425538)


def _tiny_volume_tracer():
    from theia_jax.light import SphericalLightSource, UniformWavelengthSource
    from theia_jax.random import PhiloxRNG
    from theia_jax.response import HistogramHitResponse
    from theia_jax.target import SphereTarget
    from theia_jax.testing import WaterTestModel
    from theia_jax.trace import VolumeForwardTracer

    return VolumeForwardTracer(
        256,
        SphericalLightSource(position=(-2.0, 0.0, 0.0), budget=1.0),
        SphereTarget(position=(0.0, 0.0, 0.0), radius=0.5),
        UniformWavelengthSource(lambdaRange=(400.0, 500.0)),
        HistogramHitResponse(nBins=10, t0=0.0, binSize=5.0),
        PhiloxRNG(key=1),
        medium=WaterTestModel().createMedium(),
        nScattering=2,
    )


@pytest.mark.parametrize("entry", ["run", "shard_trace"])
def test_tracer_programs_use_the_compiler_options(monkeypatch, entry):
    """A tracer's own step and shard_trace's program are compiled with
    COMPILER_OPTIONS (a bogus option makes them fail)."""
    import jax

    from theia_jax.parallel import make_photon_mesh, shard_trace, sharded_streams

    monkeypatch.setattr(compile_cache, "COMPILER_OPTIONS", {"xla_no_such_option": 0})
    tracer = _tiny_volume_tracer()
    with pytest.raises(Exception, match="xla_no_such_option"):
        if entry == "run":
            tracer.run()
        else:
            mesh = make_photon_mesh(jax.devices()[:2])
            shard_trace(tracer, mesh)(
                tracer.params(), tracer.rng.counter_words, sharded_streams(256, mesh)
            )


def test_import_leaves_xla_flags_alone():
    """Importing the package sets no process-wide XLA flag."""
    env = dict(os.environ, PYTHONPATH=str(ROOT), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    code = "import os, theia_jax, theia_jax.trace; print(repr(os.environ.get('XLA_FLAGS')))"
    out = subprocess.run(
        [sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "None"
