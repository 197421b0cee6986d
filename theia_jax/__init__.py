"""theia_jax — a differentiable transient Monte Carlo path tracer in JAX.

A from-scratch JAX framework with the capabilities of the reference
Vulkan ray tracer (tkerscher/theia): time-resolved, optionally polarized
Monte Carlo light propagation through scattering media with physically
correct Fresnel interaction at media boundaries, producing light curves —
plus, beyond the reference, end-to-end differentiability w.r.t. medium
parameters and multi-device scaling via jax.sharding.
"""

from . import units
from .random import PhiloxRNG, RNGState

__version__ = "0.1.0"

#: submodules reachable as ``theia_jax.<name>`` without an explicit
#: import, like the reference package root (ref __init__.py __all__);
#: loaded lazily so importing the root stays cheap and cycle-free
_SUBMODULES = {
    "accel", "callback", "camera", "cascades", "component", "items",
    "light", "lookup", "material", "mesh", "parallel", "pipeline",
    "polarization", "profiling", "random", "render", "response", "scene",
    "target", "task", "testing", "trace",
}

__all__ = sorted(_SUBMODULES | {"units", "PhiloxRNG", "RNGState"})


def __getattr__(name: str):
    import importlib

    if name in _SUBMODULES:
        return importlib.import_module("." + name, __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
