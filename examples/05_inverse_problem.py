"""Inverse problem: recover water absorption from an observed light curve.

The capability the reference does not have: light curves are
differentiable with respect to medium parameters, so a detector's time
histogram can drive gradient-based inference. Here we simulate an
"observation" with a hidden absorption coefficient, then recover it by
descending the squared light-curve mismatch with Adam — using common
random numbers so the gradient is exact for the realized estimator.

Run: python examples/05_inverse_problem.py
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax
import dataclasses

import jax.numpy as jnp
import numpy as np

import theia_jax.units as u
from theia_jax import compile_cache
from theia_jax.light import SphericalLightSource, UniformWavelengthSource
from theia_jax.material import (
    HenyeyGreensteinPhaseFunction,
    MediumModel,
    WaterBaseModel,
)
from theia_jax.random import PhiloxRNG
from theia_jax.response import HistogramHitResponse
from theia_jax.target import SphereTarget
from theia_jax.trace import VolumeForwardTracer


class WaterModel(WaterBaseModel, HenyeyGreensteinPhaseFunction, MediumModel):
    def __init__(self) -> None:
        WaterBaseModel.__init__(self, 10.0, 0.0, 35.0)
        HenyeyGreensteinPhaseFunction.__init__(self, 0.6)


def main() -> None:
    medium = WaterModel().createMedium()
    tracer = VolumeForwardTracer(
        32 * 1024,
        SphericalLightSource(position=(-1.0, -7.0, 0.0), timeRange=(0.0, 0.0), budget=1e9),
        SphereTarget(position=(0.0, 0.0, 0.0), radius=5.0 * u.m),
        UniformWavelengthSource(lambdaRange=(450.0, 450.0)),
        HistogramHitResponse(nBins=60, binSize=5.0 * u.ns, t0=0.0),
        PhiloxRNG(key=0xD1CE),
        medium=medium,
        nScattering=8,
        maxTime=300.0 * u.ns,
    )
    trace_fn, (p0, counter, streams) = tracer.trace_fn()

    def curve(log_scale):
        """Light curve with the absorption table scaled by exp(log_scale)."""
        med = dataclasses.replace(
            p0["medium"],
            absorption_coef=p0["medium"].absorption_coef * jnp.exp(log_scale),
        )
        p = dict(p0)
        p["medium"] = med
        state, _ = trace_fn(p, counter, streams)
        return tracer.response.result(p["response"], state)

    # hidden truth: absorption 1.35x the model's table
    true_scale = jnp.log(1.35)
    observed = curve(true_scale)

    def loss(log_scale):
        delta = (curve(log_scale) - observed) / (observed.sum() + 1.0)
        return jnp.sum(delta * delta) * 1e6

    grad = compile_cache.jit(jax.value_and_grad(loss))
    x, m, v = 0.0, 0.0, 0.0  # start at scale 1.0; Adam state
    b1, b2 = 0.9, 0.999
    for step in range(1, 16):
        lr = 0.3 / np.sqrt(step)  # decay against stochastic curvature
        value, g = grad(x)
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        x = x - lr * (m / (1 - b1**step)) / (jnp.sqrt(v / (1 - b2**step)) + 1e-8)
        if step % 5 == 0 or step == 1:
            print(f"step {step:2d}: loss={float(value):.3e} "
                  f"scale={float(jnp.exp(x)):.4f} (truth 1.3500)")
    err = abs(float(jnp.exp(x)) / 1.35 - 1.0)
    print(f"recovered absorption scale: {float(jnp.exp(x)):.4f} "
          f"({err * 100:.2f}% from truth)")


if __name__ == "__main__":
    main()
