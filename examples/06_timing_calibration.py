"""Timing inference: recover group velocity from light-curve shape.

Hard-binned histograms freeze arrival times at the bin edges, but the
kernel (KDE) histogram is smooth in time — so gradients flow from the
light curve's SHAPE back into parameters that shift arrival times.
Here we recover a hidden scaling of the medium's group velocity from
the observed mean arrival time.

Run: python examples/06_timing_calibration.py
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax
import dataclasses

import jax.numpy as jnp
import numpy as np

from theia_jax import compile_cache
from theia_jax.light import SphericalLightSource, UniformWavelengthSource
from theia_jax.random import PhiloxRNG
from theia_jax.response import KernelHistogramHitResponse
from theia_jax.target import SphereTarget
from theia_jax.testing import WaterTestModel
from theia_jax.trace import VolumeForwardTracer


def main() -> None:
    tracer = VolumeForwardTracer(
        16 * 1024,
        SphericalLightSource(position=(0.0, 0.0, 0.0), timeRange=(0.0, 0.0), budget=1e9),
        SphereTarget(position=(15.0, 0.0, 0.0), radius=4.0),
        UniformWavelengthSource(lambdaRange=(450.0, 450.0)),
        KernelHistogramHitResponse(nBins=60, binSize=4.0, t0=0.0, bandwidth=4.0),
        PhiloxRNG(key=0x7157),
        medium=WaterTestModel(mu_a=0.001, mu_s=0.02, g=0.4).createMedium(),
        nScattering=6,
        maxTime=250.0,
    )
    trace_fn, (p0, counter, streams) = tracer.trace_fn()
    bins = jnp.arange(60, dtype=jnp.float32)

    def curve(log_vg_scale):
        med = dataclasses.replace(
            p0["medium"],
            group_velocity=p0["medium"].group_velocity * jnp.exp(log_vg_scale),
        )
        p = dict(p0)
        p["medium"] = med
        state, _ = trace_fn(p, counter, streams)
        return tracer.response.result(p["response"], state)

    true_scale = jnp.log(0.92)  # hidden: light 8% slower than the model
    observed = curve(true_scale)

    def loss(x):
        d = (curve(x) - observed) / (observed.sum() + 1.0)
        return jnp.sum(d * d) * 1e6

    grad = compile_cache.jit(jax.value_and_grad(loss))
    x, m, v = 0.0, 0.0, 0.0
    b1, b2 = 0.9, 0.999
    for step in range(1, 13):
        lr = 0.05 / np.sqrt(step)
        value, g = grad(x)
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        x = x - lr * (m / (1 - b1**step)) / (np.sqrt(v / (1 - b2**step)) + 1e-8)
        if step % 4 == 0 or step == 1:
            print(f"step {step:2d}: loss={float(value):.3e} "
                  f"vg scale={float(jnp.exp(x)):.4f} (truth 0.9200)")
    print(f"recovered group-velocity scale: {float(jnp.exp(x)):.4f} "
          f"({abs(float(jnp.exp(x)) / 0.92 - 1) * 100:.2f}% from truth)")


if __name__ == "__main__":
    main()
