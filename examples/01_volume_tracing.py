"""Volume tracing: light curve of a spherical detector in scattering water.

Mirrors the reference's examples/01_volume_tracing.ipynb: build a water
model, an isotropic source and a sphere target, run the volume forward
tracer into a time histogram — plus, beyond the reference, a gradient of
the light curve with respect to the water's absorption.

Run: python examples/01_volume_tracing.py
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax
import jax.numpy as jnp
import numpy as np

import theia_jax.units as u
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
    """Sea water at 10 degC, 35 PSU salinity, g=0.9 HG scattering."""

    def __init__(self) -> None:
        WaterBaseModel.__init__(self, 10.0, 0.0, 35.0)
        HenyeyGreensteinPhaseFunction.__init__(self, 0.9)


def build_tracer(medium):
    return VolumeForwardTracer(
        batchSize=64 * 1024,
        source=SphericalLightSource(
            position=(-1.0, -7.0, 0.0) * np.array(u.m),
            timeRange=(0.0, 0.0),
            budget=1e9,
        ),
        target=SphereTarget(position=(0.0, 0.0, 0.0), radius=5.0 * u.m),
        wavelengthSource=UniformWavelengthSource(lambdaRange=(400.0, 500.0) * np.array(u.nm)),
        response=HistogramHitResponse(nBins=100, binSize=5.0 * u.ns, t0=0.0),
        rng=PhiloxRNG(key=0xC0FFEE),
        medium=medium,
        nScattering=10,
        maxTime=500.0 * u.ns,
    )


def main() -> None:
    water = WaterModel().createMedium()
    tracer = build_tracer(water)
    hist = 0.0
    for _ in range(5):
        h, _ = tracer.run()
        hist = hist + np.asarray(h)
    hist /= 5
    peak = int(hist.argmax())
    print(f"light curve: total={hist.sum():.4g} photons, peak bin={peak} "
          f"({peak * 5.0:.0f} ns)")

    # -- differentiability (not in the reference) --------------------------
    # gradient of the total detected signal w.r.t. the absorption table
    trace_fn, args = tracer.trace_fn()

    def loss(medium_params):
        p = tracer.params()
        p["medium"] = medium_params
        resp_state, _ = trace_fn(p, *args[1:])
        return tracer.response.result(p["response"], resp_state).sum()

    g = jax.grad(loss)(tracer.params()["medium"])
    dmu = np.asarray(g.absorption_coef)
    print(f"d(total)/d(mu_a): mean={dmu.mean():.4g} (negative: more "
          "absorption, less light)")


if __name__ == "__main__":
    main()
