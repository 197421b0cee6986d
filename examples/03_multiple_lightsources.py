"""Multiple light sources: separate pipelines, one shared histogram.

Mirrors the reference's examples/03_multiple_lightsources.ipynb: the
radiance field is linear, so each source runs its own pipeline and the
results add. The scheduler takes named pipelines and tasks address them
by name; because both tracers share one response, the process function
does not need to know which pipeline produced a batch.

Run: python examples/03_multiple_lightsources.py
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax
import numpy as np

import theia_jax.units as u
from theia_jax.light import (
    ConeLightSource,
    SphericalLightSource,
    UniformWavelengthSource,
)
from theia_jax.material import (
    HenyeyGreensteinPhaseFunction,
    MediumModel,
    WaterBaseModel,
)
from theia_jax.pipeline import Pipeline, PipelineScheduler
from theia_jax.random import PhiloxRNG
from theia_jax.response import HistogramHitResponse
from theia_jax.target import SphereTarget
from theia_jax.trace import VolumeForwardTracer


class WaterModel(WaterBaseModel, HenyeyGreensteinPhaseFunction, MediumModel):
    def __init__(self) -> None:
        WaterBaseModel.__init__(self, 10.0, 0.0, 35.0)
        HenyeyGreensteinPhaseFunction.__init__(self, 0.9)


def make_tracer(source, medium, response, key):
    return VolumeForwardTracer(
        32 * 1024,
        source,
        SphereTarget(position=(0.0, 0.0, 0.0), radius=5.0 * u.m),
        UniformWavelengthSource(lambdaRange=(400.0, 500.0)),
        response,
        PhiloxRNG(key=key),
        medium=medium,
        nScattering=8,
        maxTime=500.0 * u.ns,
    )


def main() -> None:
    water = WaterModel().createMedium()
    # both tracers share the response stage -> results accumulate naturally
    response = HistogramHitResponse(nBins=100, binSize=5.0 * u.ns, t0=0.0)

    flash = make_tracer(
        SphericalLightSource(
            position=(-1.0, -7.0, 0.0), timeRange=(0.0, 0.0), budget=1e9
        ),
        water, response, key=0xAAAA,
    )
    beam = make_tracer(
        ConeLightSource(
            position=(8.0, 0.0, 0.0),
            direction=(-1.0, 0.0, 0.0),
            cosOpeningAngle=0.9,
            timeRange=(50.0, 50.0),
            budget=5e8,
        ),
        water, response, key=0xBBBB,
    )

    total = np.zeros(100)

    def process(config, batch, result):
        nonlocal total
        total = total + np.asarray(result[0])

    scheduler = PipelineScheduler(
        [("flash", Pipeline(flash)), ("beam", Pipeline(beam))],
        processFn=process,
    )
    # four batches per source, addressed by pipeline name
    scheduler.schedule(
        [("flash", {}), ("beam", {})] * 4
    )
    total /= 4
    print(f"combined light curve: total={total.sum():.4g}")
    for name, t in (("flash", 0.0), ("beam", 50.0)):
        lo = int(t / 5)
        print(f"  {name} arrival window sum (bins {lo}..{lo + 20}):"
              f" {total[lo:lo + 20].sum():.4g}")


if __name__ == "__main__":
    main()
