"""Scene tracing: a glass-shelled lamp illuminating a detector sphere.

Mirrors the reference's examples/02_scene_tracing.ipynb: a light source
inside an air-filled BK7 glass shell, a black detector sphere nearby,
both submerged in scattering water. Fresnel transmission/reflection at
every interface; target-guide MIS accelerates convergence.

Run: python examples/02_scene_tracing.py
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax
import numpy as np

import theia_jax.units as u
from theia_jax.light import SphericalLightSource, UniformWavelengthSource
from theia_jax.material import (
    BK7Model,
    HenyeyGreensteinPhaseFunction,
    Material,
    MaterialStore,
    MediumModel,
    WaterBaseModel,
)
from theia_jax.random import PhiloxRNG
from theia_jax.response import HistogramHitResponse
from theia_jax.mesh import icosphere
from theia_jax.scene import MeshStore, Scene, Transform
from theia_jax.target import SphereTargetGuide
from theia_jax.trace import SceneForwardTracer


class WaterModel(WaterBaseModel, HenyeyGreensteinPhaseFunction, MediumModel):
    ModelName = "water"

    def __init__(self) -> None:
        WaterBaseModel.__init__(self, 10.0, 0.0, 35.0)
        HenyeyGreensteinPhaseFunction.__init__(self, 0.9)


def main() -> None:
    water = WaterModel().createMedium(num_lambda=256, num_theta=256)
    glass = BK7Model().createMedium(num_lambda=256, num_theta=4)
    mats = MaterialStore.pack(
        [
            # outer shell surface: glass inside, water outside
            Material("glass_water", glass, water, flags="TR"),
            # inner shell surface: air (vacuum) inside, glass outside
            Material("air_glass", None, glass, flags="TR"),
            # detector: black body, detectable
            Material("det_water", None, water, flags="DB"),
        ]
    )
    meshes = MeshStore({"sphere": icosphere()})
    light_pos, det_pos = (3.0, 0.0, 0.0), (0.0, 3.0, 0.0)
    scene = Scene(
        [
            meshes.createInstance(
                "sphere", "glass_water", Transform.TRS(scale=0.8, translate=light_pos)
            ),
            meshes.createInstance(
                "sphere", "air_glass", Transform.TRS(scale=0.75, translate=light_pos)
            ),
            meshes.createInstance(
                "sphere", "det_water",
                Transform.TRS(scale=0.6, translate=det_pos), detectorId=1,
            ),
        ],
        mats,
        medium="water",
        accel="bvh",  # native-built threaded BVH; "brute" for tiny scenes
    )
    tracer = SceneForwardTracer(
        64 * 1024,
        SphericalLightSource(position=light_pos, timeRange=(0.0, 10.0), budget=1e5),
        UniformWavelengthSource(lambdaRange=(300.0, 700.0)),
        HistogramHitResponse(nBins=100, t0=0.0, binSize=5.0 * u.ns),
        PhiloxRNG(key=42),
        scene,
        maxPathLength=8,
        sourceMedium="vacuum",  # source sits in the air-filled shell
        scatterCoefficient=0.05,
        targetId=1,
        targetGuide=SphereTargetGuide(position=det_pos, radius=0.6),
    )
    hist = 0.0
    for _ in range(4):
        h, _ = tracer.run()
        hist = hist + np.asarray(h)
    hist /= 4
    peak = int(hist.argmax())
    print(f"detector light curve: total={hist.sum():.4g}, "
          f"peak at {peak * 5.0:.0f} ns, first 10 bins: {np.round(hist[:10], 2)}")


if __name__ == "__main__":
    main()
