"""Detector array: a grid of instanced modules traced with the
two-level instanced acceleration.

The domain's production scenario: many copies of one detector-module
mesh stamped across a lattice (here 3x3x3 BK7-shelled spheres in
scattering water) with a flash in the middle. ``accel="auto"`` picks
the two-level instanced traversal (``Scene`` docs): each
photon wavefront lane tests the 27 module bounding boxes, then scans
only its candidate modules' shared prototype mesh — cost stays
near-constant as the array grows, where a flattened scan grows
linearly.

Per-module light curves come from the stamped detector ids: the
``HitRecorder`` keeps (detector id, time, contribution) per hit, so one
trace yields every module's transient.

Run: python examples/08_detector_array.py
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
from theia_jax.render import SceneTemplate
from theia_jax.response import HitRecorder
from theia_jax.mesh import icosphere
from theia_jax.scene import MeshStore, Transform
from theia_jax.trace import SceneForwardTracer


class Water(WaterBaseModel, HenyeyGreensteinPhaseFunction, MediumModel):
    ModelName = "water"

    def __init__(self):
        WaterBaseModel.__init__(self, 10.0 * u.m, 0.0, 35.0)
        HenyeyGreensteinPhaseFunction.__init__(self, 0.9)


def main() -> None:
    water = Water().createMedium(num_lambda=64, num_theta=64)
    glass = BK7Model().createMedium(num_lambda=64, num_theta=4)
    mats = MaterialStore.pack(
        [
            # photons arrive from the water; detect & absorb at the shell
            Material("det_shell", glass, water, flags="DB"),
        ]
    )

    meshes = MeshStore({"sphere": icosphere()})
    proto = meshes.createInstance(
        "sphere", "det_shell", Transform.TRS(scale=0.35 * u.m)
    )
    template = SceneTemplate([proto])

    n_side, spacing = 3, 2.0 * u.m
    transforms = [
        Transform.TRS(
            translate=(
                (i - 1) * spacing,
                (j - 1) * spacing,
                (k - 1) * spacing,
            )
        )
        for i in range(n_side)
        for j in range(n_side)
        for k in range(n_side)
        if not (i == j == k == 1)  # keep the center free for the flash
    ]
    scene = template.createScene(transforms, mats, medium="water")
    print(f"accel backend picked by auto: {scene.accel}")

    recorder = HitRecorder()
    tracer = SceneForwardTracer(
        64 * 1024,
        SphericalLightSource(
            position=(0.0, 0.0, 0.0), timeRange=(0.0, 0.0), budget=1e9
        ),
        UniformWavelengthSource(lambdaRange=(400.0 * u.nm, 500.0 * u.nm)),
        recorder,
        PhiloxRNG(key=0xA11CE),
        scene,
        maxPathLength=8,
        maxTime=120.0 * u.ns,
    )

    hits, _ = tracer.run()
    valid = np.asarray(hits["valid"])
    det = np.asarray(hits["objectId"])[valid]
    t = np.asarray(hits["time"])[valid]
    contrib = np.asarray(hits["contrib"])[valid]

    n_det = len(transforms)
    totals = np.zeros(n_det)
    np.add.at(totals, det, contrib)
    first = np.full(n_det, np.inf)
    np.minimum.at(first, det, t)

    # the 6 face-adjacent modules sit nearest the flash: earliest light
    order = np.argsort(first)
    print(f"{int(valid.sum())} hits across {np.count_nonzero(totals)} modules")
    for d in order[:6]:
        print(
            f"  module {d:2d}: first light {first[d]:6.2f} ns, "
            f"total {totals[d]:.3e} photons"
        )
    assert np.count_nonzero(totals) >= n_det // 2
    print("per-module light curves recorded")


if __name__ == "__main__":
    main()
