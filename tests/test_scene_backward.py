"""Scene backward tracers (model: reference tests/test_trace_energy.py:354-478
SceneBackwardTracer and :728-832 SceneBackwardTargetTrace)."""

import numpy as np
import pytest

import jax.numpy as jnp

import theia_jax.units as u
from theia_jax.camera import PointCamera, SphereCamera
from theia_jax.light import SphericalLightSource, UniformWavelengthSource
from theia_jax.material import (
    DispersionFreeMedium,
    HenyeyGreensteinPhaseFunction,
    Material,
    MaterialStore,
    MediumModel,
)
from theia_jax.random import PhiloxRNG
from theia_jax.response import HistogramHitResponse, HitRecorder
from theia_jax.mesh import icosphere
from theia_jax.scene import MeshStore, Scene, Transform
from theia_jax.trace.scene_backward import (
    SceneBackwardTargetTracer,
    SceneBackwardTracer,
)


class Model(DispersionFreeMedium, HenyeyGreensteinPhaseFunction, MediumModel):
    ModelName = "water"

    def __init__(self, a=0.0, s=0.01, g=0.3):
        DispersionFreeMedium.__init__(self, n=1.33, ng=1.33, mu_a=a, mu_s=s)
        HenyeyGreensteinPhaseFunction.__init__(self, g)


def test_backward_target_emissive_sphere():
    """Point camera inside an emissive ('LB') sphere in vacuum: every ray
    responds with contrib 4pi at the ballistic arrival time."""
    mat = Material("emit", None, None, flags="LB")
    store = MaterialStore.pack([mat])
    meshes = MeshStore({"sphere": icosphere()})
    inst = meshes.createInstance("sphere", "emit", Transform.TRS(scale=10.0))
    scene = Scene([inst], store, medium=None)
    batch = 4 * 1024
    rec = HitRecorder()
    tracer = SceneBackwardTargetTracer(
        batch,
        PointCamera(position=(0.0, 0.0, 0.0)),
        UniformWavelengthSource(lambdaRange=(450.0, 450.0)),
        rec,
        PhiloxRNG(key=3),
        scene,
        maxPathLength=3,
        maxTime=float("inf"),
    )
    hits, _ = tracer.run()
    valid = np.asarray(hits["valid"])
    assert valid.sum() > 0.99 * batch
    contrib = np.asarray(hits["contrib"])[valid]
    assert np.allclose(contrib, 4 * np.pi, rtol=1e-5)
    t = np.asarray(hits["time"])[valid]
    # vacuum flight to the mesh sphere wall (faces are chords of r=10)
    assert np.all(t >= 0.992 * 10.0 / u.c)
    assert np.all(t <= 10.01 / u.c)


@pytest.mark.slow
def test_scene_backward_matches_volume_backward():
    """With only a distant non-interacting object in the scene, the scene
    backward tracer must match the volume backward estimator."""
    from theia_jax.trace.backward import VolumeBackwardTracer

    medium = Model(0.0, 0.02, -0.4).createMedium()
    position = (12.0, 15.0, 0.2)
    radius = 100.0
    # a tiny black sphere far outside the detector sphere
    mat = Material("bb", None, medium, flags="B")
    store = MaterialStore.pack([mat])
    meshes = MeshStore({"sphere": icosphere()})
    far = meshes.createInstance(
        "sphere", "bb", Transform.TRS(scale=1.0, translate=(500.0, 0.0, 0.0))
    )
    scene = Scene([far], store, medium="water")

    def total_of(tracer, n_batches=6):
        total = 0.0
        for _ in range(n_batches):
            hits, _ = tracer.run()
            v = np.asarray(hits["valid"])
            total += np.asarray(hits["contrib"])[v].sum()
        return total / (tracer.batchSize * n_batches)

    batch = 32 * 1024
    common = dict(
        medium=medium,
        nScattering=12,
        maxTime=float("inf"),
    )
    vol = VolumeBackwardTracer(
        batch,
        SphericalLightSource(position=position, timeRange=(10.0, 10.0), budget=1e9),
        SphereCamera(position=position, radius=-radius),
        UniformWavelengthSource(lambdaRange=(450.0, 450.0)),
        HitRecorder(),
        PhiloxRNG(key=0xC0FFEE),
        **common,
    )
    scn = SceneBackwardTracer(
        batch,
        SphericalLightSource(position=position, timeRange=(10.0, 10.0), budget=1e9),
        SphereCamera(position=position, radius=-radius),
        UniformWavelengthSource(lambdaRange=(450.0, 450.0)),
        HitRecorder(),
        PhiloxRNG(key=0xC0FFEE),
        scene,
        medium="water",
        maxPathLength=12,
        maxTime=float("inf"),
    )
    t_vol = total_of(vol)
    t_scn = total_of(scn)
    assert np.abs(t_scn / t_vol - 1.0) < 0.05
