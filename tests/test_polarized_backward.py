"""Polarized (Mueller) backward transport in VolumeBackwardTracer.

The backward ray accumulates a Mueller matrix (reference: ray.scatter.glsl
backward specialization, ray.combine.glsl combineRaysAligned); at each
light connection the source Stokes vector is transported through the
chain and S0 folds into the contribution."""

import numpy as np
import pytest

from theia_jax.camera import SphereCamera
from theia_jax.light import SphericalLightSource, UniformWavelengthSource
from theia_jax.material import (
    HenyeyGreensteinPhaseFunction,
    KokhanovskyOceanWaterPhaseMatrix,
    MediumModel,
    WaterBaseModel,
)
from theia_jax.random import PhiloxRNG
from theia_jax.response import HistogramHitResponse, HitRecorder
from theia_jax.testing import WaterTestModel
from theia_jax.trace.backward import VolumeBackwardTracer


class PolWater(
    WaterBaseModel,
    HenyeyGreensteinPhaseFunction,
    KokhanovskyOceanWaterPhaseMatrix,
    MediumModel,
):
    def __init__(self, g=0.4):
        WaterBaseModel.__init__(self, 10.0, 0.0, 35.0)
        HenyeyGreensteinPhaseFunction.__init__(self, g)
        KokhanovskyOceanWaterPhaseMatrix.__init__(
            self, p90=0.66, theta0=0.25, alpha=4.0, xi=25.6
        )


def run(medium, polarized, response, key=0xD00D):
    tracer = VolumeBackwardTracer(
        16 * 1024,
        SphericalLightSource(position=(0.0, 0.0, 0.0), timeRange=(0.0, 0.0), budget=1e9),
        SphereCamera(position=(20.0, 0.0, 0.0), radius=5.0),
        UniformWavelengthSource(lambdaRange=(450.0, 450.0)),
        response,
        PhiloxRNG(key=key),
        medium=medium,
        nScattering=8,
        maxTime=250.0,
        polarized=polarized,
    )
    return tracer.run()


def test_scalar_medium_invariance():
    """Without phase-matrix tables the Mueller chain must not alter S0:
    polarized and unpolarized runs give identical light curves."""
    medium = WaterTestModel(mu_a=0.002, mu_s=0.02, g=0.4).createMedium()
    h_u, _ = run(medium, False, HistogramHitResponse(nBins=50, binSize=5.0, t0=0.0))
    h_p, _ = run(medium, True, HistogramHitResponse(nBins=50, binSize=5.0, t0=0.0))
    h_u, h_p = np.asarray(h_u), np.asarray(h_p)
    assert h_u.sum() > 0
    assert np.allclose(h_u, h_p, rtol=1e-4, atol=1e-3 * h_u.max())


def test_mueller_chain_physical():
    """With a real ocean-water Mueller matrix the detected Stokes vectors
    must be physical (finite, S0-normalized, DoP <= 1) and the scattered
    light partially polarized."""
    medium = PolWater().createMedium(name="pol_water")
    rec = HitRecorder(polarized=True)
    hits, _ = run(medium, True, rec)
    v = np.asarray(hits["valid"])
    st = np.asarray(hits["stokes"])[v]
    assert len(st) > 1000
    assert np.isfinite(st).all()
    assert np.allclose(st[:, 0], 1.0, atol=1e-4)
    dop = np.sqrt((st[:, 1:] ** 2).sum(-1))
    assert (dop <= 1.0 + 1e-3).all()
    assert dop.mean() > 0.01  # scattering polarizes


def test_unsupported_camera_raises():
    from theia_jax.camera import HostCamera
    from theia_jax.response import HistogramHitResponse

    medium = WaterTestModel(mu_a=0.0, mu_s=0.01, g=0.0).createMedium()
    n = 256
    cam = HostCamera(
        position=np.zeros((n, 3), np.float32) + (5.0, 0.0, 0.0),
        direction=np.tile([-1.0, 0.0, 0.0], (n, 1)).astype(np.float32),
        contrib=np.ones(n, np.float32),
        timeDelta=np.zeros(n, np.float32),
        hitPosition=np.zeros((n, 3), np.float32),
        hitDirection=np.tile([1.0, 0.0, 0.0], (n, 1)).astype(np.float32),
        hitNormal=np.tile([-1.0, 0.0, 0.0], (n, 1)).astype(np.float32),
    )
    tracer = VolumeBackwardTracer(
        256,
        SphericalLightSource(position=(0.0, 0.0, 0.0), timeRange=(0.0, 0.0), budget=1.0),
        cam,
        UniformWavelengthSource(lambdaRange=(450.0, 450.0)),
        HistogramHitResponse(nBins=10, binSize=10.0, t0=0.0),
        PhiloxRNG(key=1),
        medium=medium,
        nScattering=4,
        polarized=True,
        disableDirectLighting=True,
    )
    with pytest.raises(ValueError, match="polarization frames"):
        tracer.run()


def test_polarized_cone_light_direct():
    """Polarized cone source through the direct connection: the camera
    receives the source's Stokes vector rotated into the camera frame;
    a fully Q-polarized source keeps DoP=1 on the unscattered path."""
    from theia_jax.light import ConeLightSource

    medium = WaterTestModel(mu_a=0.0, mu_s=1e-6, g=0.0).createMedium()
    rec = HitRecorder(polarized=True)
    tracer = VolumeBackwardTracer(
        4096,
        ConeLightSource(
            position=(0.0, 0.0, 0.0),
            direction=(1.0, 0.0, 0.0),
            cosOpeningAngle=0.8,
            timeRange=(0.0, 0.0),
            budget=1e6,
            stokes=(1.0, 1.0, 0.0, 0.0),
            polarizationRef=(0.0, 0.0, 1.0),
        ),
        SphereCamera(position=(20.0, 0.0, 0.0), radius=2.0),
        UniformWavelengthSource(lambdaRange=(450.0, 450.0)),
        rec,
        PhiloxRNG(key=0xFACE),
        medium=medium,
        nScattering=1,  # direct connections only
        maxTime=250.0,
        polarized=True,
    )
    hits, _ = tracer.run()
    v = np.asarray(hits["valid"])
    st = np.asarray(hits["stokes"])[v]
    assert len(st) > 500
    dop = np.sqrt((st[:, 1:] ** 2).sum(-1))
    # pure rotations preserve full polarization on the unscattered path
    assert np.allclose(dop, 1.0, atol=1e-3)


def _pol_scene(mu_s=0.02, g=0.4):
    from theia_jax.material import Material, MaterialStore
    from theia_jax.mesh import icosphere
    from theia_jax.scene import MeshStore, Scene, Transform

    medium = WaterTestModel(mu_a=0.002, mu_s=mu_s, g=g).createMedium()
    mat = Material("wall", None, medium, flags="R")
    store = MaterialStore.pack([mat], media=[medium])
    meshes = MeshStore({"sphere": icosphere()})
    # distant enclosing shell so geometry exists but rarely interferes
    inst = meshes.createInstance("sphere", "wall", Transform.TRS(scale=500.0))
    return Scene([inst], store, medium=medium.name)


def test_scene_backward_polarized_scalar_invariance():
    """Scalar medium: polarized Mueller transport must not change the
    light curve of the scene backward tracer."""
    from theia_jax.trace.scene_backward import SceneBackwardTracer

    scene = _pol_scene()

    def run(polarized):
        resp = HistogramHitResponse(nBins=50, binSize=5.0, t0=0.0)
        tr = SceneBackwardTracer(
            16 * 1024,
            SphericalLightSource(position=(0.0, 0.0, 0.0), timeRange=(0.0, 0.0), budget=1e9),
            SphereCamera(position=(20.0, 0.0, 0.0), radius=5.0),
            UniformWavelengthSource(lambdaRange=(450.0, 450.0)),
            resp, PhiloxRNG(key=0xBEE5), scene,
            maxPathLength=8, maxTime=250.0, scatterCoefficient=0.022,
            polarized=polarized,
        )
        h, _ = tr.run()
        return np.asarray(h)

    h_u = run(False)
    h_p = run(True)
    assert h_u.sum() > 0
    assert np.allclose(h_u, h_p, rtol=1e-4, atol=1e-3 * h_u.max())


def test_scene_backward_polarized_fresnel_mueller():
    """A mirror bounce inside the camera path polarizes the transported
    light: compare the detected Stokes of a path camera->mirror->light
    against the analytic Fresnel polarizer."""
    from theia_jax.camera import PencilCamera
    from theia_jax.light import ConeLightSource
    from theia_jax.material import DispersionFreeMedium, Material, MaterialStore
    from theia_jax.mesh import Mesh, icosphere
    from theia_jax.scene import MeshStore, Scene, Transform
    from theia_jax.trace.scene_backward import SceneBackwardTracer

    N1, N2 = 4.0 / 3.0, 1.5
    water = DispersionFreeMedium(n=N1, ng=N1, mu_a=0.0, mu_s=1e-5).createMedium(
        name="water"
    )
    glass = DispersionFreeMedium(n=N2, ng=N2, mu_a=0.0, mu_s=0.0).createMedium(
        name="glass"
    )
    store = MaterialStore.pack(
        [Material("mirror", glass, "water", flags="R")], media=[water]
    )
    size = 50.0
    pos = [(-size, -size, 0.0), (size, -size, 0.0), (size, size, 0.0), (-size, size, 0.0)]
    plane = Mesh.from_geometry(pos, [(0, 1, 2), (0, 2, 3)])
    meshes = MeshStore({"plane": plane})
    scene = Scene(
        [meshes.createInstance("plane", "mirror")], store, medium="water"
    )

    # camera looks down at 45 deg onto the mirror; light sits on the
    # mirrored continuation so the connection is near-specular
    theta = np.deg2rad(45.0)
    d = (np.sin(theta), 0.0, -np.cos(theta))
    cam = PencilCamera(
        rayPosition=(-2.0, 5.0, 2.0), rayDirection=d,
    )
    # reflected ray continues upward; place the light along it
    up = np.array([np.sin(theta), 0.0, np.cos(theta)])
    hit_point = np.array([-2.0 + 2.0 * np.tan(theta), 5.0, 0.0])
    light_pos = hit_point + 12.0 * up

    rec = HitRecorder(polarized=True)
    tr = SceneBackwardTracer(
        4096,
        ConeLightSource(
            position=tuple(light_pos), direction=tuple(-up), cosOpeningAngle=0.5,
            timeRange=(0.0, 0.0), budget=1e6,
        ),
        cam,
        UniformWavelengthSource(lambdaRange=(450.0, 450.0)),
        rec, PhiloxRNG(key=0xF00D), scene,
        maxPathLength=4, maxTime=500.0, scatterCoefficient=0.03,
        polarized=True, disableDirectLighting=True,
    )
    hits, _ = tr.run()
    v = np.asarray(hits["valid"])
    st = np.asarray(hits["stokes"])[v]
    c = np.asarray(hits["contrib"])[v]
    assert len(st) > 50
    assert np.isfinite(st).all()
    dop = np.sqrt((st[:, 1:] ** 2).sum(-1))
    assert (dop <= 1.0 + 1e-3).all()
    # the dominant (highest-contribution) connections bounced off the
    # mirror near 45 deg: unpolarized light reflects with DoP ~= the
    # Fresnel polarizer's diattenuation at the actual incidence angle;
    # just require significant polarization from the mirror bounce
    top = np.argsort(c)[-50:]
    assert dop[top].mean() > 0.2
