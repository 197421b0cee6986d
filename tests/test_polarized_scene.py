"""Polarized transport in the scene forward tracer.

Validates the Fresnel reflection polarizer against the analytic
Brewster-angle result: p-polarized light reflects with r_p^2 (= 0 at
Brewster), s-polarized with r_s^2, while the scalar path weight carries
the unpolarized average R and the Stokes S0 restores the polarized
physics at detection (reference: ray.surface.glsl polarized overloads,
polarization.glsl:109-121)."""

import numpy as np
import pytest

from theia_jax.light import PencilLightSource, UniformWavelengthSource
from theia_jax.material import DispersionFreeMedium, Material, MaterialStore
from theia_jax.mesh import Mesh, icosphere
from theia_jax.random import PhiloxRNG
from theia_jax.response import HitRecorder
from theia_jax.scene import MeshStore, Scene, Transform
from theia_jax.trace.scene import SceneForwardTracer

N_WATER = 4.0 / 3.0
N_GLASS = 1.5


def plane_mesh(z, size, flip=False):
    """Two-triangle square plane at height z with +z (or -z) normal."""
    s = size
    pos = [(-s, -s, z), (s, -s, z), (s, s, z), (-s, s, z)]
    faces = [(0, 1, 2), (0, 2, 3)] if not flip else [(0, 2, 1), (0, 3, 2)]
    return Mesh.from_geometry(pos, faces)


def run_brewster(stokes_q, key=0xABCD):
    water = DispersionFreeMedium(n=N_WATER, ng=N_WATER, mu_a=0.0, mu_s=0.0).createMedium(
        name="water"
    )
    glass = DispersionFreeMedium(n=N_GLASS, ng=N_GLASS, mu_a=0.0, mu_s=0.0).createMedium(
        name="glass"
    )
    # mirror: reflection only ("R" enables reflect, transmit stays off)
    mirror = Material("mirror", glass, "water", flags="R")
    det = Material("det", None, "water", flags="DB")
    store = MaterialStore.pack([mirror, det], media=[water])

    theta = np.arctan2(N_GLASS, N_WATER)  # Brewster angle from water side
    meshes = MeshStore(
        {"plane": plane_mesh(0.0, 50.0), "plane_down": plane_mesh(0.0, 50.0, flip=True)}
    )
    wall = meshes.createInstance("plane", "mirror", Transform.Translation(0, 0, 0))
    # catcher plane above, facing down so its outward normal meets the beam
    lid = meshes.createInstance(
        "plane_down", "det", Transform.Translation(0.0, 0.0, 2.0), detectorId=1
    )
    scene = Scene([wall, lid], store, medium="water")

    rec = HitRecorder(polarized=True)
    d = np.array([np.sin(theta), 0.0, -np.cos(theta)], np.float32)
    source = PencilLightSource(
        position=(-2.0 * np.tan(theta), 5.0, 2.0),
        direction=tuple(d),
        timeRange=(0.0, 0.0),
        budget=1.0,
        stokes=(1.0, stokes_q, 0.0, 0.0),
        # perpendicular to the plane of incidence (the aligned frame)
        polarizationRef=(0.0, -1.0, 0.0),
    )
    tracer = SceneForwardTracer(
        256,
        source,
        UniformWavelengthSource(lambdaRange=(450.0, 450.0)),
        rec,
        PhiloxRNG(key=key),
        scene,
        maxPathLength=4,
        scatterCoefficient=1e-6,
        maxTime=1000.0,
        targetId=1,
        polarized=True,
    )
    hits, _ = tracer.run()
    v = np.asarray(hits["valid"])
    return np.asarray(hits["contrib"])[v].sum() / 256.0, hits, v


def fresnel(theta_i):
    sin_t = np.sin(theta_i) * N_WATER / N_GLASS
    cos_t = np.sqrt(1.0 - sin_t**2)
    cos_i = np.cos(theta_i)
    r_s = (N_WATER * cos_i - N_GLASS * cos_t) / (N_WATER * cos_i + N_GLASS * cos_t)
    r_p = (N_GLASS * cos_i - N_WATER * cos_t) / (N_GLASS * cos_i + N_WATER * cos_t)
    return r_s, r_p


def test_brewster_p_polarized_vanishes():
    theta = np.arctan2(N_GLASS, N_WATER)
    r_s, r_p = fresnel(theta)
    assert abs(r_p) < 1e-6  # sanity: Brewster
    e_p, _, _ = run_brewster(+1.0)
    e_s, _, _ = run_brewster(-1.0)
    # Q=+1 amplifies the p amplitude, Q=-1 the s amplitude
    assert e_p < 1e-5
    assert abs(e_s / r_s**2 - 1.0) < 1e-3


def test_polarized_unpolarized_equivalence():
    """Unpolarized input: polarized transport must reproduce the scalar
    result (normalized Mueller matrices leave S0=1 on the first event)."""
    e_unpol, hits, v = run_brewster(0.0)
    r_s, r_p = fresnel(np.arctan2(N_GLASS, N_WATER))
    assert abs(e_unpol / (0.5 * (r_s**2 + r_p**2)) - 1.0) < 1e-3
    # recorded stokes: fully s-polarized after Brewster reflection
    stokes = np.asarray(hits["stokes"])[v]
    assert np.allclose(stokes[:, 0], 1.0, atol=1e-5)
    assert np.allclose(np.abs(stokes[:, 1]), 1.0, atol=1e-3)


def test_packed_phase_matrix_matches_direct():
    """_phase_matrix_packed must reproduce phase_matrix_elements for a
    medium with phase-matrix tables (shared tables, packed addressing)."""
    import jax.numpy as jnp

    from theia_jax.material import MediumStore
    from theia_jax.polarization import phase_matrix_elements
    from theia_jax.testing import WaterTestModel
    from theia_jax.trace.scene import _phase_matrix_packed

    from theia_jax.material import (
        HenyeyGreensteinPhaseFunction,
        KokhanovskyOceanWaterPhaseMatrix,
        MediumModel,
        WaterBaseModel,
    )

    class PolWater(
        WaterBaseModel,
        HenyeyGreensteinPhaseFunction,
        KokhanovskyOceanWaterPhaseMatrix,
        MediumModel,
    ):
        def __init__(self):
            WaterBaseModel.__init__(self, 10.0, 0.0, 35.0)
            HenyeyGreensteinPhaseFunction.__init__(self, 0.6)
            KokhanovskyOceanWaterPhaseMatrix.__init__(
                self, p90=0.66, theta0=0.25, alpha=4.0, xi=25.6
            )

    medium = PolWater().createMedium(name="pol_water")
    assert medium.phase_m12 is not None
    store = MediumStore.pack([medium])
    h = store.handle("pol_water")
    cos_theta = jnp.linspace(-1.0, 1.0, 257)
    handles = jnp.full(cos_theta.shape, h, jnp.int32)
    packed = _phase_matrix_packed(store, handles, cos_theta)
    direct = phase_matrix_elements(medium, cos_theta)
    for a, b in zip(packed, direct):
        assert np.allclose(np.asarray(a), np.asarray(b), atol=1e-6)


@pytest.mark.slow
def test_volume_vs_scene_polarized_crosscheck():
    """The volume tracer (analytic target, Medium pytree) and the scene
    tracer (mesh geometry, packed tables) implement Stokes transport
    independently; for the same Mueller medium their detected polarization
    statistics must agree."""
    from theia_jax.light import SphericalLightSource, UniformWavelengthSource
    from theia_jax.material import (
        HenyeyGreensteinPhaseFunction,
        KokhanovskyOceanWaterPhaseMatrix,
        Material,
        MaterialStore,
        MediumModel,
        WaterBaseModel,
    )
    from theia_jax.random import PhiloxRNG
    from theia_jax.response import HitRecorder
    from theia_jax.scene import MeshStore, Scene, Transform
    from theia_jax.target import SphereTarget
    from theia_jax.trace import SceneForwardTracer, VolumeForwardTracer

    class PolWater(
        WaterBaseModel,
        HenyeyGreensteinPhaseFunction,
        KokhanovskyOceanWaterPhaseMatrix,
        MediumModel,
    ):
        ModelName = "pw"

        def __init__(self):
            WaterBaseModel.__init__(self, 10.0, 0.0, 35.0)
            HenyeyGreensteinPhaseFunction.__init__(self, 0.4)
            KokhanovskyOceanWaterPhaseMatrix.__init__(
                self, p90=0.66, theta0=0.25, alpha=4.0, xi=25.6
            )

    CEN = (20.0, 0.0, 0.0)
    N = 32 * 1024

    def stats(hits):
        v = np.asarray(hits["valid"])
        c = np.asarray(hits["contrib"])[v]
        st = np.asarray(hits["stokes"])[v]
        t = np.asarray(hits["time"])[v]
        w = c / c.sum()
        dop = np.sqrt((st[:, 1:] ** 2).sum(-1))
        out = {}
        for lo, hi in ((95, 120), (120, 180)):
            m = (t >= lo) & (t < hi)
            out[(lo, hi)] = (dop[m] * c[m]).sum() / max(c[m].sum(), 1e-30)
        return out

    medium = PolWater().createMedium()
    vol = VolumeForwardTracer(
        N,
        SphericalLightSource(position=(0.0, 0.0, 0.0), timeRange=(0.0, 0.0), budget=1e9),
        SphereTarget(position=CEN, radius=5.0),
        UniformWavelengthSource(lambdaRange=(450.0, 450.0)),
        HitRecorder(polarized=True),
        PhiloxRNG(key=0x9E3779B97F4A7C15),
        medium=medium,
        nScattering=8,
        maxTime=250.0,
        polarized=True,
    )
    s_vol = stats(vol.run()[0])

    store = MaterialStore.pack([Material("det", None, medium, flags="DB")])
    meshes = MeshStore({"sphere": icosphere()})
    scene = Scene(
        [
            meshes.createInstance(
                "sphere", "det", Transform.TRS(scale=5.0, translate=CEN), detectorId=1
            )
        ],
        store,
        medium="pw",
    )
    scn = SceneForwardTracer(
        N,
        SphericalLightSource(position=(0.0, 0.0, 0.0), timeRange=(0.0, 0.0), budget=1e9),
        UniformWavelengthSource(lambdaRange=(450.0, 450.0)),
        HitRecorder(polarized=True),
        PhiloxRNG(key=0x3C6EF372FE94F82A),
        scene,
        maxPathLength=8,
        scatterCoefficient=0.03,
        targetId=1,
        maxTime=250.0,
        polarized=True,
    )
    s_scn = stats(scn.run()[0])

    for k in s_vol:
        assert abs(s_vol[k] - s_scn[k]) < 0.08, (k, s_vol[k], s_scn[k])
