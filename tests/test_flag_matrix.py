"""Parametrized surface-flag consistency checks (model:
reference tests/test_trace.py:183-211 / :1199-1278): event statistics and
reflect/transmit behavior across material-flag combinations, with and
without polarization."""

import numpy as np
import pytest

from theia_jax.callback import EventStatisticCallback
from theia_jax.light import PencilLightSource, UniformWavelengthSource
from theia_jax.material import DispersionFreeMedium, Material, MaterialStore
from theia_jax.mesh import Mesh
from theia_jax.random import PhiloxRNG
from theia_jax.response import HistogramHitResponse
from theia_jax.scene import MeshStore, Scene, Transform
from theia_jax.trace import SceneForwardTracer

pytestmark = pytest.mark.core  # fast smoke tier, see pyproject markers

N = 256


def plane(z, size=50.0, flip=False):
    pos = [(-size, -size, z), (size, -size, z), (size, size, z), (-size, size, z)]
    faces = [(0, 1, 2), (0, 2, 3)] if not flip else [(0, 2, 1), (0, 3, 2)]
    return Mesh.from_geometry(pos, faces)


def run_flags(flags, polarized=False):
    """Pencil beam onto a z=0 interface (water above, glass below)."""
    water = DispersionFreeMedium(n=4.0 / 3.0, ng=4.0 / 3.0, mu_a=0.0, mu_s=0.0).createMedium(name="water")
    glass = DispersionFreeMedium(n=1.5, ng=1.5, mu_a=0.0, mu_s=0.0).createMedium(name="glass")
    store = MaterialStore.pack([Material("m", glass, "water", flags=flags)], media=[water])
    meshes = MeshStore({"p": plane(0.0)})
    scene = Scene([meshes.createInstance("p", "m")], store, medium="water")
    cb = EventStatisticCallback()
    tracer = SceneForwardTracer(
        N,
        PencilLightSource(
            position=(0.5, 0.3, 2.0),
            direction=(0.3, 0.0, -0.954),
            timeRange=(0.0, 0.0),
            budget=1.0,
        ),
        UniformWavelengthSource(lambdaRange=(450.0, 450.0)),
        HistogramHitResponse(nBins=10, binSize=20.0, t0=0.0),
        PhiloxRNG(key=0xF1A6),
        scene,
        maxPathLength=3,
        scatterCoefficient=1e-6,
        maxTime=200.0,
        polarized=polarized,
        callback=cb,
    )
    _, stats = tracer.run()
    return stats


@pytest.mark.parametrize("polarized", [False, True])
def test_black_body_absorbs_all(polarized):
    stats = run_flags("B", polarized)
    assert stats["absorbed"] == N
    assert stats["hit"] == 0


@pytest.mark.parametrize("polarized", [False, True])
def test_reflect_only(polarized):
    stats = run_flags("R", polarized)
    # every lane reflects at the interface, then leaves through the bbox
    assert stats["hit"] == N
    assert stats["absorbed"] == 0
    assert stats["lost"] == N


@pytest.mark.parametrize("polarized", [False, True])
def test_transmit_only(polarized):
    stats = run_flags("T", polarized)
    assert stats["hit"] == N
    assert stats["lost"] == N


def test_no_interaction_flags_absorb():
    # neither reflection nor transmission allowed -> absorbed
    stats = run_flags("")
    assert stats["absorbed"] == N


def test_volume_border_straight_through():
    """VOLUME_BORDER: rays cross without direction change (reference:
    test_trace.py:1122); the medium changes but the path continues."""
    stats = run_flags("V")
    assert stats["volume"] == N
    assert stats["absorbed"] == 0
    assert stats["lost"] == N


@pytest.mark.parametrize("polarized", [False, True])
def test_reflect_transmit_split(polarized):
    """RT surfaces importance-sample the branch: counts split roughly by
    the Fresnel reflectance, and every lane continues."""
    stats = run_flags("RT", polarized)
    assert stats["hit"] == N
    assert stats["lost"] == N
    assert stats["absorbed"] == 0


def test_media_mismatch_counted_and_kills_path():
    """A ray believing the wrong medium dies with ERROR_MEDIA_MISMATCH and
    the statistic callback counts it (reference: scene.intersect.glsl:77-80,
    callback.stat.glsl mismatch counter)."""
    from theia_jax.material import DispersionFreeMedium

    # interface whose *outside* medium (glass) disagrees with the scene
    # medium (water) the ray travels in
    water = DispersionFreeMedium(n=4.0 / 3.0, ng=4.0 / 3.0, mu_a=0.0, mu_s=0.0).createMedium(name="water")
    glass = DispersionFreeMedium(n=1.5, ng=1.5, mu_a=0.0, mu_s=0.0).createMedium(name="glass")
    store = MaterialStore.pack(
        [Material("m", None, glass, flags="R")], media=[water]
    )
    meshes = MeshStore({"p": plane(0.0)})
    scene = Scene([meshes.createInstance("p", "m")], store, medium="water")
    cb = EventStatisticCallback()
    tracer = SceneForwardTracer(
        N,
        PencilLightSource(
            position=(0.5, 0.3, 2.0),
            direction=(0.3, 0.0, -0.954),
            timeRange=(0.0, 0.0),
            budget=1.0,
        ),
        UniformWavelengthSource(lambdaRange=(450.0, 450.0)),
        HistogramHitResponse(nBins=10, binSize=20.0, t0=0.0),
        PhiloxRNG(key=0xBAD),
        scene,
        maxPathLength=3,
        scatterCoefficient=1e-6,
        maxTime=200.0,
        callback=cb,
    )
    _, stats = tracer.run()
    assert stats["mismatch"] == N
    assert stats["hit"] == 0


def test_live_statistics_counters():
    """live=True posts running totals to the host via jax.debug.callback
    (the reference's host-mapped live counters, ref trace.py:77-186);
    after the batch the live snapshot equals the final result."""
    water = DispersionFreeMedium(
        n=4.0 / 3.0, ng=4.0 / 3.0, mu_a=0.0, mu_s=0.0
    ).createMedium(name="water")
    store = MaterialStore.pack(
        [Material("m", None, "water", flags="DB")], media=[water]
    )
    meshes = MeshStore({"p": plane(0.0)})
    scene = Scene([meshes.createInstance("p", "m")], store, medium="water")
    cb = EventStatisticCallback(live=True)
    tracer = SceneForwardTracer(
        N,
        PencilLightSource(
            position=(0.5, 0.3, 2.0),
            direction=(0.0, 0.0, -1.0),
            timeRange=(0.0, 0.0),
            budget=1.0,
        ),
        UniformWavelengthSource(lambdaRange=(450.0, 450.0)),
        HistogramHitResponse(nBins=10, binSize=20.0, t0=0.0),
        PhiloxRNG(key=0x11FE),
        scene,
        maxPathLength=3,
        scatterCoefficient=1e-6,
        maxTime=200.0,
        callback=cb,
    )
    _, stats = tracer.run()
    import jax

    jax.effects_barrier()  # drain pending debug callbacks
    assert stats["created"] == N
    assert cb.statistics == stats
