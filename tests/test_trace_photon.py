"""Photon tracers: cross-check against the radiance estimator (reference
tests/test_trace_energy.py:1353-1550 chain of trust)."""

import numpy as np
import pytest

import theia_jax.units as u
from theia_jax.light import SphericalLightSource, UniformWavelengthSource
from theia_jax.material import (
    DispersionFreeMedium,
    HenyeyGreensteinPhaseFunction,
    MediumModel,
)
from theia_jax.random import PhiloxRNG
from theia_jax.response import HistogramHitResponse, StoreTimeHitResponse
from theia_jax.target import InnerSphereTarget
from theia_jax.trace import VolumeForwardTracer
from theia_jax.trace.photon import VolumePhotonTracer


class Model(DispersionFreeMedium, HenyeyGreensteinPhaseFunction, MediumModel):
    ModelName = "homogenous"

    def __init__(self, a, s, g, *, n=1.33, ng=1.33):
        DispersionFreeMedium.__init__(self, n=n, ng=ng, mu_a=a, mu_s=s)
        HenyeyGreensteinPhaseFunction.__init__(self, g)


def test_volume_photon_matches_forward():
    """Expected photon counts per time bin (photon mode) must match the
    radiance light curve (forward mode) divided by the photon budget."""
    position = (0.0, 0.0, 0.0)
    radius = 100.0
    t0 = 10.0
    mu_a, mu_s, g = 0.005, 0.01, 0.3
    budget = 1.0  # photon mode: per-photon simulation
    medium = Model(mu_a, mu_s, g).createMedium()
    n_bins, bin_size = 40, 25.0

    fwd = VolumeForwardTracer(
        64 * 1024,
        SphericalLightSource(position=position, timeRange=(t0, t0), budget=budget),
        InnerSphereTarget(position=position, radius=radius),
        UniformWavelengthSource(lambdaRange=(450.0, 450.0)),
        HistogramHitResponse(nBins=n_bins, t0=0.0, binSize=bin_size),
        PhiloxRNG(key=0xC0FFEE),
        medium=medium,
        nScattering=12,
        scatterCoefficient=float("nan"),
        maxTime=float("inf"),
    )
    facc = None
    for _ in range(4):
        h, _ = fwd.run()
        facc = h if facc is None else facc + h
    fcurve = np.asarray(facc) / 4  # expected detections per photon per bin

    # photon mode: each lane is one photon; count detections per bin
    batch = 64 * 1024
    pho = VolumePhotonTracer(
        batch,
        SphericalLightSource(position=position, timeRange=(t0, t0), budget=budget),
        InnerSphereTarget(position=position, radius=radius),
        UniformWavelengthSource(lambdaRange=(450.0, 450.0)),
        StoreTimeHitResponse(),
        PhiloxRNG(key=0xBEEF),
        medium=medium,
        nScatteringPerRun=6,
        nRuns=3,
        maxTime=float("inf"),
    )
    counts = np.zeros(n_bins)
    n_batches = 4
    for _ in range(n_batches):
        out, _ = pho.run()
        valid = np.asarray(out["valid"])
        times = np.asarray(out["time"])[valid]
        h, _ = np.histogram(times, bins=n_bins, range=(0.0, n_bins * bin_size))
        counts += h
    pcurve = counts / (batch * n_batches)

    # compare detection probabilities per bin where statistics allow
    mask = fcurve * batch * n_batches > 50
    assert mask.sum() >= 5
    rel = np.abs(pcurve[mask] - fcurve[mask]) / fcurve[mask]
    assert np.median(rel) < 0.15
    assert np.abs(pcurve.sum() / fcurve.sum() - 1.0) < 0.05


def test_scene_photon_smoke():
    """ScenePhotonTracer end-to-end on the enclosing DB sphere: detected
    photon count ~= batch (no absorption, everything eventually detected
    or truncated)."""
    from theia_jax.material import Material, MaterialStore
    from theia_jax.mesh import icosphere
    from theia_jax.scene import MeshStore, Scene, Transform
    from theia_jax.trace.photon import ScenePhotonTracer

    medium = Model(0.0, 0.01, 0.0).createMedium()
    mat = Material("det", medium, None, flags="DB")
    store = MaterialStore.pack([mat])
    meshes = MeshStore({"sphere": icosphere()})
    inst = meshes.createInstance(
        "sphere", "det", Transform.TRS(scale=50.0), detectorId=0
    )
    scene = Scene([inst], store, medium="homogenous")
    batch = 8 * 1024
    tracer = ScenePhotonTracer(
        batch,
        SphericalLightSource(position=(0.0, 0.0, 0.0), timeRange=(0.0, 0.0), budget=1.0),
        UniformWavelengthSource(lambdaRange=(450.0, 450.0)),
        StoreTimeHitResponse(),
        PhiloxRNG(key=7),
        scene,
        nScatteringPerRun=5,
        nRuns=4,
        maxTime=float("inf"),
    )
    out, _ = tracer.run()
    valid = np.asarray(out["valid"])
    # no absorption: nearly every photon must be detected within 20 segments
    assert valid.sum() > 0.95 * batch
    t = np.asarray(out["time"])[valid]
    # arrival no earlier than the ballistic flight time to the mesh
    # (triangle faces are chords: face planes sit at ~0.994 of the radius)
    assert t.min() >= 0.993 * 50.0 / (u.c / 1.33)


def test_photon_polarized_smoke():
    """Polarized photon mode (inherits the scene tracer's Stokes threading)."""
    import numpy as np

    from theia_jax.light import SphericalLightSource, UniformWavelengthSource
    from theia_jax.material import Material, MaterialStore
    from theia_jax.random import PhiloxRNG
    from theia_jax.response import HitRecorder
    from theia_jax.mesh import icosphere
    from theia_jax.scene import MeshStore, Scene, Transform
    from theia_jax.testing import WaterTestModel
    from theia_jax.trace import ScenePhotonTracer

    medium = WaterTestModel(mu_a=0.005, mu_s=0.01, g=0.3).createMedium()
    store = MaterialStore.pack([Material("det", medium, None, flags="DB")])
    meshes = MeshStore({"sphere": icosphere()})
    scene = Scene(
        [meshes.createInstance("sphere", "det", Transform.TRS(scale=50.0))],
        store,
        medium="water_test",
    )
    rec = HitRecorder(polarized=True)
    tr = ScenePhotonTracer(
        2048,
        SphericalLightSource(position=(0.0, 0.0, 0.0), timeRange=(0.0, 0.0), budget=1e6),
        UniformWavelengthSource(lambdaRange=(450.0, 450.0)),
        rec,
        PhiloxRNG(key=3),
        scene,
        nScatteringPerRun=5,
        nRuns=2,
        polarized=True,
    )
    hits, _ = tr.run()
    v = np.asarray(hits["valid"])
    st = np.asarray(hits["stokes"])[v]
    assert len(st) > 100 and np.isfinite(st).all()


def test_run_compacted_matches_run():
    """The compacted ladder (run_compacted) must reproduce run(): survivors
    keep their stream ids and every run resyncs its dim base, so the draws
    are identical — only float32 accumulation order differs."""
    medium = Model(0.05, 0.02, 0.3).createMedium()  # strongly absorbing
    def make():
        return VolumePhotonTracer(
            16 * 1024,
            SphericalLightSource(
                position=(0.0, 0.0, 0.0), timeRange=(0.0, 0.0), budget=1.0
            ),
            InnerSphereTarget(position=(0.0, 0.0, 0.0), radius=200.0),
            UniformWavelengthSource(lambdaRange=(450.0, 450.0)),
            HistogramHitResponse(nBins=40, t0=0.0, binSize=25.0),
            PhiloxRNG(key=0xFADE),
            medium=medium,
            nScatteringPerRun=4,
            nRuns=6,
            maxTime=float("inf"),
        )

    t1, t2 = make(), make()
    h_plain, _ = t1.run()
    h_comp = t2.run_compacted(min_lanes=512)
    h_plain, h_comp = np.asarray(h_plain), np.asarray(h_comp)
    assert h_plain.sum() > 0
    assert np.allclose(h_plain, h_comp, rtol=1e-5, atol=1e-7 * h_plain.max())
    # offsets advanced identically -> second batches also agree
    h_plain2, _ = t1.run()
    h_comp2 = t2.run_compacted(min_lanes=512)
    assert np.allclose(
        np.asarray(h_plain2), np.asarray(h_comp2),
        rtol=1e-5, atol=1e-7 * h_plain.max(),
    )


def test_run_compacted_guards():
    medium = Model(0.05, 0.02, 0.3).createMedium()
    tracer = VolumePhotonTracer(
        1024,
        SphericalLightSource(
            position=(0.0, 0.0, 0.0), timeRange=(0.0, 0.0), budget=1.0
        ),
        InnerSphereTarget(position=(0.0, 0.0, 0.0), radius=200.0),
        UniformWavelengthSource(lambdaRange=(450.0, 450.0)),
        StoreTimeHitResponse(),
        PhiloxRNG(key=1),
        medium=medium,
        nScatteringPerRun=2,
        nRuns=2,
    )
    with pytest.raises(ValueError, match="additive response"):
        tracer.run_compacted()


def test_scene_run_compacted_matches_run():
    """ScenePhotonTracer's compacted ladder carries each lane's dim counter
    (the scene schedule has no per-run resync), so draws — and the light
    curve — must match run() up to float32 accumulation order."""
    from theia_jax.material import Material, MaterialStore
    from theia_jax.mesh import icosphere
    from theia_jax.scene import MeshStore, Scene, Transform
    from theia_jax.trace.photon import ScenePhotonTracer

    medium = Model(0.02, 0.01, 0.3).createMedium()  # absorbing water
    store = MaterialStore.pack([Material("det", medium, None, flags="DB")])
    meshes = MeshStore({"sphere": icosphere()})
    scene = Scene(
        [meshes.createInstance("sphere", "det", Transform.TRS(scale=120.0))],
        store,
        medium="homogenous",
    )

    def make():
        return ScenePhotonTracer(
            8 * 1024,
            SphericalLightSource(
                position=(0.0, 0.0, 0.0), timeRange=(0.0, 0.0), budget=1.0
            ),
            UniformWavelengthSource(lambdaRange=(450.0, 450.0)),
            HistogramHitResponse(nBins=40, t0=0.0, binSize=40.0),
            PhiloxRNG(key=0xCAFE),
            scene,
            nScatteringPerRun=4,
            nRuns=5,
            maxTime=float("inf"),
        )

    t1, t2 = make(), make()
    h_plain, _ = t1.run()
    h_comp = t2.run_compacted(min_lanes=512)
    h_plain, h_comp = np.asarray(h_plain), np.asarray(h_comp)
    assert h_plain.sum() > 0
    assert len(t2._compact_plan) and min(t2._compact_plan) < 8 * 1024  # shrank
    assert np.allclose(h_plain, h_comp, rtol=1e-5, atol=1e-7 * h_plain.max())
    # replay path (no host syncs) also agrees and drops nothing
    h_plain2, _ = t1.run()
    h_comp2 = t2.run_compacted(min_lanes=512)
    assert t2.compaction_overflow == 0
    assert np.allclose(
        np.asarray(h_plain2), np.asarray(h_comp2),
        rtol=1e-5, atol=1e-7 * h_plain.max(),
    )
