"""SceneForwardTracer validation (model: reference
tests/test_trace_energy.py:58-184 ground truth and :187-352 cross-check)."""

import numpy as np
import pytest

import jax.numpy as jnp

import theia_jax.units as u
from theia_jax.callback import EventStatisticCallback
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
from theia_jax.target import SphereTargetGuide
from theia_jax.trace.scene import SceneForwardTracer


class Model(DispersionFreeMedium, HenyeyGreensteinPhaseFunction, MediumModel):
    ModelName = "homogenous"

    def __init__(self, a, s, g, *, n=1.33, ng=1.33):
        DispersionFreeMedium.__init__(self, n=n, ng=ng, mu_a=a, mu_s=s)
        HenyeyGreensteinPhaseFunction.__init__(self, g)


def run_ground_truth(mu_a, mu_s, g, batch_size=16 * 1024, n_batches=4):
    """Sphere detector filled with scattering medium, spherical source at
    the center — no light escapes."""
    position = (12.0, 15.0, 0.2)
    radius = 100.0 * u.m
    budget = 1e9
    t0 = 10.0 * u.ns
    lam = 400.0 * u.nm

    model = Model(mu_a, mu_s, g)
    medium = model.createMedium()
    material = Material("det", medium, None, flags="DB")
    mat_store = MaterialStore.pack([material])
    meshes = MeshStore({"sphere": icosphere()})
    trafo = Transform.TRS(scale=radius, translate=position)
    target = meshes.createInstance("sphere", "det", trafo, detectorId=0)
    scene = Scene([target], mat_store, medium="homogenous")

    rng = PhiloxRNG(key=0xC0FFEE)
    recorder = HitRecorder()
    tracer = SceneForwardTracer(
        batch_size,
        SphericalLightSource(position=position, timeRange=(t0, t0), budget=budget),
        UniformWavelengthSource(lambdaRange=(lam, lam)),
        recorder,
        rng,
        scene,
        maxPathLength=10,
        scatterCoefficient=0.05,
        maxTime=float("inf"),
        callback=EventStatisticCallback(),
    )

    total = 0.0
    positions = []
    for _ in range(n_batches):
        hits, stats = tracer.run()
        valid = np.asarray(hits["valid"])
        time = np.asarray(hits["time"])[valid]
        contrib = np.asarray(hits["contrib"])[valid]
        vg = 1.0 / model.ng * u.c
        d = vg * (time - t0)
        total += (contrib * np.exp(mu_a * d)).sum()
        positions.append(np.asarray(hits["position"])[valid])
    estimate = total / (batch_size * n_batches)
    return estimate, budget, np.concatenate(positions), stats


@pytest.mark.slow
@pytest.mark.parametrize(
    "mu_a,mu_s,g,err",
    [
        (0.0, 0.005, 0.0, 0.06),
        (0.05, 0.01, 0.0, 0.06),
        # backscatter + absorption-undo exp(mu_a*d) is extremely heavy-
        # tailed; the reference needs 84M samples for 5% here
        (0.05, 0.01, -0.9, 0.25),
        (0.05, 0.01, 0.9, 0.06),
    ],
)
def test_scene_forward_ground_truth(mu_a, mu_s, g, err):
    estimate, budget, positions, _ = run_ground_truth(mu_a, mu_s, g)
    assert np.abs(estimate / budget - 1.0) < err
    if err < 0.1:  # heavy-tailed configs may fluctuate above in small runs
        assert estimate < budget  # truncated paths -> biased low
    # hits uniform on the unit sphere (object space)
    assert np.abs(positions.mean(0)).max() < 0.05
    assert np.abs(positions.var(0) - 1 / 3).max() < 0.05


def test_scene_forward_ground_truth_quick():
    estimate, budget, positions, stats = run_ground_truth(
        0.0, 0.005, 0.0, batch_size=8 * 1024, n_batches=2
    )
    assert np.abs(estimate / budget - 1.0) < 0.08
    assert estimate < budget
    # "DB" surfaces respond then report ABSORBED (black body overrides the
    # DETECTED code, reference: scene.traverse.glsl:104-115)
    assert stats["absorbed"] > 0 and stats["detected"] == 0
    assert stats["error"] == 0 and stats["mismatch"] == 0


def test_scene_crosscheck_guide_mis():
    """Target-guide MIS must agree with the plain estimator.

    Spherical light OUTSIDE a detector sphere (reference crosscheck setup,
    test_trace_energy.py:187-352): compare light curves with and without a
    SphereTargetGuide."""
    position = (0.0, 0.0, 0.0)
    radius = 5.0 * u.m
    light_pos = (-6.0, 0.0, 0.0)
    budget = 1e9
    t0 = 30.0
    model = Model(0.0, 0.01, 0.3)
    medium = model.createMedium()
    material = Material("det", None, medium, flags="DB")
    mat_store = MaterialStore.pack([material])
    meshes = MeshStore({"sphere": icosphere()})
    trafo = Transform.TRS(scale=radius, translate=position)

    def build(guide, batch, key):
        target = meshes.createInstance("sphere", "det", trafo, detectorId=0)
        scene = Scene([target], mat_store, medium="homogenous")
        rng = PhiloxRNG(key=key)
        response = HistogramHitResponse(nBins=30, t0=0.0, binSize=20.0)
        return SceneForwardTracer(
            batch,
            SphericalLightSource(
                position=light_pos, timeRange=(t0, t0), budget=budget
            ),
            UniformWavelengthSource(lambdaRange=(400.0, 400.0)),
            response,
            rng,
            scene,
            maxPathLength=10,
            scatterCoefficient=0.01,
            maxTime=600.0,
            targetGuide=guide,
        )

    def curve(guide, batches=6, key=0xC0FFEE):
        tracer = build(guide, 16 * 1024, key)
        acc = None
        for _ in range(batches):
            h, _ = tracer.run()
            acc = h if acc is None else acc + h
        return np.asarray(acc) / batches

    plain = curve(None, batches=12)
    guided = curve(
        SphereTargetGuide(position=position, radius=radius), batches=4
    )
    # direct peak bin must match well; scattered tail statistically
    tot_p, tot_g = plain.sum(), guided.sum()
    assert np.abs(tot_g / tot_p - 1.0) < 0.15
    peak = plain.argmax()
    assert guided.argmax() == peak
    assert np.abs(guided[peak] / plain[peak] - 1.0) < 0.05


@pytest.mark.slow
def test_multimedia_shell_energy_conservation():
    """Lossless glass shell around the source inside an enclosing black
    detector sphere: every photon must eventually land on the detector,
    so the total detected weight equals the budget regardless of how many
    Fresnel reflections/transmissions it took (model: reference
    tests/test_trace_energy.py multi-media shells)."""
    from theia_jax.light import SphericalLightSource, UniformWavelengthSource
    from theia_jax.material import (
        DispersionFreeMedium,
        Material,
        MaterialStore,
    )
    from theia_jax.random import PhiloxRNG
    from theia_jax.response import HistogramHitResponse
    from theia_jax.scene import MeshStore, Scene, Transform
    from theia_jax.trace import SceneForwardTracer

    water = DispersionFreeMedium(n=4.0 / 3.0, ng=4.0 / 3.0, mu_a=0.0, mu_s=1e-4).createMedium(name="water")
    glass = DispersionFreeMedium(n=1.5, ng=1.5, mu_a=0.0, mu_s=0.0).createMedium(name="glass")
    store = MaterialStore.pack(
        [
            Material("glass_water", glass, "water", flags="TR"),
            Material("air_glass", None, "glass", flags="TR"),
            Material("det", "water", None, flags="DB"),
        ],
        media=[water],
    )
    meshes = MeshStore({"sphere": icosphere()})
    BUDGET = 1e9
    scene = Scene(
        [
            meshes.createInstance("sphere", "glass_water", Transform.Scale(2.0)),
            meshes.createInstance("sphere", "air_glass", Transform.Scale(1.8)),
            meshes.createInstance(
                "sphere", "det", Transform.Scale(30.0), detectorId=1
            ),
        ],
        store,
        medium="water",
    )
    tracer = SceneForwardTracer(
        32 * 1024,
        SphericalLightSource(position=(0.0, 0.0, 0.0), timeRange=(0.0, 0.0), budget=BUDGET),
        UniformWavelengthSource(lambdaRange=(450.0, 450.0)),
        HistogramHitResponse(nBins=50, binSize=40.0, t0=0.0),
        PhiloxRNG(key=0x51E11),
        scene,
        maxPathLength=24,  # enough for multiple TIR bounces in the shell
        sourceMedium="vacuum",
        scatterCoefficient=1e-4,
        targetId=1,
        maxTime=float("inf"),
    )
    total = 0.0
    runs = 4
    for _ in range(runs):
        h, _ = tracer.run()
        total += float(np.asarray(h).sum())
    total /= runs
    # a small fraction is truncated at maxPathLength (TIR-trapped paths)
    assert 0.93 < total / BUDGET <= 1.005, total / BUDGET


def test_shadow_split_matches_fused():
    """The MIS shadow split (accel.intersect_target: detector-subsoup
    nearest + any-hit occlusion) must reproduce the fused full-soup
    nearest bit-for-bit on both brute and BVH scenes (ties between
    detector and occluder triangles are measure-zero off shared edges)."""
    import dataclasses

    from theia_jax.target import SphereTargetGuide

    def run(accel, drop_split):
        water = Model(0.01, 0.4, 0.3).createMedium(num_lambda=8, num_theta=64, name="water")
        mats = MaterialStore.pack(
            [
                Material("det_water", None, water, flags="DB"),
                Material("occluder", None, water, flags="T"),
            ]
        )
        meshes = MeshStore({"sphere": icosphere()})
        det_pos = (0.0, 3.0, 0.0)
        scene = Scene(
            [
                meshes.createInstance(
                    "sphere", "det_water",
                    Transform.TRS(scale=0.6, translate=det_pos), detectorId=1,
                ),
                # opaque blocker between typical scatter points and target
                meshes.createInstance(
                    "sphere", "occluder",
                    Transform.TRS(scale=0.4, translate=(0.0, 1.5, 0.0)),
                ),
            ],
            mats,
            medium="water",
            accel=accel,
        )
        if drop_split:
            scene._pack = dataclasses.replace(scene._pack, shadow_split=None)
        tracer = SceneForwardTracer(
            2048,
            SphericalLightSource(
                position=(2.0, 0.0, 0.0), timeRange=(0.0, 5.0), budget=1e5
            ),
            UniformWavelengthSource(lambdaRange=(400.0, 500.0)),
            HistogramHitResponse(nBins=40, t0=0.0, binSize=5.0 * u.ns),
            PhiloxRNG(key=99),
            scene,
            maxPathLength=5,
            targetId=1,
            targetGuide=SphereTargetGuide(position=det_pos, radius=0.6),
        )
        hist, _ = tracer.run()
        return np.asarray(hist)

    for accel in ("brute", "bvh"):
        h_split = run(accel, drop_split=False)
        h_fused = run(accel, drop_split=True)
        assert h_split.sum() > 0, accel
        assert np.array_equal(h_split, h_fused), accel
