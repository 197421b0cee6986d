"""Backward + direct tracer crosschecks against the forward ground truth
(model: reference tests/test_trace_energy.py:953-1072 and :1248-1352)."""

import numpy as np
import pytest

import jax.numpy as jnp

import theia_jax.units as u
from theia_jax.camera import PointCamera, SphereCamera
from theia_jax.light import SphericalLightSource, UniformWavelengthSource
from theia_jax.material import (
    DispersionFreeMedium,
    HenyeyGreensteinPhaseFunction,
    MediumModel,
)
from theia_jax.random import PhiloxRNG
from theia_jax.response import HistogramHitResponse
from theia_jax.target import InnerSphereTarget
from theia_jax.trace import VolumeForwardTracer
from theia_jax.trace.backward import VolumeBackwardTracer
from theia_jax.trace.direct import DirectLightTracer


class Model(DispersionFreeMedium, HenyeyGreensteinPhaseFunction, MediumModel):
    ModelName = "homogenous"

    def __init__(self, a, s, g, *, n=1.33, ng=1.33):
        DispersionFreeMedium.__init__(self, n=n, ng=ng, mu_a=a, mu_s=s)
        HenyeyGreensteinPhaseFunction.__init__(self, g)


LIGHT_POS = (0.0, 0.0, 0.0)
CAM_POS = (8.0, 0.0, 0.0)
T0 = 10.0
BUDGET = 1e9
N_BINS, BIN_SIZE = 60, 10.0


def forward_curve(model, medium, batch, batches):
    """Forward estimate: spherical detector around the camera position."""
    rng = PhiloxRNG(key=0xC0FFEE)
    tracer = VolumeForwardTracer(
        batch,
        SphericalLightSource(position=LIGHT_POS, timeRange=(T0, T0), budget=BUDGET),
        InnerSphereTarget(position=LIGHT_POS, radius=200.0),
        UniformWavelengthSource(lambdaRange=(450.0, 450.0)),
        HistogramHitResponse(nBins=N_BINS, t0=0.0, binSize=BIN_SIZE),
        rng,
        medium=medium,
        nScattering=8,
        scatterCoefficient=0.05,
        maxTime=float("inf"),
    )
    acc = None
    for _ in range(batches):
        h, _ = tracer.run()
        acc = h if acc is None else acc + h
    return np.asarray(acc) / batches


def test_direct_tracer_analytic():
    """Direct tracer on a sphere camera in a purely absorbing medium has a
    closed-form expectation."""
    mu_a = 0.02
    model = Model(mu_a, 0.0, 0.0)
    medium = model.createMedium()
    r_cam = 1.0
    rng = PhiloxRNG(key=0xC0FFEE)
    batch = 32 * 1024
    tracer = DirectLightTracer(
        batch,
        SphericalLightSource(position=LIGHT_POS, timeRange=(T0, T0), budget=BUDGET),
        SphereCamera(position=CAM_POS, radius=r_cam),
        UniformWavelengthSource(lambdaRange=(450.0, 450.0)),
        HistogramHitResponse(nBins=N_BINS, t0=0.0, binSize=BIN_SIZE),
        rng,
        medium=medium,
    )
    acc = None
    for _ in range(4):
        h, _ = tracer.run()
        acc = h if acc is None else acc + h
    curve = np.asarray(acc) / 4
    total = curve.sum()
    # expectation: flux through a sphere of radius d times the projected
    # cross-section ratio... simplest closed form: power collected by a
    # sphere of radius r at distance d in an absorbing medium:
    d = np.linalg.norm(np.asarray(CAM_POS))
    # the sphere camera is a Lambertian-response detector: integrand
    # cos^2(theta) over the visible hemisphere -> budget r^2/(6 d^2)
    # (one cos from flux obliquity dw_dA, one from the camera response)
    expected = BUDGET * (r_cam**2 / (6 * d**2)) * np.exp(-mu_a * d)
    assert np.abs(total / expected - 1.0) < 0.05
    # arrival time: bin around T0 + d*ng/c
    t_arr = T0 + d / (u.c / 1.33)
    peak_bin = curve.argmax()
    assert abs(peak_bin - int(t_arr / BIN_SIZE)) <= 1


@pytest.mark.slow
def test_backward_energy_conservation():
    """Spherical light inside a spherical camera (negative radius = inside
    surface): total unattenuated estimate must equal the budget
    (reference: tests/test_trace_energy.py:953-1058; their err=2e-3 at
    102M samples for this config — scaled for 1M samples)."""
    from theia_jax.response import HitRecorder

    mu_a, mu_s, g = 0.0, 0.02, -0.4
    position = (12.0, 15.0, 0.2)
    radius = 100.0
    model = Model(mu_a, mu_s, g)
    medium = model.createMedium()

    rng = PhiloxRNG(key=0xC0FFEE)
    recorder = HitRecorder()
    tracer = VolumeBackwardTracer(
        64 * 1024,
        SphericalLightSource(position=position, timeRange=(T0, T0), budget=BUDGET),
        SphereCamera(position=position, radius=-radius),
        UniformWavelengthSource(lambdaRange=(450.0, 450.0)),
        recorder,
        rng,
        medium=medium,
        # tau_s=2 with backscattering truncates ~9% at 10 path segments
        # (verified: forward estimate -> 1.0003 at 40); use 20 here
        nScattering=30,
        target=InnerSphereTarget(position=position, radius=radius * 1.001),
        maxTime=float("inf"),
    )
    total = 0.0
    n_batches = 16
    for _ in range(n_batches):
        hits, _ = tracer.run()
        valid = np.asarray(hits["valid"])
        time = np.asarray(hits["time"])[valid]
        contrib = np.asarray(hits["contrib"])[valid]
        vg = u.c / 1.33
        d = vg * (time - T0)
        total += (contrib * np.exp(mu_a * d)).sum()
    estimate = total / (64 * 1024 * n_batches)
    assert np.abs(estimate / BUDGET - 1.0) < 0.05


@pytest.mark.slow
def test_track_backward_matches_simple_cherenkov():
    """A straight 2-segment ParticleTrack driven backward through the
    volume backward tracer must reproduce the simple Cherenkov source's
    light curve (the track source's backward mode is absent from the
    reference — lightsource.cherenkov.track.glsl:78-79 TODO). Streams
    diverge (0 vs 1 backward draw), so agreement is statistical."""
    import theia_jax.units as u
    from theia_jax.camera import PointCamera
    from theia_jax.light import (
        CherenkovLightSource,
        CherenkovTrackLightSource,
        ParticleTrack,
        UniformWavelengthSource,
    )
    from theia_jax.response import HistogramHitResponse
    from theia_jax.testing import WaterTestModel

    medium = WaterTestModel(mu_a=0.01, mu_s=0.03, g=0.4).createMedium()
    verts = np.array(
        [[-50.0, 0.0, 0.0, -50.0 / u.c], [0.0, 0.0, 0.0, 0.0],
         [50.0, 0.0, 0.0, 50.0 / u.c]], np.float32,
    )

    def run(src, key):
        tracer = VolumeBackwardTracer(
            64 * 1024, src, PointCamera(position=(0.0, 10.0, 0.0)),
            UniformWavelengthSource(lambdaRange=(420.0, 480.0)),
            HistogramHitResponse(nBins=60, t0=0.0, binSize=2.0),
            PhiloxRNG(key=key), medium=medium, nScattering=4,
            maxTime=120.0, disableDirectLighting=True,
        )
        curve, _ = tracer.run()
        return np.asarray(curve)

    track = run(
        CherenkovTrackLightSource(ParticleTrack(verts), usePhotonCount=True), 3
    )
    simple = run(
        CherenkovLightSource(
            trackStart=(-50.0, 0.0, 0.0), trackEnd=(50.0, 0.0, 0.0),
            startTime=-50.0 / u.c, endTime=50.0 / u.c, usePhotonCount=True,
        ), 3,
    )
    assert track.sum() > 0
    assert abs(track.sum() / simple.sum() - 1.0) < 0.05
    assert abs(int(np.argmax(track)) - int(np.argmax(simple))) <= 1
