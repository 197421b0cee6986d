"""VolumeForwardTracer physics validation (model: reference
tests/test_trace_energy.py:833-950 "spherical light source placed within a
spherical target" — energy conservation after undoing absorption)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import theia_jax.units as u
from theia_jax.callback import EventStatisticCallback
from theia_jax.light import SphericalLightSource, UniformWavelengthSource
from theia_jax.material import (
    DispersionFreeMedium,
    HenyeyGreensteinPhaseFunction,
    KokhanovskyOceanWaterPhaseMatrix,
    MediumModel,
)
from theia_jax.random import PhiloxRNG
from theia_jax.response import HistogramHitResponse, HitRecorder
from theia_jax.target import InnerSphereTarget
from theia_jax.trace import VolumeForwardTracer


pytestmark = pytest.mark.core  # fast smoke tier, see pyproject markers

class Model(
    DispersionFreeMedium,
    HenyeyGreensteinPhaseFunction,
    KokhanovskyOceanWaterPhaseMatrix,
    MediumModel,
):
    ModelName = "homogenous"

    def __init__(self, a, s, g, *, n=1.33, ng=1.33):
        DispersionFreeMedium.__init__(self, n=n, ng=ng, mu_a=a, mu_s=s)
        HenyeyGreensteinPhaseFunction.__init__(self, g)
        KokhanovskyOceanWaterPhaseMatrix.__init__(
            self, p90=0.66, theta0=0.25, alpha=4.0, xi=25.6
        )


def run_tracer(
    mu_a,
    mu_s,
    mu_sample,
    g,
    disableDirect=False,
    sampleTarget=True,
    batch_size=128 * 1024,
    n_batches=4,
):
    position = (12.0, 15.0, 0.2)
    radius = 100.0 * u.m
    budget = 1e9
    t0 = 10.0 * u.ns
    lam = 400.0 * u.nm

    model = Model(mu_a, mu_s, g)
    medium = model.createMedium()

    rng = PhiloxRNG(key=0xC0FFEE)
    photons = UniformWavelengthSource(lambdaRange=(lam, lam))
    light = SphericalLightSource(
        position=position, timeRange=(t0, t0), budget=budget
    )
    target = InnerSphereTarget(position=position, radius=radius)
    recorder = HitRecorder()
    tracer = VolumeForwardTracer(
        batch_size,
        light,
        target,
        photons,
        recorder,
        rng,
        medium=medium,
        maxTime=float("inf"),
        nScattering=10,
        scatterCoefficient=mu_sample,
        disableDirectLighting=disableDirect,
        disableTargetSampling=not sampleTarget,
        callback=EventStatisticCallback(),
    )

    total = 0.0
    stats_sum = None
    for _ in range(n_batches):
        hits, stats = tracer.run()
        valid = np.asarray(hits["valid"])
        time = np.asarray(hits["time"])[valid]
        contrib = np.asarray(hits["contrib"])[valid]
        vg = 1.0 / model.ng * u.c
        d = vg * (time - t0)
        total += (contrib * np.exp(mu_a * d)).sum()
        stats_sum = stats if stats_sum is None else {
            k: stats_sum[k] + v for k, v in stats.items()
        }

    direct_contrib = budget * np.exp(-mu_s * radius)
    expected = budget - direct_contrib if disableDirect else budget
    estimate = total / (batch_size * n_batches)
    return estimate, expected, stats_sum


# reference parametrization (subset, unpolarized) with tolerances widened
# ~4x for the ~13x smaller sample count
@pytest.mark.slow
@pytest.mark.parametrize(
    "mu_a,mu_s,mu_sample,g,disableDirect,sampleTarget,err",
    [
        (0.0, 0.005, 0.05, 0.0, False, True, 4e-3),
        (0.05, 0.01, 0.05, 0.0, False, True, 8e-3),
        (0.05, 0.01, 0.05, 0.9, False, True, 2.4e-2),
        (0.05, 0.01, 0.05, -0.9, False, True, 1.6e-2),
        (0.05, 0.01, np.nan, 0.9, False, True, 1.2e-2),
        (0.0, 0.005, 0.05, 0.0, True, True, 4e-3),
        (0.05, 0.01, 0.05, 0.9, True, False, 1.2e-2),
        # no-MIS + direct: rare exp(+4.5)-weighted direct hits -> heavy tail
        (0.0, 0.005, 0.05, 0.0, False, False, 6.0e-2),
    ],
)
def test_volume_forward_energy(
    mu_a, mu_s, mu_sample, g, disableDirect, sampleTarget, err
):
    estimate, expected, stats = run_tracer(
        mu_a, mu_s, mu_sample, g, disableDirect, sampleTarget
    )
    assert np.abs(estimate / expected - 1.0) < err


def test_volume_forward_quick():
    """Fast smoke version of the energy test (not marked slow)."""
    estimate, expected, stats = run_tracer(
        0.0, 0.005, 0.05, 0.0, batch_size=32 * 1024, n_batches=2
    )
    assert np.abs(estimate / expected - 1.0) < 0.02
    assert stats["created"] == 2 * 32 * 1024


def test_histogram_matches_recorder():
    """Histogram response must equal the binned recorder output."""
    position = (0.0, 0.0, 0.0)
    t0, bin_size, n_bins = 0.0, 50.0, 40
    model = Model(0.01, 0.01, 0.3)
    medium = model.createMedium()

    def build(response, batch):
        rng = PhiloxRNG(key=0xDEADBEEF)
        return VolumeForwardTracer(
            batch,
            SphericalLightSource(
                position=position, timeRange=(0.0, 0.0), budget=1e6
            ),
            InnerSphereTarget(position=position, radius=50.0),
            UniformWavelengthSource(lambdaRange=(400.0, 400.0)),
            response,
            rng,
            medium=medium,
            nScattering=6,
            scatterCoefficient=0.02,
        )

    batch = 16 * 1024
    recorder = HitRecorder()
    hist_resp = HistogramHitResponse(
        nBins=n_bins, t0=t0, binSize=bin_size
    )
    rec_hits, _ = build(recorder, batch).run()
    hist, _ = build(hist_resp, batch).run()

    valid = np.asarray(rec_hits["valid"])
    times = np.asarray(rec_hits["time"])[valid]
    contrib = np.asarray(rec_hits["contrib"])[valid]
    expected, _ = np.histogram(
        times,
        bins=n_bins,
        range=(t0, t0 + n_bins * bin_size),
        weights=(contrib / batch).astype(np.float64),
    )
    # device accumulates in float32 -> summation-order differences
    assert np.allclose(np.asarray(hist), expected, rtol=2e-3, atol=1e-8)


def test_polarized_energy_and_stokes():
    """Polarized transport must conserve energy (same totals) and produce
    valid normalized Stokes vectors (reference: test_trace_energy.py
    polarized rows; test_trace.py:90-212 Stokes checks)."""
    from theia_jax.material import KokhanovskyOceanWaterPhaseMatrix

    class PolModel(
        DispersionFreeMedium,
        HenyeyGreensteinPhaseFunction,
        KokhanovskyOceanWaterPhaseMatrix,
        MediumModel,
    ):
        ModelName = "pol"

        def __init__(self):
            DispersionFreeMedium.__init__(self, n=1.33, ng=1.33, mu_a=0.0, mu_s=0.005)
            HenyeyGreensteinPhaseFunction.__init__(self, 0.3)
            KokhanovskyOceanWaterPhaseMatrix.__init__(
                self, p90=0.66, theta0=0.25, alpha=4.0, xi=25.6
            )

    medium = PolModel().createMedium()
    position = (12.0, 15.0, 0.2)
    batch, n_batches = 32 * 1024, 2

    def run(polarized):
        rng = PhiloxRNG(key=0xC0FFEE)
        rec = HitRecorder()
        tracer = VolumeForwardTracer(
            batch,
            SphericalLightSource(position=position, timeRange=(10.0, 10.0), budget=1e9),
            InnerSphereTarget(position=position, radius=100.0),
            UniformWavelengthSource(lambdaRange=(450.0, 450.0)),
            rec,
            rng,
            medium=medium,
            nScattering=10,
            scatterCoefficient=0.05,
            maxTime=float("inf"),
            polarized=polarized,
        )
        total, stokes = 0.0, []
        for _ in range(n_batches):
            hits, _ = tracer.run()
            v = np.asarray(hits["valid"])
            total += np.asarray(hits["contrib"])[v].sum()
            if polarized:
                stokes.append(np.asarray(hits["stokes"])[v])
        return total / (batch * n_batches), stokes

    est_u, _ = run(False)
    est_p, stokes = run(True)
    # identical RNG streams: polarization must not change the energy beyond
    # Mueller-matrix float noise
    assert np.abs(est_p / est_u - 1.0) < 1e-3
    s = np.concatenate(stokes)
    assert np.abs(s[:, 0] - 1.0).max() < 1e-5
    assert s[:, 1:].max() <= 1.0 + 1e-6 and s[:, 1:].min() >= -1.0 - 1e-6
    assert np.all(np.square(s[:, 1:]).sum(-1) <= 1.0 + 1e-5)
    # scattering must actually polarize some photons
    assert np.abs(s[:, 1]).max() > 0.01
