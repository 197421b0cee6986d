"""Light/wavelength source distribution checks
(model: reference tests/test_light.py — KS tests and contrib formulas)."""

import numpy as np
import pytest
from scipy.integrate import quad
from scipy.stats import gamma as gamma_dist, kstest

import jax
import jax.numpy as jnp

import theia_jax.units as u
from theia_jax.cascades import (
    EMinus,
    Particle,
    ParticleType,
    createCascadeParameters,
    createParamsFromParticle,
)
from theia_jax.light import (
    CherenkovLightSource,
    CherenkovTrackLightSource,
    ConeLightSource,
    FunctionWavelengthSource,
    MuonTrackLightSource,
    ParticleCascadeLightSource,
    ParticleTrack,
    SphericalLightSource,
    UniformWavelengthSource,
    _eval_emission_angle,
    _sample_emission_angle,
    frankTamm,
)
from theia_jax.material import MediumConstants
from theia_jax.ops.gamma import sample_gamma
from theia_jax.random import PhiloxRNG

pytestmark = pytest.mark.core  # fast smoke tier, see pyproject markers

N = 4 * 1024


def state(n=N, key=0xC0FFEE):
    return PhiloxRNG(key=key).state(jnp.arange(n, dtype=jnp.uint32))


def constants(n=1.33):
    arr = jnp.full(N, n, jnp.float32)
    return MediumConstants(
        n=arr, vg=arr * 0 + u.c / 1.33, mu_s=arr * 0, mu_e=arr * 0
    )


def test_spherical_source_distribution():
    src = SphericalLightSource(budget=7.0, timeRange=(2.0, 5.0))
    ray, _ = src.sample_forward(src.params(), None, constants(), state())
    d = np.asarray(ray.direction)
    assert np.allclose(np.linalg.norm(d, axis=-1), 1.0, atol=1e-5)
    assert np.abs(d.mean(0)).max() < 0.05
    assert kstest(np.asarray(ray.start_time), "uniform", args=(2.0, 3.0)).pvalue > 0.01
    assert np.allclose(np.asarray(ray.contrib), 7.0)


def test_cone_source_within_cone():
    src = ConeLightSource(direction=(0.0, 0.0, 1.0), cosOpeningAngle=0.8)
    ray, _ = src.sample_forward(src.params(), None, constants(), state())
    cz = np.asarray(ray.direction)[:, 2]
    assert cz.min() >= 0.8 - 1e-6
    assert kstest(cz, "uniform", args=(0.8, 0.2)).pvalue > 0.01


def test_gamma_sampler_ks():
    """Gamma sampler vs scipy (reference: tests/test_random.py:93-121)."""
    for alpha in (0.7, 1.5, 4.2):
        z, _ = sample_gamma(alpha, state(8 * 1024))
        p = kstest(np.asarray(z), gamma_dist(alpha).cdf).pvalue
        assert p > 0.01, (alpha, p)


def test_emission_angle_sampler():
    """Angular emission sampling matches its own pdf."""
    n, a, b = 1.33, 0.5375, 3.302
    uu = np.asarray(jax.random.uniform(jax.random.PRNGKey(0), (200_000,)))
    cos_theta = np.asarray(_sample_emission_angle(n, a, b, jnp.asarray(uu)))
    assert cos_theta.min() >= -1.0 - 1e-5 and cos_theta.max() <= 1.0 + 1e-5
    hist, edges = np.histogram(cos_theta, bins=64, range=(-1, 1), density=True)
    centers = 0.5 * (edges[1:] + edges[:-1])
    pdf = np.asarray(_eval_emission_angle(n, a, b, jnp.asarray(centers)))
    mask = hist > 0.05
    rel = np.abs(hist[mask] - pdf[mask]) / pdf[mask]
    assert np.median(rel) < 0.08


def test_cherenkov_angle_and_yield():
    src = CherenkovLightSource(
        trackStart=(0.0, 0.0, 0.0),
        trackEnd=(10.0, 0.0, 0.0),
        usePhotonCount=True,
    )
    lam = jnp.full(N, 450.0, jnp.float32)
    ray, _ = src.sample_forward(src.params(), lam, constants(), state())
    # emitted on the Cherenkov cone around the track direction
    cos = np.asarray(ray.direction)[:, 0]
    assert np.allclose(cos, 1.0 / 1.33, atol=1e-5)
    # yield: 2pi * FT/2pi * L == frankTamm * L
    expected = frankTamm(450.0, 1.33) * 10.0
    assert np.allclose(np.asarray(ray.contrib), expected, rtol=1e-5)
    # linear polarization in the track/ray plane
    s = np.asarray(ray.stokes)
    assert np.allclose(s[:, 1], 1.0)


def test_cherenkov_track_source():
    verts = np.array(
        [[0, 0, 0, 0], [5, 0, 0, 5 / u.c], [5, 5, 0, 10 / u.c]], np.float32
    )
    src = CherenkovTrackLightSource(ParticleTrack(verts), usePhotonCount=True)
    lam = jnp.full(N, 450.0, jnp.float32)
    ray, _ = src.sample_forward(src.params(), lam, constants(), state())
    pos = np.asarray(ray.position)
    # positions on one of the two segments
    on_seg1 = (np.abs(pos[:, 1]) < 1e-5) & (pos[:, 0] >= -1e-5) & (pos[:, 0] <= 5 + 1e-5)
    on_seg2 = (np.abs(pos[:, 0] - 5) < 1e-5) & (pos[:, 1] >= -1e-5) & (pos[:, 1] <= 5 + 1e-5)
    assert np.all(on_seg1 | on_seg2)
    assert abs(on_seg1.mean() - 0.5) < 0.05


def test_cascade_source_longitudinal():
    params = createCascadeParameters(EMinus, 1e3)  # 1 TeV EM cascade
    src = ParticleCascadeLightSource(
        direction=(0.0, 0.0, 1.0),
        effectiveLength=params.effectiveLength,
        a_angular=params.a_angular,
        b_angular=params.b_angular,
        a_long=params.a_long,
        b_long=params.b_long,
    )
    lam = jnp.full(N, 450.0, jnp.float32)
    ray, _ = src.sample_forward(src.params(), lam, constants(), state())
    z = np.asarray(ray.position)[:, 2]
    p = kstest(z / params.b_long, gamma_dist(params.a_long).cdf).pvalue
    assert p > 0.01
    # time = z / c
    assert np.allclose(np.asarray(ray.start_time), z / u.c, atol=1e-4)


def test_muon_track_source():
    src = MuonTrackLightSource(
        startPosition=(0, 0, 0),
        endPosition=(0, 0, 20),
        startTime=0.0,
        endTime=20.0 / u.c,
        muonEnergy=1e3,
    )
    lam = jnp.full(N, 450.0, jnp.float32)
    ray, _ = src.sample_forward(src.params(), lam, constants(), state())
    pos = np.asarray(ray.position)
    assert pos[:, 2].min() >= -1e-5 and pos[:, 2].max() <= 20 + 1e-5
    # emission peaks near the Cherenkov angle
    cz = np.asarray(ray.direction)[:, 2]
    hist, edges = np.histogram(cz, bins=50, range=(-1, 1))
    peak = 0.5 * (edges[hist.argmax()] + edges[hist.argmax() + 1])
    assert abs(peak - 1 / 1.33) < 0.1


def test_create_params_from_particle():
    cls, params, ly = createParamsFromParticle(
        Particle(ParticleType.E_MINUS, (0, 0, 0), (0, 0, 1), energy=100.0)
    )
    assert cls is ParticleCascadeLightSource
    assert ly.effectiveLength > 0
    cls, params, ly = createParamsFromParticle(
        Particle(
            ParticleType.MU_MINUS, (0, 0, 0), (0, 0, 1), energy=100.0, length=50.0
        )
    )
    assert cls is MuonTrackLightSource
    assert params["lightSource__endPosition"][2] == 50.0


def test_function_wavelength_source():
    fn = lambda lam: np.exp(-((lam - 450.0) ** 2) / (2 * 30.0**2))
    src = FunctionWavelengthSource(fn, lambdaRange=(300.0, 700.0))
    (lam, contrib), _ = src.sample(src.params(), state(8 * 1024))
    lam = np.asarray(lam)
    norm_const, _ = quad(fn, 300.0, 700.0)
    assert np.allclose(np.asarray(contrib), norm_const, rtol=1e-5)
    # samples follow the distribution
    def cdf(x):
        return np.vectorize(lambda v: quad(fn, 300.0, v)[0] / norm_const)(x)
    sub = lam[:2000]
    assert kstest(sub, cdf).pvalue > 0.01
