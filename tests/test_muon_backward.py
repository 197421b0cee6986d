"""Backward importance sampling for MuonTrackLightSource.

Chain of trust: the backward estimator (DirectLightTracer, which connects
the camera to `source.sample_backward`) must reproduce the forward muon
light curve (VolumeForwardTracer onto a sphere target) in a non-scattering
absorbing medium — shape AND total (reference backward branch:
shader/lightsource.particles.muon.glsl sampleLight(observer, ...)).
"""

import numpy as np
import pytest

import jax.numpy as jnp

import theia_jax.units as u
from theia_jax.camera import SphereCamera
from theia_jax.light import MuonTrackLightSource, UniformWavelengthSource
from theia_jax.material import (
    DispersionFreeMedium,
    HenyeyGreensteinPhaseFunction,
    MediumModel,
)
from theia_jax.random import PhiloxRNG
from theia_jax.response import HistogramHitResponse
from theia_jax.target import SphereTarget
from theia_jax.trace import VolumeForwardTracer
from theia_jax.trace.direct import DirectLightTracer


class Absorber(DispersionFreeMedium, HenyeyGreensteinPhaseFunction, MediumModel):
    ModelName = "absorber"

    def __init__(self, mu_a=0.05):
        DispersionFreeMedium.__init__(self, n=1.33, ng=1.33, mu_a=mu_a, mu_s=0.0)
        HenyeyGreensteinPhaseFunction.__init__(self, 0.0)


TRACK_START = (0.0, 0.0, -5.0)
TRACK_END = (0.0, 0.0, 5.0)
DET_POS = (6.0, 0.0, 1.0)
DET_R = 1.0
ENERGY = 1.0e3 * u.GeV
N_BINS, BIN_SIZE = 40, 2.5


def _muon():
    # muon at ~c: endTime from the track length
    length = np.linalg.norm(np.subtract(TRACK_END, TRACK_START))
    return MuonTrackLightSource(
        startPosition=TRACK_START,
        startTime=0.0,
        endPosition=TRACK_END,
        endTime=length / u.speed_of_light,
        muonEnergy=ENERGY,
    )


def test_muon_supports_backward():
    src = _muon()
    assert src.supportBackward
    assert src.nRNGBackward == 1


def test_muon_backward_finite_and_on_track():
    """Sampled backward rays start on the track segment, point at the
    observer, and carry finite positive contribution."""
    from theia_jax.material import medium_constants
    from theia_jax.random import RNGState

    src = _muon()
    medium = Absorber().createMedium()
    n = 4096
    observer = jnp.asarray(np.full((n, 3), DET_POS, np.float32))
    normal = jnp.zeros((n, 3), jnp.float32)
    lam = jnp.full((n,), 450.0, jnp.float32)
    constants = medium_constants(medium, lam)
    rng = RNGState(
        key=PhiloxRNG(key=7).key_words,
        counter=jnp.zeros((4,), jnp.uint32),
        stream=jnp.arange(n, dtype=jnp.uint32),
        dim=jnp.zeros((n,), jnp.uint32),
    )
    ray, rng2 = src.sample_backward(
        src.params(), observer, normal, lam, constants, rng
    )
    pos = np.asarray(ray.position)
    # on the z-axis track, within the segment
    assert np.abs(pos[:, 0]).max() < 1e-4
    assert np.abs(pos[:, 1]).max() < 1e-4
    assert pos[:, 2].min() >= TRACK_START[2] - 1e-3
    assert pos[:, 2].max() <= TRACK_END[2] + 1e-3
    d = np.asarray(ray.direction)
    to_obs = np.asarray(observer) - pos
    to_obs /= np.linalg.norm(to_obs, axis=-1, keepdims=True)
    assert np.abs((d * to_obs).sum(-1) - 1.0).max() < 1e-5
    c = np.asarray(ray.contrib)
    assert np.isfinite(c).all() and (c >= 0.0).all() and c.max() > 0.0
    # exactly one RNG dimension consumed (reference: nRNGBackward=1)
    assert int(np.asarray(rng2.dim - rng.dim).max()) == 1


@pytest.mark.slow
def test_muon_backward_matches_forward_curve():
    """Enclosing-sphere chain of trust (model: reference
    tests/test_trace_energy.py:1248-1330 DirectTracer config): a sphere
    camera of radius -R around the track sees every photon at near-normal
    incidence (cos ~= 1 for R >> track length), so the backward estimate
    must match forward InnerSphereTarget crossings bin by bin."""
    from theia_jax.target import InnerSphereTarget

    medium = Absorber(mu_a=0.01).createMedium()
    R = 50.0
    center = (0.0, 0.0, 0.0)

    def hist():
        return HistogramHitResponse(nBins=N_BINS, t0=0.0, binSize=BIN_SIZE * 4)

    def run(tr, n):
        acc = None
        for _ in range(n):
            h, _ = tr.run()
            h = np.asarray(h)
            acc = h if acc is None else acc + h
        return acc / n

    fwd = run(
        VolumeForwardTracer(
            128 * 1024,
            _muon(),
            InnerSphereTarget(position=center, radius=R),
            UniformWavelengthSource(lambdaRange=(450.0, 450.0)),
            hist(),
            PhiloxRNG(key=0xC0FFEE),
            medium=medium,
            nScattering=4,
            scatterCoefficient=0.02,  # forced sampling; mu_s=0 reweights
            maxTime=float("inf"),
        ),
        8,
    )

    bwd = run(
        DirectLightTracer(
            128 * 1024,
            _muon(),
            SphereCamera(position=center, radius=-R),
            UniformWavelengthSource(lambdaRange=(450.0, 450.0)),
            hist(),
            PhiloxRNG(key=0xBEEF),
            medium=medium,
        ),
        8,
    )

    tot_f, tot_b = fwd.sum(), bwd.sum()
    assert tot_f > 0 and tot_b > 0
    assert np.abs(tot_b / tot_f - 1.0) < 0.05, (tot_f, tot_b)
    # curve shape: compare bins holding the bulk of the energy
    big = fwd > 0.05 * fwd.max()
    assert big.sum() >= 2
    ratio = bwd[big] / fwd[big]
    assert np.abs(ratio - 1.0).max() < 0.15, ratio
