"""Arrival-time gradients through the KDE histogram.

The kernel histogram's smooth time dependence lets gradients flow from
the light curve's SHAPE back into parameters that shift arrival times —
here the medium's group velocity. Validated AD vs common-random-number
finite differences (unique to this framework; the reference has no
gradients)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from theia_jax.light import SphericalLightSource, UniformWavelengthSource
from theia_jax.random import PhiloxRNG
from theia_jax.response import KernelHistogramHitResponse
from theia_jax.target import SphereTarget
from theia_jax.testing import WaterTestModel
from theia_jax.trace import VolumeForwardTracer


def test_group_velocity_time_gradient():
    medium = WaterTestModel(mu_a=0.001, mu_s=0.02, g=0.4).createMedium()
    tracer = VolumeForwardTracer(
        16 * 1024,
        SphericalLightSource(position=(0.0, 0.0, 0.0), timeRange=(0.0, 0.0), budget=1e9),
        SphereTarget(position=(15.0, 0.0, 0.0), radius=4.0),
        UniformWavelengthSource(lambdaRange=(450.0, 450.0)),
        KernelHistogramHitResponse(nBins=60, binSize=4.0, t0=0.0, bandwidth=4.0),
        PhiloxRNG(key=0x71AE),
        medium=medium,
        nScattering=6,
        maxTime=250.0,
    )
    trace_fn, (p0, counter, streams) = tracer.trace_fn()
    bins = jnp.arange(60, dtype=jnp.float32)

    def mean_time(log_vg_scale):
        med = dataclasses.replace(
            p0["medium"],
            group_velocity=p0["medium"].group_velocity * jnp.exp(log_vg_scale),
        )
        p = dict(p0)
        p["medium"] = med
        state, _ = trace_fn(p, counter, streams)
        hist = tracer.response.result(p["response"], state)
        return jnp.sum(hist * bins) / jnp.sum(hist)

    g_ad = float(jax.grad(mean_time)(0.0))
    eps = 0.02
    g_fd = float((mean_time(eps) - mean_time(-eps)) / (2 * eps))
    # faster light -> earlier arrival -> mean bin decreases
    assert g_ad < 0
    assert abs(g_ad - g_fd) < 0.05 * abs(g_fd), (g_ad, g_fd)
