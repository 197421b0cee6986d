"""Differentiability of the *scene* tracers w.r.t. medium parameters.

Extends tests/test_grad_volume.py to the scene path: gradients must flow through the packed media tables consumed by
``SceneForwardTracer`` — attenuation (mu_a/mu_s), and the Fresnel/IOR
path (``_fresnel``, theia_jax/trace/scene.py) including the selection
score corrections and the backward eta^2 radiance factor
(reference semantics: shader/scatter.surface.glsl:21-51,
shader/ray.surface.glsl transmitRayIS backward).

* mu_a/mu_s: with a fixed ``scatterCoefficient`` the path geometry is
  independent of the medium attenuation, so fixed-seed central
  differences must match the AD gradient to float precision.
* IOR: the reflect/transmit choice is discrete (frozen under AD, score
  corrected via log r - sg(log r)); AD and common-random-number FD are
  different unbiased estimators of the same derivative and must agree
  within Monte Carlo noise.
"""

from dataclasses import replace as dc_replace

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import theia_jax.units as u
from theia_jax.camera import PointCamera
from theia_jax.light import SphericalLightSource, UniformWavelengthSource
from theia_jax.material import (
    DispersionFreeMedium,
    HenyeyGreensteinPhaseFunction,
    Material,
    MaterialStore,
    MediumModel,
)
from theia_jax.random import PhiloxRNG
from theia_jax.response import HistogramHitResponse
from theia_jax.mesh import icosphere
from theia_jax.scene import MeshStore, Scene, Transform
from theia_jax.trace.scene import SceneForwardTracer
from theia_jax.trace.scene_backward import SceneBackwardTargetTracer

N_BINS = 50
BIN_SIZE = 25.0


class Model(DispersionFreeMedium, HenyeyGreensteinPhaseFunction, MediumModel):
    ModelName = "homogenous"

    def __init__(self, a, s, g, *, n=1.33, ng=1.33):
        DispersionFreeMedium.__init__(self, n=n, ng=ng, mu_a=a, mu_s=s)
        HenyeyGreensteinPhaseFunction.__init__(self, g)


def patch_media(p, handle, **rows):
    """Return params with the given medium's packed table rows replaced by
    (differentiable) scalars — the hook jax.grad differentiates through."""
    pack = p["scene"]
    tables = dict(pack.media.tables)
    for kind, val in rows.items():
        tables[kind] = tables[kind].at[handle].set(val)
    p = dict(p)
    p["scene"] = dc_replace(pack, media=dc_replace(pack.media, tables=tables))
    return p


# ---------------------------------------------------------------------------
# mu_a / mu_s through the forward scene tracer: FD-exact
# ---------------------------------------------------------------------------


def build_forward_tracer(batch=8 * 1024):
    model = Model(0.01, 0.008, 0.4)
    medium = model.createMedium()
    material = Material("det", medium, None, flags="DB")
    store = MaterialStore.pack([material])
    meshes = MeshStore({"sphere": icosphere()})
    trafo = Transform.TRS(scale=100.0, translate=(0.0, 0.0, 0.0))
    inst = meshes.createInstance("sphere", "det", trafo, detectorId=0)
    scene = Scene([inst], store, medium="homogenous")
    return SceneForwardTracer(
        batch,
        SphericalLightSource(
            position=(0.0, 0.0, 0.0), timeRange=(10.0, 10.0), budget=1e9
        ),
        UniformWavelengthSource(lambdaRange=(450.0, 450.0)),
        HistogramHitResponse(nBins=N_BINS, t0=0.0, binSize=BIN_SIZE),
        PhiloxRNG(key=0xC0FFEE),
        scene,
        maxPathLength=6,
        scatterCoefficient=0.02,
        maxTime=float("inf"),
    )


def test_grad_scene_mu_matches_fd_exactly():
    tracer = build_forward_tracer()
    fn, (p0, counter, streams) = tracer.trace_fn()
    handle = p0["scene"].media.handle("homogenous")
    weights = jnp.asarray(
        np.exp(-np.linspace(0.0, 2.0, N_BINS)), jnp.float32
    )

    def loss(theta):
        mu_a, mu_s = theta
        p = patch_media(
            p0, handle, absorption_coef=mu_a, scattering_coef=mu_s
        )
        hist, _ = fn(p, counter, streams)
        return jnp.sum(hist * weights)

    loss_j = jax.jit(loss)
    grad_j = jax.jit(jax.grad(loss))
    theta0 = jnp.asarray([0.01, 0.008], jnp.float32)
    g = np.asarray(grad_j(theta0), np.float64)

    for i, eps in ((0, 1e-4), (1, 1e-4)):
        e = np.zeros(2)
        e[i] = eps
        hi = float(loss_j(theta0 + jnp.asarray(e, jnp.float32)))
        lo = float(loss_j(theta0 - jnp.asarray(e, jnp.float32)))
        fd = (hi - lo) / (2 * eps)
        assert fd != 0.0
        assert np.abs(g[i] - fd) < 3e-2 * np.abs(fd), (i, g[i], fd)


def test_grad_scene_mu_a_sign():
    """More absorption -> less detected energy."""
    tracer = build_forward_tracer(batch=4 * 1024)
    fn, (p0, counter, streams) = tracer.trace_fn()
    handle = p0["scene"].media.handle("homogenous")

    def total(mu_a):
        p = patch_media(p0, handle, absorption_coef=mu_a)
        hist, _ = fn(p, counter, streams)
        return jnp.sum(hist)

    g = float(jax.jit(jax.grad(total))(jnp.float32(0.02)))
    assert g < 0.0


# ---------------------------------------------------------------------------
# IOR through the Fresnel path: statistical FD agreement
# ---------------------------------------------------------------------------


def build_fresnel_tracer(batch=16 * 1024):
    """Non-absorbing detector sphere in water: every detector hit applies
    the Fresnel transmittance 1 - (r_s^2 + r_p^2)/2 evaluated from the
    refractive-index table, and surviving rays reflect/transmit with the
    IS decision + score correction."""
    model = Model(0.0, 0.01, 0.3)
    medium = model.createMedium()
    material = Material("det", medium, None, flags="D")
    store = MaterialStore.pack([material])
    meshes = MeshStore({"sphere": icosphere()})
    inst = meshes.createInstance(
        "sphere", "det", Transform.TRS(scale=60.0), detectorId=0
    )
    scene = Scene([inst], store, medium="homogenous")
    return SceneForwardTracer(
        batch,
        SphericalLightSource(
            position=(0.0, 0.0, 0.0), timeRange=(0.0, 0.0), budget=1e9
        ),
        UniformWavelengthSource(lambdaRange=(450.0, 450.0)),
        HistogramHitResponse(nBins=N_BINS, t0=0.0, binSize=BIN_SIZE),
        PhiloxRNG(key=0xBEEF),
        scene,
        maxPathLength=5,
        scatterCoefficient=0.02,
        maxTime=float("inf"),
    )


def test_grad_scene_ior_statistical():
    tracer = build_fresnel_tracer()
    fn, (p0, counter, streams) = tracer.trace_fn()
    handle = p0["scene"].media.handle("homogenous")

    def total(n0):
        p = patch_media(p0, handle, refractive_index=n0)
        hist, _ = fn(p, counter, streams)
        return jnp.sum(hist)

    total_j = jax.jit(total)
    grad_j = jax.jit(jax.grad(total))
    n0 = jnp.float32(1.33)
    g_ad = float(grad_j(n0))
    eps = 0.02
    fd = (float(total_j(n0 + eps)) - float(total_j(n0 - eps))) / (2 * eps)
    # water->vacuum transmittance falls with n -> both estimates negative
    assert g_ad < 0.0 and fd < 0.0, (g_ad, fd)
    assert np.abs(g_ad / fd - 1.0) < 0.5, (g_ad, fd)


def test_grad_backward_eta2_statistical():
    """Backward (radiance) transport applies eta^2 on transmission: a point
    camera inside a glass ball sees an emissive sphere through one
    refracting interface; d(total)/d(n_glass) must carry the eta^2 term
    and agree with common-random-number finite differences."""
    glass = DispersionFreeMedium(n=1.5, ng=1.5, mu_a=0.0, mu_s=0.0).createMedium(
        name="glass"
    )
    shell = Material("shell", glass, None)
    emit = Material("emit", None, None, flags="LB")
    store = MaterialStore.pack([shell, emit])
    meshes = MeshStore({"sphere": icosphere()})
    ball = meshes.createInstance("sphere", "shell", Transform.TRS(scale=1.0))
    wall = meshes.createInstance("sphere", "emit", Transform.TRS(scale=10.0))
    scene = Scene([ball, wall], store, medium=None)
    tracer = SceneBackwardTargetTracer(
        16 * 1024,
        PointCamera(position=(0.0, 0.0, 0.0)),
        UniformWavelengthSource(lambdaRange=(450.0, 450.0)),
        HistogramHitResponse(nBins=N_BINS, t0=0.0, binSize=2.0),
        PhiloxRNG(key=7),
        scene,
        medium="glass",
        maxPathLength=4,
        maxTime=float("inf"),
    )
    fn, (p0, counter, streams) = tracer.trace_fn()
    handle = p0["scene"].media.handle("glass")

    def total(n0):
        p = patch_media(p0, handle, refractive_index=n0)
        hist, _ = fn(p, counter, streams)
        return jnp.sum(hist)

    total_j = jax.jit(total)
    grad_j = jax.jit(jax.grad(total))
    n0 = jnp.float32(1.5)
    g_ad = float(grad_j(n0))
    eps = 0.02
    fd = (float(total_j(n0 + eps)) - float(total_j(n0 - eps))) / (2 * eps)
    # eta^2 = n^2 on glass->vacuum transmission grows with n and dominates
    # the shrinking transmittance at near-normal incidence
    assert g_ad > 0.0 and fd > 0.0, (g_ad, fd)
    assert np.abs(g_ad / fd - 1.0) < 0.5, (g_ad, fd)


def test_arrival_time_gradient_wrt_source_position():
    """Geometry gradients through the scene tracer: the hit-distance
    reattachment makes KDE arrival times differentiable w.r.t. the
    source position, FD-consistent (the basis of examples/09)."""
    import jax
    import jax.numpy as jnp

    from theia_jax.light import SphericalLightSource, UniformWavelengthSource
    from theia_jax.material import Material, MaterialStore
    from theia_jax.random import PhiloxRNG
    from theia_jax.response import KernelHistogramHitResponse
    from theia_jax.scene import MeshStore, Scene, Transform
    from theia_jax.testing import WaterTestModel
    from theia_jax.trace import SceneForwardTracer

    medium = WaterTestModel(mu_a=0.01, mu_s=0.02, g=0.3).createMedium()
    mats = MaterialStore.pack([Material("det", None, medium, flags="DB")])
    meshes = MeshStore({"sphere": icosphere()})
    insts = [
        meshes.createInstance(
            "sphere", "det",
            Transform.TRS(scale=0.4, translate=(2.0 * i - 1.0, 2.0 * j - 1.0, 0.0)),
            detectorId=i * 2 + j,
        )
        for i in range(2)
        for j in range(2)
    ]
    scene = Scene(insts, mats, medium="water_test", accel="instanced")
    tracer = SceneForwardTracer(
        4 * 1024,
        SphericalLightSource(position=(0.0, 0.0, 0.0), timeRange=(0.0, 0.0), budget=1e6),
        UniformWavelengthSource(lambdaRange=(420.0, 480.0)),
        KernelHistogramHitResponse(nBins=30, t0=0.0, binSize=1.0, nDetectors=4),
        PhiloxRNG(key=0xBADA55),
        scene, maxPathLength=4, maxTime=30.0,
    )
    fn, (p0, counter, streams) = tracer.trace_fn()

    def curves(pos):
        p = dict(p0)
        ls = dict(p["lightSource"])
        ls["position"] = pos
        p["lightSource"] = ls
        return fn(p, counter, streams)[0]

    obs = curves(jnp.array([0.3, -0.2, 0.0], jnp.float32))

    def loss(x):
        c = curves(jnp.array([x, 0.0, 0.0], jnp.float32))
        return jnp.sum((c - obs) ** 2) / jnp.sum(obs**2)

    g = float(jax.grad(loss)(jnp.float32(0.0)))
    assert np.isfinite(g)
    eps = 2e-2
    fd = (float(loss(jnp.float32(eps))) - float(loss(jnp.float32(-eps)))) / (2 * eps)
    # reparameterized gradient: same sign and magnitude within ~50%
    assert np.sign(g) == np.sign(fd), (g, fd)
    assert 0.3 < abs(g / fd) < 3.0, (g, fd)


def test_backward_geometry_gradient_through_bounce():
    """SceneBackwardTracer: camera-side *surface* segments (hit.t) must
    carry geometry gradients like the forward tracer's (the
    core.reattach_geometry discipline). Camera sits inside a slow glass
    sphere immersed in scattering water; the glass leg of every path is a
    geometric hit distance, so d(light curve)/d(camera x) via AD must be
    FD-consistent."""
    from theia_jax.response import KernelHistogramHitResponse
    from theia_jax.trace.scene_backward import SceneBackwardTracer

    glass = DispersionFreeMedium(n=1.8, ng=1.8, mu_a=0.0, mu_s=0.0).createMedium(
        name="glass"
    )
    water = Model(0.005, 0.05, 0.3).createMedium(name="water")
    mats = MaterialStore.pack([Material("glass_water", glass, water, flags="T")])
    meshes = MeshStore({"sphere": icosphere()})
    inst = meshes.createInstance(
        "sphere", "glass_water", Transform.TRS(scale=3.0)
    )
    scene = Scene([inst], mats, medium="water")
    tracer = SceneBackwardTracer(
        4 * 1024,
        SphericalLightSource(position=(8.0, 0.0, 0.0), timeRange=(0.0, 0.0), budget=1e6),
        PointCamera(position=(0.0, 0.0, 0.0)),
        UniformWavelengthSource(lambdaRange=(450.0, 450.0)),
        KernelHistogramHitResponse(nBins=40, t0=0.0, binSize=2.0),
        PhiloxRNG(key=0x5EED),
        scene,
        medium="glass",
        maxPathLength=4,
        maxTime=80.0,
        disableDirectLighting=True,
    )
    fn, (p0, counter, streams) = tracer.trace_fn()

    def curves(x):
        p = dict(p0)
        cam = dict(p["camera"])
        cam["position"] = jnp.stack([x, jnp.float32(0.0), jnp.float32(0.0)])
        p["camera"] = cam
        return fn(p, counter, streams)[0]

    obs = curves(jnp.float32(0.9))

    def loss(x):
        c = curves(x)
        return jnp.sum((c - obs) ** 2) / jnp.sum(obs**2)

    g = float(jax.grad(loss)(jnp.float32(0.0)))
    assert np.isfinite(g)
    eps = 2e-2
    fd = (float(loss(jnp.float32(eps))) - float(loss(jnp.float32(-eps)))) / (2 * eps)
    assert np.sign(g) == np.sign(fd), (g, fd)
    assert 0.4 < abs(g / fd) < 2.5, (g, fd)


def test_detector_position_gradient():
    """Detector-geometry calibration: d(light curve)/d(module position) via
    ScenePack.translate_instance must be finite and FD-consistent — the
    flip side of the source-position gradient (geometry arrays are traced
    params; hit reconstruction + reattachment carry the derivative)."""
    from theia_jax.light import SphericalLightSource, UniformWavelengthSource
    from theia_jax.random import PhiloxRNG
    from theia_jax.response import KernelHistogramHitResponse
    from theia_jax.scene import MeshStore, Scene, Transform
    from theia_jax.testing import WaterTestModel
    from theia_jax.trace import SceneForwardTracer

    medium = WaterTestModel(mu_a=0.01, mu_s=0.02, g=0.3).createMedium()
    mats = MaterialStore.pack([Material("det", None, medium, flags="DB")])
    meshes = MeshStore({"sphere": icosphere()})
    inst = meshes.createInstance(
        "sphere", "det", Transform.TRS(scale=0.5, translate=(3.0, 0.0, 0.0)),
        detectorId=0,
    )
    scene = Scene([inst], mats, medium="water_test", accel="brute")
    tracer = SceneForwardTracer(
        4 * 1024,
        SphericalLightSource(position=(0.0, 0.0, 0.0), timeRange=(0.0, 0.0), budget=1e6),
        UniformWavelengthSource(lambdaRange=(450.0, 450.0)),
        KernelHistogramHitResponse(nBins=30, t0=0.0, binSize=1.5),
        PhiloxRNG(key=0xD07),
        scene, maxPathLength=4, maxTime=40.0,
    )
    fn, (p0, counter, streams) = tracer.trace_fn()

    def curves(x):
        p = dict(p0)
        p["scene"] = p["scene"].translate_instance(
            0, jnp.stack([x, jnp.float32(0.0), jnp.float32(0.0)])
        )
        return fn(p, counter, streams)[0]

    obs = curves(jnp.float32(0.4))

    def loss(x):
        c = curves(x)
        return jnp.sum((c - obs) ** 2) / jnp.sum(obs**2)

    g = float(jax.grad(loss)(jnp.float32(0.0)))
    assert np.isfinite(g)
    eps = 2e-2
    fd = (float(loss(jnp.float32(eps))) - float(loss(jnp.float32(-eps)))) / (2 * eps)
    assert np.sign(g) == np.sign(fd), (g, fd)
    assert 0.3 < abs(g / fd) < 3.0, (g, fd)
