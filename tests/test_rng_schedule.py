"""RNG draw-schedule conformance (the normative dim-consumption tables).

The north-star metric is "allclose vs the reference on identical Philox
streams"; that only holds if every tracer consumes RNG dimensions exactly
on the reference's schedule (reference: per-draw ``random(idx, dim)``
call sites in shader/scene.traverse.glsl, tracer.volume.forward.glsl,
tracer.volume.photon.common.glsl; host accounting src/theia/trace.py:
630-634, 1185-1196, 2488-2492).

These tests freeze the schedule: each lane's final ``dim`` counter must
equal the consumption derived *independently* from its recorded event
sequence via the tables below. Any added, removed or reordered draw fails.

Normative per-segment consumption (this repo's wavefront convention —
draws that the reference's exited threads skip still advance dead lanes
where marked "all lanes"; this is unobservable because dead lanes make no
further decisions):

SceneForwardTracer (histogram response, no volume-border materials):
  distance sample            +1   all lanes
  surface hit, refl+trans    +1   (code == RAY_HIT on TR-only scenes)
  volume scatter, i < L-1    +2   (code == RAY_SCATTERED), no guide
  volume scatter, i < L-1    +4+G (code == RAY_SCATTERED), guide with G
                                   samples: phase 2 + guide G + scatter 2
  absorbed / border / dead   +0

VolumeForwardTracer:
  distance sample            +1   all lanes
  scatter (loop segments)    +2   alive at segment entry
  MIS (phase 2 + target 2)   +4   (code == RAY_SCATTERED), MIS enabled
  target hit / dead          +0

VolumePhotonTracer (absorption-free medium -> RR never kills):
  run boundary               dim := pre + run * perRun   (resync)
  distance sample            +1   all lanes
  scatter                    +2   all lanes (unconditional, ref parity)
  Russian roulette           +1   (code == RAY_SCATTERED)
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import theia_jax.units as u
from theia_jax.callback import TraceEventCallback
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
from theia_jax.target import SphereTarget, SphereTargetGuide
from theia_jax.trace.core import EventResultCode
from theia_jax.trace.photon import VolumePhotonTracer
from theia_jax.trace.scene import SceneForwardTracer
from theia_jax.trace.volume import VolumeForwardTracer

pytestmark = pytest.mark.core  # fast smoke tier, see pyproject markers

SCATTERED = int(EventResultCode.RAY_SCATTERED)
HIT = int(EventResultCode.RAY_HIT)

BATCH = 256


class Model(DispersionFreeMedium, HenyeyGreensteinPhaseFunction, MediumModel):
    ModelName = "water"

    def __init__(self, a=0.01, s=0.4, g=0.3):
        DispersionFreeMedium.__init__(self, n=1.33, ng=1.33, mu_a=a, mu_s=s)
        HenyeyGreensteinPhaseFunction.__init__(self, g)


class GlassModel(Model):
    ModelName = "glass"


class CodeRecorder(TraceEventCallback):
    """Records (code, mask) per on_event slot for schedule accounting."""

    name = "Code Recorder"

    def init(self, batch_size: int, max_steps: int):
        self._steps = max_steps
        return dict(
            code=jnp.zeros((max_steps, batch_size), jnp.int32),
            mask=jnp.zeros((max_steps, batch_size), bool),
        )

    def on_event(self, params, state, ray, code, mask, i, pol=None):
        i_arr = jnp.asarray(i, jnp.int32)

        def write(st):
            c = jax.lax.dynamic_index_in_dim(st["code"], i_arr, 0, keepdims=False)
            m = jax.lax.dynamic_index_in_dim(st["mask"], i_arr, 0, keepdims=False)
            return dict(
                code=jax.lax.dynamic_update_index_in_dim(
                    st["code"], jnp.where(mask, code, c), i_arr, 0
                ),
                mask=jax.lax.dynamic_update_index_in_dim(st["mask"], m | mask, i_arr, 0),
            )

        return jax.lax.cond(i_arr < self._steps, write, lambda s: s, state)

    def result(self, params, state):
        return {k: np.asarray(v) for k, v in state.items()}


def run_debug(tracer):
    """Run one batch with the dim-capture hook; returns (codes, masks, dims)."""
    tracer._debug_rng = True
    p = tracer.params()
    streams = jnp.arange(tracer.batchSize, dtype=jnp.uint32)
    out = jax.jit(tracer._trace_batch)(p, tracer.rng.counter_words, streams)
    resp_state, cb_state, dims = out
    rec = tracer.callback.result(p["callback"], cb_state)
    return rec["code"], rec["mask"], np.asarray(dims).astype(np.int64)


def build_scene_tracer(guide: bool, max_path: int = 5):
    water = Model().createMedium(num_lambda=8, num_theta=64)
    mats = MaterialStore.pack(
        [
            Material("glass_water", GlassModel(0.0, 0.0, 0.0).createMedium(num_lambda=8), water, flags="TR"),
            Material("det_water", None, water, flags="DB"),
        ]
    )
    meshes = MeshStore({"sphere": icosphere()})
    det_pos = (0.0, 3.0, 0.0)
    instances = [
        meshes.createInstance("sphere", "glass_water", Transform.TRS(scale=1.0)),
        meshes.createInstance(
            "sphere", "det_water", Transform.TRS(scale=0.6, translate=det_pos),
            detectorId=1,
        ),
    ]
    scene = Scene(instances, mats, medium="water")
    return SceneForwardTracer(
        BATCH,
        SphericalLightSource(position=(2.0, 0.0, 0.0), timeRange=(0.0, 5.0), budget=1e5),
        UniformWavelengthSource(lambdaRange=(400.0, 500.0)),
        HistogramHitResponse(nBins=20, t0=0.0, binSize=5.0 * u.ns),
        PhiloxRNG(key=11),
        scene,
        maxPathLength=max_path,
        callback=CodeRecorder(),
        targetId=1,
        targetGuide=SphereTargetGuide(position=det_pos, radius=0.6) if guide else None,
        maxTime=100.0 * u.ns,
    )


@pytest.mark.parametrize("guide", [False, True])
def test_scene_forward_schedule(guide):
    tracer = build_scene_tracer(guide)
    codes, masks, dims = run_debug(tracer)
    L = tracer.maxPathLength
    wl = tracer.wavelengthSource.nRNGSamples
    src = tracer.source.nRNGForward
    g = tracer.targetGuide.nRNGSamples if guide else 0

    exp = np.full(BATCH, wl + src, np.int64)
    for i in range(L):
        c, m = codes[i + 1], masks[i + 1]
        exp += 1  # distance sample, all lanes
        if i < L - 1:
            exp += np.where(m & (c == SCATTERED), (2 + g + 2) if guide else 2, 0)
        exp += np.where(m & (c == HIT), 1, 0)  # reflect/transmit choice

    assert (dims == exp).all(), (
        f"draw-schedule drift on {int((dims != exp).sum())} lanes; "
        f"max |delta| = {np.abs(dims - exp).max()}"
    )
    # the host-side advance must cover the worst lane
    assert dims.max() <= tracer.nRNGSamples
    # sanity: the batch exercised every branch of the table
    assert (codes[1:L] == SCATTERED).any() and (codes[1:L] == HIT).any()


@pytest.mark.parametrize("mis", [True, False])
def test_volume_forward_schedule(mis):
    target = SphereTarget(position=(0.0, 0.0, 2.0), radius=0.5)
    tracer = VolumeForwardTracer(
        BATCH,
        SphericalLightSource(position=(0.0, 0.0, 0.0), timeRange=(0.0, 5.0), budget=1e5),
        target,
        UniformWavelengthSource(lambdaRange=(400.0, 500.0)),
        HistogramHitResponse(nBins=20, t0=0.0, binSize=5.0 * u.ns),
        PhiloxRNG(key=12),
        medium=Model().createMedium(num_lambda=8, num_theta=64),
        nScattering=5,
        callback=CodeRecorder(),
        maxTime=100.0 * u.ns,
        disableTargetSampling=not mis,
    )
    codes, masks, dims = run_debug(tracer)
    wl = tracer.wavelengthSource.nRNGSamples
    src = tracer.source.nRNGForward
    t_n = target.nRNGSamples

    exp = np.full(BATCH, wl + src, np.int64)
    # first trace step (recorded at slot 1)
    exp += 1
    if mis:
        exp += np.where(masks[1] & (codes[1] == SCATTERED), 2 + t_n, 0)
    # loop segments (slots i+2)
    for i in range(tracer.pathLength):
        c, m = codes[i + 2], masks[i + 2]
        exp += 1  # distance, all lanes
        exp += np.where(m, 2, 0)  # scatter draw at segment entry
        if mis:
            exp += np.where(m & (c == SCATTERED), 2 + t_n, 0)

    assert (dims == exp).all(), (
        f"draw-schedule drift on {int((dims != exp).sum())} lanes; "
        f"max |delta| = {np.abs(dims - exp).max()}"
    )
    assert dims.max() <= tracer.nRNGSamples
    assert (codes[1:-1] == SCATTERED).any()


def test_volume_photon_schedule():
    # absorption-free medium: Russian roulette never kills (contrib >= 1),
    # so RAY_ABSORBED can only mean a target hit (no draw ambiguity)
    target = SphereTarget(position=(0.0, 0.0, 2.0), radius=0.5)
    tracer = VolumePhotonTracer(
        BATCH,
        SphericalLightSource(position=(0.0, 0.0, 0.0), timeRange=(0.0, 5.0), budget=1e5),
        target,
        UniformWavelengthSource(lambdaRange=(400.0, 500.0)),
        HistogramHitResponse(nBins=20, t0=0.0, binSize=5.0 * u.ns),
        PhiloxRNG(key=13),
        medium=Model(a=0.0, s=0.3).createMedium(num_lambda=8, num_theta=64),
        nScatteringPerRun=3,
        nRuns=2,
        callback=CodeRecorder(),
        maxTime=1000.0 * u.ns,
    )
    codes, masks, dims = run_debug(tracer)
    n_steps = tracer.nRuns * tracer.nScatteringPerRun

    exp = np.full(BATCH, tracer._pre_dims, np.int64)
    for i in range(n_steps):
        if i % tracer.nScatteringPerRun == 0:
            exp[:] = tracer._pre_dims + (i // tracer.nScatteringPerRun) * tracer._per_run
        c, m = codes[i + 1], masks[i + 1]
        exp += 3  # distance (1) + scatter (2), all lanes
        exp += np.where(m & (c == SCATTERED), 1, 0)  # Russian roulette

    assert (dims == exp).all(), (
        f"draw-schedule drift on {int((dims != exp).sum())} lanes; "
        f"max |delta| = {np.abs(dims - exp).max()}"
    )
    assert dims.max() <= tracer.nRNGSamples
    assert (codes[1:-1] == SCATTERED).any()


def test_ref_compat_rng_stride():
    """refCompatRNG=True reproduces the reference's host-side offset
    advance verbatim (ref src/theia/trace.py:631-634 and :1178-1187) so
    multi-batch conformance runs land on bit-identical Philox streams."""
    # --- scene tracer with a guide: ref stride is 4 + G (not 5 + G) ---
    water = Model().createMedium(num_lambda=8, num_theta=64)
    mats = MaterialStore.pack([Material("det_water", None, water, flags="DB")])
    meshes = MeshStore({"sphere": icosphere()})
    det_pos = (0.0, 3.0, 0.0)
    scene = Scene(
        [
            meshes.createInstance(
                "sphere", "det_water",
                Transform.TRS(scale=0.6, translate=det_pos), detectorId=1,
            )
        ],
        mats,
        medium="water",
    )
    guide = SphereTargetGuide(position=det_pos, radius=0.6)

    def scene_tracer(compat, L=5):
        return SceneForwardTracer(
            BATCH,
            SphericalLightSource(
                position=(2.0, 0.0, 0.0), timeRange=(0.0, 5.0), budget=1e5
            ),
            UniformWavelengthSource(lambdaRange=(400.0, 500.0)),
            HistogramHitResponse(nBins=20, t0=0.0, binSize=5.0 * u.ns),
            PhiloxRNG(key=11),
            scene,
            maxPathLength=L,
            targetId=1,
            targetGuide=guide,
            refCompatRNG=compat,
        )

    t, tc = scene_tracer(False), scene_tracer(True)
    L, G = 5, guide.nRNGSamples
    src, wl = t.source.nRNGForward, t.wavelengthSource.nRNGSamples
    ref_n = src + wl + (4 + G) * L + tc.maxHitsPerThread * 0
    assert tc.nRNGSamples == ref_n
    assert t.nRNGSamples == ref_n + L  # ours adds the missing +1/segment

    # --- volume tracer with MIS: ref stride is 7, no first-step term ---
    def volume_tracer(compat):
        return VolumeForwardTracer(
            BATCH,
            SphericalLightSource(
                position=(0.0, 0.0, 0.0), timeRange=(0.0, 5.0), budget=1e5
            ),
            SphereTarget(position=(0.0, 0.0, 2.0), radius=0.5),
            UniformWavelengthSource(lambdaRange=(400.0, 500.0)),
            HistogramHitResponse(nBins=20, t0=0.0, binSize=5.0 * u.ns),
            PhiloxRNG(key=12),
            medium=Model().createMedium(num_lambda=8, num_theta=64),
            nScattering=5,
            refCompatRNG=compat,
        )

    v, vc = volume_tracer(False), volume_tracer(True)
    src, wl = v.source.nRNGForward, v.wavelengthSource.nRNGSamples
    assert vc.nRNGSamples == src + wl + 7 * vc.pathLength
    assert v.nRNGSamples > vc.nRNGSamples  # worst-case covers the ref's gap
