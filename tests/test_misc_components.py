"""Tests for testing helpers, estimators, replay, renderer and templates."""

import numpy as np

import jax.numpy as jnp

import theia_jax.units as u
from theia_jax.camera import SphereCamera
from theia_jax.light import SphericalLightSource, UniformWavelengthSource
from theia_jax.material import Material, MaterialStore
from theia_jax.random import PhiloxRNG
from theia_jax.render import SceneRender, SceneTemplate
from theia_jax.response import (
    HistogramEstimator,
    HistogramHitResponse,
    HitRecorder,
    HostEstimator,
    StoreValueHitResponse,
    replay_hits,
    sample_camera_hits,
)
from theia_jax.mesh import icosphere
from theia_jax.scene import MeshStore, Scene, Transform
from theia_jax.target import InnerSphereTarget, SphereTarget
from theia_jax.testing import (
    WaterTestModel,
    sampleCameraRay,
    sampleLight,
    sampleTarget,
    sampleWavelength,
)
from theia_jax.trace import VolumeForwardTracer


def test_samplers_shapes():
    ray = sampleLight(SphericalLightSource(budget=3.0), 256)
    assert ray.position.shape == (256, 3) and np.allclose(ray.contrib, 3.0)
    lam, contrib = sampleWavelength(
        UniformWavelengthSource(lambdaRange=(400.0, 500.0)), 256
    )
    assert lam.min() >= 400.0 and lam.max() <= 500.0
    cam = sampleCameraRay(SphereCamera(radius=2.0), 128)
    assert cam.direction.shape == (128, 3)
    tgt = sampleTarget(SphereTarget(radius=1.0), (5.0, 0.0, 0.0), 128)
    assert tgt.valid.all()


def _run_recorder(batch=8 * 1024):
    medium = WaterTestModel(g=0.4).createMedium()
    rec = HitRecorder()
    tracer = VolumeForwardTracer(
        batch,
        SphericalLightSource(position=(0.0, 0.0, 0.0), timeRange=(0.0, 0.0), budget=1e6),
        InnerSphereTarget(position=(0.0, 0.0, 0.0), radius=40.0),
        UniformWavelengthSource(lambdaRange=(400.0, 500.0)),
        rec,
        PhiloxRNG(key=0xC0FFEE),
        medium=medium,
        nScattering=6,
        scatterCoefficient=0.03,
    )
    hits, _ = tracer.run()
    return hits, batch


def test_replay_hits_matches_histogram():
    hits, batch = _run_recorder()
    resp = HistogramHitResponse(nBins=40, t0=0.0, binSize=20.0, normalization=1.0)
    hist = np.asarray(replay_hits(hits, resp))
    valid = np.asarray(hits["valid"])
    expected, _ = np.histogram(
        np.asarray(hits["time"])[valid],
        bins=40,
        range=(0.0, 800.0),
        weights=np.asarray(hits["contrib"])[valid].astype(np.float64),
    )
    assert np.allclose(hist, expected, rtol=2e-3)


def test_store_value_and_estimators():
    medium = WaterTestModel(g=0.4).createMedium()
    store = StoreValueHitResponse()
    tracer = VolumeForwardTracer(
        4 * 1024,
        SphericalLightSource(position=(0.0, 0.0, 0.0), timeRange=(0.0, 0.0), budget=1e6),
        InnerSphereTarget(position=(0.0, 0.0, 0.0), radius=40.0),
        UniformWavelengthSource(lambdaRange=(400.0, 500.0)),
        store,
        PhiloxRNG(key=0xC0FFEE),
        medium=medium,
        nScattering=6,
        scatterCoefficient=0.03,
    )
    queue, _ = tracer.run()
    est = HistogramEstimator(nBins=40, t0=0.0, binSize=20.0)
    hist = est(queue)
    host = HostEstimator()(queue)
    assert hist.sum() > 0
    assert np.isclose(hist.sum(), host["value"][host["time"] < 800.0].sum())


def test_sample_camera_hits():
    resp = HistogramHitResponse(nBins=10, t0=0.0, binSize=1.0, normalization=1.0)
    hist = np.asarray(sample_camera_hits(SphereCamera(radius=1.0), resp, 512))
    # all camera hits arrive at timeDelta=0 -> first bin
    assert hist[0] > 0 and hist[1:].sum() == 0


def test_scene_render():
    mat = Material("white", None, None, flags="B")
    store = MaterialStore.pack([mat])
    meshes = MeshStore({"sphere": icosphere()})
    inst = meshes.createInstance(
        "sphere", "white", Transform.TRS(scale=1.0, translate=(0.0, 5.0, 0.0))
    )
    scene = Scene([inst], store, medium=None)
    img = SceneRender(
        width=64,
        height=64,
        dimension=(4.0, 4.0),
        position=(0.0, 0.0, 0.0),
        direction=(0.0, 1.0, 0.0),
        maxDistance=20.0,
    ).render(scene)
    assert img.shape == (64, 64, 4)
    # center pixel hits the sphere (normal -y -> color encodes it),
    # corners miss (white)
    assert tuple(img[0, 0, :3]) == (255, 255, 255)
    assert tuple(img[32, 32, :3]) != (255, 255, 255)


def test_scene_template_stamping():
    mat = Material("det", None, None, flags="DB")
    store = MaterialStore.pack([mat])
    meshes = MeshStore({"sphere": icosphere()})
    proto = meshes.createInstance("sphere", "det", scale=0.5)
    template = SceneTemplate([proto])
    transforms = [
        Transform.Translation(0.0, 0.0, 0.0),
        Transform.Translation(5.0, 0.0, 0.0),
        Transform.Translation(0.0, 5.0, 0.0),
    ]
    scene = template.createScene(transforms, store, medium=None)
    assert len(scene.instances) == 3
    ids = sorted(i.detectorId for i in scene.instances)
    assert ids == [0, 1, 2]
    # stamped instances land at the right positions
    centers = [i.bbox for i in scene.instances]
    assert np.allclose(
        0.5 * (np.asarray(centers[1].lowerCorner) + np.asarray(centers[1].upperCorner)),
        (5.0, 0.0, 0.0),
        atol=1e-5,
    )


def test_mesh_camera():
    """MeshCamera: unbiased surface sampling + hemisphere directions.

    Estimator check: for a closed mesh, E[contrib]/2pi over hemisphere
    draws integrates cos over the hemisphere -> pi * totalArea, i.e.
    mean(contrib) -> pi * totalArea (reference estimator semantics)."""
    import numpy as np
    from theia_jax.camera import MeshCamera
    from theia_jax.scene import MeshStore, Transform
    from theia_jax.testing import sampleCameraRay, sampleCameraPoint

    meshes = MeshStore({"sphere": icosphere()})
    inst = meshes.createInstance(
        "sphere", "mat", Transform.TRS(scale=2.0, translate=(1.0, -2.0, 0.5))
    )
    cam = MeshCamera(inst, timeDelta=5.0)

    # total surface area of the transformed mesh
    m = inst.mesh
    pos = m.vertices[:, :3] * 2.0
    idx = m.indices
    e1 = pos[idx[:, 1]] - pos[idx[:, 0]]
    e2 = pos[idx[:, 2]] - pos[idx[:, 0]]
    area = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=-1).sum()

    n = 64 * 1024
    ray = sampleCameraRay(cam, n)
    assert np.allclose(ray.time_delta, 5.0)
    # directions leave the surface (outward): dot(dir, world normal) > 0
    # world normal from object normal: n @ w2o_lin (uniform scale -> same dir)
    wn = ray.hit_normal  # uniform scale + translation: direction unchanged
    assert (np.einsum("ij,ij->i", ray.direction, wn) > 0.0).all()
    est = ray.contrib.mean() / (2.0 * np.pi)
    assert abs(est / (area / 2.0) - 1.0) < 0.02  # cos integrates to pi*A/2pi

    # positions lie on the transformed sphere (radius 2 about center)
    r = np.linalg.norm(ray.position - np.array([1.0, -2.0, 0.5]), axis=-1)
    assert abs(np.median(r) / 2.0 - 1.0) < 0.01

    pt = sampleCameraPoint(cam, n)
    assert abs(pt.contrib.mean() / area - 1.0) < 0.02

    # inward flips normals and directions
    cam_in = MeshCamera(inst, inward=True)
    ray_in = sampleCameraRay(cam_in, 4096)
    assert (np.einsum("ij,ij->i", ray_in.direction, ray_in.hit_normal) > 0.0).all()


def test_polarized_track_record():
    """TrackRecordCallback(polarized=True): 11 columns with unit reference
    frames (reference: TRACK_POLARIZED, trace.py:189-305)."""
    import numpy as np

    from theia_jax.callback import TrackRecordCallback
    from theia_jax.light import SphericalLightSource, UniformWavelengthSource
    from theia_jax.random import PhiloxRNG
    from theia_jax.response import HistogramHitResponse
    from theia_jax.target import SphereTarget
    from theia_jax.testing import WaterTestModel
    from theia_jax.trace import VolumeForwardTracer

    cb = TrackRecordCallback(polarized=True)
    tr = VolumeForwardTracer(
        512,
        SphericalLightSource(position=(0.0, 0.0, 0.0), timeRange=(0.0, 0.0), budget=1e6),
        SphereTarget(position=(10.0, 0.0, 0.0), radius=3.0),
        UniformWavelengthSource(lambdaRange=(450.0, 450.0)),
        HistogramHitResponse(nBins=20, binSize=10.0, t0=0.0),
        PhiloxRNG(key=5),
        medium=WaterTestModel(mu_a=0.001, mu_s=0.05, g=0.5).createMedium(),
        nScattering=5,
        maxTime=300.0,
        polarized=True,
        callback=cb,
    )
    _, tracks = tr.run()
    tk = tracks["track"]
    assert tk.shape[-1] == 11
    lens = tracks["length"]
    lane = int(np.argmax(lens))
    seg = tk[lane, 1 : lens[lane] + 1]
    assert np.allclose(seg[:, 4], 1.0)  # S0 normalized... stokes[0]
    assert np.allclose(np.linalg.norm(seg[:, 8:11], axis=-1), 1.0, atol=1e-5)


def test_hit_recorder_overflow_counter():
    """Hits beyond capacity are dropped AND counted; result() warns
    (reference surfaces queue saturation via maxHits accounting)."""
    import warnings as _warnings

    import jax.numpy as jnp

    from theia_jax.component import TraceConfig
    from theia_jax.random import PhiloxRNG
    from theia_jax.response import HitRecorder
    from theia_jax.trace.core import HitItem

    n = 64
    rec = HitRecorder()
    rec.prepare(TraceConfig(n, n, 1, 1.0 / n, False))  # capacity 64
    state = rec.init()
    ones3 = jnp.ones((n, 3), jnp.float32)
    item = HitItem(
        position=ones3,
        direction=ones3,
        normal=ones3,
        wavelength=jnp.full(n, 450.0),
        time=jnp.arange(n, dtype=jnp.float32),
        contrib=jnp.ones(n, jnp.float32),
        object_id=jnp.zeros(n, jnp.int32),
    )
    rng = PhiloxRNG(key=1).state_for(
        jnp.zeros(4, jnp.uint32), jnp.arange(n, dtype=jnp.uint32)
    )
    mask = jnp.ones(n, bool)
    state, rng = rec.record({}, state, item, mask, rng)  # fills exactly
    assert int(state["cursor"]) == n and int(state["overflow"]) == 0
    state, rng = rec.record({}, state, item, mask, rng)  # all dropped
    assert int(state["cursor"]) == n
    assert int(state["overflow"]) == n
    with _warnings.catch_warnings(record=True) as w:
        _warnings.simplefilter("always")
        rec.result({}, state)
    assert any("overflow" in str(x.message) for x in w)


def test_profiling_helpers(tmp_path):
    """profile_batch produces an XLA trace dump + sane timing stats."""
    import os

    from theia_jax.profiling import batch_timings, profile_batch
    from tests.test_pipeline import build

    tracer = build(batch=1024)
    stats = profile_batch(tracer, str(tmp_path / "prof"), runs=2)
    assert stats["min"] > 0 and stats["bounces_per_s"] > 0
    dumped = [
        os.path.join(r, f)
        for r, _, fs in os.walk(tmp_path / "prof")
        for f in fs
    ]
    assert dumped, "no profiler output written"

    t = batch_timings(tracer, runs=3, warmup=0)
    assert t["min"] <= t["median"] <= t["max"]


def test_histogram_per_detector_axis():
    """nDetectors= bins hits by object id into (nDetectors, nBins); ids
    outside the range are dropped; summing over detectors reproduces the
    plain histogram restricted to valid ids."""
    import jax.numpy as jnp

    from theia_jax.component import TraceConfig
    from theia_jax.random import PhiloxRNG
    from theia_jax.response import HistogramHitResponse
    from theia_jax.trace.core import HitItem

    n = 256
    rng = np.random.default_rng(5)
    times = rng.uniform(0.0, 10.0, n).astype(np.float32)
    ids = rng.integers(-1, 4, n).astype(np.int32)  # -1 and 3 are invalid
    item = HitItem(
        position=jnp.zeros((n, 3)),
        direction=jnp.zeros((n, 3)),
        normal=jnp.zeros((n, 3)),
        wavelength=jnp.full(n, 450.0),
        time=jnp.asarray(times),
        contrib=jnp.ones(n),
        object_id=jnp.asarray(ids),
    )
    cfg = TraceConfig(
        batch_size=n, capacity=n, max_hits_per_thread=1,
        normalization=1.0, polarized=False,
    )

    def run(**kw):
        r = HistogramHitResponse(nBins=10, t0=0.0, binSize=1.0, **kw)
        r.prepare(cfg)
        state, _ = r.record(
            r.params(), r.init(), item, jnp.ones(n, bool),
            PhiloxRNG(key=1).state(jnp.arange(n, dtype=jnp.uint32)),
        )
        return np.asarray(r.result(r.params(), state))

    per_det = run(nDetectors=3)
    assert per_det.shape == (3, 10)
    # each detector's histogram matches a numpy reference
    for d in range(3):
        sel = ids == d
        ref, _ = np.histogram(times[sel], bins=10, range=(0.0, 10.0))
        np.testing.assert_allclose(per_det[d], ref)
    # ids outside [0, 3) are dropped entirely
    assert per_det.sum() == (np.isin(ids, [0, 1, 2])).sum()


def test_store_time_acceptance_probability():
    """StoreTimeHitResponse accepts each hit with probability equal to its
    response value (reference: tests/test_response.py:254-300,
    shader/response.time.store.glsl): acceptance rate tracks the value and
    accepted records keep the hit's time/objectId."""
    import jax.numpy as jnp

    from theia_jax.component import TraceConfig
    from theia_jax.response import CustomValueResponse, StoreTimeHitResponse
    from theia_jax.trace.core import HitItem

    n = 16 * 1024
    p_accept = 0.37

    def value_fn(params, item, rng):
        return jnp.full(item.time.shape, params["p"], jnp.float32), rng

    resp = StoreTimeHitResponse(
        CustomValueResponse(value_fn, params={"p": p_accept})
    )
    resp.prepare(TraceConfig(n, n, 1, 1.0 / n, False))
    state = resp.init()

    time = jnp.linspace(0.0, 50.0, n)
    ids = jnp.arange(n, dtype=jnp.int32) % 7
    zero3 = jnp.zeros((n, 3), jnp.float32)
    item = HitItem(
        position=zero3, direction=zero3, normal=zero3,
        wavelength=jnp.full(n, 450.0, jnp.float32),
        time=time, contrib=jnp.ones(n, jnp.float32), object_id=ids,
    )
    def _rng_state(key):
        from theia_jax.random import PhiloxRNG, RNGState

        return RNGState(
            key=PhiloxRNG(key=key).key_words,
            counter=jnp.zeros((4,), jnp.uint32),
            stream=jnp.arange(n, dtype=jnp.uint32),
            dim=jnp.zeros((n,), jnp.uint32),
        )

    state, _ = resp.record(
        resp.params(), state, item, jnp.ones(n, bool), _rng_state(11)
    )

    count = int(state["cursor"])
    # binomial(n, p): 5 sigma bounds
    sigma = np.sqrt(n * p_accept * (1 - p_accept))
    assert abs(count - n * p_accept) < 5 * sigma, count
    got_t = np.asarray(state["time"])[:count]
    got_id = np.asarray(state["objectId"])[:count]
    # accepted records preserve (time, objectId) pairing and order
    t_np, id_np = np.asarray(time), np.asarray(ids)
    order = np.searchsorted(t_np, got_t)
    assert np.allclose(t_np[order], got_t, atol=1e-6)
    assert np.array_equal(id_np[order], got_id)
    assert int(state["overflow"]) == 0
    # value > 1 accepts everything; masked lanes never record
    def one_fn(params, item, rng):
        return jnp.full(item.time.shape, 2.0, jnp.float32), rng

    resp2 = StoreTimeHitResponse(CustomValueResponse(one_fn))
    resp2.prepare(TraceConfig(n, n, 1, 1.0 / n, False))
    s2 = resp2.init()
    mask = jnp.arange(n) % 2 == 0
    s2, _ = resp2.record({}, s2, item, mask, _rng_state(12))
    assert int(s2["cursor"]) == n // 2


def test_task_module_alias():
    """`theia_jax.task` (the reference's module name) is importable in all
    forms and resolves to the pipeline implementations."""
    import importlib

    import theia_jax
    import theia_jax.task as task_mod
    from theia_jax.task import ConvergeHistogramTask

    assert task_mod.ConvergeHistogramTask is ConvergeHistogramTask
    assert theia_jax.task.ConvergeHistogramTask is ConvergeHistogramTask
    pipeline = importlib.import_module("theia_jax.pipeline")
    assert ConvergeHistogramTask is pipeline.ConvergeHistogramTask
