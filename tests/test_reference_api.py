"""Reference API-surface parity: every name in the reference's module
__all__ lists must exist at the matching theia_jax location and do the
real thing (items produce the reference's binary record layout, samplers
draw, queues interop with the responses that fill them)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp


pytestmark = pytest.mark.core  # fast smoke tier, see pyproject markers

REF_API = {
    "theia_jax.camera": "Camera CameraRayItem CameraRaySampler ConeCamera "
    "FlatCamera HostCamera MeshCamera PencilCamera PointCamera "
    "PolarizedCameraRayItem SphereCamera",
    "theia_jax.cascades": "CascadeLightYield CascadeParameters "
    "CascadePrimaryParticle EMinus EPlus Gamma K0_Long Neutron Particle "
    "ParticleType PiMinus PiPlus PMinus PPlus X0_ice X0_water "
    "createCascadeParameters createParamsFromParticle "
    "getCascadeParamsFromParticleType rho_ice rho_water",
    "theia_jax.light": "CherenkovLightSource CherenkovTrackLightSource "
    "ConeLightSource ConstWavelengthSource FunctionWavelengthSource "
    "HostLightSource HostWavelengthSource LightSampleItem LightSampler "
    "LightSource MuonTrackLightSource ParticleCascadeLightSource "
    "ParticleTrack PencilLightSource PolarizedLightSampleItem "
    "SphericalLightSource StreamingHostLightSource "
    "StreamingHostWavelengthSource UniformWavelengthSource "
    "WavelengthSampleItem WavelengthSource frankTamm",
    "theia_jax.lookup": "getTableSize uploadTables Table",
    "theia_jax.material": "loadMaterials parseMaterialFlags saveMaterials "
    "serializeMedium speed_of_light BK7Model FournierForandPhaseFunction "
    "HenyeyGreensteinPhaseFunction KokhanovskyOceanWaterPhaseMatrix "
    "Material MaterialFlags MaterialStore Medium MediumModel "
    "SellmeierEquation WaterBaseModel",
    "theia_jax.random": "Counter Key PhiloxRNG RNG RNGBufferSink SobolQRNG",
    "theia_jax.response": "createHitTimeQueue createValueQueue "
    "CameraHitResponseItem CameraHitResponseSampler CustomValueResponse "
    "EmptyResponse Estimator HistogramEstimator HistogramHitResponse "
    "HistogramReducer HitItem HitRecorder HitReplay HitResponse "
    "HitTimeAndIdItem HitTimeItem KernelHistogramHitResponse "
    "PolarizedCameraHitResponseItem PolarizedHitItem SampleValueResponse "
    "StoreTimeHitResponse StoreValueHitResponse UniformValueResponse "
    "ValueItem ValueResponse",
    "theia_jax.scene": "loadMesh MeshInstance MeshStore RectBBox Scene "
    "SphereBBox Transform",
    "theia_jax.render": "SceneRender SceneTemplate",
    "theia_jax.target": "DiskTarget DiskTargetGuide FlatTarget "
    "FlatTargetGuide InnerSphereTarget SphereTarget SphereTargetGuide "
    "Target TargetGuide",
    "theia_jax.pipeline": "ConvergeHistogramTask",
    "theia_jax.testing": "BackwardLightSampler CameraDirectSampler "
    "TargetGuideSampler TargetSampler WaterTestModel",
    "theia_jax.trace": "BidirectionalPathTracer EmptyEventCallback "
    "EventResultCode EventStatisticCallback SceneBackwardTracer "
    "SceneBackwardTargetTracer SceneForwardTracer ScenePhotonTracer "
    "Tracer TraceEventCallback TrackRecordCallback VolumeBackwardTracer "
    "VolumePhotonTracer VolumeForwardTracer",
    "theia_jax.units": "convert km m cm mm inch ft yd mi per_km per_m "
    "per_cm per_mm c s ms us ns ps um nm rad deg eV keV GeV TeV PeV",
}


@pytest.mark.parametrize("module", sorted(REF_API))
def test_reference_names_present(module):
    import importlib

    m = importlib.import_module(module)
    import theia_jax

    missing = [
        n
        for n in REF_API[module].split()
        if not (hasattr(m, n) or hasattr(theia_jax, n))
    ]
    assert not missing, missing


def test_item_layout_roundtrip():
    """from_queue produces the reference's exact binary record layout."""
    from theia_jax.items import PolarizedHitItem, ValueItem

    n = 7
    queue = dict(
        position=np.arange(n * 3, dtype=np.float32).reshape(n, 3),
        direction=np.ones((n, 3), np.float32),
        normal=np.zeros((n, 3), np.float32),
        stokes=np.ones((n, 4), np.float32),
        polRef=np.zeros((n, 3), np.float32),
        wavelength=np.full(n, 450.0, np.float32),
        time=np.arange(n, dtype=np.float32),
        contrib=np.ones(n, np.float32),
        objectId=np.arange(n, dtype=np.int32),
        valid=np.array([1, 1, 0, 1, 1, 1, 0], bool),
    )
    rows = PolarizedHitItem.from_queue(queue)
    assert rows.shape == (5,)
    # ctypes layout: 3+3+3+4+3 floats + f + f + f + i32 = 18f+2f... = 84 B
    assert rows.dtype.itemsize == (3 + 3 + 3 + 4 + 3 + 3) * 4 + 4
    np.testing.assert_array_equal(rows["objectId"], [0, 1, 3, 4, 5])
    np.testing.assert_array_equal(rows["position"][0], [0.0, 1.0, 2.0])

    vq = dict(
        value=np.arange(4, dtype=np.float32),
        time=np.arange(4, dtype=np.float32) * 2,
    )
    rows = ValueItem.from_queue(vq)  # no valid mask -> all rows
    assert rows.shape == (4,) and rows.dtype.itemsize == 8
    np.testing.assert_array_equal(rows["time"], vq["time"])


def test_samplers_draw_and_advance():
    from theia_jax.light import LightSampler, SphericalLightSource
    from theia_jax.random import PhiloxRNG
    from theia_jax.items import LightSampleItem

    src = SphericalLightSource(
        position=(1.0, 2.0, 3.0), timeRange=(0.0, 0.0), budget=1.0
    )
    sampler = LightSampler(src, 256, rng=PhiloxRNG(key=5))
    a = sampler.run()
    b = sampler.run()  # advanced RNG -> different directions
    assert set(a) >= {"position", "direction", "startTime", "contrib"}
    assert np.abs(a["direction"] - b["direction"]).max() > 0.1
    rows = LightSampleItem.from_queue(a)
    assert rows.shape == (256,)
    np.testing.assert_allclose(rows["position"][0], [1.0, 2.0, 3.0])


def test_camera_ray_sampler():
    from theia_jax.camera import CameraRaySampler, PencilCamera

    cam = PencilCamera(rayPosition=(0.0, 0.0, 0.0), rayDirection=(0, 0, 1.0))
    out = CameraRaySampler(cam, 64).run()
    assert out["position"].shape == (64, 3)
    np.testing.assert_allclose(out["direction"], [[0.0, 0.0, 1.0]] * 64)


def test_rng_buffer_sink_matches_rng_buffer():
    from theia_jax.random import PhiloxRNG, RNGBufferSink, rng_buffer

    sink = RNGBufferSink(PhiloxRNG(key=77), streams=32, samples=16)
    buf = sink.run()
    ref = np.asarray(rng_buffer(PhiloxRNG(key=77), 32, 16))
    np.testing.assert_array_equal(buf, ref)
    # generator advanced: next block differs
    assert np.abs(sink.run() - buf).max() > 0.0


def test_key_counter_views():
    from theia_jax.random import Counter, Key, PhiloxRNG

    k = Key(0xDEADBEEF12345678)
    assert k.lo == 0x12345678 and k.hi == 0xDEADBEEF
    assert k.value == 0xDEADBEEF12345678
    rng = PhiloxRNG(key=k.value)
    np.testing.assert_array_equal(np.asarray(rng.key_words), np.asarray(k.words))
    c = Counter(2**40 + 7)
    assert c.value == 2**40 + 7
    assert int(np.asarray(c.words)[1]) == 2**40 >> 32


def test_queue_creators_match_response_layouts():
    from theia_jax.component import TraceConfig
    from theia_jax.response import (
        StoreTimeHitResponse,
        StoreValueHitResponse,
        createHitTimeQueue,
        createValueQueue,
    )

    cfg = TraceConfig(
        batch_size=8,
        capacity=8,
        max_hits_per_thread=2,
        normalization=1.0,
        polarized=False,
    )
    st = StoreTimeHitResponse()
    st.prepare(cfg)
    ref = st.init()
    q = createHitTimeQueue(16)
    assert set(q) == set(ref)
    assert all(q[k].shape == ref[k].shape for k in q)

    sv = StoreValueHitResponse()
    sv.prepare(cfg)
    ref = sv.init()
    q = createValueQueue(16)
    assert set(q) == set(ref)


def test_histogram_reducer():
    from theia_jax.response import HistogramReducer

    red = HistogramReducer(nBins=8, normalization=0.5)
    hists = np.stack([np.arange(8.0), np.ones(8)])
    out = np.asarray(red(hists))
    np.testing.assert_allclose(out, (np.arange(8.0) + 1.0) * 0.5)


def test_table_upload_and_size():
    from theia_jax.lookup import Table, getTableSize, uploadTables, lookup
    from theia_jax.material import lookup_packed

    t = Table(np.linspace(0.0, 1.0, 11))
    assert t.nbytes == 11 * 4 + 4
    dev = t.upload()
    assert float(lookup(dev, 0.5)) == pytest.approx(0.5)
    assert getTableSize((11,)) == getTableSize(t.data) == 4 * 12
    assert getTableSize(None) == 0

    (values, sizes), handles = uploadTables(
        [np.linspace(0, 1, 5), np.linspace(2, 3, 9)]
    )
    assert handles == [0, 1]
    h = jnp.asarray([0, 1])
    got = lookup_packed(values, sizes, h, jnp.asarray([0.5, 0.5]))
    np.testing.assert_allclose(np.asarray(got), [0.5, 2.5])


def test_serialize_medium():
    from theia_jax.material import serializeMedium
    from theia_jax.testing import WaterTestModel

    med = WaterTestModel().createMedium()
    assert serializeMedium(med) == med.name
    assert serializeMedium("water") == "water"
    assert serializeMedium(None) is None


def test_package_root_exposes_submodules():
    """`import theia_jax; theia_jax.camera...` works like the reference
    root (ref __init__.py exposes every submodule), including the
    reference's `task` module name."""
    import theia_jax

    assert theia_jax.camera.PencilCamera is not None
    assert theia_jax.task.ConvergeHistogramTask is not None
    assert theia_jax.scene.Scene is not None
    with pytest.raises(AttributeError):
        theia_jax.not_a_module
