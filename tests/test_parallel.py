"""Multi-chip data parallelism: sharded trace must equal single-device
(identical global RNG streams; only float summation order differs)."""

import numpy as np

import jax
import jax.numpy as jnp

from theia_jax.callback import EventStatisticCallback
from theia_jax.light import SphericalLightSource, UniformWavelengthSource
from theia_jax.material import (
    DispersionFreeMedium,
    HenyeyGreensteinPhaseFunction,
    MediumModel,
)
from theia_jax.parallel import make_photon_mesh, shard_trace, sharded_streams
from theia_jax.random import PhiloxRNG
from theia_jax.response import HistogramHitResponse
from theia_jax.target import InnerSphereTarget
from theia_jax.trace import VolumeForwardTracer


class Model(DispersionFreeMedium, HenyeyGreensteinPhaseFunction, MediumModel):
    def __init__(self):
        DispersionFreeMedium.__init__(self, n=1.33, ng=1.33, mu_a=0.01, mu_s=0.01)
        HenyeyGreensteinPhaseFunction.__init__(self, 0.4)


def build(batch):
    return VolumeForwardTracer(
        batch,
        SphericalLightSource(position=(0.0, 0.0, 0.0), timeRange=(0.0, 0.0), budget=1e9),
        InnerSphereTarget(position=(0.0, 0.0, 0.0), radius=60.0),
        UniformWavelengthSource(lambdaRange=(400.0, 500.0)),
        HistogramHitResponse(nBins=40, t0=0.0, binSize=20.0),
        PhiloxRNG(key=0xC0FFEE),
        medium=Model().createMedium(num_lambda=64, num_theta=64),
        nScattering=4,
        scatterCoefficient=0.02,
        callback=EventStatisticCallback(),
    )


def test_sharded_equals_single():
    assert jax.device_count() >= 8, "conftest should provide 8 CPU devices"
    batch = 8 * 1024
    tracer = build(batch)
    p = tracer.params()
    counter = tracer.rng.counter_words

    # single device
    hist1, stats1 = tracer._jit_trace(p, counter, jnp.arange(batch, dtype=jnp.uint32))

    # 8-way sharded
    mesh = make_photon_mesh()
    fn = shard_trace(tracer, mesh)
    streams = sharded_streams(batch, mesh)
    hist8, stats8 = fn(p, counter, streams)

    assert np.allclose(np.asarray(hist1), np.asarray(hist8), rtol=2e-4, atol=1e-3)
    assert np.array_equal(np.asarray(stats1), np.asarray(stats8))


def test_sharded_gradient():
    """Gradients flow through shard_map + psum (the distributed backward)."""
    import dataclasses

    batch = 4 * 1024
    tracer = build(batch)
    medium = tracer.medium
    p0 = tracer.params()
    counter = tracer.rng.counter_words
    mesh = make_photon_mesh()
    streams = sharded_streams(batch, mesh)

    def total(tbl, streams):
        p = dict(p0)
        p["medium"] = dataclasses.replace(medium, absorption_coef=tbl)
        hist, _ = tracer._trace_batch(p, counter, streams)
        return jnp.sum(hist)

    from jax.sharding import PartitionSpec as P

    g_single = jax.grad(total)(
        jnp.asarray(medium.absorption_coef), jnp.arange(batch, dtype=jnp.uint32)
    )

    def sharded_total(tbl, streams):
        def inner(tbl, streams):
            val = total(tbl, streams)
            return jax.lax.psum(val, "batch")

        return jax.shard_map(
            inner,
            mesh=mesh,
            in_specs=(P(), P("batch")),
            out_specs=P(),
            check_vma=False,
        )(tbl, streams)

    g_shard = jax.jit(jax.grad(sharded_total))(
        jnp.asarray(medium.absorption_coef), streams
    )
    assert np.allclose(
        np.asarray(g_single), np.asarray(g_shard), rtol=2e-3, atol=1e-2
    )


def test_sharded_polarized_scene_gradient():
    """Capstone config (BASELINE.md staged config 5): lobed-sphere polarized
    transient with medium-parameter gradients, sharded over the device
    mesh with psum'd histograms and gradients."""
    import dataclasses

    from theia_jax.light import SphericalLightSource, UniformWavelengthSource
    from theia_jax.material import Material, MaterialStore
    from theia_jax.random import PhiloxRNG
    from theia_jax.response import HistogramHitResponse
    from theia_jax.mesh import icosphere, lobed_sphere
    from theia_jax.scene import MeshStore, Scene, Transform
    from theia_jax.testing import WaterTestModel
    from theia_jax.trace import SceneForwardTracer

    medium = WaterTestModel(mu_a=0.002, mu_s=0.01, g=0.4).createMedium()
    store = MaterialStore.pack([Material("det", None, medium, flags="DB")])
    meshes = MeshStore({"lobed": lobed_sphere()})
    scene = Scene(
        [
            meshes.createInstance(
                "lobed", "det",
                Transform.TRS(scale=8.0, translate=(25.0, 0.0, 0.0)),
                detectorId=1,
            )
        ],
        store,
        medium="water_test",
    )
    batch = 4 * 1024
    tracer = SceneForwardTracer(
        batch,
        SphericalLightSource(position=(0.0, 0.0, 0.0), timeRange=(0.0, 0.0), budget=1e9),
        UniformWavelengthSource(lambdaRange=(400.0, 500.0)),
        HistogramHitResponse(nBins=40, binSize=10.0, t0=0.0),
        PhiloxRNG(key=0x5C0_FFEE),
        scene,
        maxPathLength=6,
        scatterCoefficient=0.012,
        targetId=1,
        maxTime=400.0,
        polarized=True,
    )
    p0 = tracer.params()
    counter = tracer.rng.counter_words
    mesh = make_photon_mesh()
    streams = sharded_streams(batch, mesh)

    def loss(tbl, streams):
        p = dict(p0)
        p["scene"] = dataclasses.replace(
            p0["scene"],
            media=dataclasses.replace(
                p0["scene"].media,
                tables={**p0["scene"].media.tables, "absorption_coef": tbl},
            ),
        )
        hist, _ = tracer._trace_batch(p, counter, streams)
        return jnp.sum(hist)

    tbl = p0["scene"].media.tables["absorption_coef"]
    g_single = jax.grad(loss)(tbl, jnp.arange(batch, dtype=jnp.uint32))

    from jax.sharding import PartitionSpec as P

    def sharded_loss(tbl, streams):
        def inner(tbl, streams):
            return jax.lax.psum(loss(tbl, streams), "batch")

        return jax.shard_map(
            inner, mesh=mesh, in_specs=(P(), P("batch")), out_specs=P(),
            check_vma=False,
        )(tbl, streams)

    val, g_shard = jax.value_and_grad(sharded_loss)(tbl, streams)
    assert float(val) > 0
    assert np.asarray(np.abs(g_single)).max() > 0
    assert np.allclose(np.asarray(g_single), np.asarray(g_shard), rtol=2e-4, atol=1e-6 * np.abs(np.asarray(g_single)).max())


def test_sharded_instanced_scene_equals_single():
    """The instanced accel's lax.while_loop traversal must compile and
    run inside shard_map with results identical to single-device."""
    from theia_jax.material import Material, MaterialStore
    from theia_jax.mesh import icosphere, lobed_sphere
    from theia_jax.scene import MeshStore, Scene, Transform
    from theia_jax.testing import WaterTestModel
    from theia_jax.trace import SceneForwardTracer

    def build_scene_tracer(batch):
        medium = WaterTestModel(mu_a=0.0, mu_s=0.03, g=0.0).createMedium()
        mat = Material("det", None, medium, flags="DB")
        store = MaterialStore.pack([mat])
        meshes = MeshStore({"sphere": icosphere()})
        insts = [
            meshes.createInstance(
                "sphere",
                "det",
                Transform.TRS(scale=0.5, translate=(2.0 * i - 1, 2.0 * j - 1, 0.0)),
            )
            for i in range(2)
            for j in range(2)
        ]
        scene = Scene(insts, store, medium="water_test", accel="instanced")
        return SceneForwardTracer(
            4 * 1024,
            SphericalLightSource(
                position=(0.0, 0.0, 0.0), timeRange=(0.0, 0.0), budget=1e6
            ),
            UniformWavelengthSource(lambdaRange=(400.0, 500.0)),
            HistogramHitResponse(nBins=20, t0=0.0, binSize=4.0),
            PhiloxRNG(key=0xFACE),
            scene,
            maxPathLength=4,
            maxTime=80.0,
        )

    tracer = build_scene_tracer(4 * 1024)
    single, _ = tracer.run(advance=False)

    mesh = make_photon_mesh()
    fn = shard_trace(tracer, mesh)
    streams = sharded_streams(tracer.capacity, mesh)
    resp_state, _ = fn(tracer.params(), tracer.rng.counter_words, streams)
    sharded = tracer.response.result(tracer.params()["response"], resp_state)

    assert np.asarray(single).sum() > 0
    np.testing.assert_allclose(
        np.asarray(sharded), np.asarray(single), rtol=1e-5
    )


def test_multihost_runner_single_params_snapshot():
    """shard_trace_multihost must take exactly ONE params() snapshot per
    batch (regression: a second call double-advanced streaming sources,
    silently skipping every other data block)."""
    from theia_jax.light import StreamingHostWavelengthSource
    from theia_jax.parallel import shard_trace_multihost

    wl = np.linspace(400.0, 500.0, 16 * 1024, dtype=np.float32)
    src = StreamingHostWavelengthSource(wl, batchSize=4 * 1024)
    tracer = VolumeForwardTracer(
        4 * 1024,
        SphericalLightSource(
            position=(0.0, 0.0, 0.0), timeRange=(0.0, 0.0), budget=1e9
        ),
        InnerSphereTarget(position=(0.0, 0.0, 0.0), radius=60.0),
        src,
        HistogramHitResponse(nBins=10, t0=0.0, binSize=50.0),
        PhiloxRNG(key=0xC0DE),
        medium=Model().createMedium(num_lambda=16, num_theta=16),
        nScattering=2,
        scatterCoefficient=0.02,
    )
    run = shard_trace_multihost(tracer)
    assert src.offset == 0
    curve, _ = run()
    assert src.offset == 4 * 1024  # exactly one block consumed
    assert np.asarray(curve).sum() > 0
    run()
    assert src.offset == 8 * 1024
