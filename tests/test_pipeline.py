"""Pipeline/scheduler/task tests (model: reference tests/test_task.py)."""

import numpy as np
import pytest

import theia_jax.units as u
from theia_jax.light import SphericalLightSource, UniformWavelengthSource
from theia_jax.material import (
    DispersionFreeMedium,
    HenyeyGreensteinPhaseFunction,
    MediumModel,
)
from theia_jax.pipeline import (
    ConvergeHistogramTask,
    Pipeline,
    PipelineScheduler,
)
from theia_jax.random import PhiloxRNG
from theia_jax.response import HistogramHitResponse
from theia_jax.target import InnerSphereTarget
from theia_jax.trace import VolumeForwardTracer


pytestmark = pytest.mark.core  # fast smoke tier, see pyproject markers

class Model(DispersionFreeMedium, HenyeyGreensteinPhaseFunction, MediumModel):
    def __init__(self):
        DispersionFreeMedium.__init__(self, n=1.33, ng=1.33, mu_a=0.005, mu_s=0.01)
        HenyeyGreensteinPhaseFunction.__init__(self, 0.3)


def build(batch=8 * 1024):
    return VolumeForwardTracer(
        batch,
        SphericalLightSource(position=(0.0, 0.0, 0.0), timeRange=(0.0, 0.0), budget=1e6),
        InnerSphereTarget(position=(0.0, 0.0, 0.0), radius=50.0),
        UniformWavelengthSource(lambdaRange=(400.0, 500.0)),
        HistogramHitResponse(nBins=40, t0=0.0, binSize=20.0),
        PhiloxRNG(key=0xC0FFEE),
        medium=Model().createMedium(num_lambda=64, num_theta=64),
        nScattering=6,
        scatterCoefficient=0.02,
    )


def test_pipeline_param_addressing():
    tracer = build()
    pipe = Pipeline(tracer)
    pipe.setParams({"lightSource__budget": 2e6, "tracer__maxTime": 500.0})
    assert pipe.getParam("lightSource__budget") == 2e6
    assert tracer.maxTime == 500.0
    h1, _ = pipe.run()
    pipe.setParams({"lightSource__budget": 4e6})
    h2, _ = pipe.run()
    # doubling the budget ~doubles the curve (different RNG offset -> noise)
    assert 1.5 < np.asarray(h2).sum() / np.asarray(h1).sum() < 2.5


@pytest.mark.parametrize("threaded", [True, False])
def test_scheduler_processes_all_batches(threaded):
    tracer = build()
    results = []

    def process(config, batch, result):
        results.append(np.asarray(result[0]))

    sched = PipelineScheduler(
        Pipeline(tracer), processFn=process, dispatchThread=threaded
    )
    sched.schedule([{}, {"lightSource__budget": 2e6}, {}])
    sched.wait()
    assert len(results) == 3
    # the middle batch used twice the budget
    assert results[1].sum() > 1.5 * results[0].sum()


def test_scheduler_threaded_matches_sync():
    """The dispatch-thread scheduler routes params and advances RNG in
    the same FIFO order as the synchronous path -> identical results."""

    def collect(threaded):
        tracer = build()
        results = []
        sched = PipelineScheduler(
            Pipeline(tracer),
            processFn=lambda c, b, r: results.append(np.asarray(r[0])),
            dispatchThread=threaded,
        )
        sched.schedule([{}, {"lightSource__budget": 3e6}, {}, {}])
        return results

    a = collect(True)
    b = collect(False)
    assert len(a) == len(b) == 4
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_scheduler_threaded_propagates_errors():
    tracer = build()
    sched = PipelineScheduler(Pipeline(tracer), dispatchThread=True)
    with pytest.raises(ValueError, match="unknown stage"):
        sched.schedule([{"noSuchStage__param": 1.0}])


def test_runtime_batch_size_no_retrace():
    """batchSize is a runtime parameter (the indirect-dispatch analogue,
    reference src/theia/trace.py:354-408): changing it via the pipeline
    never retraces, masks exactly the dropped lanes, and renormalizes."""
    full = 4 * 1024
    half = full // 2

    def make(batch, capacity=None):
        return VolumeForwardTracer(
            batch,
            SphericalLightSource(
                position=(0.0, 0.0, 0.0), timeRange=(0.0, 0.0), budget=1e6
            ),
            InnerSphereTarget(position=(0.0, 0.0, 0.0), radius=50.0),
            UniformWavelengthSource(lambdaRange=(400.0, 500.0)),
            HistogramHitResponse(nBins=40, t0=0.0, binSize=20.0),
            PhiloxRNG(key=0xC0FFEE),
            medium=Model().createMedium(num_lambda=64, num_theta=64),
            nScattering=6,
            scatterCoefficient=0.02,
            capacity=capacity,
        )

    tracer = make(full)
    pipe = Pipeline(tracer)
    h_full, _ = pipe.run()
    pipe.setParams({"tracer__batchSize": half})
    assert tracer.normalization == 1.0 / half
    # rewind the RNG so the sub-batch sees the same streams as a
    # dedicated half-size tracer
    tracer.rng.offset = 0
    h_half, _ = pipe.run()
    assert tracer._jit_trace._cache_size() == 1  # no retrace

    ref = make(half)
    h_ref, _ = ref.run()
    # same hits, but the histogram accumulation reduces over capacity
    # lanes (masked ones add exact zeros), so the f32 reduction tree
    # differs from the dedicated half-size tracer's
    np.testing.assert_allclose(np.asarray(h_half), np.asarray(h_ref), rtol=1e-4)
    # and the full batch is a strict superset: un-normalized sums grow
    assert np.asarray(h_full).sum() > 0

    # batchSize beyond capacity must be rejected
    try:
        pipe.setParams({"tracer__batchSize": 2 * full})
        raise AssertionError("expected ValueError")
    except ValueError:
        pass


def test_converge_histogram_task():
    tracer = build(4 * 1024)
    done = []
    task = ConvergeHistogramTask(
        {},
        initialBatchCount=3,
        extraBatchCount=2,
        maxBatchCount=30,
        atol=0.0,
        rtol=5e-3,
        finishedCallback=lambda t: done.append(t),
    )
    sched = PipelineScheduler(Pipeline(tracer))
    sched.schedule([task])
    assert done and done[0] is task
    assert task.totalBatches >= 3
    assert task.result is not None and task.result.sum() > 0
    if task.converged:
        assert task.error <= task._atol + task._rtol * task._totalMean


def test_checkpoint_resume_bitexact(tmp_path):
    """saveCheckpoint/loadCheckpoint: a run interrupted after 2 batches
    and resumed in a FRESH process-equivalent pipeline must finish with
    exactly the uninterrupted run's estimator state and RNG cursor
    (SURVEY aux 5.4 — RNG offsets + Welford accumulators are the only
    non-reproducible state)."""
    from theia_jax.pipeline import loadCheckpoint, saveCheckpoint

    def batches(pipe, task, n):
        for _ in range(n):
            task.processBatch(pipe.run())

    # uninterrupted reference: 4 batches
    pipe_ref = Pipeline(build())
    task_ref = ConvergeHistogramTask(maxBatchCount=50)
    batches(pipe_ref, task_ref, 4)

    # interrupted: 2 batches, checkpoint, rebuild, resume, 2 more
    pipe_a = Pipeline(build())
    task_a = ConvergeHistogramTask(maxBatchCount=50)
    batches(pipe_a, task_a, 2)
    ckpt = tmp_path / "run.npz"
    saveCheckpoint(ckpt, pipe_a, task_a)

    pipe_b = Pipeline(build())  # fresh user-code rebuild
    task_b = ConvergeHistogramTask(maxBatchCount=50)
    loadCheckpoint(ckpt, pipe_b, task_b)
    assert pipe_b.tracer.rng.offset == pipe_a.tracer.rng.offset
    assert task_b.totalBatches == 2
    batches(pipe_b, task_b, 2)

    assert task_b.totalBatches == task_ref.totalBatches == 4
    np.testing.assert_array_equal(task_b.result, task_ref.result)
    assert task_b.error == task_ref.error
    assert pipe_b.tracer.rng.offset == pipe_ref.tracer.rng.offset


def test_checkpoint_captures_streaming_source_cursor(tmp_path):
    """Streaming host sources replay host arrays block by block; their
    cursor must survive checkpoint/resume (regression: only stages with
    advance() were captured)."""
    from theia_jax.light import StreamingHostWavelengthSource
    from theia_jax.pipeline import loadCheckpoint, saveCheckpoint
    from theia_jax.target import InnerSphereTarget
    from theia_jax.trace import VolumeForwardTracer

    def build_streaming():
        wl = np.linspace(400.0, 500.0, 40 * 1024, dtype=np.float32)
        return VolumeForwardTracer(
            4 * 1024,
            SphericalLightSource(
                position=(0.0, 0.0, 0.0), timeRange=(0.0, 0.0), budget=1e6
            ),
            InnerSphereTarget(position=(0.0, 0.0, 0.0), radius=50.0),
            StreamingHostWavelengthSource(wl, batchSize=4 * 1024),
            HistogramHitResponse(nBins=10, t0=0.0, binSize=50.0),
            PhiloxRNG(key=0xBEEF),
            medium=Model().createMedium(num_lambda=16, num_theta=16),
            nScattering=2,
            scatterCoefficient=0.02,
        )

    pipe = Pipeline(build_streaming())
    pipe.run()
    pipe.run()
    src = pipe.stages["photons"]
    assert src.offset == 2 * 4 * 1024
    ckpt = tmp_path / "s.npz"
    saveCheckpoint(ckpt, pipe)

    pipe2 = Pipeline(build_streaming())
    loadCheckpoint(ckpt, pipe2)
    assert pipe2.stages["photons"].offset == 2 * 4 * 1024
    assert pipe2.tracer.rng.offset == pipe.tracer.rng.offset
