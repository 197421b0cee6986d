"""Orchestration x distribution: the scheduler, dynamic tasks and
checkpoint/resume must compose with the sharded multi-chip runner
(reference L5 semantics over multi-device execution:
docs/pipeline/pipeline.md:66-95, src/theia/task.py:157-196)."""

import numpy as np
import pytest

import jax

from theia_jax.light import SphericalLightSource, UniformWavelengthSource
from theia_jax.material import (
    DispersionFreeMedium,
    HenyeyGreensteinPhaseFunction,
    MediumModel,
)
from theia_jax.parallel import ShardedRunner
from theia_jax.pipeline import (
    ConvergeHistogramTask,
    Pipeline,
    PipelineScheduler,
    loadCheckpoint,
    saveCheckpoint,
)
from theia_jax.random import PhiloxRNG
from theia_jax.response import HistogramHitResponse
from theia_jax.target import InnerSphereTarget
from theia_jax.trace import VolumeForwardTracer


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


def sharded_pipeline(batch=8 * 1024):
    tracer = build(batch)
    return Pipeline(tracer, runner=ShardedRunner(tracer))


@pytest.mark.core
def test_sharded_pipeline_run_matches_single_device():
    """Pipeline(runner=ShardedRunner) returns the single-device curve
    (identical global streams; only float summation order differs)."""
    assert jax.device_count() >= 8, "conftest should provide 8 CPU devices"
    h_single, _ = Pipeline(build()).run()
    h_shard, _ = sharded_pipeline().run()
    assert np.asarray(h_single).sum() > 0
    np.testing.assert_allclose(
        np.asarray(h_shard), np.asarray(h_single), rtol=2e-4, atol=1e-3
    )


@pytest.mark.parametrize("threaded", [True, False])
def test_scheduler_converges_task_on_mesh(threaded):
    """ConvergeHistogramTask driven by the scheduler over the 8-device
    mesh: converges, and the estimator equals the single-device run
    batch for batch (same RNG cursor advance)."""

    def converge(pipe):
        task = ConvergeHistogramTask(
            {},
            initialBatchCount=3,
            extraBatchCount=2,
            maxBatchCount=12,
            atol=0.0,
            rtol=5e-3,
        )
        sched = PipelineScheduler(pipe, dispatchThread=threaded)
        sched.schedule([task])
        return task

    t_shard = converge(sharded_pipeline())
    t_single = converge(Pipeline(build()))
    assert t_shard.totalBatches == t_single.totalBatches
    assert t_shard.result is not None and t_shard.result.sum() > 0
    np.testing.assert_allclose(
        t_shard.result, t_single.result, rtol=2e-4, atol=1e-3
    )


def test_sharded_checkpoint_resume_mid_task(tmp_path):
    """A sharded converge run interrupted after 2 batches and resumed in a
    fresh pipeline+runner finishes with the uninterrupted run's estimator
    state and RNG cursor (SURVEY aux 5.4 over multi-chip)."""

    def batches(pipe, task, n):
        for _ in range(n):
            task.processBatch(pipe.run())

    pipe_ref = sharded_pipeline()
    task_ref = ConvergeHistogramTask(maxBatchCount=50)
    batches(pipe_ref, task_ref, 4)

    pipe_a = sharded_pipeline()
    task_a = ConvergeHistogramTask(maxBatchCount=50)
    batches(pipe_a, task_a, 2)
    ckpt = tmp_path / "sharded.npz"
    saveCheckpoint(ckpt, pipe_a, task_a)

    pipe_b = sharded_pipeline()  # fresh rebuild, fresh runner
    task_b = ConvergeHistogramTask(maxBatchCount=50)
    loadCheckpoint(ckpt, pipe_b, task_b)
    assert pipe_b.tracer.rng.offset == pipe_a.tracer.rng.offset
    batches(pipe_b, task_b, 2)

    assert task_b.totalBatches == task_ref.totalBatches == 4
    np.testing.assert_array_equal(task_b.result, task_ref.result)
    assert pipe_b.tracer.rng.offset == pipe_ref.tracer.rng.offset


def test_runner_rejects_foreign_tracer():
    tracer = build()
    runner = ShardedRunner(tracer)
    with pytest.raises(ValueError, match="different tracer"):
        Pipeline(build(), runner=runner)
