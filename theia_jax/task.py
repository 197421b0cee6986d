"""Reference-name alias: the reference keeps its dynamic-task layer in
``theia.task`` (reference: src/theia/task.py); here those live in
:mod:`theia_jax.pipeline`. This shim keeps ``import theia_jax.task`` /
``from theia_jax.task import ConvergeHistogramTask`` working."""

from .pipeline import (  # noqa: F401
    ConvergeHistogramTask,
    DynamicTask,
    Pipeline,
    PipelineScheduler,
    runPipeline,
)

__all__ = [
    "ConvergeHistogramTask",
    "DynamicTask",
    "Pipeline",
    "PipelineScheduler",
    "runPipeline",
]
