"""Pipelines, scheduler and dynamic tasks.

The orchestration layer (reference: hephaistos.pipeline,
docs/pipeline/pipeline.md:24-95, src/theia/task.py):

* :class:`Pipeline` names a tracer's stages and provides the uniform
  ``stage__param`` addressing for per-batch parameter updates.
* :class:`PipelineScheduler` overlaps device work with host processing:
  JAX dispatch is asynchronous, so issuing batch k+1 before converting
  batch k's results to numpy gives the reference's double-buffered
  CPU/GPU pipelining without explicit command buffers.
* :class:`DynamicTask` / :class:`ConvergeHistogramTask` issue additional
  batches until a convergence criterion is met (Welford mean/variance on
  the histogram total).
"""

from __future__ import annotations

import warnings
from collections import deque
from typing import Callable

import numpy as np

__all__ = [
    "Pipeline",
    "PipelineScheduler",
    "runPipeline",
    "DynamicTask",
    "ConvergeHistogramTask",
    "saveCheckpoint",
    "loadCheckpoint",
]


class Pipeline:
    """Named stages around a tracer (reference: hephaistos.pipeline.Pipeline).

    ``setParams({"lightSource__budget": 1e5})`` routes values to the named
    component; ``run()`` traces one batch and returns
    (response result, callback result).

    ``runner`` plugs in an alternative batch executor — e.g.
    :class:`theia_jax.parallel.ShardedRunner` to spread every batch over a
    device mesh — while the scheduler/task/checkpoint layers on top stay
    unchanged. A runner provides ``launch(params) -> device_states`` and
    ``materialize(device_states, params) -> (response, callback) results``.
    """

    def __init__(self, stages_or_tracer, *, runner=None) -> None:
        if hasattr(stages_or_tracer, "collectStages"):
            stages = stages_or_tracer.collectStages()
        else:
            stages = list(stages_or_tracer)
        self._stages = dict(stages)
        tracers = [s for _, s in stages if hasattr(s, "_trace_batch")]
        if len(tracers) != 1:
            raise ValueError("pipeline needs exactly one tracer stage")
        self._tracer = tracers[0]
        if runner is not None and runner.tracer is not self._tracer:
            raise ValueError("runner was built for a different tracer")
        self._runner = runner

    @property
    def tracer(self):
        return self._tracer

    @property
    def runner(self):
        return self._runner

    @property
    def stages(self) -> dict:
        return self._stages

    def setParams(self, params: dict) -> None:
        """Apply ``stage__param`` addressed values
        (reference: docs/pipeline/pipeline.md:44-64)."""
        for key, value in params.items():
            if "__" not in key:
                raise ValueError(f"parameter {key!r} is not stage-addressed")
            stage_name, param = key.split("__", 1)
            if stage_name not in self._stages:
                raise ValueError(f"unknown stage {stage_name!r}")
            self._stages[stage_name].setParams(**{param: value})

    def getParam(self, key: str):
        stage_name, param = key.split("__", 1)
        return self._stages[stage_name].getParam(param)

    def run(self, params: dict | None = None):
        if params:
            self.setParams(params)
        if self._runner is None:
            return self._tracer.run()
        out, p = self.run_async()
        return _materialize(self, out, p)

    def run_async(self, params: dict | None = None):
        """Launch one batch without synchronizing; returns the raw device
        states (resp_state, cb_state) plus the params snapshot."""
        if params:
            self.setParams(params)
        tracer = self._tracer
        p = tracer.params()
        if self._runner is not None:
            out = self._runner.launch(p)
        else:
            out = tracer._jit_trace(
                p, tracer.rng.counter_words, tracer.streams()
            )
        tracer.rng.advance()
        return out, p


def runPipeline(stages_or_tracer, params: dict | None = None):
    """One-shot convenience (reference: hephaistos.pipeline.runPipeline)."""
    return Pipeline(stages_or_tracer).run(params)


def _materialize(pl, out, p):
    """Convert a batch's raw device states to (response, callback) results."""
    if pl.runner is not None:
        return pl.runner.materialize(out, p)
    tracer = pl.tracer
    return (
        tracer.response.result(p["response"], out[0]),
        tracer.callback.result(p["callback"], out[1]),
    )


class DynamicTask:
    """A task whose batch count is decided while running
    (reference: hephaistos.pipeline.DynamicTask).

    ``processBatch(result)`` consumes one batch result and returns how many
    extra batches to enqueue."""

    def __init__(self, params: dict | None = None, *, initialBatchCount: int = 1):
        self.parameters = params or {}
        self.initialBatchCount = initialBatchCount
        self.batchesRemaining = 0

    def processBatch(self, result) -> int:
        return 0

    def onTaskFinished(self) -> None:
        pass


class PipelineScheduler:
    """Issues batches ahead of host processing (reference:
    hephaistos.pipeline.PipelineScheduler, docs/pipeline/pipeline.md:66-95).

    ``processFn(config, batch, result)`` is called with each finished
    batch's (response result, callback result) tuple. ``lookahead`` batches
    are kept in flight: the asynchronous JAX dispatch computes them on
    device while the host converts earlier results.

    Multiple pipelines may be scheduled together by passing a list of
    ``(name, pipeline)`` tuples; tasks then address a pipeline by wrapping
    their params as ``(name, params)`` or via ``DynamicTask.pipeline``
    (reference: hephaistos.pipeline.PipelineScheduler multi-pipeline mode,
    examples/03_multiple_lightsources.ipynb).
    """

    def __init__(
        self,
        pipeline,
        *,
        processFn: Callable | None = None,
        lookahead: int = 2,
        dispatchThread: bool = True,
    ) -> None:
        if isinstance(pipeline, list):
            self.pipelines = {
                name: (pl if isinstance(pl, Pipeline) else Pipeline(pl))
                for name, pl in pipeline
            }
            self.pipeline = next(iter(self.pipelines.values()))
        else:
            if not isinstance(pipeline, Pipeline):
                pipeline = Pipeline(pipeline)
            self.pipeline = pipeline
            self.pipelines = {None: pipeline}
        self.processFn = processFn
        self.lookahead = max(1, lookahead)
        self.dispatchThread = dispatchThread
        self._batch = 0

    def _resolve(self, name):
        if name is None:
            return self.pipeline
        if name not in self.pipelines:
            raise KeyError(f"unknown pipeline '{name}'")
        return self.pipelines[name]

    def schedule(self, tasks: list) -> None:
        """Run a list of tasks; each is a params dict, a DynamicTask, or a
        ``(pipeline_name, params_or_task)`` tuple.

        With ``dispatchThread=True`` (default) device batches are issued
        and awaited on a dedicated worker thread — the analogue of the
        reference scheduler's worker threads (hephaistos
        PipelineScheduler) — so host-side processing overlaps device
        execution even where dispatch itself blocks (compare with
        tools/bench_pipeline_overlap.py). Parameter routing and RNG
        advancement happen on the worker in FIFO task order, exactly as
        in the synchronous path."""
        queue = deque(tasks)
        if self.dispatchThread:
            self._schedule_threaded(queue)
            return
        in_flight: deque = deque()

        def launch(task, pl):
            params = (
                task.parameters if isinstance(task, DynamicTask) else task
            )
            out, p = pl.run_async(params)
            in_flight.append((task, pl, out, p))

        def drain_one():
            task, pl, out, p = in_flight.popleft()
            self._finish_batch(task, pl, _materialize(pl, out, p), launch)

        self._drive(queue, launch, drain_one, lambda: len(in_flight))

    def _schedule_threaded(self, queue: deque) -> None:
        """schedule() with a dispatch worker thread (see schedule docs).

        Params are snapshotted (shallow-copied) at enqueue time, so a
        processFn/processBatch that mutates ``task.parameters`` on the main
        thread cannot race the worker's deferred routing; note that mutating
        shared *stage* state from those callbacks is still unsynchronized in
        threaded mode. The worker keeps up to ``lookahead`` batches
        dispatched before blocking on the oldest, preserving device-side
        pipelining on backends with true async dispatch."""
        import queue as q
        import threading

        import jax

        launch_q: q.SimpleQueue = q.SimpleQueue()
        done_q: q.SimpleQueue = q.SimpleQueue()
        cancel = threading.Event()

        def worker() -> None:
            # dispatched-but-not-awaited batches, FIFO:
            # ("ok", task, pl, out, p) or ("err", task, pl, exc)
            pending: deque = deque()
            stop = False
            while True:
                # fill: dispatch queued launches up to the lookahead window;
                # block for input only when nothing is pending
                while not stop and len(pending) < self.lookahead:
                    try:
                        item = (
                            launch_q.get_nowait() if pending else launch_q.get()
                        )
                    except q.Empty:
                        break
                    if item is None:
                        stop = True
                        break
                    task, pl, params = item
                    if cancel.is_set():
                        # main thread aborted: skip unstarted work so the
                        # exception propagates without waiting on it
                        continue
                    try:
                        pending.append((task, pl, *pl.run_async(params)))
                    except BaseException as exc:
                        pending.append((task, pl, exc))
                        stop = True
                if not pending:
                    if stop:
                        return
                    continue
                entry = pending.popleft()
                if len(entry) == 3:  # dispatch error, in FIFO position
                    task, pl, exc = entry
                    done_q.put((task, pl, None, exc))
                    return
                task, pl, out, p = entry
                try:
                    jax.block_until_ready(out)
                    # materialize results here too: device-to-host
                    # copies can queue behind executions, so doing this
                    # on the main thread could stall host processing
                    # behind the *next* batch
                    result = _materialize(pl, out, p)
                except BaseException as exc:  # re-raised on the main thread
                    done_q.put((task, pl, None, exc))
                    return
                done_q.put((task, pl, result, None))

        th = threading.Thread(target=worker, name="theia-dispatch", daemon=True)
        th.start()
        in_flight = 0

        def launch(task, pl) -> None:
            nonlocal in_flight
            params = task.parameters if isinstance(task, DynamicTask) else task
            # snapshot: the live dict may be mutated by later callbacks
            launch_q.put((task, pl, dict(params) if params else params))
            in_flight += 1

        def drain_one() -> None:
            nonlocal in_flight
            task, pl, result, err = done_q.get()
            in_flight -= 1
            if err is not None:
                raise err
            self._finish_batch(task, pl, result, launch)

        try:
            self._drive(queue, launch, drain_one, lambda: in_flight)
        except BaseException:
            cancel.set()
            raise
        finally:
            launch_q.put(None)
            th.join()

    def _drive(self, queue, launch, drain_one, in_flight_count) -> None:
        """Shared fill-to-lookahead / drain loop of both schedule modes."""
        while queue or in_flight_count():
            while queue and in_flight_count() < self.lookahead:
                task = queue.popleft()
                name = None
                if isinstance(task, tuple) and len(task) == 2 and (
                    task[0] is None or isinstance(task[0], str)
                ):
                    name, task = task
                pl = self._resolve(name)
                if isinstance(task, DynamicTask):
                    task.batchesRemaining = task.initialBatchCount
                    for _ in range(task.initialBatchCount):
                        launch(task, pl)
                else:
                    launch(task, pl)
            if in_flight_count():
                drain_one()

    def _finish_batch(self, task, pl, result, launch) -> None:
        """Dynamic-task bookkeeping + process callback for one batch."""
        if isinstance(task, DynamicTask):
            task.batchesRemaining -= 1
            extra = task.processBatch(result)
            task.batchesRemaining += extra
            for _ in range(extra):
                launch(task, pl)
            if task.batchesRemaining == 0:
                task.onTaskFinished()
        if self.processFn is not None:
            self.processFn(0, self._batch, result)
        self._batch += 1

    def wait(self) -> None:
        """Kept for API parity; schedule() is synchronous at exit."""

    def destroy(self) -> None:
        pass


class ConvergeHistogramTask(DynamicTask):
    """Issue histogram batches until the standard error of the total drops
    below ``atol + rtol * total`` (reference: src/theia/task.py:22-196)."""

    def __init__(
        self,
        params: dict | None = None,
        *,
        initialBatchCount: int = 4,
        extraBatchCount: int = 2,
        maxBatchCount: int = 50,
        atol: float = 0.1,
        rtol: float = 5e-5,
        finishedCallback=None,
    ) -> None:
        if initialBatchCount < 2:
            raise ValueError("initialBatchCount must be at least 2!")
        if extraBatchCount < 1:
            raise ValueError("extraBatchCount must be at least 1!")
        super().__init__(params, initialBatchCount=initialBatchCount)
        self._extraCount = extraBatchCount
        self._maxBatchCount = maxBatchCount
        self._atol = atol
        self._rtol = rtol
        self._callback = finishedCallback
        self._totalBatches = 0
        self._converged = False
        self._result = None
        self._totalMean = 0.0
        self._sumSquareErr = 0.0

    @property
    def converged(self) -> bool:
        return self._converged

    @property
    def totalBatches(self) -> int:
        return self._totalBatches

    @property
    def result(self):
        return self._result

    @property
    def error(self) -> float:
        n = self._totalBatches
        # pessimistic small-sample correction (approximate c4), as the
        # reference does (src/theia/task.py:108-123)
        return float(
            np.sqrt(self._sumSquareErr / max(n - 1.5, 0.5)) / np.sqrt(n)
        )

    def onTaskFinished(self) -> None:
        if self._callback is not None:
            self._callback(self)

    def state_dict(self) -> dict:
        """Estimator state for checkpoint/resume (see saveCheckpoint)."""
        return {
            "totalBatches": self._totalBatches,
            "converged": self._converged,
            "result": None if self._result is None else self._result.copy(),
            "totalMean": self._totalMean,
            "sumSquareErr": self._sumSquareErr,
        }

    def load_state_dict(self, state: dict) -> None:
        self._totalBatches = int(state["totalBatches"])
        self._converged = bool(state["converged"])
        r = state["result"]
        self._result = None if r is None else np.asarray(r, np.float64)
        self._totalMean = float(state["totalMean"])
        self._sumSquareErr = float(state["sumSquareErr"])

    def processBatch(self, result) -> int:
        hist = np.asarray(result[0], np.float64)
        self._totalBatches += 1
        if self._result is None:
            self._result = np.zeros_like(hist)
        # Welford updates
        self._result += (hist - self._result) / self._totalBatches
        mean_i = hist.sum()
        old = self._totalMean
        self._totalMean += (mean_i - old) / self._totalBatches
        self._sumSquareErr += (mean_i - old) * (mean_i - self._totalMean)

        if self.batchesRemaining > 1:
            return 0
        thres = self._atol + self._rtol * self._totalMean
        if self._totalBatches >= 2 and self.error <= thres:
            self._converged = True
            return 0
        remaining = max(self._maxBatchCount - self._totalBatches, 0)
        n = min(remaining, self._extraCount)
        if n == 0:
            warnings.warn(
                f"Failed to converge histogram (error: {self.error:.3e}) "
                f"before reaching maxBatchCount={self._maxBatchCount}!"
            )
        return n


# ---------------------------------------------------------------------------
# checkpoint / resume
# ---------------------------------------------------------------------------


def _rng_stages(pipeline: Pipeline):
    """(name, stage) pairs with host-side cursors: the tracer's generator
    (not a named stage) plus any stage exposing an integer ``offset`` —
    RNGs (offset + advance) AND streaming host sources (offset + update),
    whose replay position is exactly the kind of state resume needs."""
    out = [("_tracer_rng", pipeline.tracer.rng)]
    for name, stage in pipeline.stages.items():
        if isinstance(getattr(stage, "offset", None), int):
            out.append((name, stage))
    return out


def saveCheckpoint(path, pipeline: Pipeline, task=None) -> None:
    """Persist a long-running simulation's *stateful* pieces (SURVEY §5.4).

    Everything else — scene, materials, component params — is
    reproducible host code the user re-runs on resume; what cannot be
    reproduced is (a) how far each RNG stage has advanced and (b) the
    running estimator of a dynamic task. Both go into one ``.npz``:

    * per-stage RNG cursors (``offset``/``autoAdvance`` of any stage
      exposing them, e.g. PhiloxRNG / SobolQRNG),
    * ``task.state_dict()`` when a task is given (e.g.
      ConvergeHistogramTask's Welford accumulators).
    """
    blobs: dict = {}
    for name, stage in _rng_stages(pipeline):
        blobs[f"rng__{name}__offset"] = np.int64(stage.offset)
        if hasattr(stage, "autoAdvance"):
            blobs[f"rng__{name}__autoAdvance"] = np.int64(stage.autoAdvance)
    if task is not None:
        state = task.state_dict()
        for k, v in state.items():
            if v is None:
                blobs[f"task__none__{k}"] = np.int8(0)
            else:
                blobs[f"task__{k}"] = np.asarray(v)
    np.savez(path, **blobs)


def loadCheckpoint(path, pipeline: Pipeline, task=None) -> None:
    """Restore what :func:`saveCheckpoint` saved into an already-built
    pipeline (and optional task); the next ``run()`` continues exactly
    where the checkpointed process stopped."""
    with np.load(path, allow_pickle=False) as data:
        for name, stage in _rng_stages(pipeline):
            key = f"rng__{name}__offset"
            if key in data:
                stage.offset = int(data[key])
                if f"rng__{name}__autoAdvance" in data:
                    stage.autoAdvance = int(data[f"rng__{name}__autoAdvance"])
        if task is not None:
            state = {}
            for k in data.files:
                if k.startswith("task__none__"):
                    state[k[len("task__none__"):]] = None
                elif k.startswith("task__"):
                    v = data[k]
                    state[k[len("task__"):]] = v if v.ndim else v.item()
            if state:
                task.load_state_dict(state)
