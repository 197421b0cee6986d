"""Sharded batch runner pluggable into the orchestration layer.

The reference's L5 value proposition — converge-until-SEM dynamic tasks
over a lookahead scheduler (docs/pipeline/pipeline.md:66-95,
src/theia/task.py:157-196) — composes with multi-chip execution here:
``Pipeline(tracer, runner=ShardedRunner(tracer))`` routes every batch
launch through shard_map over the photon mesh (psum'd histograms),
while the scheduler, dynamic tasks and checkpoint/resume stay
unchanged — they only ever see the pipeline's ``run_async``/materialize
surface and the host-side RNG cursors.
"""

from __future__ import annotations

import jax

from .dataparallel import make_photon_mesh, shard_trace, sharded_streams

__all__ = ["ShardedRunner"]


class ShardedRunner:
    """Batch runner executing a tracer's step over a device mesh.

    Implements the two-method runner protocol consumed by
    :class:`theia_jax.pipeline.Pipeline`:

    * ``launch(params) -> device_states`` — dispatch one batch
      asynchronously over the mesh (histograms/stats psum'd on-device);
    * ``materialize(out, params) -> (response_result, callback_result)``
      — convert finished device states to host results.

    ``multihost=None`` (default) auto-detects the multi-controller
    runtime: with >1 JAX processes, params are replicated as global
    arrays and results fetched from the addressable shard (see
    :mod:`theia_jax.parallel.multihost`).
    """

    def __init__(self, tracer, mesh=None, *, multihost: bool | None = None):
        self.tracer = tracer
        self.mesh = make_photon_mesh() if mesh is None else mesh
        self.multihost = (
            jax.process_count() > 1 if multihost is None else multihost
        )
        self._fn = shard_trace(tracer, self.mesh)
        if self.multihost:
            from .multihost import global_streams

            self._streams = global_streams(tracer.capacity, self.mesh)
        else:
            self._streams = sharded_streams(tracer.capacity, self.mesh)

    def launch(self, params):
        """Dispatch one batch; returns raw (response, callback) device
        states without synchronizing."""
        tracer = self.tracer
        counter = tracer.rng.counter_words
        if self.multihost:
            from .multihost import replicate_tree

            params = replicate_tree(params, self.mesh)
            counter = replicate_tree(counter, self.mesh)
        return self._fn(params, counter, self._streams)

    def materialize(self, out, params):
        """Convert a finished batch's device states to host results."""
        resp_state, cb_state = out
        if self.multihost:
            from .multihost import fetch

            resp_state = fetch(resp_state)
            cb_state = fetch(cb_state)
        tracer = self.tracer
        return (
            tracer.response.result(params["response"], resp_state),
            tracer.callback.result(params["callback"], cb_state),
        )
