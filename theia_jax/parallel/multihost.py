"""Multi-host distribution: one JAX process per host, one global mesh.

The reference scales with MPI-style per-GPU processes; the answer here
is JAX's multi-controller runtime (SURVEY §7 hard part:
"per-host process addressing, global histogram gather, scene build
host-0 + broadcast"):

* every host runs the same program and calls :func:`initialize` with its
  process id — afterwards ``jax.devices()`` spans ALL hosts and the
  existing :func:`~theia_jax.parallel.dataparallel.shard_trace` wrapper
  works unchanged over the global mesh (its ``psum`` runs over the
  intra-host links and the network across hosts);
* the "broadcast" of the scene is implicit: scene/material packing is
  deterministic host code, so each process builds identical tables and
  hands them to jit as replicated *global* arrays
  (:func:`replicate_tree`);
* per-host lane addressing falls out of the global stream ids:
  :func:`global_streams` materializes ``arange(capacity)`` sharded over
  the global mesh, so each device traces its own contiguous range of
  path indices and results are process-count invariant;
* the summed histogram comes back replicated — every host reads its
  local copy (:func:`fetch`), no separate gather step.

Tested end-to-end with 2 CPU processes x 2 virtual devices against a
single-process 4-device run (tests/test_multihost.py): identical
histograms.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .dataparallel import BATCH_AXIS, make_photon_mesh

__all__ = [
    "initialize",
    "global_photon_mesh",
    "global_streams",
    "replicate_tree",
    "fetch",
    "shard_trace_multihost",
]


def initialize(
    coordinator: str = "localhost:29400",
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """Join the multi-controller runtime (host 0 doubles as coordinator).

    On clusters JAX detects by itself (e.g. SLURM) call with no
    arguments; the explicit form serves manual setups and the CPU
    integration test."""
    if num_processes is None:
        jax.distributed.initialize()
    else:
        jax.distributed.initialize(
            coordinator, num_processes=num_processes, process_id=process_id
        )


def global_photon_mesh() -> Mesh:
    """1D mesh over every device of every process."""
    return make_photon_mesh(jax.devices())


def global_streams(capacity: int, mesh: Mesh) -> jax.Array:
    """Global path indices 0..capacity sharded over the global mesh;
    each process materializes only its addressable shards."""
    if capacity % mesh.size != 0:
        raise ValueError("capacity must be divisible by the device count")
    sharding = NamedSharding(mesh, P(BATCH_AXIS))
    return jax.make_array_from_callback(
        (capacity,),
        sharding,
        lambda idx: np.arange(capacity, dtype=np.uint32)[idx],
    )


def replicate_tree(tree, mesh: Mesh):
    """Turn host-local (identical-on-every-host) pytree leaves into
    replicated global arrays usable as jit inputs across processes."""
    sharding = NamedSharding(mesh, P())

    def rep(x):
        arr = np.asarray(x)
        return jax.make_array_from_callback(
            arr.shape, sharding, lambda idx: arr[idx]
        )

    return jax.tree.map(rep, tree)


def fetch(x):
    """Host-local numpy view of a replicated (psum'd) result."""
    return jax.tree.map(lambda a: np.asarray(a.addressable_data(0)), x)


def shard_trace_multihost(tracer, mesh: Mesh | None = None):
    """Multi-host batch runner for a tracer.

    Returns ``run() -> (response_result, callback_result)`` mirroring
    ``tracer.run()``: each call traces one global batch of
    ``tracer.capacity`` paths spread over every device of every host,
    advances the RNG, and returns the globally-psum'd results as
    host-local numpy.

    Note: the params snapshot is re-replicated every batch because
    stateful stages (streaming host sources) may change it between
    batches. For static params that costs one host->device table upload
    per batch, dominated by batch compute at production sizes."""
    from .runner import ShardedRunner

    runner = ShardedRunner(
        tracer, global_photon_mesh() if mesh is None else mesh, multihost=True
    )

    def run(params=None, *, advance: bool = True):
        # ONE params() snapshot per batch (stateful stages advance inside
        # params(), e.g. streaming host sources) — trace and finalize
        # against the same snapshot, like the single-host tracer.run()
        p_local = tracer.params() if params is None else params
        out = runner.launch(p_local)
        if advance:
            tracer.rng.advance()
        return runner.materialize(out, p_local)

    return run
