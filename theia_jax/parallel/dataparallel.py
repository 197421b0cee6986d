"""Photon-wavefront data parallelism via shard_map + psum."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..compile_cache import jit

__all__ = ["make_photon_mesh", "sharded_streams", "shard_trace"]

BATCH_AXIS = "batch"


def make_photon_mesh(devices=None) -> Mesh:
    """1D device mesh over all (or the given) devices."""
    devices = np.asarray(devices if devices is not None else jax.devices())
    return Mesh(devices.reshape(-1), (BATCH_AXIS,))


def sharded_streams(batch_size: int, mesh: Mesh) -> jax.Array:
    """Global path indices laid out along the batch axis."""
    if batch_size % mesh.size != 0:
        raise ValueError("batch size must be divisible by the device count")
    streams = jnp.arange(batch_size, dtype=jnp.uint32)
    return jax.device_put(
        streams, NamedSharding(mesh, P(BATCH_AXIS))
    )


def shard_trace(tracer, mesh: Mesh, *, reduce_response: bool = True):
    """Wrap ``tracer._trace_batch`` in shard_map over the photon axis.

    Returns ``fn(params, counter, streams)`` where ``streams`` is sharded
    along the batch axis and params/counter are replicated. Histogram-like
    response states and statistic-callback states are psum'd over the mesh;
    set ``reduce_response=False`` to keep per-device states (e.g. for
    HitRecorder, whose slots stay device-local)."""

    trace = tracer._trace_batch

    def wrapped(p, counter, streams):
        resp_state, cb_state = trace(p, counter, streams)
        if reduce_response:
            resp_state = jax.tree.map(
                lambda x: jax.lax.psum(x, BATCH_AXIS), resp_state
            )
        if cb_state is not None:
            cb_state = jax.tree.map(
                lambda x: jax.lax.psum(x, BATCH_AXIS), cb_state
            )
        return resp_state, cb_state

    out_resp = P() if reduce_response else P(BATCH_AXIS)
    fn = jax.shard_map(
        wrapped,
        mesh=mesh,
        in_specs=(P(), P(), P(BATCH_AXIS)),
        out_specs=(out_resp, P()),
        check_vma=False,
    )
    return jit(fn)
