"""Multi-device distribution (SURVEY.md §5.8: new design, no reference analogue).

The only parallel axis this workload needs is the photon axis: pure data
parallelism. ``shard_trace`` wraps a tracer's jitted batch function in
``shard_map`` over a 1D device mesh — photons sharded, scene/material/RNG
parameters replicated, per-chip partial histograms and event statistics
combined with ``psum``. RNG streams are the *global* path indices,
so results are independent of the device count (the multi-device analogue of
the reference's stream/offset scheme, SURVEY.md §2.2).

Across hosts the same program scales via JAX's multi-controller runtime:
``parallel.multihost`` joins every host into one global mesh, replicates
the (deterministically re-built) scene tables per process, and the same
``shard_trace``/``psum`` program runs unchanged — collectives run over
the intra-host links (NVLink between the cards of a host) and the
network across hosts.
"""

from .dataparallel import make_photon_mesh, shard_trace, sharded_streams
from .multihost import (
    fetch,
    global_photon_mesh,
    global_streams,
    replicate_tree,
    shard_trace_multihost,
)
from .runner import ShardedRunner

__all__ = [
    "make_photon_mesh",
    "shard_trace",
    "sharded_streams",
    "fetch",
    "global_photon_mesh",
    "global_streams",
    "replicate_tree",
    "shard_trace_multihost",
    "ShardedRunner",
]
