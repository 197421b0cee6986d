"""Worker for tests/test_multihost.py: one JAX process of a 2-host run.

Usage: python _multihost_worker.py <process_id> <num_processes> <port> <out.npy>
Builds the shared test tracer, joins the multi-controller runtime, runs
one global batch via shard_trace_multihost, and (process 0) saves the
histogram.
"""

import sys

import jax

jax.config.update("jax_platforms", "cpu")

pid, nproc, port, out = (
    int(sys.argv[1]),
    int(sys.argv[2]),
    int(sys.argv[3]),
    sys.argv[4],
)

sys.path.insert(0, __file__.rsplit("/", 2)[0])

# join the runtime BEFORE importing theia_jax (whose import may touch the
# XLA backend; jax.distributed.initialize must run first)
jax.distributed.initialize(
    f"localhost:{port}", num_processes=nproc, process_id=pid
)
assert jax.device_count() == 2 * nproc, jax.device_count()

from theia_jax.parallel import shard_trace_multihost

from tests.test_multihost import build_tracer

tracer = build_tracer()
run = shard_trace_multihost(tracer)
curve, _ = run()

if pid == 0:
    import numpy as np

    np.save(out, np.asarray(curve))
print(f"worker {pid} done", flush=True)
