"""Weak-scaling measurement of the sharded tracer on a virtual CPU mesh.

It checks the structure of the sharded program without GPUs
(`python chip_smoke.py --four` runs the sharded path on four cards):

* weak scaling on an N-virtual-device CPU mesh
  (xla_force_host_platform_device_count): per-device batch held fixed,
  global batch grows with the mesh. The photon axis is embarrassingly
  parallel — the ONLY cross-device communication is one psum of the
  (nBins,) histogram per batch (and of the gradient in training), so the
  collective payload is ~400 bytes regardless of batch size. On a CPU
  mesh the devices are threads sharing one machine's FLOPs, so raw
  wall-clock SLOWS with N; the meaningful check is that the sharded
  program adds no serialization: time(N devices, N*B photons) /
  time(1 device, N*B photons) ~= 1. That ratio (reported as
  ``overhead``) bounds the multi-device efficiency loss from program
  structure; on real cards the remaining loss is the psum latency of a
  ~400 B payload.

Usage: python tools/bench_scaling.py [per_device_batch]
"""

import os
import sys
import time

N_DEV = int(os.environ.get("SCALING_DEVICES", "8"))
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + f" --xla_force_host_platform_device_count={N_DEV}"
)
os.environ["JAX_PLATFORMS"] = "cpu"

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np

import __graft_entry__ as g
from theia_jax.parallel.dataparallel import (
    make_photon_mesh,
    shard_trace,
    sharded_streams,
)


def time_config(n_devices: int, global_batch: int, max_path: int, runs: int):
    mesh = make_photon_mesh(jax.devices()[:n_devices])
    tracer = g._build_scene_tracer(global_batch, max_path=max_path)
    fn = shard_trace(tracer, mesh)
    p = tracer.params()
    streams = sharded_streams(global_batch, mesh)
    counter = tracer.rng.counter_words
    out = fn(p, counter, streams)
    jax.block_until_ready(out)
    ts = []
    for _ in range(runs):
        tracer.rng.advance()
        counter = tracer.rng.counter_words
        t0 = time.perf_counter()
        out = fn(p, counter, streams)
        jax.block_until_ready(out)
        ts.append(time.perf_counter() - t0)
    hist = np.asarray(out[0])
    return min(ts), float(hist.sum())


def main():
    per_dev = int(sys.argv[1]) if len(sys.argv) > 1 else 8192
    max_path, runs = 6, 3
    print(f"virtual devices: {N_DEV}, per-device batch: {per_dev}")
    rows = []
    for n in (1, 2, 4, N_DEV):
        dt, hsum = time_config(n, per_dev * n, max_path, runs)
        rows.append((n, dt, hsum))
        print(
            f"n={n}: global_batch={per_dev * n:7d}  {dt * 1e3:8.1f} ms"
            f"  hist={hsum:.4e}"
        )
    # serialization check: 1 device crunching the FULL 8-way batch vs the
    # 8-device sharded program on the same machine FLOPs
    dt_full_1dev, _ = time_config(1, per_dev * N_DEV, max_path, runs)
    dt_sharded = rows[-1][1]
    overhead = dt_sharded / dt_full_1dev
    print(
        f"single-device full batch: {dt_full_1dev * 1e3:.1f} ms; "
        f"sharded/{N_DEV}-dev same total work: {dt_sharded * 1e3:.1f} ms; "
        f"structural overhead = {overhead:.3f}"
        f" (1.0 = no serialization added by sharding)"
    )


if __name__ == "__main__":
    main()
