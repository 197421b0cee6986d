"""Measure CPU/device overlap from the PipelineScheduler's lookahead.

The reference's headline orchestration feature is triple-way CPU/GPU
pipelining via the double-buffered scheduler (reference:
docs/pipeline/pipeline.md:66-95) — the device computes batch k+1 while
the host processes batch k-1. Our analogue leans on JAX's asynchronous
dispatch: `Pipeline.run_async` issues a batch without synchronizing and
the host only blocks when converting results to numpy.

This tool quantifies the overlap on the device: N batches of the
bench tracer, each followed by `host_ms` of host-side processing
(busy-spin on a checksum to emulate histogram post-processing /
convergence accounting), run (a) sequentially (sync after every batch)
and (b) through PipelineScheduler with lookahead. Perfect overlap makes
wall time max(device_total, host_total); no overlap makes it the sum.

Run on the GPU:
    python tools/bench_pipeline_overlap.py [batches] [host_ms]
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def host_work(hist: np.ndarray, ms: float) -> float:
    """Emulated host-side batch processing: checksum spin for `ms`."""
    end = time.perf_counter() + ms * 1e-3
    acc = float(hist.sum())
    while time.perf_counter() < end:
        acc = acc * 0.9999999 + 1.0
    return acc


def main() -> None:
    n_batches = int(sys.argv[1]) if len(sys.argv) > 1 else 8
    host_ms = float(sys.argv[2]) if len(sys.argv) > 2 else 400.0
    batch = int(os.environ.get("BENCH_BATCH", 64 * 1024))

    import jax

    import __graft_entry__ as g
    from theia_jax.pipeline import Pipeline, PipelineScheduler

    tracer = g._build_scene_tracer(batch, max_path=10, accel="brute")
    pipeline = Pipeline(tracer)

    # warm up the compile cache
    out, p = pipeline.run_async()
    np.asarray(out[0])

    # (a) sequential: sync + host work per batch
    t0 = time.perf_counter()
    dev_s = 0.0
    host_s = 0.0
    for _ in range(n_batches):
        td = time.perf_counter()
        out, p = pipeline.run_async()
        hist = np.asarray(tracer.response.result(p["response"], out[0]))
        dev_s += time.perf_counter() - td
        th = time.perf_counter()
        host_work(hist, host_ms)
        host_s += time.perf_counter() - th
    t_seq = time.perf_counter() - t0

    # (b) scheduler: async-dispatch only vs dispatch worker thread
    def process(config, k, result):
        host_work(np.asarray(result[0]), host_ms)

    def run_sched(threaded: bool) -> float:
        sched = PipelineScheduler(
            pipeline, processFn=process, lookahead=2, dispatchThread=threaded
        )
        t0 = time.perf_counter()
        sched.schedule([{} for _ in range(n_batches)])
        return time.perf_counter() - t0

    t_async = run_sched(False)
    t_thread = run_sched(True)

    ideal = max(dev_s, host_s)
    hidable = min(dev_s, host_s)
    print(f"batches={n_batches} batch={batch} host_ms={host_ms}")
    print(f"sequential      : {t_seq:.2f} s  (device {dev_s:.2f} + host {host_s:.2f})")
    print(f"async dispatch  : {t_async:.2f} s")
    print(f"dispatch thread : {t_thread:.2f} s  (ideal overlap {ideal:.2f})")
    for name, t in (("async", t_async), ("thread", t_thread)):
        saved = t_seq - t
        print(
            f"overlap[{name}] : hid {saved:.2f} of {hidable:.2f} hidable s "
            f"({100.0 * saved / max(hidable, 1e-9):.0f}% efficiency)"
        )


if __name__ == "__main__":
    main()
