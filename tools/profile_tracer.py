"""Profile the bench tracer's per-segment cost split on the real chip.

Variants isolate components:
  full        — bench configuration (MIS guide, 3 intersects/segment)
  nomis       — targetGuide=None (1 intersect/segment, no shadow pass)
  path1..pathN — scaling in maxPathLength separates per-segment cost from
                 setup (source sampling, init, histogram finalize)
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

import __graft_entry__ as g
from theia_jax import compile_cache

BATCH = 256 * 1024


def time_tracer(tracer, label):
    fn, (p, counter, streams) = tracer.trace_fn()
    step = compile_cache.jit(fn)
    out = step(p, counter, streams)
    jax.block_until_ready(out)
    ts = []
    for _ in range(3):
        tracer.rng.advance()
        counter = tracer.rng.counter_words
        t0 = time.perf_counter()
        out = step(p, counter, streams)
        v = float(np.asarray(out[0]).sum())
        ts.append(time.perf_counter() - t0)
    dt = min(ts)
    print(f"{label:28s} {dt*1e3:9.1f} ms   hist={v:.4e}")
    return dt


def build(max_path, mis=True):
    t = g._build_scene_tracer(BATCH, max_path=max_path)
    if not mis:
        t2 = g._build_scene_tracer(BATCH, max_path=max_path)
        t2.targetGuide = None
        t2.__init__(
            BATCH,
            t2.source,
            t2.wavelengthSource,
            t2.response,
            t2.rng,
            t2.scene,
            maxPathLength=max_path,
            sourceMedium="vacuum",
            scatterCoefficient=0.05,
            targetId=1,
            targetGuide=None,
        )
        return t2
    return t


def main():
    d10 = time_tracer(build(10), "full path=10")
    d2 = time_tracer(build(2), "full path=2")
    seg = (d10 - d2) / 8
    print(f"  -> per-segment {seg*1e3:.1f} ms, setup+2seg {d2*1e3:.1f} ms")
    n10 = time_tracer(build(10, mis=False), "nomis path=10")
    n2 = time_tracer(build(2, mis=False), "nomis path=2")
    nseg = (n10 - n2) / 8
    print(f"  -> per-segment {nseg*1e3:.1f} ms (1 intersect, no MIS)")
    print(f"  -> MIS adds {(seg-nseg)*1e3:.1f} ms/segment (2 intersects + 2 shadow responses + guide)")


if __name__ == "__main__":
    main()
