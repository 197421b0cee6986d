"""End-to-end detector-array benchmark: the domain's flagship workload.

The reference ships SceneTemplate precisely for neutrino-telescope module
arrays (reference: src/theia/scene.py:713-935); this tool measures the
FULL MIS tracer — not a raw intersect microbench — on SceneTemplate-
stamped n^3 grids of BK7 detector spheres in water, across the accel
backends whose wins have so far only been shown on raw queries
(instanced two-level traversal, >= 4-detector culled det groups):

  * brute          — plain soup scan + MIS shadow split + culled det
                     groups (>= 4 detectors engages the per-module
                     compacted nearest, accel.intersect_target)
  * brute+cull=off — the un-specialized floor
  * instanced      — two-level instanced traversal
  * auto           — whatever Scene's heuristic picks (validates it)

Per config: bounces/s = batch x maxPathLength / median batch seconds,
plus the histogram sum as the cross-backend correctness check (identical
physics; backends may differ in f32 ordering — sums agree to ~1e-6 rel).

Usage: python tools/bench_detector_array.py [--sides 3 5] [--batch 262144]
Prints one JSON line per scene size + a summary line.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax
import jax.numpy as jnp
import numpy as np


def build_array_tracer(n_side: int, accel: str, batch: int, max_path: int):
    """n_side^3 BK7 sphere modules in water + a central light source +
    target-guide MIS toward one module — the bench.py physics on the
    array geometry."""
    import theia_jax.units as u
    from theia_jax.light import SphericalLightSource, UniformWavelengthSource
    from theia_jax.material import (
        BK7Model,
        HenyeyGreensteinPhaseFunction,
        Material,
        MaterialStore,
        MediumModel,
        WaterBaseModel,
    )
    from theia_jax.random import PhiloxRNG
    from theia_jax.render import SceneTemplate
    from theia_jax.response import HistogramHitResponse
    from theia_jax.mesh import icosphere
    from theia_jax.scene import MeshStore, Transform
    from theia_jax.target import SphereTargetGuide
    from theia_jax.trace.scene import SceneForwardTracer

    class WaterModel(WaterBaseModel, HenyeyGreensteinPhaseFunction, MediumModel):
        ModelName = "water"

        def __init__(self):
            WaterBaseModel.__init__(self, 10.0, 0.0, 35.0)
            HenyeyGreensteinPhaseFunction.__init__(self, 0.9)

    water = WaterModel().createMedium(num_lambda=64, num_theta=64)
    glass = BK7Model().createMedium(num_lambda=64, num_theta=4)
    mats = MaterialStore.pack([Material("det_water", glass, water, flags="DB")])
    meshes = MeshStore({"sphere": icosphere()})
    proto = meshes.createInstance(
        "sphere", "det_water", Transform.TRS(scale=0.4), detectorId=0
    )
    template = SceneTemplate([proto])
    spacing = 2.0
    transforms = []
    det_id = 0
    for i in range(n_side):
        for j in range(n_side):
            for k in range(n_side):
                transforms.append(
                    Transform.TRS(
                        translate=(i * spacing, j * spacing, k * spacing)
                    )
                )
                det_id += 1
    scene = template.createScene(
        transforms, mats, medium="water", accel=accel
    )
    # light between modules near the array center; guide aims at the
    # nearest module (its detectorId = index in stamping order)
    c = (n_side - 1) / 2.0 * spacing
    light_pos = (c + 0.5 * spacing, c, c)
    guide_idx = (
        (n_side // 2) * n_side * n_side
        + (n_side // 2) * n_side
        + (n_side // 2)
    )
    guide_pos = np.asarray(transforms[guide_idx].offset, np.float32)
    tracer = SceneForwardTracer(
        batch,
        SphericalLightSource(
            position=light_pos, timeRange=(0.0, 10.0), budget=1e5
        ),
        UniformWavelengthSource(lambdaRange=(300.0, 700.0)),
        HistogramHitResponse(nBins=100, t0=0.0, binSize=5.0 * u.ns),
        PhiloxRNG(key=42),
        scene,
        maxPathLength=max_path,
        scatterCoefficient=0.05,
        targetId=-1,  # every module responds
        targetGuide=SphereTargetGuide(
            position=tuple(float(x) for x in guide_pos), radius=0.4
        ),
    )
    return tracer


def run_config(n_side, accel, batch, max_path, reps, cull_mode=None):
    import theia_jax.accel as accel_mod
    from theia_jax import compile_cache

    prev = accel_mod.CULL_MODE
    if cull_mode is not None:
        accel_mod.CULL_MODE = cull_mode
    try:
        tracer = build_array_tracer(n_side, accel, batch, max_path)
        fn, (p, counter, streams) = tracer.trace_fn()
        step = compile_cache.jit(fn)
        t0 = time.perf_counter()
        out = step(p, counter, streams)
        jax.block_until_ready(out)
        first_call = time.perf_counter() - t0
        hist = np.asarray(out[0])
        times = []
        for _ in range(reps):
            tracer.rng.advance()
            counter = tracer.rng.counter_words
            t0 = time.perf_counter()
            out = step(p, counter, streams)
            jax.block_until_ready(out)
            times.append(time.perf_counter() - t0)
        dt = float(np.median(times))
        hist_sum = float(np.asarray(out[0]).sum())
        backend = next(
            (
                b
                for b in ("instanced", "bvh")
                if getattr(tracer.scene.pack, b) is not None
            ),
            "brute",
        )
        return {
            "bounces_per_s": batch * max_path / dt,
            "first_call_seconds": first_call,
            "hist": hist,
            "seconds": dt,
            "seconds_spread": [float(min(times)), float(max(times))],
            "hist_sum": hist_sum,
            "resolved_backend": backend,
            "n_tri": int(tracer.scene.pack.w_v0.shape[0]),
        }
    finally:
        accel_mod.CULL_MODE = prev


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--sides", type=int, nargs="*", default=[3, 5])
    ap.add_argument("--batch", type=int, default=128 * 1024)
    ap.add_argument("--path", type=int, default=6)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument(
        "--configs",
        nargs="*",
        default=["brute", "brute-nocull", "instanced", "auto"],
    )
    args = ap.parse_args()

    from theia_jax import compile_cache

    compile_cache.enable(ROOT)
    print(f"device: {jax.devices()[0]}", file=sys.stderr)
    for n_side in args.sides:
        results = {}
        for cfg in args.configs:
            accel = cfg.split("-")[0]
            cull = "off" if cfg.endswith("nocull") else None
            r = run_config(
                n_side, accel, args.batch, args.path, args.reps, cull
            )
            r.pop("hist")
            results[cfg] = r
            print(
                f"  {n_side ** 3} modules / {cfg}: "
                f"{r['bounces_per_s']:.3g} bounces/s "
                f"({r['resolved_backend']}, sum={r['hist_sum']:.6g})",
                file=sys.stderr,
                flush=True,
            )
        sums = {k: v["hist_sum"] for k, v in results.items()}
        ref = next(iter(sums.values()))
        agree = all(abs(s - ref) <= 1e-4 * abs(ref) for s in sums.values())
        winner = max(results, key=lambda k: results[k]["bounces_per_s"])
        print(
            json.dumps(
                {
                    "modules": n_side**3,
                    "batch": args.batch,
                    "path_length": args.path,
                    "results": results,
                    "winner": winner,
                    "hist_sums_agree_1e-4": agree,
                }
            ),
            flush=True,
        )


if __name__ == "__main__":
    main()
