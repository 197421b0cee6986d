"""Benchmark: scene-tracing throughput on one GPU.

Runs the examples/02-equivalent benchmark (three instanced sphere meshes,
3840 triangles, target-guide MIS, 100-bin light curve) and reports
photon-bounces/s — batchSize x maxPathLength path segments per wall-clock
second, steady-state (compile excluded). Headline value = MEDIAN over
BENCH_RUNS (>= 5) reps; min/max/std in detail. It fails when JAX finds no
GPU; every result names the device and the card's power limit.

Every run also measures, in the same process:
  * the standalone brute intersection scan on the same triangle soup at
    the tracer's ray count (kernel_Gtest_s);
  * bf16 matmul and device-memory stream probes pinning the card's
    compute and bandwidth envelope.

Work accounting (PAIRS):
  * pairs_nominal_per_s — bounces/s x 3 sweeps x n_tri: what a tracer
    testing every ray against every triangle would do. Kept for
    cross-round continuity with rounds 1-4.
  * pairs_tested_per_s — the pairs the program ACTUALLY tests, computed
    exactly from the static query inventory (every cull/compaction
    capacity is a static shape): per batch, primary nearest tests
    N x T on all S segments; the MIS shadow split (S-1 segments) tests
    2N x T_det on the detector subsoup plus cap_occ x T_occ on the
    compacted occluder any-hit (cap_occ = its static lane capacity —
    a compacted scan's cost IS its capacity; padding slots scan a
    duplicate ray. The any-hit while_loop may early-exit below that, so
    occ is a tight upper bound). Assumes the cull cond never falls back
    — dischargeable with BENCH_AUDIT=1, which re-runs one batch on CPU
    with the accel.CULL_AUDIT host callback and reports the actual
    fallback count.
  * tracer_over_kernel_tested = pairs_tested rate / kernel rate — the
    "fraction of standalone-scan speed" health metric.
  * tracer_over_kernel_nominal = pairs_nominal rate / kernel rate —
    scan speed x work-reduction factor (>1 means the tracer AVOIDS
    pairs).

Env switches: BENCH_BATCH, BENCH_PATH_LENGTH, BENCH_RUNS, BENCH_ACCEL,
BENCH_RNG=philox|sobol (sobol = Owen-scrambled QRNG; same bounces/s
metric, lower light-curve variance), BENCH_AUDIT=1.

Prints ONE json line: {"metric", "value", "unit", "detail"}.
"""

import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
RAYS_PER_BOUNCE = 3  # primary + 2 MIS shadow sweeps per segment


def _times(fn, make_args, runs):
    """wall times over runs, inputs varied per rep."""
    import jax

    times = []
    for rep in range(runs):
        args = make_args(rep)
        jax.block_until_ready(args)
        t0 = time.perf_counter()
        out = fn(*args)
        jax.block_until_ready(out)
        times.append(time.perf_counter() - t0)
    return times


def _min_time(fn, make_args, runs):
    return min(_times(fn, make_args, runs))


def probe_kernel(pack, n_rays: int, runs: int) -> float:
    """Standalone brute intersection rate (ray-tri tests/s) on the bench
    scene's own triangle soup at the tracer's per-sweep ray count."""
    import jax
    import jax.numpy as jnp

    from theia_jax.accel import _nearest_triangle

    rng = np.random.default_rng(7)
    o = rng.uniform(-2.0, 5.0, (n_rays, 3)).astype(np.float32)
    d = rng.normal(size=(n_rays, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    oj, dj = jnp.asarray(o), jnp.asarray(d)

    @jax.jit
    def run(o, d):
        t, i = _nearest_triangle(pack, o, d, jnp.float32(100.0), 256)
        return jnp.where(jnp.isfinite(t), t, 0.0).sum() + i.sum()

    jax.block_until_ready(run(oj, dj))  # compile
    dt = _min_time(run, lambda rep: (oj + rep * 1e-4, dj), runs)
    n_tri = int(pack.w_v0.shape[0])
    return n_rays * n_tri / dt


def probe_matmul(runs: int) -> float:
    """bf16 matmul TFLOP/s (tensor-core envelope)."""
    import jax
    import jax.numpy as jnp

    n = 2048
    a = jnp.ones((n, n), jnp.bfloat16)
    b = jnp.ones((n, n), jnp.bfloat16)

    @jax.jit
    def run(a, b):
        return (a @ b).sum()

    jax.block_until_ready(run(a, b))
    dt = _min_time(run, lambda rep: (a + jnp.bfloat16(rep), b), runs)
    return 2.0 * n**3 / dt / 1e12


def probe_hbm(runs: int) -> float:
    """Streaming-add GB/s (device-memory envelope): read+write of a 256
    MiB array."""
    import jax
    import jax.numpy as jnp

    n = 64 * 1024 * 1024  # 256 MiB f32
    x = jnp.ones((n,), jnp.float32)

    @jax.jit
    def run(x):
        return x + 1.0

    jax.block_until_ready(run(x))
    dt = _min_time(run, lambda rep: (x + np.float32(rep),), runs)
    return 2.0 * 4.0 * n / dt / 1e9


def _cull_cap(n_lanes: int, frac: float) -> int:
    return max(128, min(n_lanes, int(n_lanes * frac)))


def pairs_per_batch(tracer, n_lanes: int):
    """(pairs_tested, pairs_nominal, breakdown, exact) per batch.

    Mirrors the traced program's static query inventory (trace/scene.py
    _segment_body + accel.intersect_target): exact for the committed
    defaults (brute pack, CULL_MODE in {shadow, off}); other accel
    backends / cull modes report the un-culled inventory with
    exact=False."""
    import theia_jax.accel as accel

    pack = tracer.scene.pack
    T = int(pack.w_v0.shape[0])
    S = tracer.maxPathLength
    N = n_lanes
    nominal = RAYS_PER_BOUNCE * S * N * T
    bd = {"primary": S * N * T, "det": 0, "occ": 0}
    if tracer.targetGuide is None:
        return bd["primary"], nominal, bd, True

    sl = 2 * N  # fused MIS shadow pair lanes
    segs = S - 1  # final segment is peeled: no shadow query
    accelerated = pack.instanced is not None or pack.bvh is not None
    if accelerated or pack.shadow_split is None:
        # fused full-soup nearest for the pair
        bd["det"] = segs * sl * T
        return sum(bd.values()), nominal, bd, not accelerated

    T_det = int(pack.shadow_split.det_v0.shape[0])
    T_occ = T - T_det
    cull = pack.cull if accel.CULL_MODE in ("all", "shadow") else None
    exact = accel.CULL_MODE in ("shadow", "off")
    if cull is None:
        bd["det"] = segs * sl * T_det
        bd["occ"] = segs * sl * T_occ
        return sum(bd.values()), nominal, bd, exact

    det_groups = [k for k, d in enumerate(cull.is_det) if d]
    occ_tris = sum(
        e - s for (s, e), d in zip(cull.spans, cull.is_det) if not d
    )
    if len(det_groups) >= 4 and accel.CULL_CAP_DET > 0:
        cap_det = _cull_cap(sl, accel.CULL_CAP_DET)
        bd["det"] = segs * sum(
            cap_det * (cull.spans[k][1] - cull.spans[k][0])
            for k in det_groups
        )
    else:
        bd["det"] = segs * sl * T_det
    cap_occ = _cull_cap(sl, accel.CULL_CAP_OCC)
    bd["occ"] = segs * cap_occ * occ_tris
    return sum(bd.values()), nominal, bd, exact


def run_audit(batch: int, max_path: int, accel_mode: str, rng_mode: str):
    """Discharge the no-fallback assumption: run one batch on CPU with the
    accel.CULL_AUDIT host callback recording every culled query's cond
    predicate. Prints {"queries": n, "fallbacks": k} and exits."""
    import jax

    sys.path.insert(0, ROOT)
    import __graft_entry__ as g
    import theia_jax.accel as accel
    from theia_jax import compile_cache

    accel.CULL_AUDIT = audit = []
    tracer = g._build_scene_tracer(
        batch, max_path=max_path, accel=accel_mode, rng=rng_mode
    )
    fn, (p, counter, streams) = tracer.trace_fn()
    out = compile_cache.jit(fn)(p, counter, streams)
    jax.block_until_ready(out)
    print(
        json.dumps(
            {"queries": len(audit), "fallbacks": audit.count(False)}
        )
    )


def main() -> None:
    batch = int(os.environ.get("BENCH_BATCH", 256 * 1024))
    max_path = int(os.environ.get("BENCH_PATH_LENGTH", 10))
    runs = int(os.environ.get("BENCH_RUNS", 5))
    accel_mode = os.environ.get("BENCH_ACCEL", "brute")
    rng_mode = os.environ.get("BENCH_RNG", "philox")

    if "--audit" in sys.argv:
        run_audit(
            int(os.environ.get("BENCH_AUDIT_BATCH", 64 * 1024)),
            max_path,
            accel_mode,
            rng_mode,
        )
        return

    import jax

    sys.path.insert(0, ROOT)
    from theia_jax import compile_cache
    from theia_jax.profiling import card_info

    devices = jax.devices()
    if devices[0].platform != "gpu":
        sys.exit(f"bench.py measures a GPU; JAX found {devices[0].platform}")
    card = card_info()
    compile_cache.enable(ROOT)
    import __graft_entry__ as g

    tracer = g._build_scene_tracer(
        batch, max_path=max_path, accel=accel_mode, rng=rng_mode
    )
    fn, (p, counter, streams) = tracer.trace_fn()
    step = compile_cache.jit(fn)

    # warmup / compile
    out = step(p, counter, streams)
    jax.block_until_ready(out)

    # advance the RNG offset per run so every execution is distinct
    times = []
    for _ in range(runs):
        tracer.rng.advance()
        counter = tracer.rng.counter_words
        t0 = time.perf_counter()
        out = step(p, counter, streams)
        jax.block_until_ready(out)
        times.append(time.perf_counter() - t0)
    dt = float(np.median(times))
    bounces = batch * max_path
    value = bounces / dt
    hist_sum = float(out[0].sum())

    # same-session calibration probes (see module docstring)
    pack = tracer.scene.pack
    n_tri = int(pack.w_v0.shape[0])
    n_lanes = int(streams.shape[0])
    kernel_rate = probe_kernel(pack, batch, runs)
    matmul_tflops = probe_matmul(runs)
    hbm_gbps = probe_hbm(runs)

    # work accounting (module docstring "PAIRS")
    tested_b, nominal_b, breakdown, exact = pairs_per_batch(tracer, n_lanes)
    pairs_tested_s = tested_b / dt
    pairs_nominal_s = nominal_b / dt

    detail = {
        "batch": batch,
        "path_length": max_path,
        "rng": rng_mode,
        "seconds_per_batch": dt,
        "seconds_min": float(np.min(times)),
        "seconds_max": float(np.max(times)),
        "seconds_std": float(np.std(times)),
        "reps": runs,
        "histogram_sum": hist_sum,
        "platform": devices[0].platform,
        "device_kind": devices[0].device_kind,
        "device_count": len(devices),
        "card": card,
        "n_tri": n_tri,
        "kernel_Gtest_s": kernel_rate / 1e9,
        "pairs_nominal_per_s": pairs_nominal_s,
        "pairs_tested_per_s": pairs_tested_s,
        "pairs_tested_exact": exact,
        "pairs_breakdown_per_batch": breakdown,
        "tracer_over_kernel_tested": pairs_tested_s / kernel_rate,
        "tracer_over_kernel_nominal": pairs_nominal_s / kernel_rate,
        "matmul_tflops": matmul_tflops,
        "hbm_gbps": hbm_gbps,
        "note": (
            "value = median over reps (spread in seconds_min/max/std). "
            "tracer_over_kernel_tested = fraction of the standalone "
            "kernel's rate on pairs ACTUALLY tested (exact static "
            "accounting; see module docstring); _nominal additionally "
            "credits avoided pairs."
        ),
    }
    if os.environ.get("BENCH_EXTRAS", "1") != "0":
        # the domain's flagship scaling workload in the same artifact: a
        # 27-module SceneTemplate detector array under accel='auto'
        # (instanced), full MIS tracer (tools/bench_detector_array.py has
        # the sweep)
        sys.path.insert(0, os.path.join(ROOT, "tools"))
        from bench_detector_array import run_config as _array_cfg

        r = _array_cfg(3, "auto", 128 * 1024, 6, 3)
        detail["array27_bounces_per_s"] = r["bounces_per_s"]
        detail["array27_backend"] = r["resolved_backend"]
        detail["array27_seconds_spread"] = r["seconds_spread"]

    if os.environ.get("BENCH_AUDIT") == "1":
        import subprocess

        # the audit runs on the CPU, so this process keeps the card alone
        env = dict(os.environ)
        env["JAX_PLATFORMS"] = "cpu"
        r = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--audit"],
            capture_output=True,
            text=True,
            env=env,
        )
        detail["cull_audit"] = (
            json.loads(r.stdout.strip().splitlines()[-1])
            if r.returncode == 0
            else {"error": r.stderr[-400:]}
        )

    print(
        json.dumps(
            {
                "metric": "photon-bounces/s per card (scene tracing)",
                "value": value,
                "unit": "bounces/s",
                "detail": detail,
            }
        )
    )


if __name__ == "__main__":
    main()
