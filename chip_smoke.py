"""Smoke test of the transient tracer on an NVIDIA GPU.

Drives the main path through the entry points a user calls, at the
reference's own sizes, in one process, phase after phase:

  a. SceneForwardTracer on the bench scene (3 x 1280-triangle spheres, MIS
     target guide, brute backend), 524,288 lanes x path length 10;
  b. a 125-module detector array on ``accel="auto"`` (two-level instanced
     walk with the compaction ladder), compared with ``accel="brute"``;
  c. VolumeForwardTracer energy conservation, 2,097,152 lanes x 10;
  d. ``jax.grad`` of phase a's signal w.r.t. the water absorption table;
  e. the conformance configurations c1-c6 of tools/ref_conformance.py
     against the CPU goldens in tests/goldens.

Each phase prints one ``phase {...}`` line with its compile seconds, steady
seconds per batch (timed around ``block_until_ready``), the device's
``peak_bytes_in_use`` and its checks. The first line is the card's name and
power limit; the last line is ``{"ok": true, "device": {...}}``, printed
only when every phase passed. With no GPU the script exits non-zero and
prints no result.

Usage:
    python chip_smoke.py            # phases a-e on one card
    python chip_smoke.py --four     # the sharded path on four cards
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent

LANES = 524_288  # the reference's example batch size (BASELINE.md)
PATH_LENGTH = 10
VOLUME_LANES = 2_097_152  # the reference's validation batch size
ARRAY_SIDE = 5  # 125 modules: above the instanced compaction ladder's gate

# Tolerances of the card's results against another program or platform,
# as fractions of the largest entry. Each sits between the largest reading
# of a sound run and the reading of a planted fault (H100, PERF.md).
# Phase b: the instanced walk tests triangles in each module's object space
# and the brute scan in world space, and the two programs sum in other
# orders. Sound: 3.4e-6 at 524,288 lanes. Planted fault (a quarter of the
# lanes reusing another quarter's streams): 3.4e-3.
ARRAY_RTOL = 1e-4
# Phase a: the scene tracer forms each contribution in log space
# (RayState.contrib: exp(log|lin| + log_contrib)), so doubling the source
# budget changes the last bits of every exp(); the doubled light curve
# equals twice the first to a few float32 ulps of its largest bin.
LINEARITY_RTOL = 4e-6
# --four: each card runs a program compiled for its 524,288 lanes, the
# one-card twin one compiled for all 2,097,152; the two compilations
# round differently and their light curves differ, the same on every
# run. Sound: 1.6e-4 (bench scene) and 7.4e-5
# (ladder), reproduced on one card by summing four 524,288-lane calls.
# Planted fault (the last shard reusing the first shard's streams):
# 2.5e-2 and 3.4e-3.
FOUR_RTOL = 5e-4
# Phase e: XLA:GPU and XLA:CPU use different transcendental approximations
# and summation orders (the GPU histogram adds with atomics), so a lane
# whose path decision sits on a boundary can take the other branch.
# Sound: 1.6e-5 (c5's log phase-function gradient; a 2-ulp change of
# every scatter length moves it by 1.2e-5 on the CPU). Planted fault (a
# TF32-sized 2^-11 error in every scatter length, CPU): 1.6e-2 and
# 1.5e-4 on three gradients. RNG draws and dim counters are exact.
CONFORMANCE_RTOL = 1e-4


def _jax():
    import jax

    return jax


def peak_bytes() -> int | None:
    """``peak_bytes_in_use`` of the first device (None where the backend
    keeps no statistics, e.g. the CPU)."""
    stats = _jax().devices()[0].memory_stats()
    return None if stats is None else int(stats.get("peak_bytes_in_use", 0))


def report(name: str, checks: dict, **numbers) -> dict:
    """Print one phase line and return it; ``ok`` is True when every check
    passed."""
    ok = all(bool(v) for v in checks.values())
    line = {
        "phase": name,
        "ok": ok,
        **numbers,
        "peak_bytes_in_use": peak_bytes(),
        "checks": {k: bool(v) for k, v in checks.items()},
    }
    print("phase " + json.dumps(line, default=float), flush=True)
    return line


def compile_step(fn, *args):
    """(compiled, lowered, seconds): jit, lower and compile ``fn`` (a
    function the package already jitted, such as shard_trace's, is
    lowered as it is)."""
    from theia_jax import compile_cache

    t0 = time.perf_counter()
    jitted = fn if hasattr(fn, "lower") else compile_cache.jit(fn)
    lowered = jitted.lower(*args)
    compiled = lowered.compile()
    return compiled, lowered, time.perf_counter() - t0


def steady_seconds(step, make_args, reps: int) -> list[float]:
    """Wall seconds of ``reps`` calls, each ended by ``block_until_ready``."""
    jax = _jax()
    times = []
    for rep in range(reps):
        args = make_args(rep)
        jax.block_until_ready(args)
        t0 = time.perf_counter()
        jax.block_until_ready(step(*args))
        times.append(time.perf_counter() - t0)
    return times


def count_dots(lowered_text: str) -> tuple[int, int]:
    """(matrix products, products at HIGHEST precision) in a lowered
    StableHLO module."""
    lines = [l for l in lowered_text.splitlines() if "stablehlo.dot_general" in l]
    return len(lines), sum("HIGHEST" in l for l in lines)


def _scene_tracer(lanes: int, path: int):
    sys.path.insert(0, str(ROOT))
    import __graft_entry__ as entry

    return entry._build_scene_tracer(lanes, max_path=path, accel="brute")


def predicted_peak_bin(tracer) -> int:
    """Histogram bin of the direct light's mean arrival in the bench scene:
    mean emission time plus the straight flight from the source through
    the air core (r 0.75) and the glass shell (to r 0.8) to the nearest
    point of the detector sphere (r 0.6), at 500 nm."""
    import jax.numpy as jnp
    import numpy as np

    from theia_jax import units as u
    from theia_jax.material import medium_constants

    media = tracer.scene.materials.media
    vg = {
        name: float(medium_constants(media.medium(name), jnp.float32(500.0)).vg)
        for name in ("water", "bk7")
    }
    light = np.asarray(tracer.source.position, np.float64)
    det = np.asarray(tracer.targetGuide.position, np.float64)
    water_path = np.linalg.norm(det - light) - tracer.targetGuide.radius - 0.8
    t_mean = float(np.mean(tracer.source.timeRange))
    tof = 0.75 / u.c + 0.05 / vg["bk7"] + water_path / vg["water"]
    resp = tracer.response
    return int((t_mean + tof - resp.t0) // resp.binSize)


# ------------------------------------------------------------------ phases


def phase_scene(lanes: int = LANES, path: int = PATH_LENGTH, reps: int = 3):
    """a. The bench scene's forward tracer: light curve, peak position,
    linearity in the source budget, matrix-product precision."""
    jax = _jax()
    import numpy as np

    tracer = _scene_tracer(lanes, path)
    fn, (p, counter, streams) = tracer.trace_fn()
    step, lowered, compile_s = compile_step(fn, p, counter, streams)
    mem = step.memory_analysis()
    print(f"memory_analysis scene step: {mem}", flush=True)
    n_dots, n_highest = count_dots(lowered.as_text())

    hist0 = np.asarray(tracer.response.result(p["response"], step(p, counter, streams)[0]))

    def advanced(rep):
        tracer.rng.advance()
        return p, tracer.rng.counter_words, streams

    times = steady_seconds(step, advanced, reps)

    budget = tracer.source.budget
    tracer.source.setParams(budget=2.0 * budget)
    p2 = tracer.params()
    hist2 = np.asarray(tracer.response.result(p2["response"], step(p2, counter, streams)[0]))
    tracer.source.setParams(budget=budget)

    peak, want = int(np.argmax(hist0)), predicted_peak_bin(tracer)
    lin_rel = float(np.abs(hist2 - 2.0 * hist0).max() / np.abs(2.0 * hist0).max())
    checks = {
        "finite": np.isfinite(hist0).all(),
        "non_empty": hist0.sum() > 0,
        "peak_within_one_bin": abs(peak - want) <= 1,
        "budget_doubled_is_2x": lin_rel <= LINEARITY_RTOL,
        "all_products_highest": n_dots == n_highest,
    }
    seconds = float(np.median(times))
    return report(
        "a_scene", checks,
        lanes=lanes, path_length=path, compile_s=compile_s,
        steady_s=seconds, steady_s_all=times,
        bounces_per_s=lanes * path / seconds,
        hist_sum=float(hist0.sum()), peak_bin=peak, predicted_bin=want,
        budget_2x_max_rel_diff=lin_rel,
        dot_generals=n_dots, dot_generals_highest=n_highest,
        memory_analysis=str(mem),
    )


def phase_array(
    lanes: int = LANES, side: int = ARRAY_SIDE, path: int = PATH_LENGTH,
    reps: int = 3,
):
    """b. A side^3 detector array on accel="auto" (resolves to the
    instanced walk with the compaction ladder), and its first batch
    against the plain brute scan of every triangle on the same seed."""
    import numpy as np

    sys.path.insert(0, str(ROOT / "tools"))
    from bench_detector_array import run_config

    import theia_jax.ops.instanced as inst

    big = run_config(side, "auto", lanes, path, reps)
    brute = run_config(side, "brute", lanes, path, 1, cull_mode="off")
    h_auto, h_brute = big["hist"], brute["hist"]
    scale = float(np.abs(h_brute).max()) or 1.0
    rel = float(np.abs(h_auto - h_brute).max()) / scale
    checks = {
        "resolved_instanced": big["resolved_backend"] == "instanced",
        "ladder_engaged": side**3 >= inst.COMPACT_MIN_BOXES,
        "finite": np.isfinite(big["hist"]).all(),
        "non_empty": big["hist"].sum() > 0,
        "auto_matches_brute": rel <= ARRAY_RTOL and h_brute.sum() > 0,
    }
    return report(
        "b_array", checks,
        modules=side**3, lanes=lanes, path_length=path,
        compile_s=big["first_call_seconds"] - big["seconds"],
        steady_s=big["seconds"], steady_s_spread=big["seconds_spread"],
        bounces_per_s=big["bounces_per_s"], n_tri=big["n_tri"],
        brute_steady_s=brute["seconds"], max_rel_diff_vs_brute=rel,
        bit_identical=bool(np.array_equal(h_auto, h_brute)),
    )


def phase_volume(lanes: int = VOLUME_LANES, reps: int = 2):
    """c. Energy conservation: an InnerSphereTarget around the source
    catches every photon; with absorption undone the total equals the
    budget within the reference's 5 %."""
    jax = _jax()
    import jax.numpy as jnp
    import numpy as np

    from theia_jax import units as u
    from theia_jax.light import SphericalLightSource, UniformWavelengthSource
    from theia_jax.material import (
        DispersionFreeMedium,
        HenyeyGreensteinPhaseFunction,
        MediumModel,
    )
    from theia_jax.random import PhiloxRNG
    from theia_jax.response import HitRecorder
    from theia_jax.target import InnerSphereTarget
    from theia_jax.trace import VolumeForwardTracer

    mu_a, mu_s, g, ng = 0.05, 0.01, 0.9, 1.33
    t0, budget = 10.0 * u.ns, 1e9

    class Model(DispersionFreeMedium, HenyeyGreensteinPhaseFunction, MediumModel):
        ModelName = "homogenous"

        def __init__(self):
            DispersionFreeMedium.__init__(self, n=1.33, ng=ng, mu_a=mu_a, mu_s=mu_s)
            HenyeyGreensteinPhaseFunction.__init__(self, g)

    position = (12.0, 15.0, 0.2)
    tracer = VolumeForwardTracer(
        lanes,
        SphericalLightSource(position=position, timeRange=(t0, t0), budget=budget),
        InnerSphereTarget(position=position, radius=100.0 * u.m),
        UniformWavelengthSource(lambdaRange=(400.0, 400.0)),
        HitRecorder(),
        PhiloxRNG(key=0xC0FFEE),
        medium=Model().createMedium(),
        maxTime=float("inf"),
        nScattering=PATH_LENGTH,
        scatterCoefficient=0.05,
    )
    fn, (p, counter, streams) = tracer.trace_fn()
    vg = u.c / ng

    def total(p, counter, streams):
        hits = fn(p, counter, streams)[0]  # the HitRecorder's raw slots
        d = vg * (hits["time"] - t0)
        undone = hits["contrib"] * jnp.exp(mu_a * d)
        return jnp.sum(jnp.where(hits["valid"], undone, 0.0)), hits["overflow"]

    step, _, compile_s = compile_step(total, p, counter, streams)
    summed, overflow = step(p, counter, streams)
    estimate = float(summed) / lanes

    def advanced(rep):
        tracer.rng.advance()
        return p, tracer.rng.counter_words, streams

    times = steady_seconds(step, advanced, reps)
    ratio = estimate / budget
    checks = {
        "finite": np.isfinite(estimate),
        "no_hit_dropped": int(overflow) == 0,
        "energy_within_5pct": abs(ratio - 1.0) < 0.05,
    }
    return report(
        "c_volume", checks,
        lanes=lanes, path_length=PATH_LENGTH, compile_s=compile_s,
        steady_s=float(np.median(times)), estimate_over_budget=ratio,
    )


def phase_gradient(lanes: int = LANES, path: int = PATH_LENGTH, reps: int = 2):
    """d. d(total signal)/d(water absorption table) through trace_fn():
    finite, and never positive (more absorption, less light)."""
    jax = _jax()
    import dataclasses

    import jax.numpy as jnp
    import numpy as np

    tracer = _scene_tracer(lanes, path)
    fn, (p, counter, streams) = tracer.trace_fn()
    media = p["scene"].media
    handle = media.handle("water")
    table = media.tables["absorption_coef"][handle]

    def signal(tbl, p, counter, streams):
        tables = dict(media.tables)
        tables["absorption_coef"] = tables["absorption_coef"].at[handle].set(tbl)
        pp = dict(p)
        pp["scene"] = dataclasses.replace(
            p["scene"], media=dataclasses.replace(media, tables=tables)
        )
        return jnp.sum(fn(pp, counter, streams)[0])

    step, _, compile_s = compile_step(
        jax.value_and_grad(signal), table, p, counter, streams
    )
    value, grad = step(table, p, counter, streams)
    grad = np.asarray(grad)
    times = steady_seconds(step, lambda rep: (table, p, counter, streams), reps)
    checks = {
        "signal_positive": float(value) > 0,
        "finite_no_nan": np.isfinite(grad).all(),
        "d_signal_d_mu_a_nonpositive": (grad <= 0).all() and grad.sum() < 0,
    }
    return report(
        "d_gradient", checks,
        lanes=lanes, path_length=path, compile_s=compile_s,
        steady_s=float(np.median(times)), grad_sum=float(grad.sum()),
        grad_max=float(grad.max()),
    )


def phase_conformance(configs=None, batch: int | None = None):
    """e. c1-c6 of tools/ref_conformance.py on this device against the
    goldens written on the CPU."""
    import numpy as np

    sys.path.insert(0, str(ROOT / "tools"))
    from ref_conformance import CONFIGS, run_config

    configs = sorted(CONFIGS) if configs is None else configs
    checks, worst = {}, {}
    t0 = time.perf_counter()
    # the configurations are independent programs: compile them
    # concurrently (XLA releases the interpreter lock while compiling)
    with ThreadPoolExecutor(max_workers=len(configs)) as pool:
        fresh_all = list(pool.map(lambda name: run_config(name, batch), configs))
    for name, fresh in zip(configs, fresh_all):
        with np.load(ROOT / "tests" / "goldens" / f"{name}.npz") as golden:
            golden = dict(golden)
        for key, g in golden.items():
            if key == "meta":
                continue
            f = np.asarray(fresh[key])
            if key.startswith(("rng_draws", "rng_dims")):
                checks[f"{name}.{key}"] = np.array_equal(g, f)
                continue
            scale = float(np.abs(g).max()) or 1.0
            rel = float(np.abs(g - f).max()) / scale
            worst[f"{name}.{key}"] = rel
            checks[f"{name}.{key}"] = rel <= CONFORMANCE_RTOL
    return report(
        "e_conformance", checks,
        seconds=time.perf_counter() - t0, max_rel_diff=worst,
        rtol=CONFORMANCE_RTOL,
    )


def four_card_checks(
    devices, lanes_per_card: int = LANES, path: int = PATH_LENGTH,
    short_path: int = 3, reps: int = 3,
):
    """The sharded path over four cards against one card running the same
    global batch: shard_trace's histogram (bench scene, full path length),
    the psum'd absorption gradient and the instanced compaction ladder
    under shard_map (both at ``short_path`` segments: the sharding does
    not depend on the path length, the compile time does). All six
    programs compile concurrently, then run one after another: one warm
    call, then ``reps`` timed calls."""
    jax = _jax()
    import dataclasses

    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import PartitionSpec as P

    from theia_jax.parallel import make_photon_mesh, shard_trace, sharded_streams
    from theia_jax.parallel.dataparallel import BATCH_AXIS

    mesh = make_photon_mesh(devices)
    n = len(devices)
    batch = n * lanes_per_card
    on_one = lambda x: jax.device_put(x, devices[0])
    checks = []  # (name, rtol, (sharded fn, args), (single-card fn, args))

    # 1. shard_trace on the bench scene; lanes draw from their global
    # index, so only the order of the sums differs from one card
    tracer = _scene_tracer(batch, path)
    p, counter = tracer.params(), tracer.rng.counter_words
    traced = shard_trace(tracer, mesh)
    checks.append((
        "four_shard_trace", FOUR_RTOL,
        (traced, (p, counter, sharded_streams(batch, mesh))),
        (tracer._trace_batch, (p, counter, on_one(tracer.streams()))),
    ))

    # 2. the absorption gradient, psum'd over the mesh
    grad_batch = n * max(lanes_per_card // 4, 128)
    gtracer = _scene_tracer(grad_batch, short_path)
    gp, gcounter = gtracer.params(), gtracer.rng.counter_words
    media = gp["scene"].media
    handle = media.handle("water")
    table = media.tables["absorption_coef"][handle]

    def signal(tbl, streams):
        tables = dict(media.tables)
        tables["absorption_coef"] = tables["absorption_coef"].at[handle].set(tbl)
        pp = dict(gp)
        pp["scene"] = dataclasses.replace(
            gp["scene"], media=dataclasses.replace(media, tables=tables)
        )
        return jnp.sum(gtracer._trace_batch(pp, gcounter, streams)[0])

    sharded_grad = jax.shard_map(
        lambda tbl, s: jax.lax.psum(jax.grad(signal)(tbl, s), BATCH_AXIS),
        mesh=mesh, in_specs=(P(), P(BATCH_AXIS)), out_specs=P(), check_vma=False,
    )
    checks.append((
        "four_psum_gradient", FOUR_RTOL,
        (sharded_grad, (table, sharded_streams(grad_batch, mesh))),
        (jax.grad(signal), (table, on_one(gtracer.streams()))),
    ))

    # 3. the 125-module array: instanced walk + compaction ladder in SPMD
    sys.path.insert(0, str(ROOT / "tools"))
    from bench_detector_array import build_array_tracer

    atracer = build_array_tracer(ARRAY_SIDE, "auto", batch, short_path)
    afn, (ap, acounter, _) = atracer.trace_fn()
    sharded_array = jax.shard_map(
        lambda s: jax.lax.psum(afn(ap, acounter, s)[0], BATCH_AXIS),
        mesh=mesh, in_specs=P(BATCH_AXIS), out_specs=P(), check_vma=False,
    )
    checks.append((
        "four_instanced_ladder", FOUR_RTOL,
        (sharded_array, (sharded_streams(batch, mesh),)),
        (lambda s: afn(ap, acounter, s)[0], (on_one(atracer.streams()),)),
    ))

    programs = [prog for _, _, *pair in checks for prog in pair]
    with ThreadPoolExecutor(max_workers=len(programs)) as pool:
        compiled = list(pool.map(lambda prog: compile_step(*prog[0:1], *prog[1]), programs))

    lines = []
    for k, (name, rtol, sharded, single) in enumerate(checks):
        outs, numbers = [], {}
        for tag, (fn, args), (step, _, compile_s) in zip(
            ("sharded", "single_card"), (sharded, single), compiled[2 * k: 2 * k + 2]
        ):
            numbers[f"{tag}_compile_s"] = compile_s
            out = step(*args)  # also the warm-up call
            outs.append(np.asarray(out[0] if isinstance(out, tuple) else out))
            times = steady_seconds(step, lambda rep: args, reps)
            numbers[f"{tag}_s"] = float(np.median(times))
            numbers[f"{tag}_s_all"] = times
        out_sh, out_1 = outs
        scale = float(np.abs(out_1).max()) or 1.0
        rel = float(np.abs(out_sh - out_1).max()) / scale
        lines.append(report(
            name,
            {"finite": np.isfinite(out_sh).all(), "non_zero": np.abs(out_sh).sum() > 0,
             "sharded_matches_single": rel <= rtol},
            cards=n, max_rel_diff=rel, rtol=rtol, **numbers,
        ))
    return lines


# ------------------------------------------------------------------ driver


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument(
        "--four", action="store_true",
        help="run only the sharded checks, on four cards",
    )
    args = ap.parse_args(argv)

    # outside a checkout this import fails and nothing is printed
    sys.path.insert(0, str(ROOT))
    from theia_jax import compile_cache
    from theia_jax.profiling import card_info

    jax = _jax()
    devices = jax.devices()
    want = 4 if args.four else 1
    if devices[0].platform != "gpu" or len(devices) < want:
        print(
            f"chip_smoke.py needs {want} GPU(s); JAX found "
            f"{len(devices)} {devices[0].platform} device(s)",
            file=sys.stderr,
        )
        return 2

    print(card_info(), flush=True)
    compile_cache.enable(ROOT)

    if args.four:
        phases = [lambda: four_card_checks(devices[:4])]
    else:
        phases = [phase_scene, phase_array, phase_volume, phase_gradient,
                  phase_conformance]
    ok = True
    for phase in phases:
        try:
            out = phase()
            lines = out if isinstance(out, list) else [out]
            ok &= all(line["ok"] for line in lines)
        except Exception:  # report the failed phase, run the rest, fail at exit
            traceback.print_exc()
            print(f"phase {getattr(phase, '__name__', 'four')} raised", flush=True)
            ok = False
    if not ok:
        print("chip_smoke.py: a phase failed", file=sys.stderr)
        return 1
    d = devices[0]
    print(json.dumps({
        "ok": True,
        "device": {"platform": d.platform, "kind": d.device_kind, "count": len(devices)},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
