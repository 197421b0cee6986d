"""Effective-throughput measurement: SobolQRNG vs PhiloxRNG on the bench scene.

The product of this framework is a *converged light curve*, not raw
bounces: an RNG that lowers the curve's Monte-Carlo variance raises the
effective sample rate even at identical bounces/s. The on-device
Owen-scrambled Sobol sampler (working where the reference's GPU Sobol is
documented broken, reference src/theia/random.py:285-352) has a measured
variance win in tests/test_sobol.py; this tool prices it in wall-clock
terms on the device and the bench workload:

    equal_error_speedup = (var_philox / var_sobol) x (t_philox / t_sobol)

i.e. how many times faster Sobol reaches a given curve error than Philox,
combining the variance ratio (across independent replicates: far-apart
Philox keys / distinct Owen scrambles) with the per-batch time ratio
(Owen hashing costs more per draw than Philox).

Variance metric: per-bin across-replicate variance summed over bins
(tests/test_sobol.py::test_tracer_variance_reduction methodology), plus
the same restricted to the curve's top-half bins (the peak region users
actually fit).

Usage: python tools/bench_sobol_effective.py [--batch 262144] [--reps 8]
Prints one JSON line.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax
import numpy as np


def run_replicates(rng_mode, batch, max_path, reps, accel):
    """Per-replicate curves + steady-state per-batch seconds.

    Replicate structure (the key/seed are baked into the traced program,
    so replication must ride the runtime ``counter`` argument):

    * philox — successive non-overlapping counter blocks (the tracer's
      own ``advance()`` stride; the default schedule advances by the
      true worst-case draws per path, so blocks never overlap). Standard
      counter-based-RNG replication: same key, disjoint counters = iid.
    * sobol — fresh Owen-scramble seeds (counter word 1; see
      SobolQRNG.counter_words): independent randomizations of the same
      point set — the replicate structure QMC error estimation requires
      (successive index blocks of ONE scramble are anti-correlated by
      construction and would bias the variance)."""
    import __graft_entry__ as g
    from theia_jax import compile_cache

    tracer = g._build_scene_tracer(
        batch, max_path=max_path, accel=accel, rng=rng_mode
    )
    fn, (p, counter, streams) = tracer.trace_fn()
    step = compile_cache.jit(fn)
    jax.block_until_ready(step(p, counter, streams))  # compile

    curves, times = [], []
    for r in range(reps):
        if rng_mode == "sobol":
            tracer.rng.seed = 0x9E3779B9 * (r + 1) & 0xFFFFFFFF
        else:
            tracer.rng.advance()
        counter = tracer.rng.counter_words
        t0 = time.perf_counter()
        out = step(p, counter, streams)
        hist = np.asarray(out[0])
        times.append(time.perf_counter() - t0)
        curves.append(hist.astype(np.float64))
    curves = np.stack(curves)
    assert not all(
        np.array_equal(curves[0], c) for c in curves[1:]
    ), "replicates identical — replication wiring broken"
    return curves, times


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=256 * 1024)
    ap.add_argument("--path", type=int, default=10)
    ap.add_argument("--reps", type=int, default=8)
    ap.add_argument("--accel", default="brute")
    args = ap.parse_args()

    from theia_jax import compile_cache

    compile_cache.enable(ROOT)

    print(f"device: {jax.devices()[0]}", file=sys.stderr)
    out = {}
    for mode in ("philox", "sobol"):
        curves, times = run_replicates(
            mode, args.batch, args.path, args.reps, args.accel
        )
        mean = curves.mean(0)
        var = curves.var(0, ddof=1)
        peak = mean >= 0.5 * mean.max()
        out[mode] = {
            "curves_mean_sum": float(mean.sum()),
            "var_sum": float(var.sum()),
            "var_sum_peak_bins": float(var[peak].sum()),
            "seconds_median": float(np.median(times)),
            "seconds_spread": [float(min(times)), float(max(times))],
        }
        print(
            f"  {mode}: var={out[mode]['var_sum']:.4g} "
            f"t={out[mode]['seconds_median']:.3f}s",
            file=sys.stderr,
            flush=True,
        )
    # same expectation across modes (sanity)
    rel = abs(
        out["philox"]["curves_mean_sum"] - out["sobol"]["curves_mean_sum"]
    ) / out["philox"]["curves_mean_sum"]
    var_ratio = out["philox"]["var_sum"] / out["sobol"]["var_sum"]
    var_ratio_peak = (
        out["philox"]["var_sum_peak_bins"] / out["sobol"]["var_sum_peak_bins"]
    )
    # 95% CI on the variance ratio (F distribution, reps-1 dof each side;
    # treats the summed-bin variances as one variance scale — the bins
    # are correlated within a curve, so this is indicative, not exact)
    from scipy.stats import f as f_dist

    q = f_dist.ppf(0.975, args.reps - 1, args.reps - 1)
    var_ratio_ci = [var_ratio / q, var_ratio * q]
    t_ratio = (
        out["philox"]["seconds_median"] / out["sobol"]["seconds_median"]
    )
    print(
        json.dumps(
            {
                "batch": args.batch,
                "path_length": args.path,
                "reps": args.reps,
                "philox": out["philox"],
                "sobol": out["sobol"],
                "mean_rel_diff": rel,
                "var_ratio": var_ratio,
                "var_ratio_ci95": var_ratio_ci,
                "var_ratio_peak_bins": var_ratio_peak,
                "time_ratio_philox_over_sobol": t_ratio,
                "equal_error_speedup": var_ratio * t_ratio,
                "equal_error_speedup_peak": var_ratio_peak * t_ratio,
            }
        ),
        flush=True,
    )


if __name__ == "__main__":
    main()
