"""Quasi-random sampling: converge light curves faster with SobolQRNG.

The product of a simulation is a *converged light curve*; a sampler
with lower Monte-Carlo variance reaches a target error in fewer paths.
`SobolQRNG` — an on-device Owen-scrambled Sobol sequence (the reference
ships a GPU Sobol documented broken, reference src/theia/random.py:
285-352) — is a drop-in for `PhiloxRNG` in any tracer. This example
runs the same volume configuration under both generators and estimates
each one's across-replicate variance:

* Philox replicates = successive non-overlapping counter blocks
  (`rng.advance()` — same key, disjoint draws);
* Sobol replicates = fresh Owen-scramble seeds (independent
  randomizations of the same low-discrepancy point set; successive
  blocks of ONE scramble are variance-reduced parts of a single
  estimate, not replicates).

tools/bench_sobol_effective.py prices the win on the full benchmark
workload; this small configuration shows a decisive win too.

Run: python examples/11_quasirandom_sampling.py
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax
import numpy as np

import theia_jax.units as u
from theia_jax.light import SphericalLightSource, UniformWavelengthSource
from theia_jax.material import (
    DispersionFreeMedium,
    HenyeyGreensteinPhaseFunction,
    MediumModel,
)
from theia_jax.random import PhiloxRNG, SobolQRNG
from theia_jax.response import HistogramHitResponse
from theia_jax.target import InnerSphereTarget
from theia_jax.trace import VolumeForwardTracer


class Model(DispersionFreeMedium, HenyeyGreensteinPhaseFunction, MediumModel):
    def __init__(self) -> None:
        DispersionFreeMedium.__init__(
            self, n=1.33, ng=1.33, mu_a=0.005, mu_s=0.01
        )
        HenyeyGreensteinPhaseFunction.__init__(self, 0.3)


def build(rng):
    return VolumeForwardTracer(
        batchSize=8 * 1024,
        source=SphericalLightSource(
            position=(0.0, 0.0, 0.0), timeRange=(0.0, 0.0), budget=1e6
        ),
        target=InnerSphereTarget(position=(0.0, 0.0, 0.0), radius=50.0),
        wavelengthSource=UniformWavelengthSource(
            lambdaRange=(400.0, 500.0) * np.array(u.nm)
        ),
        response=HistogramHitResponse(nBins=40, binSize=20.0 * u.ns, t0=0.0),
        rng=rng,
        medium=Model().createMedium(num_lambda=32, num_theta=64),
        nScattering=6,
        scatterCoefficient=0.02,
    )


def replicate_curves(rng_kind: str, reps: int) -> np.ndarray:
    tracer = build(
        SobolQRNG(seed=1, dims=64) if rng_kind == "sobol" else PhiloxRNG(key=7)
    )
    curves = []
    for r in range(reps):
        if rng_kind == "sobol":
            # fresh Owen randomization; the seed rides in the runtime
            # counter, so no recompile happens between replicates
            tracer.rng.seed = 0x9E3779B9 * (r + 1) & 0xFFFFFFFF
            curve, _ = tracer.run(advance=False)
        else:
            curve, _ = tracer.run()  # advance(): next counter block
        curves.append(np.asarray(curve, np.float64))
    return np.stack(curves)

REPS = 8
cp = replicate_curves("philox", REPS)
cq = replicate_curves("sobol", REPS)

# both estimate the same expectation...
rel = abs(cp.mean() - cq.mean()) / cp.mean()
assert rel < 0.05, rel
# ...but Sobol's replicates scatter much less
vp = cp.var(0, ddof=1).sum()
vq = cq.var(0, ddof=1).sum()
print(f"mean curves agree to {rel * 100:.1f}%")
print(
    f"across-replicate variance: philox {vp:.4g}, sobol {vq:.4g} "
    f"-> variance ratio {vp / vq:.1f}x"
)
assert vp / vq > 1.5
print("sobol variance win confirmed")
