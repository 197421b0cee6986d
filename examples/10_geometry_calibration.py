"""Detector-geometry calibration: recover a misplaced module's position
from calibration-flash data by gradient descent through the simulator.

The complement of examples/09: there the source moved and the detectors
were known; here flashes at KNOWN positions illuminate an array whose
one module is off its nominal position (as-built vs as-designed — the
standard survey problem for in-ice/in-water telescopes). We simulate
"observed" per-module transients with the true (offset) geometry, then
fit the offset by minimizing the curve mismatch with `jax.grad` through
the whole Monte Carlo simulation.

Geometry enters through `ScenePack.translate_instance(id, delta)`: the
scene tables live in the params pytree, so a rigid module shift is an
ordinary differentiable function of `delta` inside jit (brute-scan
backend; see docs/differentiability.md "Geometry gradients").

Run: python examples/10_geometry_calibration.py
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax
import jax.numpy as jnp
import numpy as np

import theia_jax.units as u
from theia_jax import compile_cache
from theia_jax.light import SphericalLightSource, UniformWavelengthSource
from theia_jax.material import Material, MaterialStore
from theia_jax.random import PhiloxRNG
from theia_jax.response import KernelHistogramHitResponse
from theia_jax.mesh import icosphere
from theia_jax.scene import MeshStore, Scene, Transform
from theia_jax.testing import WaterTestModel
from theia_jax.trace import SceneForwardTracer

# module 0 is actually displaced by this much from its nominal position.
# The reparameterized gradient captures how existing hit lanes' arrival
# times and transmittances move, but not lanes entering/leaving the
# detector (the visibility-boundary term of differentiable rendering),
# so calibration is accurate for offsets small against the module radius
TRUE_OFFSET = jnp.array([0.12, -0.08, 0.05], jnp.float32)


def main() -> None:
    medium = WaterTestModel(mu_a=0.01, mu_s=0.04, g=0.5).createMedium()
    mats = MaterialStore.pack([Material("det", None, medium, flags="DB")])
    meshes = MeshStore({"sphere": icosphere()})
    # a small string of 3 modules; module 0 is the suspect
    insts = [
        meshes.createInstance(
            "sphere",
            "det",
            Transform.TRS(scale=0.4, translate=(0.0, 0.0, 2.0 * k - 2.0)),
            detectorId=k,
        )
        for k in range(3)
    ]
    scene = Scene(insts, mats, medium="water_test", accel="brute")

    # two calibration flashes at known positions bracket the string
    flashes = [(-2.5, 0.0, -1.0), (2.0, 2.0, 0.0), (0.5, -2.2, 1.5)]
    tracer = SceneForwardTracer(
        8 * 1024,
        SphericalLightSource(position=flashes[0], timeRange=(0.0, 0.0), budget=1e6),
        UniformWavelengthSource(lambdaRange=(420.0, 480.0)),
        KernelHistogramHitResponse(
            nBins=40, t0=0.0, binSize=1.0 * u.ns, nDetectors=3
        ),
        PhiloxRNG(key=0xCAB),
        scene,
        maxPathLength=4,
        maxTime=40.0 * u.ns,
    )
    fn, (p0, counter, streams) = tracer.trace_fn()

    def curves(offset, flash):
        p = dict(p0)
        p["scene"] = p["scene"].translate_instance(0, offset)
        ls = dict(p["lightSource"])
        ls["position"] = jnp.asarray(flash, jnp.float32)
        p["lightSource"] = ls
        resp, _ = fn(p, counter, streams)
        return tracer.response.result(p["response"], resp)

    observed = [curves(TRUE_OFFSET, f) for f in flashes]

    def loss(offset):
        acc = 0.0
        for f, obs in zip(flashes, observed):
            c = curves(offset, f)
            acc = acc + jnp.sum((c - obs) ** 2) / jnp.sum(obs**2)
        return acc

    value_and_grad = compile_cache.jit(jax.value_and_grad(loss))
    offset = jnp.zeros(3, jnp.float32)  # start at nominal
    print(f"start {np.asarray(offset).round(3)}  (true {np.asarray(TRUE_OFFSET)})")
    # fixed RNG streams make the loss deterministic; Adam handles the
    # anisotropic curvature (x is far better constrained than y here)
    m = jnp.zeros(3)
    vv = jnp.zeros(3)
    lr, b1, b2 = 0.03, 0.9, 0.999
    for it in range(30):
        v, g = value_and_grad(offset)
        m = b1 * m + (1 - b1) * g
        vv = b2 * vv + (1 - b2) * g * g
        mh = m / (1 - b1 ** (it + 1))
        vh = vv / (1 - b2 ** (it + 1))
        offset = offset - lr * mh / (jnp.sqrt(vh) + 1e-9)
        if it % 6 == 0:
            print(f"  it {it:2d}: loss {float(v):.4f} offset {np.asarray(offset).round(3)}")

    err = float(jnp.linalg.norm(offset - TRUE_OFFSET))
    print(f"calibrated offset {np.asarray(offset).round(3)}, error {err*100:.1f} cm")
    assert err < 0.06, err
    print("module position calibrated by gradient descent")


if __name__ == "__main__":
    main()
