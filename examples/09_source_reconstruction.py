"""Source reconstruction: recover a flash position from detector data
by gradient descent through the full simulator.

The neutrino-telescope reconstruction task in miniature: a 2x2x2 array
of detector modules records per-module transients (one differentiable
KDE light curve per module, `nDetectors=` on the histogram response)
from a flash at an unknown position. We simulate "observed" curves at
the true position, then fit the position by minimizing the curve
mismatch with `jax.grad` THROUGH the whole Monte Carlo simulation —
scattering, Fresnel shells, per-module arrival times.

This needs two pieces the framework provides beyond the reference:
smooth arrival-time dependence (kernel histogram) and geometry
gradients through the intersection (the hit distance is recomputed
differentiably; its zero-valued reattachment makes arrival times carry
d(time)/d(source position) while sampled scatter distances stay frozen
— trace/scene.py).

Run: python examples/09_source_reconstruction.py
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

TRUE_POS = jnp.array([0.3, -0.2, 0.1], jnp.float32)


def main() -> None:
    medium = WaterTestModel(mu_a=0.01, mu_s=0.05, g=0.6).createMedium()
    mats = MaterialStore.pack([Material("det", None, medium, flags="DB")])
    meshes = MeshStore({"sphere": icosphere()})
    insts = [
        meshes.createInstance(
            "sphere",
            "det",
            Transform.TRS(
                scale=0.4, translate=(2.0 * i - 1, 2.0 * j - 1, 2.0 * k - 1)
            ),
            detectorId=(i * 2 + j) * 2 + k,
        )
        for i in range(2)
        for j in range(2)
        for k in range(2)
    ]
    scene = Scene(insts, mats, medium="water_test", accel="instanced")

    tracer = SceneForwardTracer(
        8 * 1024,
        SphericalLightSource(position=(0.0, 0.0, 0.0), timeRange=(0.0, 0.0), budget=1e6),
        UniformWavelengthSource(lambdaRange=(420.0, 480.0)),
        KernelHistogramHitResponse(
            nBins=40, t0=0.0, binSize=1.0 * u.ns, nDetectors=8
        ),
        PhiloxRNG(key=0xBADA55),
        scene,
        maxPathLength=5,
        maxTime=40.0 * u.ns,
    )
    fn, (p0, counter, streams) = tracer.trace_fn()

    def curves(pos):
        p = dict(p0)
        ls = dict(p["lightSource"])
        ls["position"] = pos
        p["lightSource"] = ls
        resp, _ = fn(p, counter, streams)
        # normalized per-module light curves (8 modules, 40 bins),
        # differentiable in pos
        return tracer.response.result(p["response"], resp)

    observed = curves(TRUE_POS)  # "data" taken at the unknown true position

    def loss(pos):
        c = curves(pos)
        return jnp.sum((c - observed) ** 2) / jnp.sum(observed**2)

    value_and_grad = compile_cache.jit(jax.value_and_grad(loss))
    pos = jnp.zeros(3, jnp.float32)  # start at the array center
    print(f"start {np.asarray(pos).round(3)}  (true {np.asarray(TRUE_POS)})")
    for it in range(12):
        v, g = value_and_grad(pos)
        pos = pos - 0.05 * g / jnp.maximum(jnp.linalg.norm(g), 1e-9)
        if it % 5 == 0:
            print(f"  it {it:2d}: loss {float(v):.4f} pos {np.asarray(pos).round(3)}")

    err = float(jnp.linalg.norm(pos - TRUE_POS))
    print(f"reconstructed {np.asarray(pos).round(3)}, error {err*100:.1f} cm")
    assert err < 0.12, err
    print("flash position recovered by gradient descent")


if __name__ == "__main__":
    main()
