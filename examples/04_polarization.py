"""Polarized transport: Brewster's angle on a water/glass interface.

Demonstrates the Stokes-vector forward transport (see the reference's
docs/polarization.md): a pencil beam reflecting off a glass wall at
Brewster's angle vanishes for p-polarized light and follows the Fresnel
coefficients exactly otherwise.

Run: python examples/04_polarization.py
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax
import numpy as np

from theia_jax.light import PencilLightSource, UniformWavelengthSource
from theia_jax.material import DispersionFreeMedium, Material, MaterialStore
from theia_jax.mesh import Mesh
from theia_jax.random import PhiloxRNG
from theia_jax.response import HitRecorder
from theia_jax.scene import MeshStore, Scene, Transform
from theia_jax.trace import SceneForwardTracer

N_WATER, N_GLASS = 4.0 / 3.0, 1.5


def plane(z, size, flip=False):
    pos = [(-size, -size, z), (size, -size, z), (size, size, z), (-size, size, z)]
    faces = [(0, 1, 2), (0, 2, 3)] if not flip else [(0, 2, 1), (0, 3, 2)]
    return Mesh.from_geometry(pos, faces)


def detected(stokes_q: float) -> float:
    water = DispersionFreeMedium(n=N_WATER, ng=N_WATER, mu_a=0.0, mu_s=0.0).createMedium(name="water")
    glass = DispersionFreeMedium(n=N_GLASS, ng=N_GLASS, mu_a=0.0, mu_s=0.0).createMedium(name="glass")
    store = MaterialStore.pack(
        [
            Material("mirror", glass, "water", flags="R"),
            Material("det", None, "water", flags="DB"),
        ],
        media=[water],
    )
    meshes = MeshStore({"wall": plane(0.0, 50.0), "lid": plane(0.0, 50.0, flip=True)})
    scene = Scene(
        [
            meshes.createInstance("wall", "mirror"),
            meshes.createInstance("lid", "det", Transform.Translation(0, 0, 2.0), detectorId=1),
        ],
        store,
        medium="water",
    )
    theta = np.arctan2(N_GLASS, N_WATER)  # Brewster from the water side
    tracer = SceneForwardTracer(
        256,
        PencilLightSource(
            position=(-2.0 * np.tan(theta), 5.0, 2.0),
            direction=(np.sin(theta), 0.0, -np.cos(theta)),
            timeRange=(0.0, 0.0),
            budget=1.0,
            stokes=(1.0, stokes_q, 0.0, 0.0),
            polarizationRef=(0.0, -1.0, 0.0),  # perpendicular to incidence plane
        ),
        UniformWavelengthSource(lambdaRange=(450.0, 450.0)),
        HitRecorder(polarized=True),
        PhiloxRNG(key=0xB0),
        scene,
        maxPathLength=4,
        scatterCoefficient=1e-6,
        maxTime=1000.0,
        targetId=1,
        polarized=True,
    )
    hits, _ = tracer.run()
    v = np.asarray(hits["valid"])
    return np.asarray(hits["contrib"])[v].sum() / 256.0


def main() -> None:
    theta = np.arctan2(N_GLASS, N_WATER)
    sin_t = np.sin(theta) * N_WATER / N_GLASS
    cos_t = np.sqrt(1 - sin_t**2)
    r_s = (N_WATER * np.cos(theta) - N_GLASS * cos_t) / (
        N_WATER * np.cos(theta) + N_GLASS * cos_t
    )
    print(f"Brewster angle (water->glass): {np.rad2deg(theta):.2f} deg")
    print(f"p-polarized reflected: {detected(+1.0):.3e}  (analytic: 0)")
    print(f"s-polarized reflected: {detected(-1.0):.6f}  (analytic r_s^2 = {r_s**2:.6f})")
    print(f"unpolarized reflected: {detected(0.0):.6f}  (analytic R = {0.5 * r_s**2:.6f})")


if __name__ == "__main__":
    main()
