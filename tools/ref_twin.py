"""Reference-side conformance twin — RUN THIS ON A VULKAN MACHINE.

This script is the other half of tools/ref_conformance.py: it rebuilds
the five BASELINE.md staged configs with the *reference* implementation
(tkerscher/theia + hephaistos, which need a Vulkan-capable GPU and are
not installable without a Vulkan driver), runs them on identical Philox
streams, and compares against this repo's vendored goldens.

Usage (on the Vulkan machine):

    pip install git+https://github.com/tkerscher/theia
    python tools/ref_twin.py --goldens tests/goldens [--write ref_out]

What is compared, per config:

``rng_draws``   raw Philox uniforms, (16 streams, nRNGSamples) at the
                config's key/offset 0 — captured with the reference's
                RNGBufferSink (reference src/theia/random.py:44-199).
                Must match to one float32 ulp: both sides derive the
                uniforms from the same Philox 4x32-10 u32 blocks.
``hist_runs``   per-batch light curves. Both sides construct the same
                physics config, use PhiloxRNG with the same key, and
                advance offsets by the same per-batch stride (this repo
                passes refCompatRNG=True so its host-side accounting
                reproduces the reference's, reference
                src/theia/trace.py:631-634, 1185-1196). Compared with
                rtol=1e-3: identical streams drive identical path
                decisions, but GPU float32 rounding differs from XLA's
                in the last ulps, which random-walk through long paths.
``hist``        mean curve, same tolerance.

``grad_*`` and ``rng_dims`` keys in the goldens are skipped: the
reference is not differentiable and has no per-lane dim-counter probe;
those artifacts are self-regression pins for this repo only.

Expected outcome and known deviations are documented in PARITY.md
("Conformance procedure"); notably config c1/c2 (volume MIS) and any
guided scene config inherit the reference's between-batch stream-overlap
bug when refCompatRNG=True — run-to-run histograms still match because
BOTH sides replay the same (overlapping) streams.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

import hephaistos.pipeline as pl

import theia.units as u
from theia.light import (
    ConeLightSource,
    ConstWavelengthSource,
    SphericalLightSource,
    UniformWavelengthSource,
)
from theia.material import (
    BK7Model,
    DispersionFreeMedium,
    HenyeyGreensteinPhaseFunction,
    Material,
    MaterialStore,
    MediumModel,
    WaterBaseModel,
)
from theia.random import PhiloxRNG, RNGBufferSink
from theia.response import HistogramHitResponse, UniformValueResponse
from theia.scene import MeshStore, Scene, Transform
from theia.target import SphereTarget, SphereTargetGuide
from theia.trace import SceneForwardTracer, VolumeForwardTracer

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from theia_jax.mesh import icosphere, lobed_sphere  # noqa: E402

_MESHES = {"sphere": icosphere, "lobed": lobed_sphere}


def _mesh_file(name: str) -> str:
    """Write one of this repo's procedural meshes (the geometry of
    tools/ref_conformance.py) as binary STL for the reference's loader."""
    path = REPO / "build" / "ref_twin_assets" / f"{name}.stl"
    if not path.exists():
        mesh = _MESHES[name]()
        tri = mesh.vertices[:, :3][mesh.indices].astype(np.float32)
        rec = np.zeros(len(tri), [("n", "<f4", 3), ("v", "<f4", (3, 3)), ("a", "<u2")])
        rec["v"] = tri
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_bytes(
            bytes(80) + np.uint32(len(tri)).tobytes() + rec.tobytes()
        )
    return str(path)
N_RUNS = 2
RNG_PROBE_STREAMS = 16


class _Homogeneous(DispersionFreeMedium, HenyeyGreensteinPhaseFunction, MediumModel):
    ModelName = "homogenous"

    def __init__(self):
        DispersionFreeMedium.__init__(self, n=1.33, ng=1.33, mu_a=0.05, mu_s=0.02)
        HenyeyGreensteinPhaseFunction.__init__(self, 0.2)


class _Water(WaterBaseModel, HenyeyGreensteinPhaseFunction, MediumModel):
    ModelName = "water"

    def __init__(self):
        WaterBaseModel.__init__(self, 10.0, 0.0, 35.0)
        HenyeyGreensteinPhaseFunction.__init__(self, 0.9)


def c1_volume_homogeneous(batch: int):
    medium = _Homogeneous().createMedium(num_lambda=8, num_theta=256)
    store = MaterialStore([], media=[medium])
    return [
        VolumeForwardTracer(
            batch,
            SphericalLightSource(
                position=(1.0, 0.0, 0.0), timeRange=(0.0, 10.0), budget=1e5
            ),
            SphereTarget(position=(-1.0, 0.0, 0.0), radius=0.5),
            ConstWavelengthSource(500.0 * u.nm),
            HistogramHitResponse(UniformValueResponse(), nBins=100, binSize=5.0),
            PhiloxRNG(key=42),
            medium=store.media["homogenous"],
            scatterCoefficient=0.05,
            nScattering=10,
        )
    ]


def c2_volume_hg(batch: int):
    medium = _Water().createMedium(num_lambda=64, num_theta=256)
    store = MaterialStore([], media=[medium])
    return [
        VolumeForwardTracer(
            batch,
            SphericalLightSource(
                position=(-1.0, -7.0, 0.0), timeRange=(0.0, 0.0), budget=1e9
            ),
            SphereTarget(position=(0.0, 0.0, 0.0), radius=5.0),
            UniformWavelengthSource(lambdaRange=(400.0, 500.0)),
            HistogramHitResponse(UniformValueResponse(), nBins=100, binSize=5.0),
            PhiloxRNG(key=0xC0FFEE),
            medium=store.media["water"],
            nScattering=10,
            maxTime=500.0,
        )
    ]


def _three_sphere_scene():
    water = _Water().createMedium(400.0, 800.0, num_lambda=64, num_theta=256)
    glass = BK7Model().createMedium(400.0, 800.0, num_lambda=64, num_theta=4)
    store = MaterialStore(
        [
            Material("glass_water", glass, water, flags="TR"),
            Material("air_glass", None, glass, flags="TR"),
            Material("det_water", None, water, flags="DB"),
        ]
    )
    meshes = MeshStore({"sphere": _mesh_file("sphere")})
    light_pos, det_pos = (3.0, 0.0, 0.0), (0.0, 3.0, 0.0)
    instances = [
        meshes.createInstance(
            "sphere", "glass_water", Transform.TRS(scale=0.8, translate=light_pos)
        ),
        meshes.createInstance(
            "sphere", "air_glass", Transform.TRS(scale=0.75, translate=light_pos)
        ),
        meshes.createInstance(
            "sphere", "det_water", Transform.TRS(scale=0.6, translate=det_pos),
            detectorId=1,
        ),
    ]
    scene = Scene(instances, materials=store.material, medium=store.media["water"])
    return scene, store, light_pos, det_pos


def c3_scene_fresnel(batch: int):
    scene, store, light_pos, det_pos = _three_sphere_scene()
    return [
        SceneForwardTracer(
            batch,
            SphericalLightSource(
                position=light_pos, timeRange=(0.0, 10.0), budget=1e5
            ),
            UniformWavelengthSource(lambdaRange=(300.0, 700.0)),
            HistogramHitResponse(UniformValueResponse(), nBins=100, binSize=5.0),
            PhiloxRNG(key=42),
            scene,
            maxPathLength=6,
            sourceMedium=0,  # vacuum inside the inner shell
            scatterCoefficient=0.05,
            targetId=1,
            targetGuide=SphereTargetGuide(position=det_pos, radius=0.6),
        )
    ]


def c4_multisource_polarized(batch: int):
    scene, store, light_pos, det_pos = _three_sphere_scene()

    def make(source, key):
        return SceneForwardTracer(
            batch,
            source,
            UniformWavelengthSource(lambdaRange=(300.0, 700.0)),
            HistogramHitResponse(UniformValueResponse(), nBins=100, binSize=5.0),
            PhiloxRNG(key=key),
            scene,
            maxPathLength=5,
            sourceMedium=0,
            scatterCoefficient=0.05,
            targetId=1,
            polarized=True,
        )

    return [
        make(
            SphericalLightSource(
                position=light_pos, timeRange=(0.0, 10.0), budget=1e5
            ),
            key=0xAAAA,
        ),
        make(
            ConeLightSource(
                position=(-3.0, 3.0, 0.0),
                direction=(1.0, 0.0, 0.0),
                cosOpeningAngle=0.9,
                timeRange=(5.0, 5.0),
                budget=5e4,
            ),
            key=0xBBBB,
        ),
    ]


def c5_lobed_polarized_grad(batch: int):
    water = _Water().createMedium(400.0, 800.0, num_lambda=64, num_theta=256)
    glass = BK7Model().createMedium(400.0, 800.0, num_lambda=64, num_theta=4)
    store = MaterialStore(
        [
            Material("glass_water", glass, water, flags="TR"),
            Material("det_water", None, water, flags="DB"),
        ]
    )
    meshes = MeshStore(
        {
            "lobed": _mesh_file("lobed"),
            "sphere": _mesh_file("sphere"),
        }
    )
    src_pos = (0.0, -2.0, 0.0)
    scene = Scene(
        [
            meshes.createInstance(
                "sphere", "glass_water", Transform.TRS(scale=0.8, translate=src_pos)
            ),
            meshes.createInstance(
                "lobed", "det_water",
                Transform.TRS(scale=1.0, translate=(0.0, 4.0, 0.0)),
                detectorId=1,
            ),
        ],
        materials=store.material,
        medium=store.media["water"],
    )
    return [
        SceneForwardTracer(
            batch,
            SphericalLightSource(position=src_pos, timeRange=(0.0, 5.0), budget=1e6),
            UniformWavelengthSource(lambdaRange=(400.0, 500.0)),
            HistogramHitResponse(UniformValueResponse(), nBins=100, binSize=2.0),
            PhiloxRNG(key=0x5A),
            scene,
            maxPathLength=6,
            sourceMedium=store.media["bk7"],
            targetId=1,
            targetGuide=SphereTargetGuide(position=(0.0, 4.0, 0.0), radius=1.5),
            polarized=True,
        )
    ]


def c6_detector_array(batch: int):
    """3x3x3 array of BK7 detector spheres in water, central source,
    guide MIS toward the center module. This repo stamps it from an
    in-memory SceneTemplate assigning detector ids 0..26 in (i, j, k)
    stamping order; the reference's SceneTemplate is file-based
    (src/theia/scene.py:713-935), so the twin builds the identical scene
    with an explicit instance loop and the same ids."""
    water = _Water().createMedium(400.0, 800.0, num_lambda=64, num_theta=64)
    glass = BK7Model().createMedium(400.0, 800.0, num_lambda=64, num_theta=4)
    store = MaterialStore([Material("det_water", glass, water, flags="DB")])
    meshes = MeshStore({"sphere": _mesh_file("sphere")})
    spacing, n_side = 2.0, 3
    instances = []
    det = 0
    for i in range(n_side):
        for j in range(n_side):
            for k in range(n_side):
                instances.append(
                    meshes.createInstance(
                        "sphere",
                        "det_water",
                        Transform.TRS(
                            scale=0.4,
                            translate=(
                                i * spacing, j * spacing, k * spacing
                            ),
                        ),
                        detectorId=det,
                    )
                )
                det += 1
    scene = Scene(
        instances, materials=store.material, medium=store.media["water"]
    )
    c = (n_side - 1) / 2.0 * spacing
    return [
        SceneForwardTracer(
            batch,
            SphericalLightSource(
                position=(c + 0.5 * spacing, c, c),
                timeRange=(0.0, 10.0),
                budget=1e5,
            ),
            UniformWavelengthSource(lambdaRange=(300.0, 700.0)),
            HistogramHitResponse(UniformValueResponse(), nBins=100, binSize=5.0),
            PhiloxRNG(key=42),
            scene,
            maxPathLength=4,
            scatterCoefficient=0.05,
            targetId=-1,
            targetGuide=SphereTargetGuide(
                position=(spacing, spacing, spacing), radius=0.4
            ),
        )
    ]


CONFIGS = {
    "c1_volume_homogeneous": c1_volume_homogeneous,
    "c2_volume_hg": c2_volume_hg,
    "c3_scene_fresnel": c3_scene_fresnel,
    "c4_multisource_polarized": c4_multisource_polarized,
    "c5_lobed_polarized_grad": c5_lobed_polarized_grad,
    "c6_detector_array": c6_detector_array,
}


def capture_rng(key: int, n_samples: int) -> np.ndarray:
    """(RNG_PROBE_STREAMS, n_samples) uniforms via the reference's sink."""
    from hephaistos.pipeline import RetrieveTensorStage

    gen = PhiloxRNG(key=key)
    sink = RNGBufferSink(gen, RNG_PROBE_STREAMS, n_samples)
    ret = RetrieveTensorStage(sink.tensor)
    pl.runPipeline([gen, sink, ret])
    # sink layout: consecutive samples in consecutive streams
    return ret.view(0).reshape(n_samples, RNG_PROBE_STREAMS).T.astype(np.float32)


def run_config(name: str, batch: int) -> dict:
    tracers = CONFIGS[name](batch)
    responses = [t.response for t in tracers]
    for t in tracers:
        t.rng.autoAdvance = t.nRNGSamples

    hist_runs = []
    for _ in range(N_RUNS):
        total = 0.0
        for t, r in zip(tracers, responses):
            pl.runPipeline(t.collectStages())
            total = total + np.asarray(r.result(0), np.float64)
        hist_runs.append(total)
    hist_runs = np.stack(hist_runs)

    art = {"hist": hist_runs.mean(0), "hist_runs": hist_runs}
    for i, t in enumerate(tracers):
        key = "rng_draws" if i == 0 else f"rng_draws_{i}"
        art[key] = capture_rng(t.rng.key, t.nRNGSamples)
    return art


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--goldens", required=True, help="tests/goldens dir")
    ap.add_argument("--write", help="also write reference outputs here")
    ap.add_argument("--configs", nargs="*", default=list(CONFIGS))
    args = ap.parse_args(argv)

    failures = 0
    for name in args.configs:
        path = Path(args.goldens) / f"{name}.npz"
        golden = dict(np.load(path, allow_pickle=False))
        meta = json.loads(str(golden["meta"]))
        art = run_config(name, meta["batch"])
        if args.write:
            out = Path(args.write) / f"{name}.ref.npz"
            out.parent.mkdir(parents=True, exist_ok=True)
            np.savez_compressed(out, **art)

        errs = []
        for key, ref in art.items():
            g = np.asarray(golden[key])
            if key.startswith("rng_draws"):
                ok = np.allclose(g, ref, rtol=0.0, atol=2**-24)
            else:
                scale = np.abs(g).max() or 1.0
                ok = np.allclose(g, ref, rtol=1e-3, atol=1e-3 * scale)
            if not ok:
                errs.append(f"{key}: max|Δ|={np.abs(g - ref).max():g}")
        print(f"{name}: {'OK' if not errs else 'MISMATCH ' + '; '.join(errs)}")
        failures += bool(errs)
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
