"""Reference-conformance harness: canonical artifacts for the five
BASELINE.md staged configs.

The north-star correctness claim is "light curves + medium-parameter
gradients allclose vs the reference on identical Philox streams"
(BASELINE.md). The reference itself validates estimators against
*captured* GPU runs (reference tests/test_trace_energy.py:21-26 chain of
trust); with no Vulkan runtime in this sandbox, the deliverable is the
same shape: a harness + vendored golden artifacts + a runnable
reference-side twin (tools/ref_twin.py) for a Vulkan machine.

For each config this tool emits one ``<name>.npz`` with canonical keys:

``hist``            mean light curve over ``n_runs`` batches, float64
``hist_runs``       per-batch histograms ``(n_runs, nBins)`` — the twin
                    compares per-batch so RNG-stream identity is testable,
                    not just the average
``rng_draws``       raw Philox uniforms ``(16 streams, nRNGSamples)`` at
                    the config's key/offset — bit-level stream identity
                    (twin: theia.random.RNGBufferSink)
``rng_dims``        per-lane final RNG dim counter from a small probe
                    batch — pins the draw *schedule*, not just the stream
``grad_<table>``    gradients of the total detected signal w.r.t. medium
                    tables (this repo only; the reference is not
                    differentiable — self-regression goldens)
``meta``            JSON: key, offset, batch, nRNGSamples, tolerances

Write goldens:   python tools/ref_conformance.py --write tests/goldens
Check goldens:   python tools/ref_conformance.py --check tests/goldens
(the pytest wrapper tests/test_goldens.py runs --check on the small tier)

Tolerances: ``rng_draws`` must match to one float32 ulp (identical u32
bit-streams on both sides); histograms use rtol=1e-4 — float32 scatter-add
order may differ between backends, counts are O(1e4).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))


# goldens are generated and checked on the virtual CPU mesh so they are
# platform-stable; chip_smoke.py compares a GPU run against them
if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax

if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import numpy as np

import theia_jax.units as u
from theia_jax import compile_cache
from theia_jax.light import (
    ConeLightSource,
    ConstWavelengthSource,
    SphericalLightSource,
    UniformWavelengthSource,
)
from theia_jax.material import (
    BK7Model,
    DispersionFreeMedium,
    HenyeyGreensteinPhaseFunction,
    Material,
    MaterialStore,
    MediumModel,
    WaterBaseModel,
)
from theia_jax.random import PhiloxRNG, rng_buffer
from theia_jax.response import HistogramHitResponse
from theia_jax.mesh import icosphere, lobed_sphere
from theia_jax.scene import MeshStore, Scene, Transform
from theia_jax.target import SphereTarget, SphereTargetGuide
from theia_jax.trace.scene import SceneForwardTracer
from theia_jax.trace.volume import VolumeForwardTracer

N_RUNS = 2  # per-batch comparison needs >= 2 to exercise the offset stride
RNG_PROBE_STREAMS = 16
RNG_DIM_PROBE = 256


class _Homogeneous(DispersionFreeMedium, HenyeyGreensteinPhaseFunction, MediumModel):
    """The reference's examples/01 medium: n=1.33, mu_a=0.05, mu_s=0.02, g=0.2."""

    ModelName = "homogenous"  # [sic] — reference notebook spelling

    def __init__(self):
        DispersionFreeMedium.__init__(self, n=1.33, ng=1.33, mu_a=0.05, mu_s=0.02)
        HenyeyGreensteinPhaseFunction.__init__(self, 0.2)


class _Water(WaterBaseModel, HenyeyGreensteinPhaseFunction, MediumModel):
    """Sea water 10 degC / 35 PSU with strong HG scattering (g=0.9)."""

    ModelName = "water"

    def __init__(self):
        WaterBaseModel.__init__(self, 10.0, 0.0, 35.0)
        HenyeyGreensteinPhaseFunction.__init__(self, 0.9)


# ---------------------------------------------------------------------------
# config builders — each returns (tracer, extras) where extras may carry
# additional tracers (multi-source) or gradient closures
# ---------------------------------------------------------------------------


def c1_volume_homogeneous(batch: int):
    """BASELINE config 1 = the reference's examples/01 notebook, verbatim
    parameters (medium, source, target, histogram, key=42)."""
    medium = _Homogeneous().createMedium(num_lambda=8, num_theta=256)
    tracer = VolumeForwardTracer(
        batch,
        SphericalLightSource(
            position=(1.0, 0.0, 0.0), timeRange=(0.0, 10.0) * np.array(u.ns), budget=1e5
        ),
        SphereTarget(position=(-1.0, 0.0, 0.0), radius=50.0 * u.cm),
        ConstWavelengthSource(500.0 * u.nm),
        HistogramHitResponse(nBins=100, binSize=5.0 * u.ns, t0=0.0),
        PhiloxRNG(key=42),
        medium=medium,
        scatterCoefficient=0.05,
        nScattering=10,
        refCompatRNG=True,
    )
    return tracer, {}


def c2_volume_hg(batch: int):
    """BASELINE config 2: wavelength-dependent water + strong HG scattering."""
    medium = _Water().createMedium(num_lambda=64, num_theta=256)
    tracer = VolumeForwardTracer(
        batch,
        SphericalLightSource(
            position=(-1.0, -7.0, 0.0), timeRange=(0.0, 0.0), budget=1e9
        ),
        SphereTarget(position=(0.0, 0.0, 0.0), radius=5.0 * u.m),
        UniformWavelengthSource(lambdaRange=(400.0, 500.0)),
        HistogramHitResponse(nBins=100, binSize=5.0 * u.ns, t0=0.0),
        PhiloxRNG(key=0xC0FFEE),
        medium=medium,
        nScattering=10,
        maxTime=500.0 * u.ns,
        refCompatRNG=True,
    )

    def grads(tracer):
        return _medium_grads(tracer, "water", ("absorption_coef", "scattering_coef"))

    return tracer, {"grads": grads}


def _three_sphere_scene(accel: str, polarized: bool):
    water = _Water().createMedium(num_lambda=64, num_theta=256)
    glass = BK7Model().createMedium(num_lambda=64, num_theta=4)
    mats = MaterialStore.pack(
        [
            Material("glass_water", glass, water, flags="TR"),
            Material("air_glass", None, glass, flags="TR"),
            Material("det_water", None, water, flags="DB"),
        ]
    )
    meshes = MeshStore({"sphere": icosphere()})
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
    return Scene(instances, mats, medium="water", accel=accel), light_pos, det_pos


def c3_scene_fresnel(batch: int):
    """BASELINE config 3: examples/02-style three-sphere scene, BVH accel,
    Fresnel transmission through the glass shell, target-guide MIS."""
    scene, light_pos, det_pos = _three_sphere_scene("bvh", polarized=False)
    tracer = SceneForwardTracer(
        batch,
        SphericalLightSource(position=light_pos, timeRange=(0.0, 10.0), budget=1e5),
        UniformWavelengthSource(lambdaRange=(300.0, 700.0)),
        HistogramHitResponse(nBins=100, t0=0.0, binSize=5.0 * u.ns),
        PhiloxRNG(key=42),
        scene,
        maxPathLength=6,
        sourceMedium="vacuum",
        scatterCoefficient=0.05,
        targetId=1,
        targetGuide=SphereTargetGuide(position=det_pos, radius=0.6),
        refCompatRNG=True,
    )
    return tracer, {}


def c4_multisource_polarized(batch: int):
    """BASELINE config 4: two light sources, polarized (Mueller) transport,
    one shared histogram (reference examples/03 scheduling pattern)."""
    scene, light_pos, det_pos = _three_sphere_scene("brute", polarized=True)
    response = HistogramHitResponse(nBins=100, t0=0.0, binSize=5.0 * u.ns)

    def make(source, key):
        return SceneForwardTracer(
            batch,
            source,
            UniformWavelengthSource(lambdaRange=(300.0, 700.0)),
            response,
            PhiloxRNG(key=key),
            scene,
            maxPathLength=5,
            sourceMedium="vacuum",
            scatterCoefficient=0.05,
            targetId=1,
            polarized=True,
            refCompatRNG=True,
        )

    flash = make(
        SphericalLightSource(position=light_pos, timeRange=(0.0, 10.0), budget=1e5),
        key=0xAAAA,
    )
    beam = make(
        ConeLightSource(
            position=(-3.0, 3.0, 0.0),
            direction=(1.0, 0.0, 0.0),
            cosOpeningAngle=0.9,
            timeRange=(5.0, 5.0),
            budget=5e4,
        ),
        key=0xBBBB,
    )
    return flash, {"extra_tracers": [beam]}


def c5_lobed_polarized_grad(batch: int):
    """BASELINE config 5 (lobed sphere in place of suzanne.stl): polarized transient + medium-parameter
    gradients (mu_a, mu_s, g via the phase tables, IOR via Fresnel at the
    glass shell), sharded over the full device mesh."""
    water = _Water().createMedium(num_lambda=64, num_theta=256)
    glass = BK7Model().createMedium(num_lambda=64, num_theta=4)
    mats = MaterialStore.pack(
        [
            Material("glass_water", glass, water, flags="TR"),
            Material("det_water", None, water, flags="DB"),
        ]
    )
    src_pos = (0.0, -2.0, 0.0)
    meshes = MeshStore(
        {"lobed": lobed_sphere(), "sphere": icosphere()}
    )
    scene = Scene(
        [
            # glass shell around the source: light refracts out through a
            # Fresnel interface, so d(signal)/d(refractive_index) != 0
            meshes.createInstance(
                "sphere", "glass_water",
                Transform.TRS(scale=0.8, translate=src_pos),
            ),
            meshes.createInstance(
                "lobed", "det_water",
                Transform.TRS(scale=1.0, translate=(0.0, 4.0, 0.0)),
                detectorId=1,
            ),
        ],
        mats,
        medium="water",
    )
    tracer = SceneForwardTracer(
        batch,
        SphericalLightSource(
            position=src_pos, timeRange=(0.0, 5.0), budget=1e6
        ),
        UniformWavelengthSource(lambdaRange=(400.0, 500.0)),
        HistogramHitResponse(nBins=100, t0=0.0, binSize=2.0 * u.ns),
        PhiloxRNG(key=0x5A),
        scene,
        maxPathLength=6,
        sourceMedium="bk7",
        targetId=1,
        # the guide's MIS shadow rays evaluate the phase function toward
        # the target, so d(signal)/d(log_phase_function) is nonzero
        targetGuide=SphereTargetGuide(position=(0.0, 4.0, 0.0), radius=1.5),
        polarized=True,
        refCompatRNG=True,
    )

    def grads(tracer):
        out = _medium_grads(
            tracer,
            "water",
            ("absorption_coef", "scattering_coef", "log_phase_function"),
            sharded=True,
        )
        out.update(
            {
                f"{k}_glass": v
                for k, v in _medium_grads(
                    tracer, "bk7", ("refractive_index",), sharded=True
                ).items()
            }
        )
        return out

    return tracer, {"grads": grads, "sharded": True}


def c6_detector_array(batch: int):
    """BASELINE config 6: the domain's flagship workload — a
    3x3x3 SceneTemplate-stamped array of BK7 detector modules in water
    (reference analogue: src/theia/scene.py:713-935 SceneTemplate for
    telescope module arrays), central light source, target-guide MIS
    toward the center module, every module responding (targetId=-1,
    detector ids 0..26 in stamping order)."""
    from theia_jax.render import SceneTemplate

    water = _Water().createMedium(num_lambda=64, num_theta=64)
    glass = BK7Model().createMedium(num_lambda=64, num_theta=4)
    mats = MaterialStore.pack(
        [Material("det_water", glass, water, flags="DB")]
    )
    meshes = MeshStore({"sphere": icosphere()})
    proto = meshes.createInstance(
        "sphere", "det_water", Transform.TRS(scale=0.4), detectorId=0
    )
    template = SceneTemplate([proto])
    spacing, n_side = 2.0, 3
    transforms = [
        Transform.TRS(translate=(i * spacing, j * spacing, k * spacing))
        for i in range(n_side)
        for j in range(n_side)
        for k in range(n_side)
    ]
    scene = template.createScene(
        transforms, mats, medium="water", accel="brute"
    )
    c = (n_side - 1) / 2.0 * spacing
    guide_pos = (spacing, spacing, spacing)  # center module (index 13)
    tracer = SceneForwardTracer(
        batch,
        SphericalLightSource(
            position=(c + 0.5 * spacing, c, c),
            timeRange=(0.0, 10.0),
            budget=1e5,
        ),
        UniformWavelengthSource(lambdaRange=(300.0, 700.0)),
        HistogramHitResponse(nBins=100, t0=0.0, binSize=5.0 * u.ns),
        PhiloxRNG(key=42),
        scene,
        maxPathLength=4,
        scatterCoefficient=0.05,
        targetId=-1,
        targetGuide=SphereTargetGuide(position=guide_pos, radius=0.4),
        refCompatRNG=True,
    )

    def grads(tracer):
        return _medium_grads(tracer, "water", ("absorption_coef",))

    return tracer, {"grads": grads}


CONFIGS = {
    "c1_volume_homogeneous": c1_volume_homogeneous,
    "c2_volume_hg": c2_volume_hg,
    "c3_scene_fresnel": c3_scene_fresnel,
    "c4_multisource_polarized": c4_multisource_polarized,
    "c5_lobed_polarized_grad": c5_lobed_polarized_grad,
    "c6_detector_array": c6_detector_array,
}

# small enough that --check runs in the test suite; regenerate with
# --batch for higher-statistics goldens
DEFAULT_BATCH = {
    "c1_volume_homogeneous": 16 * 1024,
    "c2_volume_hg": 16 * 1024,
    "c3_scene_fresnel": 4 * 1024,
    "c4_multisource_polarized": 2 * 1024,
    "c5_lobed_polarized_grad": 2 * 1024,
    "c6_detector_array": 2 * 1024,
}


# ---------------------------------------------------------------------------
# artifact generation
# ---------------------------------------------------------------------------


def _medium_params_loss(tracer, medium_name: str, table: str):
    """Loss closure: time-weighted detected signal as a function of one
    medium table, with the path sampler frozen (frozen-sampler AD — see
    docs/differentiability). The smooth time weights make the loss
    sensitive to the light curve's *shape*, not just its total."""
    n_bins = tracer.response.nBins
    weights = jnp.exp(-jnp.linspace(0.0, 2.0, n_bins, dtype=jnp.float32))

    def loss(tbl, params, counter, streams):
        p = dict(params)
        if "scene" in p:
            media = p["scene"].media
            tables = dict(media.tables)
            h = media.handle(medium_name)
            tables[table] = tables[table].at[h, : tbl.shape[0]].set(tbl)
            p["scene"] = dataclasses.replace(
                p["scene"], media=dataclasses.replace(media, tables=tables)
            )
        else:
            p["medium"] = dataclasses.replace(p["medium"], **{table: tbl})
        resp_state = tracer._trace_batch(p, counter, streams)[0]
        hist = tracer.response.result(p["response"], resp_state)
        return jnp.sum(hist.reshape(-1, n_bins) * weights)

    return loss


def _medium_grads(tracer, medium_name, tables, *, sharded: bool = False):
    """Gradients of the total detected signal w.r.t. each medium table.

    ``sharded=True`` runs the gradient through shard_map over the photon
    mesh with a psum — the BASELINE config-5 'multi-host sharded' shape."""
    out = {}
    p = tracer.params()
    counter = tracer.rng.counter_words
    if "scene" in p:
        medium_obj = p["scene"].media.medium(medium_name)
    else:
        medium_obj = p["medium"]
    get = lambda t: jnp.asarray(getattr(medium_obj, t))

    if sharded:
        from jax.sharding import PartitionSpec as P

        from theia_jax.parallel.dataparallel import (
            BATCH_AXIS,
            make_photon_mesh,
            sharded_streams,
        )

        mesh = make_photon_mesh()
        streams = sharded_streams(tracer.capacity, mesh)
        for t in tables:
            loss = _medium_params_loss(tracer, medium_name, t)

            def inner(tbl, streams, _loss=loss):
                g = jax.grad(_loss)(tbl, p, counter, streams)
                return jax.lax.psum(g, BATCH_AXIS)

            g = compile_cache.jit(
                jax.shard_map(
                    inner,
                    mesh=mesh,
                    in_specs=(P(), P(BATCH_AXIS)),
                    out_specs=P(),
                    check_vma=False,
                )
            )(get(t), streams)
            out[f"grad_{t}"] = np.asarray(g, np.float64)
    else:
        streams = tracer.streams()
        for t in tables:
            loss = _medium_params_loss(tracer, medium_name, t)
            g = compile_cache.jit(jax.grad(loss))(get(t), p, counter, streams)
            out[f"grad_{t}"] = np.asarray(g, np.float64)
    return out


def _probe_rng_dims(tracer) -> np.ndarray:
    """Per-lane final RNG dim counters on a small probe batch (the draw
    schedule fingerprint; see tests/test_rng_schedule.py)."""
    tracer._debug_rng = True
    try:
        p = tracer.params()
        streams = jnp.arange(RNG_DIM_PROBE, dtype=jnp.uint32)
        out = compile_cache.jit(tracer._trace_batch)(p, tracer.rng.counter_words, streams)
        return np.asarray(out[-1], np.uint32)
    finally:
        tracer._debug_rng = False


def run_config(name: str, batch: int | None = None) -> dict:
    batch = DEFAULT_BATCH[name] if batch is None else batch
    tracer, extras = CONFIGS[name](batch)
    tracers = [tracer] + extras.get("extra_tracers", [])

    # per-batch histograms: each run advances every tracer's offset by its
    # (ref-compatible) nRNGSamples, so the twin sees identical streams
    hist_runs = []
    for _ in range(N_RUNS):
        total = 0.0
        for t in tracers:
            h, _ = t.run()
            total = total + np.asarray(h, np.float64)
        hist_runs.append(total)
    hist_runs = np.stack(hist_runs)

    art: dict = {
        "hist": hist_runs.mean(0),
        "hist_runs": hist_runs,
        "rng_dims": _probe_rng_dims(tracers[0]),
    }

    # raw Philox uniforms at the config's key/offset 0 — stream identity
    for i, t in enumerate(tracers):
        probe_rng = PhiloxRNG(key=t.rng.key, offset=0)
        draws = rng_buffer(probe_rng, RNG_PROBE_STREAMS, t.nRNGSamples)
        art["rng_draws" if i == 0 else f"rng_draws_{i}"] = np.asarray(
            draws, np.float32
        )

    if "grads" in extras:
        # rebuild at offset 0 so gradients are batch-1 deterministic
        fresh, fresh_extras = CONFIGS[name](batch)
        art.update(fresh_extras["grads"](fresh))

    art["meta"] = json.dumps(
        {
            "config": name,
            "batch": batch,
            "n_runs": N_RUNS,
            "keys": [t.rng.key for t in tracers],
            "nRNGSamples": [t.nRNGSamples for t in tracers],
            "refCompatRNG": True,
            "tol": {"hist": 1e-4, "rng_draws": 2**-24, "grads": 1e-3},
        }
    )
    return art


# ---------------------------------------------------------------------------
# golden comparison
# ---------------------------------------------------------------------------


def compare(golden: dict, fresh: dict, name: str) -> list[str]:
    """Return a list of mismatch descriptions (empty = conformant)."""
    errors = []
    meta = json.loads(str(golden["meta"]))
    tol = meta["tol"]
    for key in golden:
        if key == "meta":
            continue
        if key not in fresh:
            errors.append(f"{name}: missing artifact key {key!r}")
            continue
        g, f = np.asarray(golden[key]), np.asarray(fresh[key])
        if g.shape != f.shape:
            errors.append(f"{name}.{key}: shape {f.shape} != golden {g.shape}")
            continue
        if key.startswith("rng_dims"):
            ok = np.array_equal(g, f)
            detail = "exact"
        elif key.startswith("rng_draws"):
            ok = np.allclose(g, f, rtol=0.0, atol=tol["rng_draws"])
            detail = f"atol={tol['rng_draws']:g}"
        elif key.startswith("grad_"):
            scale = np.abs(g).max() or 1.0
            ok = np.allclose(g, f, rtol=tol["grads"], atol=tol["grads"] * scale)
            detail = f"rtol={tol['grads']:g}"
        else:
            scale = np.abs(g).max() or 1.0
            ok = np.allclose(g, f, rtol=tol["hist"], atol=tol["hist"] * scale)
            detail = f"rtol={tol['hist']:g}"
        if not ok:
            delta = np.abs(g - f).max()
            errors.append(f"{name}.{key}: max|Δ|={delta:g} exceeds {detail}")
    return errors


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--write", metavar="DIR", help="write golden .npz files")
    ap.add_argument("--check", metavar="DIR", help="compare against goldens")
    ap.add_argument("--configs", nargs="*", default=list(CONFIGS))
    ap.add_argument("--batch", type=int, default=None, help="override batch size")
    args = ap.parse_args(argv)
    if not (args.write or args.check):
        ap.error("need --write or --check")

    failures = []
    for name in args.configs:
        art = run_config(name, args.batch)
        if args.write:
            out = Path(args.write) / f"{name}.npz"
            out.parent.mkdir(parents=True, exist_ok=True)
            np.savez_compressed(out, **art)
            print(f"wrote {out} ({out.stat().st_size // 1024} KiB)")
        if args.check:
            path = Path(args.check) / f"{name}.npz"
            with np.load(path, allow_pickle=False) as golden:
                errs = compare(dict(golden), art, name)
            failures.extend(errs)
            print(f"{name}: {'OK' if not errs else f'{len(errs)} MISMATCHES'}")
            for e in errs:
                print(f"  {e}")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
