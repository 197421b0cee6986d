"""Matrix products and histograms keep full float32 precision.

On a GPU, XLA may run a float32 product left at default precision in TF32
(a 10-bit mantissa). A CPU computes it exactly either way, so the CPU
tests check what the program asks for (every product in a traced tracer
step carries ``HIGHEST``); the histogram tests compare its scatter-add
with a float64 reference, on the CPU and (``gpu``) on the card.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from chip_smoke import count_dots
from theia_jax.response import HistogramHitResponse
from theia_jax.trace.core import HitItem


def _bench_scene_tracer(polarized):
    import __graft_entry__ as entry

    return entry._build_scene_tracer(256, max_path=3, polarized=polarized)


def _scene_backward_tracer():
    from theia_jax.camera import SphereCamera
    from theia_jax.light import SphericalLightSource, UniformWavelengthSource
    from theia_jax.random import PhiloxRNG
    from theia_jax.trace.scene_backward import SceneBackwardTracer

    scene = _bench_scene_tracer(False).scene
    return SceneBackwardTracer(
        256,
        SphericalLightSource(position=(3.0, 0.0, 0.0), timeRange=(0.0, 0.0), budget=1e5),
        SphereCamera(position=(0.0, 3.0, 0.0), radius=0.6),
        UniformWavelengthSource(lambdaRange=(450.0, 450.0)),
        HistogramHitResponse(nBins=20, binSize=5.0, t0=0.0),
        PhiloxRNG(key=1),
        scene,
        maxPathLength=3,
        scatterCoefficient=0.05,
        polarized=True,
    )


@pytest.mark.parametrize(
    "build",
    [
        lambda: _bench_scene_tracer(False),
        lambda: _bench_scene_tracer(True),
        _scene_backward_tracer,
    ],
    ids=["scene_forward", "scene_forward_polarized", "scene_backward_polarized"],
)
def test_every_traced_product_is_highest(build):
    """Frame transforms, Mueller/Stokes products and the histogram sum."""
    fn, args = build().trace_fn()
    n_dots, n_highest = count_dots(jax.jit(fn).lower(*args).as_text())
    assert n_dots > 0
    assert n_highest == n_dots


def _record(response, bins_time, values, object_id, device=None):
    """One HistogramHitResponse.record call over the given hits."""
    n = len(values)
    item = HitItem(
        position=jnp.zeros((n, 3)),
        direction=jnp.zeros((n, 3)),
        normal=jnp.zeros((n, 3)),
        wavelength=jnp.full((n,), 400.0),
        time=jnp.asarray(bins_time, jnp.float32),
        contrib=jnp.asarray(values, jnp.float32),
        object_id=jnp.asarray(object_id, jnp.int32),
    )
    params = response.params()
    args = (params, response.init(), item, jnp.ones(n, bool))
    if device is not None:
        args = jax.device_put(args, device)
    f = jax.jit(lambda p, s, i, m: response.record(p, s, i, m, None)[0])
    return np.asarray(f(*args))


def _hits(n_bins, n_det, n=200_000, seed=0):
    rng = np.random.default_rng(seed)
    # some hits land before t0, after the last bin or on foreign detectors
    time = rng.uniform(-5.0, (n_bins + 5) * 2.0, n)
    values = rng.lognormal(0.0, 1.0, n)
    det = rng.integers(-1, (n_det or 1) + 1, n)
    return time, values, det


def _reference(time, values, det, n_bins, n_det):
    # bin on the float32 times the tracer records
    b = np.floor(time.astype(np.float32) / np.float32(2.0)).astype(np.int64)
    keep = (b >= 0) & (b < n_bins)
    if n_det is not None:
        keep &= (det >= 0) & (det < n_det)
        b = b + det * n_bins
    out = np.zeros(n_bins * (n_det or 1))
    np.add.at(out, b[keep], values.astype(np.float32)[keep].astype(np.float64))
    return out


# float32 accumulation of ~10^4 lognormal values per bin: a few ulps of
# the bin's total (TF32 would miss by ~1e-3)
F32_RTOL = 1e-5


@pytest.mark.parametrize("n_bins,n_det", [(100, None), (40, 8), (2000, None)])
def test_histogram_record_matches_float64(n_bins, n_det):
    time, values, det = _hits(n_bins, n_det)
    response = HistogramHitResponse(nBins=n_bins, t0=0.0, binSize=2.0, nDetectors=n_det)
    got = _record(response, time, values, det).reshape(-1)
    want = _reference(time, values, det, n_bins, n_det)
    np.testing.assert_allclose(got, want, rtol=F32_RTOL, atol=F32_RTOL * want.max())


@pytest.mark.gpu
@pytest.mark.parametrize("n_bins,n_det", [(100, None), (40, 8)])
def test_histogram_record_matches_float64_on_gpu(gpu_device, n_bins, n_det):
    time, values, det = _hits(n_bins, n_det, n=524_288)
    response = HistogramHitResponse(nBins=n_bins, t0=0.0, binSize=2.0, nDetectors=n_det)
    got = _record(response, time, values, det, device=gpu_device).reshape(-1)
    want = _reference(time, values, det, n_bins, n_det)
    np.testing.assert_allclose(got, want, rtol=F32_RTOL, atol=F32_RTOL * want.max())
