"""Multi-host distribution (parallel.multihost).

Two real OS processes joined into one JAX multi-controller runtime
(gloo collectives on CPU), each holding 2 virtual devices, trace one
global batch — the psum'd histogram must match the plain single-process
run of the same tracer, because RNG streams are global path indices
(process-count invariance, the multi-host extension of
tests/test_parallel.py's device-count invariance).
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

BATCH = 4 * 1024


def build_tracer():
    """Deterministic tracer both the test and the workers rebuild —
    'scene build host-0 + broadcast' becomes 'every process builds the
    same tables' (SURVEY §7)."""
    from theia_jax.light import SphericalLightSource, UniformWavelengthSource
    from theia_jax.random import PhiloxRNG
    from theia_jax.response import HistogramHitResponse
    from theia_jax.target import SphereTarget
    from theia_jax.testing import WaterTestModel
    from theia_jax.trace import VolumeForwardTracer

    return VolumeForwardTracer(
        BATCH,
        SphericalLightSource(
            position=(-2.0, 0.0, 0.0), timeRange=(0.0, 0.0), budget=1e9
        ),
        SphereTarget(position=(0.0, 0.0, 0.0), radius=0.5),
        UniformWavelengthSource(lambdaRange=(400.0, 500.0)),
        HistogramHitResponse(nBins=30, t0=0.0, binSize=3.0),
        PhiloxRNG(key=0xD157),
        medium=WaterTestModel(mu_a=0.05, mu_s=0.1, g=0.4).createMedium(),
        nScattering=4,
        maxTime=90.0,
    )


@pytest.mark.slow
def test_two_process_run_matches_single(tmp_path):
    out = tmp_path / "curve.npy"
    port = 29517
    env = dict(
        os.environ,
        JAX_PLATFORMS="cpu",
        XLA_FLAGS="--xla_force_host_platform_device_count=2",
    )
    worker = Path(__file__).with_name("_multihost_worker.py")
    procs = [
        subprocess.Popen(
            [sys.executable, str(worker), str(pid), "2", str(port), str(out)],
            env=env,
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
        )
        for pid in range(2)
    ]
    logs = [p.communicate(timeout=560)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-2000:]
    multi = np.load(out)

    single, _ = build_tracer().run()
    single = np.asarray(single)
    assert single.sum() > 0
    # global stream ids -> only fp summation order may differ
    np.testing.assert_allclose(multi, single, rtol=1e-5)
