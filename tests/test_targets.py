"""Target and target-guide geometry tests
(model: reference tests/test_target.py / test_target_guide.py)."""

import pytest

import numpy as np

import jax.numpy as jnp

from theia_jax.random import PhiloxRNG
from theia_jax.target import (
    DiskTarget,
    DiskTargetGuide,
    FlatTarget,
    FlatTargetGuide,
    InnerSphereTarget,
    SphereTarget,
)

pytestmark = pytest.mark.core  # fast smoke tier, see pyproject markers

N = 4096


def state(n=N):
    return PhiloxRNG(key=0xC0FFEE).state(jnp.arange(n, dtype=jnp.uint32))


def obs(x, y, z, n=N):
    return jnp.broadcast_to(jnp.asarray([x, y, z], jnp.float32), (n, 3))


def test_sphere_target_sample_on_visible_cap():
    t = SphereTarget(position=(0.0, 0.0, 0.0), radius=2.0)
    observer = obs(10.0, 0.0, 0.0)
    smp, _ = t.sample(t.params(), observer, state())
    pos = np.asarray(smp.position)
    assert np.allclose(np.linalg.norm(pos, axis=-1), 2.0, atol=1e-5)
    # visible cap: x >= r^2/d
    assert pos[:, 0].min() > 2.0**2 / 10.0 - 1e-4
    # prob = 1/(2 pi r^2 (1 - cosOpening))
    cos_open = 2.0 / 10.0
    exp_prob = 1.0 / (2 * np.pi * 4.0) / (1 - cos_open)
    assert np.allclose(np.asarray(smp.prob), exp_prob, rtol=1e-5)


def test_flat_target_intersect():
    t = FlatTarget(
        width=2.0, length=4.0, position=(0.0, 0.0, 5.0), direction=(0.0, 0.0, 1.0)
    )
    p = t.params()
    observer = obs(0.3, 0.7, 0.0, 4)
    # straight up: hits the plane at z=5
    d = jnp.broadcast_to(jnp.asarray([0.0, 0.0, 1.0], jnp.float32), (4, 3))
    hit = t.intersect(p, observer, d)
    assert bool(np.asarray(hit.valid).all())
    assert np.allclose(np.asarray(hit.dist), 5.0, atol=1e-5)
    assert np.allclose(np.asarray(hit.position)[:, 2], 5.0, atol=1e-5)
    # ray normal must oppose the ray (observer below -> -z side)
    assert np.allclose(np.asarray(hit.normal)[:, 2], -1.0)
    # outside the rectangle -> miss
    observer2 = obs(3.0, 0.0, 0.0, 4)
    miss = t.intersect(p, observer2, d)
    assert not bool(np.asarray(miss.valid).any())


def test_flat_target_sample_distribution():
    t = FlatTarget(width=2.0, length=4.0, position=(1.0, 2.0, 3.0))
    smp, _ = t.sample(t.params(), obs(0.0, 0.0, 10.0), state())
    pos = np.asarray(smp.position)
    assert np.abs(pos[:, 0] - 1.0).max() <= 1.0 + 1e-5
    assert np.abs(pos[:, 1] - 2.0).max() <= 2.0 + 1e-5
    assert np.allclose(pos[:, 2], 3.0, atol=1e-5)
    assert np.allclose(np.asarray(smp.prob), 1.0 / 8.0)


def test_disk_target_sample_and_intersect():
    t = DiskTarget(radius=2.0, position=(0.0, 0.0, 1.0))
    p = t.params()
    smp, _ = t.sample(p, obs(0.0, 0.0, 5.0), state())
    pos = np.asarray(smp.position)
    r = np.linalg.norm(pos[:, :2], axis=-1)
    assert r.max() <= 2.0 + 1e-5
    assert np.allclose(np.asarray(smp.prob), 1.0 / (np.pi * 4.0))
    d = jnp.broadcast_to(jnp.asarray([0.0, 0.0, -1.0], jnp.float32), (4, 3))
    hit = t.intersect(p, obs(1.0, 0.0, 5.0, 4), d)
    assert bool(np.asarray(hit.valid).all())
    assert np.allclose(np.asarray(hit.dist), 4.0, atol=1e-5)


def test_guides_sample_eval_consistent():
    """eval() at a sampled direction must reproduce the sample's pdf."""
    for guide in (
        FlatTargetGuide(width=2.0, height=3.0, position=(0.0, 0.0, 5.0)),
        DiskTargetGuide(radius=1.5, position=(0.0, 0.0, 5.0)),
    ):
        p = guide.params()
        # guide normals are +z: the observer must be on the normal side so
        # sampled directions oppose it (the reference's wrong-side gate)
        observer = obs(0.2, -0.3, 10.0)
        smp, _ = guide.sample(p, observer, state())
        ev = guide.eval(p, observer, smp.direction)
        s_prob = np.asarray(smp.prob)
        e_prob = np.asarray(ev.prob)
        valid = s_prob > 0
        assert valid.mean() > 0.9
        assert np.allclose(e_prob[valid], s_prob[valid], rtol=1e-3)
        # distances agree (sample reports exact, eval reports plane hit)
        assert np.allclose(
            np.asarray(ev.dist)[valid], np.asarray(smp.dist)[valid], rtol=1e-4
        )
