"""Per-camera analytic correctness tests at reference depth
(modelled on the reference's tests/test_camera.py).

Each camera's ray mode (``sample_ray``) and direct mode (``sample_point`` +
``ray_from_point``) are validated against the closed-form contributions and
geometric invariants the reference asserts, plus polarization-frame
properties (orthonormality, plane-of-scattering alignment).
"""

import pytest

import numpy as np
import jax.numpy as jnp

from theia_jax.camera import (
    ConeCamera,
    FlatCamera,
    PencilCamera,
    PointCamera,
    SphereCamera,
)
from theia_jax.random import PhiloxRNG
from theia_jax.testing import sampleCameraPoint, sampleCameraRay

pytestmark = pytest.mark.core  # fast smoke tier, see pyproject markers

N = 32 * 1024


def _unit(v):
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _check_pol_frame(direction, pol_ref):
    # perpendicular to propagation and unit length
    assert np.abs((direction * pol_ref).sum(-1)).max() < 1e-5
    assert np.abs(np.square(pol_ref).sum(-1) - 1.0).max() < 1e-5


def _direct(camera, light_dir, n=N, rng_key=0xC0FFEE):
    """Sample points and complete direct connections with a fixed light
    direction per point."""
    lam = jnp.full(n, 450.0, jnp.float32)
    rng = PhiloxRNG(key=rng_key).state(jnp.arange(n, dtype=jnp.uint32))
    pt, rng = camera.sample_point(camera.params(), lam, rng)
    ld = jnp.broadcast_to(jnp.asarray(light_dir, jnp.float32), (n, 3))
    ray = camera.ray_from_point(camera.params(), pt, ld, lam)
    import jax

    return jax.tree.map(np.asarray, pt), jax.tree.map(np.asarray, ray)


# -- pencil ----------------------------------------------------------------


def test_pencil_camera():
    pos = (12.0, -5.0, 3.2)
    direction = _unit(np.array([1.0, -2.0, 0.4]))
    delta = 12.5
    hit_pos = (0.3, 0.2, 0.1)
    hit_dir = _unit(np.array([0.0, 0.36, -0.48]))
    hit_nrm = _unit(np.array([0.6, 0.0, 0.8]))
    cam = PencilCamera(
        rayPosition=pos,
        rayDirection=tuple(direction),
        timeDelta=delta,
        hitPosition=hit_pos,
        hitDirection=tuple(hit_dir),
        hitNormal=tuple(hit_nrm),
    )
    rays = sampleCameraRay(cam, 256)
    assert np.allclose(rays.position, pos)
    assert np.allclose(rays.direction, direction)
    assert np.allclose(rays.contrib, 1.0)
    assert np.allclose(rays.time_delta, delta)
    assert np.allclose(rays.hit_position, hit_pos)
    assert np.allclose(rays.hit_direction, hit_dir)
    assert np.allclose(rays.hit_normal, hit_nrm)
    _check_pol_frame(rays.direction, rays.pol_ref)
    _check_pol_frame(rays.hit_direction, rays.hit_pol_ref)


# -- flat ------------------------------------------------------------------


def _rot(axis, angle):
    axis = _unit(np.asarray(axis, np.float64))
    c, s = np.cos(angle), np.sin(angle)
    K = np.array(
        [
            [0, -axis[2], axis[1]],
            [axis[2], 0, -axis[0]],
            [-axis[1], axis[0], 0],
        ]
    )
    return np.eye(3) + s * K + (1 - c) * (K @ K)


def test_flat_camera_ray_mode():
    width, length = 0.8, 0.6
    offset = (4.0, -2.0, 1.0)
    o2w = _rot((0.2, 1.0, -0.5), 0.7)  # object -> world
    view = o2w.T  # camera stores world -> object
    cam = FlatCamera(width=width, length=length, offset=offset, view=view)
    rays = sampleCameraRay(cam, N)

    # hit positions cover the local rectangle uniformly
    hp = rays.hit_position
    assert np.abs(hp[:, :2].min(0) + (width / 2, length / 2)).max() < 5e-3
    assert np.abs(hp[:, :2].max(0) - (width / 2, length / 2)).max() < 5e-3
    assert np.abs(hp[:, :2].mean(0)).max() < 5e-3
    assert np.all(hp[:, 2] == 0.0)
    # world position is the transformed local position
    assert np.abs(hp @ o2w.T + offset - rays.position).max() < 1e-5
    # hit dir is the local inverse of the world direction
    assert np.abs(rays.hit_direction @ o2w.T + rays.direction).max() < 1e-5
    assert rays.hit_direction[:, 2].max() <= 0.0
    assert np.allclose(rays.hit_normal, (0.0, 0.0, 1.0))
    # contrib = area * 2pi * cos(theta) (reference test_camera.py:153)
    world_nrm = o2w @ np.array([0.0, 0.0, 1.0])
    cos_n = (rays.direction * world_nrm).sum(-1)
    assert (
        np.abs(rays.contrib - width * length * 2.0 * np.pi * cos_n).max()
        < 1e-5  # float32 accumulation
    )
    assert np.allclose(rays.time_delta, 0.0)
    _check_pol_frame(rays.direction, rays.pol_ref)
    _check_pol_frame(rays.hit_direction, rays.hit_pol_ref)


def test_flat_camera_direct_mode():
    width, length = 0.8, 0.6
    offset = (4.0, -2.0, 1.0)
    o2w = _rot((1.0, 0.3, 0.2), -0.4)
    cam = FlatCamera(width=width, length=length, offset=offset, view=o2w.T)
    world_nrm = o2w @ np.array([0.0, 0.0, 1.0])
    light_dir = _unit(-world_nrm + 0.3 * _unit(np.array([1.0, 0.0, 0.0])))
    pt, ray = _direct(cam, light_dir)

    assert np.allclose(pt.contrib, width * length)
    assert np.abs(_unit(pt.normal) - world_nrm).max() < 1e-5
    assert np.all(ray.position == pt.position)
    assert np.allclose(ray.direction, -light_dir, atol=1e-6)
    # rayContrib = area * cos(theta), front side only
    cos_t = -(light_dir * world_nrm).sum(-1)
    assert cos_t > 0
    assert np.allclose(ray.contrib, width * length * cos_t, rtol=1e-5)
    # back-side light is rejected
    _, ray_back = _direct(cam, -light_dir)
    assert np.all(ray_back.contrib == 0.0)


# -- cone ------------------------------------------------------------------


def test_cone_camera_ray_mode():
    pos = (-8.0, 5.4, 3.0)
    axis = (0.36, 0.48, 0.80)
    c = 0.12
    cam = ConeCamera(position=pos, direction=axis, cosOpeningAngle=c)
    rays = sampleCameraRay(cam, N)
    assert np.allclose(rays.position, pos)
    assert np.abs(np.square(rays.direction).sum(-1) - 1.0).max() < 1e-5
    cos_a = (rays.direction * np.asarray(axis)).sum(-1)
    assert cos_a.min() >= c - 1e-6
    # MC solid angle of the sampled directions == 2pi(1-c)
    assert np.allclose(rays.contrib, 2.0 * np.pi * (1.0 - c))
    assert np.allclose(rays.hit_position, 0.0)
    assert rays.hit_direction[:, 2].max() <= -c + 1e-6
    assert np.allclose(rays.hit_normal, (0.0, 0.0, 1.0))
    _check_pol_frame(rays.direction, rays.pol_ref)
    # polRef perpendicular to the plane spanned by axis and direction
    inc = np.cross(np.asarray(axis)[None, :], rays.direction)
    inc = _unit(inc)
    assert np.abs(np.abs((rays.pol_ref * inc).sum(-1)) - 1.0).max() < 1e-4


def test_cone_camera_direct_consistent_with_sampling():
    """Direct mode accepts exactly the cone that ray mode samples — the
    deliberate fix of camera.cone.glsl:55 (which uses >= 1-c)."""
    axis = _unit(np.array([0.2, -0.4, 0.89]))
    c = 0.3
    cam = ConeCamera(position=(1.0, 2.0, 3.0), direction=tuple(axis), cosOpeningAngle=c)
    # light directions on a fine sphere grid: acceptance must match cos >= c
    n = 4096
    rng = np.random.default_rng(5)
    dirs = _unit(rng.normal(size=(n, 3)))
    lam = jnp.full(n, 450.0, jnp.float32)
    st = PhiloxRNG(key=1).state(jnp.arange(n, dtype=jnp.uint32))
    pt, _ = cam.sample_point(cam.params(), lam, st)
    ray = cam.ray_from_point(
        cam.params(), pt, jnp.asarray(dirs, jnp.float32), lam
    )
    accepted = np.asarray(ray.contrib) > 0.0
    expect = (-dirs @ axis) >= c
    assert (accepted == expect).mean() > 0.999


# -- sphere ----------------------------------------------------------------


def test_sphere_camera_ray_mode():
    position = (12.0, 5.0, -7.0)
    radius = 4.0
    t0 = 12.5
    cam = SphereCamera(position=position, radius=radius, timeDelta=t0)
    rays = sampleCameraRay(cam, N)
    d = np.sqrt(np.square(rays.position - position).sum(-1))
    assert np.abs(d - radius).max() < 1e-4
    # hit position is the unit-sphere normal (object space)
    assert np.abs(rays.hit_position.mean(0)).max() < 0.02
    assert np.abs(rays.hit_position.var(0) - 1 / 3).max() < 0.02
    assert (
        np.abs(rays.hit_position * radius + position - rays.position).max()
        < 1e-4
    )
    assert np.allclose(rays.time_delta, t0)
    cos_n = np.abs((rays.hit_direction * rays.hit_normal).sum(-1))
    contrib = 4.0 * np.pi * radius**2 * 2.0 * np.pi * cos_n
    assert np.abs(rays.contrib - contrib).max() < 5e-3  # float32
    _check_pol_frame(rays.direction, rays.pol_ref)
    _check_pol_frame(rays.hit_direction, rays.hit_pol_ref)


def test_sphere_camera_direct_mode():
    position = (12.0, 5.0, -7.0)
    radius = 4.0
    cam = SphereCamera(position=position, radius=radius, timeDelta=3.0)
    light_dir = _unit(np.array([0.0, -1.0, 0.25]))
    pt, ray = _direct(cam, light_dir)
    d = np.sqrt(np.square(pt.position - position).sum(-1))
    assert np.abs(d - radius).max() < 1e-4
    assert np.allclose(pt.contrib, 4.0 * np.pi * radius**2, rtol=1e-6)
    cos_n = -(pt.normal * light_dir).sum(-1)
    mask = cos_n > 0
    expect = 4.0 * np.pi * radius**2 * cos_n * mask
    assert np.abs(ray.contrib - expect).max() < 1e-2
    assert np.allclose(ray.direction, -light_dir, atol=1e-6)
    assert np.allclose(ray.time_delta, 3.0)


def test_sphere_camera_importance_matches_area_integral():
    """MC check of the direct estimator: integrating a constant unit
    radiance field over the sphere camera yields area * pi (the cosine-
    weighted hemisphere integral), matching the ray-mode estimator."""
    radius = 2.0
    cam = SphereCamera(position=(0.0, 0.0, 0.0), radius=radius)
    # ray mode: E[contrib/(2pi cos)] over cosine... integrate unit radiance:
    # estimator = mean(contrib) / (4pi * 2pi) per (area x solid angle)
    rays = sampleCameraRay(cam, N)
    est_ray = rays.contrib.mean()
    # direct mode with uniformly random light directions
    rng = np.random.default_rng(11)
    dirs = _unit(rng.normal(size=(N, 3)))
    lam = jnp.full(N, 450.0, jnp.float32)
    st = PhiloxRNG(key=3).state(jnp.arange(N, dtype=jnp.uint32))
    pt, _ = cam.sample_point(cam.params(), lam, st)
    ray = cam.ray_from_point(cam.params(), pt, jnp.asarray(dirs, jnp.float32), lam)
    # uniform-sphere pdf 1/(4pi) -> multiply by 4pi to integrate direction;
    # both then estimate the unit-radiance flux: area * pi
    est_direct = np.asarray(ray.contrib).mean() * 4.0 * np.pi
    area_pi = 4.0 * np.pi * radius**2 * np.pi
    assert np.abs(est_direct / est_ray - 1.0) < 0.05
    assert np.abs(est_ray / area_pi - 1.0) < 0.02


# -- point -----------------------------------------------------------------


def test_point_camera():
    pos = (1.0, -2.0, 0.5)
    cam = PointCamera(position=pos, timeDelta=7.0)
    rays = sampleCameraRay(cam, N)
    assert np.allclose(rays.position, pos)
    assert np.allclose(rays.contrib, 4.0 * np.pi)
    assert np.allclose(rays.time_delta, 7.0)
    assert np.abs(np.square(rays.direction).sum(-1) - 1.0).max() < 1e-5
    # isotropic: mean direction ~ 0, variance ~ 1/3 per axis
    assert np.abs(rays.direction.mean(0)).max() < 0.02
    assert np.abs(rays.direction.var(0) - 1 / 3).max() < 0.02
    assert np.allclose(rays.hit_direction, -rays.direction)
    _check_pol_frame(rays.direction, rays.pol_ref)


def test_point_sampler_queue():
    pts = sampleCameraPoint(SphereCamera(position=(0, 0, 0), radius=1.0), 512)
    assert pts.position.shape == (512, 3)
    assert np.abs(np.square(pts.normal).sum(-1) - 1.0).max() < 1e-5
