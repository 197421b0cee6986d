"""Targets: analytic detector proxies for volume tracing.

A target provides three pure functions — ``sample`` (next-event
estimation), ``intersect`` and ``occluded`` — returning a
:class:`TargetSample` wavefront pytree (reference: src/theia/target.py:37-75,
shader/target.common.glsl). Lanes carry a ``valid`` mask instead of
divergent early returns.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from . import units as u
from .component import Component
from .ops.math3d import (
    distance,
    dot,
    intersect_sphere,
    local_frame,
    matvec,
    normalize,
    sign_bit,
    vec3,
)
from .ops.sampling import sample_direction_cone, sample_unit_sphere
from .random import RNGState

__all__ = [
    "TargetSample",
    "Target",
    "SphereTarget",
    "InnerSphereTarget",
    "FlatTarget",
    "DiskTarget",
    "TargetGuideSample",
    "TargetGuide",
    "SphereTargetGuide",
    "FlatTargetGuide",
    "DiskTargetGuide",
]


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class TargetSample:
    """Sampled/intersected point on a target
    (reference: shader/target.common.glsl:4-16).

    ``offset``/``world_to_obj`` give the world->object transform as
    obj = world_to_obj @ world + offset (orthogonal part only)."""

    position: jax.Array  # f32[N,3] world space
    normal: jax.Array  # f32[N,3] world space
    dist: jax.Array  # f32[N] observer->sample distance
    obj_position: jax.Array  # f32[N,3]
    obj_normal: jax.Array  # f32[N,3]
    prob: jax.Array  # f32[N] sample probability over area
    valid: jax.Array  # bool[N]
    offset: jax.Array  # f32[N,3]
    world_to_obj: jax.Array  # f32[N,3,3]


class Target(Component):
    """Base class for targets (reference: src/theia/target.py:37-75)."""

    name = "Target"
    nRNGSamples: int = 0

    def sample(
        self, params, observer: jax.Array, rng: RNGState
    ) -> tuple[TargetSample, RNGState]:
        raise NotImplementedError

    def intersect(
        self, params, observer: jax.Array, direction: jax.Array
    ) -> TargetSample:
        raise NotImplementedError

    def occluded(self, params, position: jax.Array) -> jax.Array:
        raise NotImplementedError


def _eye3(shape) -> jax.Array:
    return jnp.broadcast_to(jnp.eye(3, dtype=jnp.float32), (*shape, 3, 3))


class SphereTarget(Target):
    """Sphere sampled via its visible cap; object space is the unit sphere
    at the origin (reference: src/theia/target.py:78-141,
    shader/target.sphere.glsl)."""

    name = "Sphere Target"
    nRNGSamples = 2
    _param_names = ("position", "radius")

    def __init__(self, *, position=(0.0, 0.0, 0.0), radius: float = 1.0 * u.m):
        self.position = position
        self.radius = radius

    def _common(self, params, shape):
        center = jnp.broadcast_to(params["position"], (*shape, 3))
        r = params["radius"]
        inv_pos = -center / r
        world_to_obj = _eye3(shape) / r
        hemi_prob = 1.0 / (2.0 * np.pi * r * r)
        return center, r, inv_pos, world_to_obj, hemi_prob

    def sample(self, params, observer, rng: RNGState):
        shape = observer.shape[:-1]
        center, r, inv_pos, w2o, hemi_prob = self._common(params, shape)
        axis = normalize(observer - center)  # center -> observer
        d = distance(observer, center)
        cos_opening = r / d
        (u1, u2), rng = rng.uniform2d()
        local = sample_direction_cone(cos_opening, u1, u2)
        vx, vy = local_frame(axis)
        normal = (
            local[..., 0:1] * vx + local[..., 1:2] * vy + local[..., 2:3] * axis
        )
        pos = normal * r + center
        prob = hemi_prob / (1.0 - cos_opening)
        valid = ~jnp.isinf(prob)
        prob = jnp.where(valid, prob, 0.0)
        return (
            TargetSample(
                position=pos,
                normal=normal,
                dist=distance(pos, observer),
                obj_position=normal,
                obj_normal=normal,
                prob=prob,
                valid=valid,
                offset=inv_pos,
                world_to_obj=w2o,
            ),
            rng,
        )

    def intersect(self, params, observer, direction):
        shape = observer.shape[:-1]
        center, r, inv_pos, w2o, hemi_prob = self._common(params, shape)
        t, _ = intersect_sphere(center, r, observer, direction)
        hit = (t > 0.0) & ~jnp.isinf(t)
        t_safe = jnp.where(hit, t, 1.0)
        pos = observer + direction * t_safe[..., None]
        nrm = normalize(pos - center)
        d = distance(observer, center)
        cos_opening = r / d
        prob = hemi_prob / (1.0 - cos_opening)
        valid = hit & ~jnp.isinf(prob)
        prob = jnp.where(valid, prob, 0.0)
        return TargetSample(
            position=pos,
            normal=nrm,
            dist=jnp.where(hit, t, jnp.inf),
            obj_position=nrm,
            obj_normal=nrm,
            prob=prob,
            valid=valid,
            offset=inv_pos,
            world_to_obj=w2o,
        )

    def occluded(self, params, position):
        center = jnp.broadcast_to(params["position"], position.shape)
        return distance(position, center) <= params["radius"]


class InnerSphereTarget(Target):
    """Sphere detected from the inside (reference: src/theia/target.py:142-201,
    shader/target.sphere.inner.glsl)."""

    name = "Inner Sphere Target"
    nRNGSamples = 2
    _param_names = ("position", "radius")

    def __init__(self, *, position=(0.0, 0.0, 0.0), radius: float = 1.0 * u.m):
        self.position = position
        self.radius = radius

    def _common(self, params, shape):
        center = jnp.broadcast_to(params["position"], (*shape, 3))
        r = params["radius"]
        inv_pos = -center / r
        world_to_obj = _eye3(shape) / r
        prob = 1.0 / (4.0 * np.pi * r * r)
        return center, r, inv_pos, world_to_obj, prob

    def sample(self, params, observer, rng: RNGState):
        shape = observer.shape[:-1]
        center, r, inv_pos, w2o, prob = self._common(params, shape)
        (u1, u2), rng = rng.uniform2d()
        normal = sample_unit_sphere(u1, u2)
        pos = r * normal + center
        return (
            TargetSample(
                position=pos,
                normal=-normal,
                dist=distance(observer, pos),
                obj_position=normal,
                obj_normal=-normal,
                prob=jnp.full(shape, prob, jnp.float32),
                valid=jnp.ones(shape, bool),
                offset=inv_pos,
                world_to_obj=w2o,
            ),
            rng,
        )

    def intersect(self, params, observer, direction):
        shape = observer.shape[:-1]
        center, r, inv_pos, w2o, prob = self._common(params, shape)
        _, t = intersect_sphere(center, r, observer, direction)  # far hit
        hit = (t > 0.0) & ~jnp.isinf(t)
        t_safe = jnp.where(hit, t, 1.0)
        pos = observer + direction * t_safe[..., None]
        nrm = normalize(center - pos)
        return TargetSample(
            position=pos,
            normal=nrm,
            dist=jnp.where(hit, t, jnp.inf),
            obj_position=-nrm,
            obj_normal=nrm,
            prob=jnp.full(shape, prob, jnp.float32),
            valid=hit,
            offset=inv_pos,
            world_to_obj=w2o,
        )

    def occluded(self, params, position):
        center = jnp.broadcast_to(params["position"], position.shape)
        return distance(position, center) >= params["radius"]


# ---------------------------------------------------------------------------
# target guides (MIS proxies for scene tracing)
# ---------------------------------------------------------------------------


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class TargetGuideSample:
    """Guide sample: direction + max trace distance + solid-angle pdf
    (reference: shader/target_guide.common.glsl:4-9)."""

    direction: jax.Array  # f32[N,3]
    dist: jax.Array  # f32[N]
    prob: jax.Array  # f32[N]


class TargetGuide(Component):
    """Base class for target guides (reference: src/theia/target.py:427-469)."""

    name = "Target Guide"
    nRNGSamples: int = 0

    def sample(self, params, observer, rng: RNGState):
        raise NotImplementedError

    def eval(self, params, observer, direction) -> TargetGuideSample:
        raise NotImplementedError


class SphereTargetGuide(TargetGuide):
    """Samples the cone subtending a sphere, weighted toward passing fully
    through it (reference: src/theia/target.py:470-527,
    shader/target_guide.sphere.glsl)."""

    name = "Sphere Target Guide"
    nRNGSamples = 2
    _param_names = ("position", "radius")

    def __init__(self, *, position=(0.0, 0.0, 0.0), radius: float = 1.0 * u.m):
        self.position = position
        self.radius = radius

    def _cone(self, params, observer):
        center = jnp.broadcast_to(params["position"], observer.shape)
        d = distance(center, observer)
        view_dir = normalize(center - observer)
        sin_max = params["radius"] / d
        sin2 = sin_max * sin_max
        cos_min = 1.0 - jnp.sqrt(jnp.maximum(1.0 - sin2, 0.0))
        # Taylor fallback for narrow cones (f32 catastrophic cancellation)
        cos_min = jnp.where(sin2 < 0.00068523, 0.5 * sin2, cos_min)
        prob = 1.0 / (2.0 * np.pi * cos_min)
        prob = prob * (d > params["radius"]).astype(jnp.float32)
        dist = d + params["radius"]
        return view_dir, cos_min, prob, dist

    def sample(self, params, observer, rng: RNGState):
        view_dir, cos_min, prob, dist = self._cone(params, observer)
        u1, rng = rng.uniform()
        u2, rng = rng.uniform()
        cos_theta = 1.0 - cos_min * u1
        sin_theta = jnp.sqrt(jnp.maximum(1.0 - cos_theta * cos_theta, 0.0))
        phi = jnp.float32(2.0 * np.pi) * u2
        vx, vy = local_frame(view_dir)
        direction = (
            (sin_theta * jnp.sin(phi))[..., None] * vx
            + (sin_theta * jnp.cos(phi))[..., None] * vy
            + cos_theta[..., None] * view_dir
        )
        return TargetGuideSample(direction, dist, prob), rng

    def eval(self, params, observer, direction) -> TargetGuideSample:
        view_dir, cos_min, prob, dist = self._cone(params, observer)
        cos_dir = dot(view_dir, direction)
        prob = prob * (cos_min >= 1.0 - cos_dir).astype(jnp.float32)
        return TargetGuideSample(direction, dist, prob)


def _orient_frame(normal, up):
    """Orthonormal obj->world columns (x, y, z=normal) from normal+up
    (reference: Transform.View)."""
    z = np.asarray(normal, np.float64)
    z = z / np.linalg.norm(z)
    upv = np.asarray(up, np.float64)
    x = np.cross(upv, z)
    if np.linalg.norm(x) < 1e-12:
        raise ValueError("normal and up may not be parallel")
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    return np.stack([x, y, z], axis=1).astype(np.float32)  # columns


class _PlanarTarget(Target):
    """Shared machinery for rect/disk planar targets
    (reference: shader/target.flat.glsl, target.disk.glsl)."""

    nRNGSamples = 2

    def _frames(self, params, shape):
        o2w = jnp.broadcast_to(params["_objToWorld"], (*shape, 3, 3))
        w2o = jnp.swapaxes(o2w, -1, -2)
        pos = jnp.broadcast_to(params["position"], (*shape, 3))
        nrm = jnp.broadcast_to(params["_normal"], (*shape, 3))
        return o2w, w2o, pos, nrm

    def _sample_local(self, params, rng):
        raise NotImplementedError

    def _inside(self, params, local_xy):
        raise NotImplementedError

    def sample(self, params, observer, rng: RNGState):
        shape = observer.shape[:-1]
        o2w, w2o, offset, base_nrm = self._frames(params, shape)
        local, rng = self._sample_local(params, rng)
        pos = matvec(o2w, local) + offset
        side = jnp.sign(dot(base_nrm, observer - pos))
        normal = base_nrm * side[..., None]
        valid = dot(normal, normal) != 0.0
        prob = jnp.broadcast_to(params["_prob"], shape)
        return (
            TargetSample(
                position=pos,
                normal=normal,
                dist=distance(observer, pos),
                obj_position=local,
                obj_normal=vec3(
                    jnp.zeros_like(side), jnp.zeros_like(side), side
                ),
                prob=prob,
                valid=valid,
                offset=-matvec(w2o, offset),
                world_to_obj=w2o,
            ),
            rng,
        )

    def intersect(self, params, observer, direction):
        shape = observer.shape[:-1]
        o2w, w2o, offset, base_nrm = self._frames(params, shape)
        local_obs = matvec(w2o, observer - offset)
        local_dir = matvec(w2o, direction)
        dz = local_dir[..., 2]
        t = -local_obs[..., 2] / jnp.where(jnp.abs(dz) > 1e-12, dz, 1e-12)
        local_pos = local_obs + t[..., None] * local_dir
        valid = (t > 0.0) & self._inside(params, local_pos)
        pos = matvec(o2w, local_pos) + offset
        side = sign_bit(local_obs[..., 2])
        normal = base_nrm * side[..., None]
        prob = jnp.broadcast_to(params["_prob"], shape) * valid.astype(
            jnp.float32
        )
        return TargetSample(
            position=pos,
            normal=normal,
            dist=jnp.where(valid, t, jnp.inf),
            obj_position=local_pos,
            obj_normal=vec3(jnp.zeros_like(side), jnp.zeros_like(side), side),
            prob=prob,
            valid=valid,
            offset=-matvec(w2o, offset),
            world_to_obj=w2o,
        )

    def occluded(self, params, position):
        return jnp.zeros(position.shape[:-1], bool)


class FlatTarget(_PlanarTarget):
    """Rectangular target (reference: src/theia/target.py:202-324)."""

    name = "Flat Target"
    _param_names = ("width", "length", "position", "_normal", "_prob", "_objToWorld")
    _extra_names = ("direction", "up")

    def __init__(
        self,
        *,
        width: float = 1.0 * u.cm,
        length: float = 1.0 * u.cm,
        position=(0.0, 0.0, 0.0),
        direction=(0.0, 0.0, 1.0),
        up=(0.0, 1.0, 0.0),
    ) -> None:
        self.width = width
        self.length = length
        self.position = position
        self.direction = direction
        self.up = up
        self.update()

    def update(self) -> None:
        m = _orient_frame(self.direction, self.up)
        self._objToWorld = m
        self._normal = m[:, 2]
        self._prob = 1.0 / (self.width * self.length)

    def params(self):
        self.update()
        return super().params()

    def _sample_local(self, params, rng):
        (u1, u2), rng = rng.uniform2d()
        return (
            vec3(
                params["width"] * (u1 - 0.5),
                params["length"] * (u2 - 0.5),
                jnp.zeros_like(u1),
            ),
            rng,
        )

    def _inside(self, params, local_pos):
        return (2.0 * jnp.abs(local_pos[..., 0]) <= params["width"]) & (
            2.0 * jnp.abs(local_pos[..., 1]) <= params["length"]
        )


class DiskTarget(_PlanarTarget):
    """Disk target (reference: src/theia/target.py:325-424)."""

    name = "Disk Target"
    _param_names = ("radius", "position", "_normal", "_prob", "_objToWorld")
    _extra_names = ("direction", "up")

    def __init__(
        self,
        *,
        radius: float = 1.0 * u.cm,
        position=(0.0, 0.0, 0.0),
        direction=(0.0, 0.0, 1.0),
        up=(0.0, 1.0, 0.0),
    ) -> None:
        self.radius = radius
        self.position = position
        self.direction = direction
        self.up = up
        self.update()

    def update(self) -> None:
        m = _orient_frame(self.direction, self.up)
        self._objToWorld = m
        self._normal = m[:, 2]
        self._prob = 1.0 / (np.pi * self.radius**2)

    def params(self):
        self.update()
        return super().params()

    def _sample_local(self, params, rng):
        from .ops.sampling import sample_unit_disk

        (u1, u2), rng = rng.uniform2d()
        return params["radius"] * sample_unit_disk(u1, u2), rng

    def _inside(self, params, local_pos):
        r2 = local_pos[..., 0] ** 2 + local_pos[..., 1] ** 2
        return r2 <= params["radius"] ** 2


def _guide_sample_from_point(observer, pos, normal, prob_area, dist=None):
    """createTargetGuideSample: area pdf -> solid-angle pdf with wrong-side
    and grazing guards (reference: shader/target_guide.common.glsl:10-32)."""
    d = pos - observer
    d2 = jnp.maximum(dot(d, d), 1e-30)
    direction = d / jnp.sqrt(d2)[..., None]
    cos_normal = dot(direction, normal)
    prob = prob_area * d2 / jnp.maximum(jnp.abs(cos_normal), 1e-30)
    prob = jnp.where(jnp.isinf(prob), 0.0, prob)
    prob = prob * (cos_normal < 0.0).astype(jnp.float32)
    if dist is None:
        dist = jnp.sqrt(d2)
    return TargetGuideSample(direction, dist, prob)


class _PlanarTargetGuide(TargetGuide):
    """Shared rect/disk guide machinery
    (reference: shader/target_guide.flat.glsl, target_guide.disk.glsl)."""

    nRNGSamples = 2

    def sample(self, params, observer, rng: RNGState):
        shape = observer.shape[:-1]
        o2w = jnp.broadcast_to(params["_objToWorld"], (*shape, 3, 3))
        offset = jnp.broadcast_to(params["position"], (*shape, 3))
        nrm = jnp.broadcast_to(params["_normal"], (*shape, 3))
        local, rng = self._sample_local(params, rng)
        pos = matvec(o2w, local) + offset
        prob = jnp.broadcast_to(params["_prob"], shape)
        return _guide_sample_from_point(observer, pos, nrm, prob), rng

    def eval(self, params, observer, direction) -> TargetGuideSample:
        shape = observer.shape[:-1]
        o2w = jnp.broadcast_to(params["_objToWorld"], (*shape, 3, 3))
        w2o = jnp.swapaxes(o2w, -1, -2)
        offset = jnp.broadcast_to(params["position"], (*shape, 3))
        nrm = jnp.broadcast_to(params["_normal"], (*shape, 3))
        local_obs = matvec(w2o, observer - offset)
        local_dir = matvec(w2o, direction)
        dz = local_dir[..., 2]
        t = -local_obs[..., 2] / jnp.where(jnp.abs(dz) > 1e-12, dz, 1e-12)
        local_pos = local_obs + t[..., None] * local_dir
        inside = (t > 0.0) & self._inside(params, local_pos)
        cos_normal = dot(direction, nrm)
        prob_area = jnp.broadcast_to(params["_prob"], shape)
        prob = prob_area * t * t / jnp.maximum(jnp.abs(cos_normal), 1e-30)
        prob = jnp.where(jnp.isinf(prob), 0.0, prob)
        prob = prob * (cos_normal < 0.0).astype(jnp.float32)
        prob = prob * inside.astype(jnp.float32)
        dist = jnp.where(inside, t, jnp.inf)
        return TargetGuideSample(direction, dist, prob)


class FlatTargetGuide(_PlanarTargetGuide):
    """Rectangular target guide (reference: src/theia/target.py:528-637)."""

    name = "Flat Target Guide"
    _param_names = ("width", "height", "position", "_normal", "_prob", "_objToWorld")
    _extra_names = ("normal", "up")

    def __init__(
        self,
        *,
        width: float = 1.0 * u.m,
        height: float = 1.0 * u.m,
        position=(0.0, 0.0, 0.0),
        normal=(0.0, 0.0, 1.0),
        up=(0.0, 1.0, 0.0),
    ) -> None:
        self.width = width
        self.height = height
        self.position = position
        self.normal = normal
        self.up = up
        self.update()

    def update(self) -> None:
        m = _orient_frame(self.normal, self.up)
        self._objToWorld = m
        self._normal = m[:, 2]
        self._prob = 1.0 / (self.width * self.height)

    def params(self):
        self.update()
        return super().params()

    def _sample_local(self, params, rng):
        (u1, u2), rng = rng.uniform2d()
        return (
            vec3(
                params["width"] * (u1 - 0.5),
                params["height"] * (u2 - 0.5),
                jnp.zeros_like(u1),
            ),
            rng,
        )

    def _inside(self, params, local_pos):
        return (2.0 * jnp.abs(local_pos[..., 0]) <= params["width"]) & (
            2.0 * jnp.abs(local_pos[..., 1]) <= params["height"]
        )


class DiskTargetGuide(_PlanarTargetGuide):
    """Disk target guide (reference: src/theia/target.py:639-736)."""

    name = "Disk Target Guide"
    _param_names = ("radius", "position", "_normal", "_prob", "_objToWorld")
    _extra_names = ("normal", "up")

    def __init__(
        self,
        *,
        radius: float = 1.0 * u.m,
        position=(0.0, 0.0, 0.0),
        normal=(0.0, 0.0, 1.0),
        up=(0.0, 1.0, 0.0),
    ) -> None:
        self.radius = radius
        self.position = position
        self.normal = normal
        self.up = up
        self.update()

    def update(self) -> None:
        m = _orient_frame(self.normal, self.up)
        self._objToWorld = m
        self._normal = m[:, 2]
        self._prob = 1.0 / (np.pi * self.radius**2)

    def params(self):
        self.update()
        return super().params()

    def _sample_local(self, params, rng):
        from .ops.sampling import sample_unit_disk

        (u1, u2), rng = rng.uniform2d()
        return params["radius"] * sample_unit_disk(u1, u2), rng

    def _inside(self, params, local_pos):
        r2 = local_pos[..., 0] ** 2 + local_pos[..., 1] ** 2
        return r2 <= params["radius"] ** 2
