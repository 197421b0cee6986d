"""Cameras: entry points for backward and direct tracing.

A camera samples rays *leaving* the detector (backward tracing) or detector
points to connect light samples to (direct tracing). Hit coordinates are
reported in the camera's object space so responses are pose-independent;
the hit position may differ from the ray origin to model lenses/housings
(reference: src/theia/camera.py:39-75, shader/camera.common.glsl,
docs/pipeline/components.md:154-157).
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from . import units as u
from .component import Component
from .ops.math3d import (
    dot,
    local_frame,
    matmul,
    matvec,
    normalize,
    perpendicular_to,
    perpendicular_to2,
    perpendicular_to_z_and,
    vec3,
)
from .ops.sampling import (
    FOUR_PI,
    TWO_PI,
    sample_direction_cone,
    sample_hemisphere,
    sample_unit_sphere,
)
from .polarization import rotation_coeffs, rotation_mueller
from .random import RNGState

__all__ = [
    "CameraRayItem",
    "PolarizedCameraRayItem",
    "CameraRaySampler",
    "CameraRay",
    "CameraSample",
    "Camera",
    "PencilCamera",
    "FlatCamera",
    "ConeCamera",
    "SphereCamera",
    "PointCamera",
    "MeshCamera",
    "HostCamera",
]


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class CameraRay:
    """Ray leaving the detector plus the detector-space hit it corresponds
    to (reference: shader/camera.common.glsl:34-47)."""

    position: jax.Array  # f32[N,3]
    direction: jax.Array  # f32[N,3]
    contrib: jax.Array  # f32[N]
    time_delta: jax.Array  # f32[N]
    hit_position: jax.Array  # f32[N,3] object space
    hit_direction: jax.Array  # f32[N,3] object space
    hit_normal: jax.Array  # f32[N,3] object space
    object_id: jax.Array  # i32[N]
    pol_ref: jax.Array | None = None  # f32[N,3]
    hit_pol_ref: jax.Array | None = None  # f32[N,3]
    # rotation mapping the world frame onto the (object-space) hit frame;
    # seeds the backward ray's accumulated Mueller matrix
    mueller: jax.Array | None = None  # f32[N,4,4]


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class CameraSample:
    """Detector point for direct connections
    (reference: shader/camera.common.glsl:8-20)."""

    position: jax.Array  # f32[N,3]
    normal: jax.Array  # f32[N,3]
    contrib: jax.Array  # f32[N]
    object_id: jax.Array  # i32[N]
    # object-space hit data for cameras whose object space differs from
    # world space (MeshCamera); None -> position/normal are already both
    obj_position: jax.Array | None = None  # f32[N,3]
    obj_normal: jax.Array | None = None  # f32[N,3]


def _ids(shape, value=-1):
    return jnp.full(shape, value, jnp.int32)


def _identity_mueller(shape):
    return jnp.broadcast_to(jnp.eye(4, dtype=jnp.float32), (*shape, 4, 4))


def _perp_host(v):
    """Host-side perpendicularTo (reference: math.glsl:58-64)."""
    v = np.asarray(v, np.float64)
    v = v / np.linalg.norm(v)
    other = (
        np.array([0.0, 1.0, 0.0]) if abs(v[1]) < 0.9 else np.array([1.0, 0.0, 0.0])
    )
    p = np.cross(v, other)
    return p / np.linalg.norm(p)


def _pol_fields(ray_dir, world_nrm, hit_dir, hit_nrm, o2w_lin=None):
    """Polarization frames for a camera ray: world reference perpendicular
    to the plane of incidence, object-space hit reference, and the Mueller
    rotation aligning the world frame with the expected hit frame
    (reference: camera.mesh.glsl sampleCameraRay POLARIZATION section;
    identical construction in the other camera shaders)."""
    hit_pol_ref = perpendicular_to2(hit_dir, hit_nrm)
    pol_ref = perpendicular_to2(ray_dir, world_nrm)
    exp = (
        hit_pol_ref
        if o2w_lin is None
        else normalize(matvec(o2w_lin, hit_pol_ref))
    )
    c, s = rotation_coeffs(-ray_dir, pol_ref, exp)
    return pol_ref, hit_pol_ref, rotation_mueller(c, s)


def _pol_fields_point(light_dir, world_nrm, hit_dir, hit_nrm, o2w_lin=None):
    """Polarization frames for a direct connection through a camera point;
    the photon travels along ``light_dir``
    (reference: camera.mesh.glsl createCameraRay POLARIZATION section)."""
    hit_pol_ref = perpendicular_to2(hit_dir, hit_nrm)
    pol_ref = perpendicular_to2(light_dir, world_nrm)
    exp = (
        hit_pol_ref
        if o2w_lin is None
        else normalize(matvec(o2w_lin, hit_pol_ref))
    )
    c, s = rotation_coeffs(light_dir, pol_ref, exp)
    return pol_ref, hit_pol_ref, rotation_mueller(c, s)


class Camera(Component):
    """Base camera (reference: src/theia/camera.py:39-75)."""

    name = "Camera"
    nRNGSamples: int = 0
    nRNGDirect: int = 0
    supportDirect: bool = False

    def sample_ray(
        self, params, wavelength, rng: RNGState
    ) -> tuple[CameraRay, RNGState]:
        raise NotImplementedError

    def sample_point(
        self, params, wavelength, rng: RNGState
    ) -> tuple[CameraSample, RNGState]:
        """sampleCamera: detector point for direct lighting."""
        raise NotImplementedError

    def ray_from_point(
        self, params, cam: CameraSample, light_dir, wavelength
    ) -> CameraRay:
        """createCameraRay(sample, lightDir): complete a direct connection."""
        raise NotImplementedError


class PencilCamera(Camera):
    """Single deterministic ray (reference: src/theia/camera.py:350-427,
    shader/camera.pencil.glsl)."""

    name = "Pencil Camera"
    nRNGSamples = 0
    _param_names = (
        "rayPosition",
        "rayDirection",
        "timeDelta",
        "hitPosition",
        "hitDirection",
        "hitNormal",
        "rayPolRef",
        "hitPolRef",
    )

    def __init__(
        self,
        *,
        rayPosition=(0.0, 0.0, 0.0),
        rayDirection=(0.0, 0.0, 1.0),
        timeDelta: float = 0.0,
        hitPosition=(0.0, 0.0, 0.0),
        hitDirection=(0.0, 0.0, -1.0),
        hitNormal=(0.0, 0.0, 1.0),
        rayPolRef=None,
        hitPolRef=None,
    ) -> None:
        self.rayPosition = rayPosition
        self.rayDirection = rayDirection
        self.timeDelta = timeDelta
        self.hitPosition = hitPosition
        self.hitDirection = hitDirection
        self.hitNormal = hitNormal
        if rayPolRef is None:
            rayPolRef = tuple(
                np.asarray(_perp_host(rayDirection), np.float32)
            )
        if hitPolRef is None:
            hitPolRef = tuple(
                np.asarray(_perp_host(hitDirection), np.float32)
            )
        self.rayPolRef = rayPolRef
        self.hitPolRef = hitPolRef

    def sample_ray(self, params, wavelength, rng: RNGState):
        shape = rng.stream.shape
        b = lambda k: jnp.broadcast_to(params[k], (*shape, 3))
        s = lambda v: jnp.broadcast_to(jnp.asarray(v, jnp.float32), shape)
        # explicit frames with identity mueller (reference: camera.pencil.glsl)
        pol_ref = normalize(b("rayPolRef"))
        hit_pol_ref = normalize(b("hitPolRef"))
        mueller = _identity_mueller(shape)
        return (
            CameraRay(
                position=b("rayPosition"),
                direction=b("rayDirection"),
                contrib=s(1.0),
                time_delta=jnp.broadcast_to(params["timeDelta"], shape),
                hit_position=b("hitPosition"),
                hit_direction=b("hitDirection"),
                hit_normal=b("hitNormal"),
                object_id=_ids(shape),
                pol_ref=pol_ref,
                hit_pol_ref=hit_pol_ref,
                mueller=mueller,
            ),
            rng,
        )


class FlatCamera(Camera):
    """Rectangular detector; local frame given by a view matrix
    (reference: src/theia/camera.py:468-577, shader/camera.flat.glsl)."""

    name = "Flat Camera"
    nRNGSamples = 4
    nRNGDirect = 2
    supportDirect = True
    _param_names = ("width", "length", "offset", "view")

    def __init__(
        self,
        *,
        width: float = 1.0 * u.cm,
        length: float = 1.0 * u.cm,
        offset=(0.0, 0.0, 0.0),
        view=None,
    ) -> None:
        self.width = width
        self.length = length
        self.offset = offset
        self.view = np.eye(3, dtype=np.float32) if view is None else np.asarray(view, np.float32)

    def _frames(self, params, shape):
        view = jnp.broadcast_to(params["view"], (*shape, 3, 3))
        obj_to_world = jnp.swapaxes(view, -1, -2)  # orthogonal inverse
        return view, obj_to_world

    def sample_ray(self, params, wavelength, rng: RNGState):
        shape = rng.stream.shape
        view, o2w = self._frames(params, shape)
        (u1, u2), rng = rng.uniform2d()
        local_pos = vec3(
            params["width"] * (u1 - 0.5),
            params["length"] * (u2 - 0.5),
            jnp.zeros_like(u1),
        )
        ray_pos = (
            matvec(o2w, local_pos) + params["offset"]
        )
        (u3, u4), rng = rng.uniform2d()
        local_dir = sample_hemisphere(u3, u4)
        cos_theta = local_dir[..., 2]
        ray_dir = matvec(o2w, local_dir)
        local_dir = -local_dir
        contrib = (
            jnp.float32(TWO_PI) * params["width"] * params["length"] * cos_theta
        )
        z = jnp.broadcast_to(jnp.asarray([0.0, 0.0, 1.0], jnp.float32), local_pos.shape)
        world_nrm = matvec(o2w, z)
        hit_pol_ref = perpendicular_to2(local_dir, z)
        pol_ref = perpendicular_to2(ray_dir, world_nrm)
        exp = matvec(o2w, hit_pol_ref)
        pc, ps = rotation_coeffs(-ray_dir, pol_ref, exp)
        return (
            CameraRay(
                position=ray_pos,
                direction=ray_dir,
                contrib=contrib,
                time_delta=jnp.zeros_like(contrib),
                hit_position=local_pos,
                hit_direction=local_dir,
                hit_normal=z,
                object_id=_ids(shape),
                pol_ref=pol_ref,
                hit_pol_ref=hit_pol_ref,
                mueller=rotation_mueller(pc, ps),
            ),
            rng,
        )

    def sample_point(self, params, wavelength, rng: RNGState):
        shape = rng.stream.shape
        view, o2w = self._frames(params, shape)
        (u1, u2), rng = rng.uniform2d()
        local_pos = vec3(
            params["width"] * (u1 - 0.5),
            params["length"] * (u2 - 0.5),
            jnp.zeros_like(u1),
        )
        pos = matvec(o2w, local_pos) + params["offset"]
        nrm = matvec(o2w,
            jnp.broadcast_to(jnp.asarray([0.0, 0.0, 1.0], jnp.float32), local_pos.shape),
        )
        contrib = jnp.broadcast_to(
            params["width"] * params["length"], shape
        )
        return CameraSample(pos, nrm, contrib, _ids(shape)), rng

    def ray_from_point(self, params, cam: CameraSample, light_dir, wavelength):
        shape = cam.contrib.shape
        view, o2w = self._frames(params, shape)
        local_pos = matvec(view, cam.position - params["offset"]
        )
        local_dir = matvec(view, light_dir)
        cos_theta = -local_dir[..., 2]
        contrib = cam.contrib * cos_theta
        contrib = contrib * (dot(cam.normal, light_dir) < 0.0).astype(jnp.float32)
        z = jnp.broadcast_to(jnp.asarray([0.0, 0.0, 1.0], jnp.float32), local_pos.shape)
        hit_pol_ref = perpendicular_to2(local_dir, z)
        pol_ref = perpendicular_to2(light_dir, cam.normal)
        exp = matvec(o2w, hit_pol_ref)
        pc, ps = rotation_coeffs(light_dir, pol_ref, exp)
        return CameraRay(
            position=cam.position,
            direction=-light_dir,
            contrib=contrib,
            time_delta=jnp.zeros_like(contrib),
            hit_position=local_pos,
            hit_direction=local_dir,
            hit_normal=z,
            object_id=cam.object_id,
            pol_ref=pol_ref,
            hit_pol_ref=hit_pol_ref,
            mueller=rotation_mueller(pc, ps),
        )


class ConeCamera(Camera):
    """Point detector accepting a cone of directions
    (reference: src/theia/camera.py:580-632, shader/camera.cone.glsl)."""

    name = "Cone Camera"
    nRNGSamples = 2
    nRNGDirect = 0
    supportDirect = True
    _param_names = ("position", "direction", "cosOpeningAngle")

    def __init__(
        self,
        *,
        position=(0.0, 0.0, 0.0),
        direction=(0.0, 0.0, 1.0),
        cosOpeningAngle: float = 1.0,
    ) -> None:
        self.position = position
        self.direction = direction
        self.cosOpeningAngle = cosOpeningAngle

    def sample_ray(self, params, wavelength, rng: RNGState):
        shape = rng.stream.shape
        (u1, u2), rng = rng.uniform2d()
        local_dir = sample_direction_cone(params["cosOpeningAngle"], u1, u2)
        axis = jnp.broadcast_to(params["direction"], (*shape, 3))
        vx, vy = local_frame(axis)
        ray_dir = (
            local_dir[..., 0:1] * vx
            + local_dir[..., 1:2] * vy
            + local_dir[..., 2:3] * axis
        )
        local_dir = -local_dir
        contrib = jnp.broadcast_to(
            jnp.float32(TWO_PI) * (1.0 - params["cosOpeningAngle"]), shape
        )
        zero = jnp.zeros((*shape, 3), jnp.float32)
        z = jnp.broadcast_to(jnp.asarray([0.0, 0.0, 1.0], jnp.float32), zero.shape)
        # reference: camera.cone.glsl:22-34 -- identity mueller, frame
        # carried from local to world by the cone's basis
        hit_pol_ref = perpendicular_to_z_and(local_dir)
        pol_ref = (
            hit_pol_ref[..., 0:1] * vx
            + hit_pol_ref[..., 1:2] * vy
            + hit_pol_ref[..., 2:3] * axis
        )
        return (
            CameraRay(
                position=jnp.broadcast_to(params["position"], (*shape, 3)),
                direction=ray_dir,
                contrib=contrib,
                time_delta=jnp.zeros(shape, jnp.float32),
                hit_position=zero,
                hit_direction=local_dir,
                hit_normal=z,
                object_id=_ids(shape),
                pol_ref=pol_ref,
                hit_pol_ref=hit_pol_ref,
                mueller=_identity_mueller(shape),
            ),
            rng,
        )

    def sample_point(self, params, wavelength, rng: RNGState):
        shape = rng.stream.shape
        return (
            CameraSample(
                position=jnp.broadcast_to(params["position"], (*shape, 3)),
                normal=jnp.broadcast_to(params["direction"], (*shape, 3)),
                contrib=jnp.ones(shape, jnp.float32),
                object_id=_ids(shape),
            ),
            rng,
        )

    def ray_from_point(self, params, cam: CameraSample, light_dir, wavelength):
        shape = cam.contrib.shape
        axis = jnp.broadcast_to(params["direction"], (*shape, 3))
        cos_angle = dot(axis, -light_dir)
        # deliberate fix over the reference: camera.cone.glsl:55 accepts
        # cosAngle >= 1-c while sampleCameraRay samples cosAngle >= c —
        # inconsistent unless c == 0.5. Accept the sampled cone.
        contrib = (cos_angle >= params["cosOpeningAngle"]).astype(jnp.float32)
        vx, vy = local_frame(axis)
        # transpose(trafo) @ lightDir
        hit_dir = jnp.stack(
            [dot(vx, light_dir), dot(vy, light_dir), dot(axis, light_dir)],
            axis=-1,
        )
        zero = jnp.zeros((*shape, 3), jnp.float32)
        z = jnp.broadcast_to(jnp.asarray([0.0, 0.0, 1.0], jnp.float32), zero.shape)
        hit_pol_ref = perpendicular_to_z_and(hit_dir)
        pol_ref = (
            hit_pol_ref[..., 0:1] * vx
            + hit_pol_ref[..., 1:2] * vy
            + hit_pol_ref[..., 2:3] * axis
        )
        return CameraRay(
            position=cam.position,
            direction=-light_dir,
            contrib=contrib,
            time_delta=jnp.zeros(shape, jnp.float32),
            hit_position=zero,
            hit_direction=hit_dir,
            hit_normal=z,
            object_id=cam.object_id,
            pol_ref=pol_ref,
            hit_pol_ref=hit_pol_ref,
            mueller=_identity_mueller(shape),
        )


class SphereCamera(Camera):
    """Spherical detector; object space is the unit sphere
    (reference: src/theia/camera.py:635-701, shader/camera.sphere.glsl)."""

    name = "Sphere Camera"
    nRNGSamples = 4
    nRNGDirect = 2
    supportDirect = True
    _param_names = ("position", "radius", "timeDelta")

    def __init__(
        self,
        *,
        position=(0.0, 0.0, 0.0),
        radius: float = 1.0 * u.m,
        timeDelta: float = 0.0,
    ) -> None:
        self.position = position
        self.radius = radius
        self.timeDelta = timeDelta

    def sample_ray(self, params, wavelength, rng: RNGState):
        shape = rng.stream.shape
        r = params["radius"]
        (u1, u2), rng = rng.uniform2d()
        normal = sample_unit_sphere(u1, u2)
        ray_pos = r * normal + jnp.broadcast_to(params["position"], normal.shape)
        (u3, u4), rng = rng.uniform2d()
        local = sample_hemisphere(u3, u4)
        cos_theta = local[..., 2]
        vx, vy = local_frame(normal)
        ray_dir = (
            local[..., 0:1] * vx + local[..., 1:2] * vy + local[..., 2:3] * normal
        )
        contrib = cos_theta * (
            jnp.float32(4.0 * np.pi * 2.0 * np.pi) * r * r
        )
        pol_ref, hit_pol_ref, mueller = _pol_fields(
            ray_dir, normal, -ray_dir, normal
        )
        return (
            CameraRay(
                position=ray_pos,
                direction=ray_dir,
                contrib=contrib,
                time_delta=jnp.broadcast_to(params["timeDelta"], shape),
                hit_position=normal,
                # object space is the unit sphere (no rotation): the local
                # incident direction is just the negated world direction
                hit_direction=-ray_dir,
                hit_normal=normal,
                object_id=_ids(shape),
                pol_ref=pol_ref,
                hit_pol_ref=hit_pol_ref,
                mueller=mueller,
            ),
            rng,
        )

    def sample_point(self, params, wavelength, rng: RNGState):
        shape = rng.stream.shape
        r = params["radius"]
        (u1, u2), rng = rng.uniform2d()
        normal = sample_unit_sphere(u1, u2)
        pos = r * normal + jnp.broadcast_to(params["position"], normal.shape)
        contrib = jnp.broadcast_to(
            jnp.float32(4.0 * np.pi) * r * r, shape
        )
        return CameraSample(pos, normal, contrib, _ids(shape)), rng

    def ray_from_point(self, params, cam: CameraSample, light_dir, wavelength):
        shape = cam.contrib.shape
        cos_theta = dot(light_dir, -cam.normal)
        contrib = cam.contrib * cos_theta
        contrib = contrib * (dot(cam.normal, light_dir) < 0.0).astype(jnp.float32)
        pol_ref, hit_pol_ref, mueller = _pol_fields_point(
            light_dir, cam.normal, light_dir, cam.normal
        )
        return CameraRay(
            position=cam.position,
            direction=-light_dir,
            contrib=contrib,
            time_delta=jnp.broadcast_to(params["timeDelta"], shape),
            hit_position=cam.normal,
            hit_direction=light_dir,
            hit_normal=cam.normal,
            object_id=cam.object_id,
            pol_ref=pol_ref,
            hit_pol_ref=hit_pol_ref,
            mueller=mueller,
        )


class MeshCamera(Camera):
    """Camera producing rays from the surface of a mesh instance
    (reference: src/theia/camera.py:746-860, shader/camera.mesh.glsl).

    Matches the reference's estimator: triangles are drawn uniformly by
    *count* (not area) and compensated via ``contrib = area * triCount``;
    points are uniform in the triangle via the (1-sqrt(u), v*sqrt(u))
    warp; directions are uniform on the hemisphere above the (optionally
    flipped) geometric normal with ``contrib *= cos_theta * 2pi``. The
    geometric normal is sign-aligned with the interpolated vertex normal.

    Note: the reference GLSL adds the translation column when taking the
    triangle edges to world space for the area factor
    (camera.mesh.glsl:52-53) — a bug for direction vectors; we apply only
    the linear part.
    """

    name = "Mesh Camera"
    nRNGSamples = 5
    nRNGDirect = 3
    supportDirect = True
    _param_names = ("timeDelta",)
    _extra_names = ("mesh", "inward")

    def __init__(
        self,
        mesh,
        *,
        timeDelta: float = 0.0,
        inward: bool = False,
    ) -> None:
        self.mesh = mesh
        self.timeDelta = timeDelta
        self.inward = inward

    def params(self):
        m = self.mesh.mesh
        idx = m.indices
        pos = m.vertices[:, :3]
        nrm = m.vertices[:, 3:6]
        v0 = pos[idx[:, 0]]
        o2w = self.mesh.transform.numpy()
        w2o = self.mesh.transform.inverse().numpy()
        return {
            "timeDelta": jnp.float32(self.timeDelta),
            "outward": jnp.float32(-1.0 if self.inward else 1.0),
            "v0": jnp.asarray(v0),
            "e1": jnp.asarray(pos[idx[:, 1]] - v0),
            "e2": jnp.asarray(pos[idx[:, 2]] - v0),
            "n0": jnp.asarray(nrm[idx[:, 0]]),
            "n1": jnp.asarray(nrm[idx[:, 1]]),
            "n2": jnp.asarray(nrm[idx[:, 2]]),
            "o2w": jnp.asarray(o2w),
            "w2o": jnp.asarray(w2o),
        }

    def _sample_surface(self, params, rng: RNGState):
        """Shared sampleCamera (3 draws): world/object point + contrib."""
        n_tri = params["v0"].shape[0]
        u1, rng = rng.uniform()
        tri = jnp.minimum(
            jnp.floor(u1 * n_tri).astype(jnp.int32), n_tri - 1
        )
        g = lambda name: jnp.take(params[name], tri, axis=0)
        v0, e1, e2 = g("v0"), g("e1"), g("e2")
        (b1, b2), rng = rng.uniform2d()
        sb = jnp.sqrt(b1)
        b1 = 1.0 - sb
        b2 = b2 * sb
        local_pos = v0 + b1[..., None] * e1 + b2[..., None] * e2
        local_nrm = normalize(jnp.cross(e1, e2))
        int_nrm = (
            g("n0")
            + b1[..., None] * (g("n1") - g("n0"))
            + b2[..., None] * (g("n2") - g("n0"))
        )
        from .ops.math3d import sign_bit

        local_nrm = local_nrm * sign_bit(dot(local_nrm, int_nrm))[..., None]
        local_nrm = local_nrm * params["outward"]

        o2w = params["o2w"]
        lin, off = o2w[:3, :3], o2w[:3, 3]
        ray_pos = matvec(lin, local_pos) + off
        # normals transform with the inverse transpose: n' = n @ w2o[:3,:3]
        ray_nrm = normalize(matmul(local_nrm, params["w2o"][:3, :3]))
        from .accel import offset_ray

        ray_pos = offset_ray(ray_pos, ray_nrm)

        we1 = matvec(lin, e1)
        we2 = matvec(lin, e2)
        area = 0.5 * jnp.sqrt(
            jnp.maximum(dot(jnp.cross(we1, we2), jnp.cross(we1, we2)), 1e-30)
        )
        contrib = area * jnp.float32(n_tri)
        return (ray_pos, ray_nrm, local_pos, local_nrm, contrib), rng

    def sample_ray(self, params, wavelength, rng: RNGState):
        shape = rng.stream.shape
        (ray_pos, ray_nrm, local_pos, local_nrm, contrib), rng = (
            self._sample_surface(params, rng)
        )
        (u3, u4), rng = rng.uniform2d()
        local = sample_hemisphere(u3, u4)
        cos_theta = local[..., 2]
        vx, vy = local_frame(local_nrm)
        local_dir = (
            local[..., 0:1] * vx + local[..., 1:2] * vy + local[..., 2:3] * local_nrm
        )
        ray_dir = normalize(matvec(params["o2w"][:3, :3], local_dir))
        contrib = contrib * cos_theta * jnp.float32(TWO_PI)
        pol_ref, hit_pol_ref, mueller = _pol_fields(
            ray_dir, ray_nrm, -local_dir, local_nrm, params["o2w"][:3, :3]
        )
        return (
            CameraRay(
                position=ray_pos,
                direction=ray_dir,
                contrib=contrib,
                time_delta=jnp.broadcast_to(params["timeDelta"], shape),
                hit_position=local_pos,
                hit_direction=-local_dir,
                hit_normal=local_nrm,
                object_id=_ids(shape),
                pol_ref=pol_ref,
                hit_pol_ref=hit_pol_ref,
                mueller=mueller,
            ),
            rng,
        )

    def sample_point(self, params, wavelength, rng: RNGState):
        shape = rng.stream.shape
        (ray_pos, ray_nrm, local_pos, local_nrm, contrib), rng = (
            self._sample_surface(params, rng)
        )
        return (
            CameraSample(
                position=ray_pos,
                normal=ray_nrm,
                contrib=contrib,
                object_id=_ids(shape),
                obj_position=local_pos,
                obj_normal=local_nrm,
            ),
            rng,
        )

    def ray_from_point(self, params, cam: CameraSample, light_dir, wavelength):
        shape = cam.contrib.shape
        cos_theta = dot(light_dir, -cam.normal)
        contrib = cam.contrib * cos_theta
        contrib = contrib * (dot(cam.normal, light_dir) < 0.0).astype(jnp.float32)
        hit_dir = matvec(params["w2o"][:3, :3], light_dir)
        pol_ref, hit_pol_ref, mueller = _pol_fields_point(
            light_dir, cam.normal, hit_dir, cam.obj_normal, params["o2w"][:3, :3]
        )
        return CameraRay(
            position=cam.position,
            direction=-light_dir,
            contrib=contrib,
            time_delta=jnp.broadcast_to(params["timeDelta"], shape),
            hit_position=cam.obj_position,
            hit_direction=hit_dir,
            hit_normal=cam.obj_normal,
            object_id=cam.object_id,
            pol_ref=pol_ref,
            hit_pol_ref=hit_pol_ref,
            mueller=mueller,
        )


class PointCamera(Camera):
    """Isotropic point detector (reference: src/theia/camera.py:702-745,
    shader/camera.point.glsl)."""

    name = "Point Camera"
    nRNGSamples = 2
    _param_names = ("position", "timeDelta")

    def __init__(self, *, position=(0.0, 0.0, 0.0), timeDelta: float = 0.0):
        self.position = position
        self.timeDelta = timeDelta

    def sample_ray(self, params, wavelength, rng: RNGState):
        shape = rng.stream.shape
        (u1, u2), rng = rng.uniform2d()
        direction = sample_unit_sphere(u1, u2)
        zero = jnp.zeros((*shape, 3), jnp.float32)
        # reference: camera.point.glsl:15-28 -- shared perpendicular frame,
        # identity mueller
        pol_ref = perpendicular_to(direction)
        return (
            CameraRay(
                position=jnp.broadcast_to(params["position"], (*shape, 3)),
                direction=direction,
                contrib=jnp.full(shape, FOUR_PI, jnp.float32),
                time_delta=jnp.broadcast_to(params["timeDelta"], shape),
                hit_position=zero,
                hit_direction=-direction,
                hit_normal=direction,
                object_id=_ids(shape),
                pol_ref=pol_ref,
                hit_pol_ref=pol_ref,
                mueller=_identity_mueller(shape),
            ),
            rng,
        )


class HostCamera(Camera):
    """Camera rays provided by the host, indexed by stream id; optional
    polarization frames with identity Mueller matrices
    (reference: src/theia/camera.py:270-349, shader/camera.queue.glsl
    CAMERA_QUEUE_POLARIZED)."""

    name = "Host Camera"
    nRNGSamples = 0
    _param_names = (
        "position",
        "direction",
        "contrib",
        "timeDelta",
        "hitPosition",
        "hitDirection",
        "hitNormal",
    )

    def __init__(
        self, position, direction, contrib, timeDelta, hitPosition,
        hitDirection, hitNormal, polRef=None, hitPolRef=None,
    ) -> None:
        self.position = np.asarray(position, np.float32)
        self.direction = np.asarray(direction, np.float32)
        self.contrib = np.asarray(contrib, np.float32)
        self.timeDelta = np.asarray(timeDelta, np.float32)
        self.hitPosition = np.asarray(hitPosition, np.float32)
        self.hitDirection = np.asarray(hitDirection, np.float32)
        self.hitNormal = np.asarray(hitNormal, np.float32)
        self.polRef = None if polRef is None else np.asarray(polRef, np.float32)
        self.hitPolRef = (
            None if hitPolRef is None else np.asarray(hitPolRef, np.float32)
        )

    def params(self):
        p = super().params()
        if self.polRef is not None:
            p["polRef"] = jnp.asarray(self.polRef)
            p["hitPolRef"] = jnp.asarray(
                self.hitPolRef if self.hitPolRef is not None else self.polRef
            )
        return p

    def sample_ray(self, params, wavelength, rng: RNGState):
        idx = rng.stream.astype(jnp.int32) % params["contrib"].shape[0]
        take = lambda k: jnp.take(params[k], idx, axis=0)
        pol_ref = hit_pol_ref = mueller = None
        if "polRef" in params:
            pol_ref = take("polRef")
            hit_pol_ref = take("hitPolRef")
            mueller = _identity_mueller(idx.shape)
        return (
            CameraRay(
                position=take("position"),
                direction=take("direction"),
                contrib=take("contrib"),
                time_delta=take("timeDelta"),
                hit_position=take("hitPosition"),
                hit_direction=take("hitDirection"),
                hit_normal=take("hitNormal"),
                object_id=_ids(idx.shape),
                pol_ref=pol_ref,
                hit_pol_ref=hit_pol_ref,
                mueller=mueller,
            ),
            rng,
        )


from .items import CameraRayItem, PolarizedCameraRayItem  # noqa: E402


def __getattr__(name):
    # the sampler lives in theia_jax.testing (which imports this module);
    # resolve lazily to mirror the reference's camera.CameraRaySampler
    if name == "CameraRaySampler":
        from .testing import CameraRaySampler

        return CameraRaySampler
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
