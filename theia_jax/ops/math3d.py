"""3D vector math on arrays with a trailing component axis.

Vectors are ``f32[..., 3]``; all functions broadcast over leading axes so the
same code runs per-lane over a whole photon wavefront. Semantics follow the
reference's GLSL math library (reference: src/theia/shader/math.glsl:17-94,
math.sphere.glsl:11-45).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = [
    "vec3",
    "dot",
    "cross",
    "norm",
    "normalize",
    "distance",
    "sign_bit",
    "local_frame",
    "perpendicular_to",
    "perpendicular_to2",
    "perpendicular_to_z_and",
    "intersect_sphere",
    "matmul",
    "matvec",
    "moeller_trumbore_rowwise",
]

INF = jnp.float32(jnp.inf)

# Every matrix product of the tracers (frame transforms, Mueller/Stokes
# transport) runs at full float32 precision: left at the default, XLA:GPU
# may execute a float32 product in TF32 (a 10-bit mantissa), which moves
# hit positions and self-intersection offsets.
HIGHEST = jax.lax.Precision.HIGHEST


def matvec(m, v):
    """Batched matrix-vector product ``m @ v`` over leading axes."""
    return jnp.einsum("...ij,...j->...i", m, v, precision=HIGHEST)


def matmul(a, b):
    """``a @ b`` at full float32 precision."""
    return jnp.matmul(a, b, precision=HIGHEST)


def vec3(x, y, z) -> jax.Array:
    return jnp.stack(
        jnp.broadcast_arrays(
            jnp.asarray(x, jnp.float32),
            jnp.asarray(y, jnp.float32),
            jnp.asarray(z, jnp.float32),
        ),
        axis=-1,
    )


def dot(a: jax.Array, b: jax.Array) -> jax.Array:
    return jnp.sum(a * b, axis=-1)


def cross(a: jax.Array, b: jax.Array) -> jax.Array:
    return jnp.cross(a, b)


def norm(a: jax.Array) -> jax.Array:
    # the eps floor keeps norm/normalize finite (0/0 = NaN on masked dead
    # lanes otherwise) and the sqrt VJP finite at a == 0; must be a NORMAL
    # float32 — XLA flushes subnormals like 1e-38 to zero. Primal error
    # <= 1e-15, far below float32 noise on any real distance.
    return jnp.sqrt(jnp.maximum(dot(a, a), jnp.float32(1e-30)))


def normalize(a: jax.Array) -> jax.Array:
    return a / norm(a)[..., None]


def distance(a: jax.Array, b: jax.Array) -> jax.Array:
    return norm(a - b)


def sign_bit(f: jax.Array) -> jax.Array:
    """+-1.0 from the sign bit; maps +-0.0 to +-1.0 (unlike ``jnp.sign``)."""
    f = jnp.asarray(f, jnp.float32)
    bits = (f.view(jnp.uint32) & jnp.uint32(0x80000000)) | jnp.uint32(0x3F800000)
    return bits.view(jnp.float32)


def local_frame(vz: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Branchless orthonormal basis completion (Duff et al. / PBRT 3.3.3).

    Returns (vx, vy) such that (vx, vy, vz) is a right-handed orthonormal
    frame; matches the reference's ``createLocalCOSY``."""
    z = vz[..., 2]
    s = sign_bit(z)
    a = -1.0 / (s + z)
    b = vz[..., 0] * vz[..., 1] * a
    vx = vec3(
        1.0 + s * vz[..., 0] * vz[..., 0] * a,
        s * b,
        -s * vz[..., 0],
    )
    vy = vec3(b, s + vz[..., 1] * vz[..., 1] * a, -vz[..., 1])
    return normalize(vx), normalize(vy)


def perpendicular_to(v: jax.Array) -> jax.Array:
    """A unit vector normal to unit vector v (the frame's vy)."""
    s = sign_bit(v[..., 2])
    a = -1.0 / (s + v[..., 2])
    b = v[..., 0] * v[..., 1] * a
    return vec3(b, s + v[..., 1] * v[..., 1] * a, -v[..., 1])


def perpendicular_to2(a: jax.Array, b: jax.Array) -> jax.Array:
    """Unit vector normal to both a and b; falls back to a vector
    perpendicular to a when they are (nearly) parallel."""
    c = cross(a, b)
    length = norm(c)
    degenerate = length < 1e-5
    safe = c / jnp.maximum(length, jnp.float32(1e-20))[..., None]
    return jnp.where(degenerate[..., None], perpendicular_to(a), safe)


def perpendicular_to_z_and(a: jax.Array) -> jax.Array:
    """Unit vector normal to both a and the z axis (x-axis fallback)."""
    b = vec3(a[..., 1], -a[..., 0], jnp.zeros_like(a[..., 0]))
    length = norm(b)
    degenerate = length < 1e-5
    safe = b / jnp.maximum(length, jnp.float32(1e-20))[..., None]
    x_axis = jnp.broadcast_to(jnp.array([1.0, 0.0, 0.0], jnp.float32), a.shape)
    return jnp.where(degenerate[..., None], x_axis, safe)


def intersect_sphere(
    center: jax.Array, radius, origin: jax.Array, direction: jax.Array
) -> tuple[jax.Array, jax.Array]:
    """Robust ray/sphere intersection ("Ray Tracing Gems" ch. 7).

    Returns (t_near, t_far), both +inf on miss; t_near <= t_far."""
    f = origin - center
    b2 = dot(f, direction)
    r2 = jnp.square(jnp.asarray(radius, jnp.float32))
    fd = f - b2[..., None] * direction
    discr = r2 - dot(fd, fd)
    c = dot(f, f) - r2
    sqrt_d = jnp.sqrt(jnp.maximum(discr, 0.0))
    q = -b2 - sign_bit(b2) * sqrt_d
    t1 = c / q
    t2 = q
    t_near = jnp.minimum(t1, t2)
    t_far = jnp.maximum(t1, t2)
    miss = discr < 0.0
    return jnp.where(miss, INF, t_near), jnp.where(miss, INF, t_far)


def moeller_trumbore_rowwise(origin, direction, v0, e1, e2):
    """Row-wise Moeller-Trumbore: one (N,)-lane ray against one (N,)-lane
    triangle (v0, e1, e2). Returns (b1, b2, t, inv) with ``inv = 0`` for
    degenerate (|det| <= 1e-12) pairs — callers gate hits on ``inv != 0``
    and their own barycentric/t tolerances.

    This is the single normative formulation; the chunked scan in
    accel._nearest_triangle and the Pallas kernels restate the same
    arithmetic in their own layouts (and must keep the 1e-12 degeneracy /
    -1e-6 barycentric tolerances in sync with it)."""
    px = direction[:, 1] * e2[:, 2] - direction[:, 2] * e2[:, 1]
    py = direction[:, 2] * e2[:, 0] - direction[:, 0] * e2[:, 2]
    pz = direction[:, 0] * e2[:, 1] - direction[:, 1] * e2[:, 0]
    det = e1[:, 0] * px + e1[:, 1] * py + e1[:, 2] * pz
    inv = jnp.where(jnp.abs(det) > 1e-12, 1.0 / det, 0.0)
    tx = origin[:, 0] - v0[:, 0]
    ty = origin[:, 1] - v0[:, 1]
    tz = origin[:, 2] - v0[:, 2]
    b1 = (tx * px + ty * py + tz * pz) * inv
    qx = ty * e1[:, 2] - tz * e1[:, 1]
    qy = tz * e1[:, 0] - tx * e1[:, 2]
    qz = tx * e1[:, 1] - ty * e1[:, 0]
    b2 = (direction[:, 0] * qx + direction[:, 1] * qy + direction[:, 2] * qz) * inv
    t = (e2[:, 0] * qx + e2[:, 1] * qy + e2[:, 2] * qz) * inv
    return b1, b2, t, inv
