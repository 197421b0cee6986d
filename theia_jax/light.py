"""Wavelength and light sources.

Each source contributes a pure sampling function consuming the per-lane
:class:`~theia_jax.random.RNGState`; draw counts (``nRNG*``) are normative
and match the reference so identical Philox streams produce identical
simulations (reference: src/theia/light.py, shader/lightsource.*.glsl,
shader/wavelengthsource.*.glsl).
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
from jax import lax
import numpy as np

from . import units as u
from .component import Component
from .material import MediumConstants
from .ops.math3d import distance, dot, local_frame, matvec, normalize, vec3
from .ops.sampling import TWO_PI, sample_unit_sphere, spherical_to_cartesian
from .random import RNGState

__all__ = [
    "WavelengthSampleItem",
    "LightSampleItem",
    "PolarizedLightSampleItem",
    "LightSampler",
    "WavelengthSource",
    "ConstWavelengthSource",
    "UniformWavelengthSource",
    "HostWavelengthSource",
    "LightSource",
    "SphericalLightSource",
    "PencilLightSource",
    "ConeLightSource",
    "HostLightSource",
    "SourceRay",
    "dw_dA",
]


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class SourceRay:
    """Light-source sample (reference: shader/lightsource.common.glsl:11-46).
    ``stokes``/``pol_ref`` are None for unpolarized sources."""

    position: jax.Array  # f32[N,3]
    direction: jax.Array  # f32[N,3]
    start_time: jax.Array  # f32[N]
    contrib: jax.Array  # f32[N]
    stokes: jax.Array | None = None  # f32[N,4]
    pol_ref: jax.Array | None = None  # f32[N,3]


def dw_dA(observer: jax.Array, target: jax.Array, normal: jax.Array | None):
    """Jacobian converting an area integral to a solid-angle integral:
    dw = |cos|/r^2 dA (reference: lightsource.common.glsl:40-56).
    ``normal=None`` (or the zero vector) marks a volume point (cos = 1)."""
    direction = target - observer
    r2 = dot(direction, direction)
    if normal is None:
        cos_nrm = 1.0
    else:
        d = normalize(direction)
        is_zero = dot(normal, normal) == 0.0
        cos_nrm = jnp.where(is_zero, 1.0, jnp.abs(dot(d, normal)))
    return cos_nrm / r2


# ---------------------------------------------------------------------------
# wavelength sources
# ---------------------------------------------------------------------------


class WavelengthSource(Component):
    """Base class for wavelength samplers (reference: src/theia/light.py:58-78)."""

    name = "Wavelength Source"
    nRNGSamples: int = 0

    def sample(self, params, rng: RNGState) -> tuple[tuple, RNGState]:
        """Returns ((wavelength, contrib), advanced rng)."""
        raise NotImplementedError


class ConstWavelengthSource(WavelengthSource):
    """Monochromatic source (reference: src/theia/light.py:258-283)."""

    name = "Const Wavelength Source"
    nRNGSamples = 0
    _param_names = ("wavelength",)

    def __init__(self, wavelength: float = 600.0 * u.nm) -> None:
        self.wavelength = wavelength

    def sample(self, params, rng: RNGState):
        lam = jnp.broadcast_to(params["wavelength"], rng.stream.shape)
        return (lam, jnp.ones_like(lam)), rng


class UniformWavelengthSource(WavelengthSource):
    """Uniform wavelength in [lam_min, lam_max]; contribution 1 when
    normalized else the range width (reference: src/theia/light.py:286-348,
    shader/wavelengthsource.uniform.glsl)."""

    name = "Uniform Wavelength Source"
    nRNGSamples = 1
    _param_names = ("lambdaRange", "_contrib")
    _extra_names = ("normalize",)

    def __init__(
        self,
        *,
        lambdaRange: tuple[float, float] = (300.0, 700.0),
        normalize: bool = True,
    ) -> None:
        self.lambdaRange = lambdaRange
        self.normalize = normalize
        self._contrib = 1.0

    def update(self) -> None:
        lr = self.lambdaRange[1] - self.lambdaRange[0]
        self._contrib = abs(lr) if (lr != 0.0 and not self.normalize) else 1.0

    def params(self):
        self.update()
        return super().params()

    def sample(self, params, rng: RNGState):
        uu, rng = rng.uniform()
        lo, hi = params["lambdaRange"][0], params["lambdaRange"][1]
        lam = lo * (1.0 - uu) + hi * uu
        contrib = jnp.broadcast_to(params["_contrib"], lam.shape)
        return (lam, contrib), rng


class HostWavelengthSource(WavelengthSource):
    """Samples provided by the host as arrays indexed by the lane's stream id
    (reference: src/theia/light.py:87-257)."""

    name = "Host Wavelength Source"
    nRNGSamples = 0
    _param_names = ("wavelength", "contrib")

    def __init__(self, wavelength, contrib=None) -> None:
        self.wavelength = np.asarray(wavelength, np.float32)
        self.contrib = (
            np.ones_like(self.wavelength)
            if contrib is None
            else np.asarray(contrib, np.float32)
        )

    def sample(self, params, rng: RNGState):
        idx = rng.stream.astype(jnp.int32) % params["wavelength"].shape[0]
        return (
            (jnp.take(params["wavelength"], idx), jnp.take(params["contrib"], idx)),
            rng,
        )


# ---------------------------------------------------------------------------
# light sources
# ---------------------------------------------------------------------------


class LightSource(Component):
    """Base class for light sources (reference: src/theia/light.py:417-460)."""

    name = "Light Source"
    supportForward: bool = False
    supportBackward: bool = False
    nRNGForward: int = 0
    nRNGBackward: int = 0

    def sample_forward(
        self, params, wavelength, constants: MediumConstants, rng: RNGState
    ) -> tuple[SourceRay, RNGState]:
        raise NotImplementedError

    def sample_backward(
        self,
        params,
        observer,
        normal,
        wavelength,
        constants: MediumConstants,
        rng: RNGState,
    ) -> tuple[SourceRay, RNGState]:
        raise NotImplementedError


class SphericalLightSource(LightSource):
    """Isotropic unpolarized point source distributing ``budget`` photons/
    energy (reference: src/theia/light.py:1105-1180,
    shader/lightsource.spherical.glsl)."""

    name = "Spherical Light Source"
    supportForward = True
    supportBackward = True
    nRNGForward = 3
    nRNGBackward = 1
    _param_names = ("position", "timeRange", "_contribFwd", "_contribBwd")
    _extra_names = ("budget",)

    def __init__(
        self,
        *,
        position=(0.0, 0.0, 0.0),
        timeRange=(0.0, 100.0),
        budget: float = 1.0,
    ) -> None:
        self.position = position
        self.timeRange = timeRange
        self.budget = budget
        self._contribFwd = budget
        self._contribBwd = budget / (4.0 * np.pi)

    def update(self) -> None:
        self._contribFwd = self.budget
        # forward: the 4pi parameter volume cancels with the sampling prob
        self._contribBwd = self.budget / (4.0 * np.pi)

    def params(self):
        self.update()
        return super().params()

    def sample_forward(self, params, wavelength, constants, rng: RNGState):
        (u1, u2), rng = rng.uniform2d()
        direction = sample_unit_sphere(u1, u2)
        v, rng = rng.uniform()
        t0, t1 = params["timeRange"][0], params["timeRange"][1]
        start = t0 * (1.0 - v) + t1 * v
        pos = jnp.broadcast_to(params["position"], direction.shape)
        contrib = jnp.broadcast_to(params["_contribFwd"], start.shape)
        return SourceRay(pos, direction, start, contrib), rng

    def sample_backward(self, params, observer, normal, wavelength, constants, rng):
        pos = jnp.broadcast_to(params["position"], observer.shape)
        direction = normalize(observer - pos)
        uu, rng = rng.uniform()
        t0, t1 = params["timeRange"][0], params["timeRange"][1]
        start = t0 * (1.0 - uu) + t1 * uu
        contrib = params["_contribBwd"] * dw_dA(pos, observer, normal)
        return SourceRay(pos, direction, start, contrib), rng


class PencilLightSource(LightSource):
    """Delta beam (forward only)
    (reference: src/theia/light.py:1024-1102, shader/lightsource.pencil.glsl)."""

    name = "Pencil Light Source"
    supportForward = True
    supportBackward = False
    nRNGForward = 1
    _param_names = ("position", "direction", "budget", "timeRange")
    _extra_names = ("stokes", "polarizationRef")

    def __init__(
        self,
        *,
        position=(0.0, 0.0, 0.0),
        direction=(0.0, 0.0, 1.0),
        timeRange=(0.0, 100.0),
        budget: float = 1.0,
        stokes=None,
        polarizationRef=None,
    ) -> None:
        self.position = position
        self.direction = direction
        self.timeRange = timeRange
        self.budget = budget
        # optional constant polarization state (reference: src/theia/light.py
        # PencilLightSource stokes/polarizationRef)
        self.stokes = stokes
        self.polarizationRef = polarizationRef

    def sample_forward(self, params, wavelength, constants, rng: RNGState):
        uu, rng = rng.uniform()
        t0, t1 = params["timeRange"][0], params["timeRange"][1]
        start = t0 * (1.0 - uu) + t1 * uu
        pos = jnp.broadcast_to(params["position"], (*start.shape, 3))
        direction = jnp.broadcast_to(params["direction"], pos.shape)
        contrib = jnp.broadcast_to(params["budget"], start.shape)
        stokes = pol_ref = None
        if self.stokes is not None:
            stokes = jnp.broadcast_to(
                jnp.asarray(self.stokes, jnp.float32), (*start.shape, 4)
            )
            pol_ref = jnp.broadcast_to(
                jnp.asarray(self.polarizationRef, jnp.float32), pos.shape
            )
        return SourceRay(pos, direction, start, contrib, stokes, pol_ref), rng


class ConeLightSource(LightSource):
    """Point source emitting uniformly into a cone
    (reference: src/theia/light.py:883-1021, shader/lightsource.cone.glsl)."""

    name = "Cone Light Source"
    supportForward = True
    supportBackward = True
    nRNGForward = 3
    nRNGBackward = 1
    _param_names = (
        "position",
        "direction",
        "cosOpeningAngle",
        "timeRange",
        "_contribFwd",
        "_contribBwd",
    )
    _extra_names = ("budget",)

    def __init__(
        self,
        *,
        position=(0.0, 0.0, 0.0),
        direction=(0.0, 0.0, 1.0),
        cosOpeningAngle: float = 0.5,
        timeRange=(0.0, 100.0),
        budget: float = 1.0,
        stokes=None,
        polarizationRef=None,
    ) -> None:
        self.position = position
        self.direction = direction
        self.cosOpeningAngle = cosOpeningAngle
        self.timeRange = timeRange
        self.budget = budget
        # optional constant polarization state (reference: src/theia/light.py
        # ConeLightSource stokes/polarizationReference)
        self.stokes = stokes
        self.polarizationRef = polarizationRef
        self.update()

    def update(self) -> None:
        self._contribFwd = self.budget
        self._contribBwd = self.budget / (
            2.0 * np.pi * (1.0 - self.cosOpeningAngle)
        )

    def params(self):
        self.update()
        return super().params()

    def sample_forward(self, params, wavelength, constants, rng: RNGState):
        (u1, u2), rng = rng.uniform2d()
        phi = jnp.float32(TWO_PI) * u1
        cos_theta = (1.0 - u2) + params["cosOpeningAngle"] * u2
        sin_theta = jnp.sqrt(jnp.maximum(1.0 - cos_theta * cos_theta, 0.0))
        local = vec3(sin_theta * jnp.cos(phi), sin_theta * jnp.sin(phi), cos_theta)
        axis = normalize(
            jnp.broadcast_to(params["direction"], (*phi.shape, 3))
        )
        vx, vy = local_frame(axis)
        direction = (
            local[..., 0:1] * vx + local[..., 1:2] * vy + local[..., 2:3] * axis
        )
        v, rng = rng.uniform()
        t0, t1 = params["timeRange"][0], params["timeRange"][1]
        start = t0 * (1.0 - v) + t1 * v
        pos = jnp.broadcast_to(params["position"], direction.shape)
        contrib = jnp.broadcast_to(params["_contribFwd"], start.shape)
        stokes, pol_ref = self._pol(direction, start.shape)
        return SourceRay(pos, direction, start, contrib, stokes, pol_ref), rng

    def _pol(self, direction, shape):
        """Constant stokes with the reference frame re-orthogonalized
        against each ray (reference: lightsource.cone.glsl:47-59)."""
        if self.stokes is None:
            return None, None
        stokes = jnp.broadcast_to(
            jnp.asarray(self.stokes, jnp.float32), (*shape, 4)
        )
        ref = jnp.broadcast_to(
            jnp.asarray(self.polarizationRef, jnp.float32), direction.shape
        )
        ref = ref - dot(ref, direction)[..., None] * direction
        return stokes, normalize(ref)

    def sample_backward(self, params, observer, normal, wavelength, constants, rng):
        pos = jnp.broadcast_to(params["position"], observer.shape)
        direction = normalize(observer - pos)
        cos_angle = dot(direction, jnp.broadcast_to(params["direction"], pos.shape))
        inside = cos_angle > params["cosOpeningAngle"]
        contrib = (
            params["_contribBwd"]
            * inside.astype(jnp.float32)
            * dw_dA(pos, observer, normal)
        )
        uu, rng = rng.uniform()
        t0, t1 = params["timeRange"][0], params["timeRange"][1]
        start = t0 * (1.0 - uu) + t1 * uu
        stokes, pol_ref = self._pol(direction, start.shape)
        return SourceRay(pos, direction, start, contrib, stokes, pol_ref), rng


class HostLightSource(LightSource):
    """Source rays provided by the host as arrays indexed by stream id
    (reference: src/theia/light.py:692-881)."""

    name = "Host Light Source"
    supportForward = True
    supportBackward = False
    nRNGForward = 0
    _param_names = ("position", "direction", "startTime", "contrib")

    def __init__(self, position, direction, startTime, contrib) -> None:
        self.position = np.asarray(position, np.float32)
        self.direction = np.asarray(direction, np.float32)
        self.startTime = np.asarray(startTime, np.float32)
        self.contrib = np.asarray(contrib, np.float32)

    def sample_forward(self, params, wavelength, constants, rng: RNGState):
        idx = rng.stream.astype(jnp.int32) % params["startTime"].shape[0]
        return (
            SourceRay(
                position=jnp.take(params["position"], idx, axis=0),
                direction=jnp.take(params["direction"], idx, axis=0),
                start_time=jnp.take(params["startTime"], idx),
                contrib=jnp.take(params["contrib"], idx),
            ),
            rng,
        )


# ---------------------------------------------------------------------------
# Cherenkov / particle light sources
# ---------------------------------------------------------------------------

#: fine structure constant
_ALPHA = 7.2973525693e-3


def frankTamm(wavelength, refractiveIndex, beta: float = 1.0):
    """Frank-Tamm photon yield d^2N/(dx dlam) in [1/m 1/nm]
    (reference: src/theia/light.py:1667-1687)."""
    lam = np.asarray(wavelength) / u.nm
    n = beta * np.asarray(refractiveIndex)
    return 2.0 * np.pi * _ALPHA / lam**2 * (1.0 - 1.0 / n**2) * 1e9


def _frank_tamm_photons(n, lam):
    """Device Frank-Tamm, photon-count units
    (reference: shader/lightsource.particles.common.glsl:52-62)."""
    lam_um = lam * 1e-3
    res = (
        jnp.float32(2.0 * np.pi * 7.2973525693)
        / (lam_um * lam_um)
        * (1.0 - 1.0 / (n * n))
    )
    return jnp.maximum(res, 0.0)


def _frank_tamm_energy(n, lam):
    """Device Frank-Tamm in eV/(m nm), radial
    (reference: shader/lightsource.cherenkov.common.glsl:6-23)."""
    lam_um = lam * 1e-3
    res = (
        jnp.float32(9.04756408986352)
        / (lam_um * lam_um * lam_um)
        * (1.0 - 1.0 / (n * n))
    )
    return jnp.maximum(res, 0.0)


def _rotate_to(axis, local):
    vx, vy = local_frame(axis)
    return (
        local[..., 0:1] * vx + local[..., 1:2] * vy + local[..., 2:3] * axis
    )


class CherenkovLightSource(LightSource):
    """Cherenkov light from a straight particle track at beta = 1
    (reference: src/theia/light.py:1183-1271,
    shader/lightsource.cherenkov.simple.glsl)."""

    name = "Cherenkov Light Source"
    supportForward = True
    supportBackward = True
    nRNGForward = 2
    nRNGBackward = 0
    _param_names = ("trackStart", "trackEnd", "startTime", "endTime")
    _extra_names = ("usePhotonCount",)

    def __init__(
        self,
        *,
        trackStart=(0.0, 0.0, 0.0),
        trackEnd=(100.0, 0.0, 0.0),
        startTime: float = 0.0,
        endTime: float = 100.0 / u.c,
        usePhotonCount: bool = False,
    ) -> None:
        self.trackStart = trackStart
        self.trackEnd = trackEnd
        self.startTime = startTime
        self.endTime = endTime
        self.usePhotonCount = usePhotonCount

    def _ft(self, n, lam):
        return (
            _frank_tamm_photons(n, lam) / jnp.float32(2.0 * np.pi)
            if self.usePhotonCount
            else _frank_tamm_energy(n, lam)
        )

    def _track(self, params, shape):
        start = jnp.broadcast_to(params["trackStart"], (*shape, 3))
        end = jnp.broadcast_to(params["trackEnd"], (*shape, 3))
        d = end - start
        dist = jnp.sqrt(jnp.maximum(dot(d, d), 1e-30))
        return start, end, d / dist[..., None], dist

    def sample_forward(self, params, wavelength, constants, rng: RNGState):
        shape = rng.stream.shape
        start, end, track_dir, track_dist = self._track(params, shape)
        uu, rng = rng.uniform()
        position = start * (1.0 - uu[..., None]) + end * uu[..., None]
        t0, t1 = params["startTime"], params["endTime"]
        start_time = t0 * (1.0 - uu) + t1 * uu

        contrib = (
            jnp.float32(2.0 * np.pi)
            * self._ft(constants.n, wavelength)
            * track_dist
        )
        cos_theta = 1.0 / constants.n
        sin_theta = jnp.sqrt(jnp.maximum(1.0 - cos_theta * cos_theta, 0.0))
        phi, rng2 = rng.uniform()
        rng = rng2
        phi = jnp.float32(2.0 * np.pi) * phi
        local = vec3(
            sin_theta * jnp.cos(phi), sin_theta * jnp.sin(phi), cos_theta
        )
        ray_dir = _rotate_to(track_dir, local)
        pol_ref = normalize(jnp.cross(ray_dir, track_dir))
        stokes = jnp.zeros((*shape, 4), jnp.float32)
        stokes = stokes.at[..., 0].set(1.0).at[..., 1].set(1.0)
        return (
            SourceRay(position, ray_dir, start_time, contrib, stokes, pol_ref),
            rng,
        )

    def sample_backward(self, params, observer, normal, wavelength, constants, rng):
        shape = observer.shape[:-1]
        start, end, track_dir, track_dist = self._track(params, shape)
        cos_theta = 1.0 / constants.n
        sin_theta = jnp.sqrt(jnp.maximum(1.0 - cos_theta * cos_theta, 0.0))
        mu = dot(observer - start, track_dir)
        c_point = start + mu[..., None] * track_dir
        d = distance(observer, c_point)
        mu = mu - cos_theta / jnp.maximum(sin_theta, 1e-7) * d
        position = start + mu[..., None] * track_dir
        ray_dir = normalize(observer - position)
        uu = mu / track_dist
        t0, t1 = params["startTime"], params["endTime"]
        start_time = t0 * (1.0 - uu) + t1 * uu

        contrib = self._ft(constants.n, wavelength)
        is_zero = dot(normal, normal) == 0.0
        cos_nrm = jnp.where(is_zero, 1.0, dot(ray_dir, normal))
        cos_nrm = jnp.maximum(cos_nrm, 0.0)
        contrib = contrib * cos_nrm / jnp.maximum(d, 1e-30)
        contrib = contrib * ((mu >= 0.0) & (mu <= track_dist)).astype(jnp.float32)
        pol_ref = normalize(jnp.cross(ray_dir, track_dir))
        stokes = jnp.zeros((*shape, 4), jnp.float32)
        stokes = stokes.at[..., 0].set(1.0).at[..., 1].set(1.0)
        return (
            SourceRay(position, ray_dir, start_time, contrib, stokes, pol_ref),
            rng,
        )


class ParticleTrack:
    """Particle track as (L, 4) [x, y, z, t] vertex array
    (reference: src/theia/light.py:1274-1352 — device tensor + length
    header; here a plain array in the params pytree)."""

    def __init__(self, vertices) -> None:
        self.vertices = np.asarray(vertices, np.float32)
        if self.vertices.ndim != 2 or self.vertices.shape[1] != 4:
            raise ValueError("track vertices must have shape (L, 4)")

    def setVertices(self, vertices) -> None:
        self.vertices = np.asarray(vertices, np.float32)

    @property
    def length(self) -> int:
        return len(self.vertices)


class CherenkovTrackLightSource(LightSource):
    """Cherenkov light from an arbitrary particle track (beta = 1)
    (reference: src/theia/light.py:1355-1410,
    shader/lightsource.cherenkov.track.glsl)."""

    name = "Cherenkov Track Light Source"
    supportForward = True
    # backward mode is NOT in the reference (its shader stops at
    # "TODO: Implement light sampling for backward mode ... weighted
    # reservoir sampling", lightsource.cherenkov.track.glsl:78-79); the
    # wavefront layout makes the weighted selection it suggests a plain
    # vectorized cumsum over segments — see sample_backward
    supportBackward = True
    nRNGForward = 2
    nRNGBackward = 1
    _param_names = ("track",)
    _extra_names = ("usePhotonCount",)

    def __init__(self, track: ParticleTrack | None = None, *, usePhotonCount: bool = False):
        self.track = track
        self.usePhotonCount = usePhotonCount

    def params(self):
        return {"track": jnp.asarray(self.track.vertices)}

    def sample_forward(self, params, wavelength, constants, rng: RNGState):
        track = params["track"]  # (L, 4)
        n_seg = track.shape[0] - 1
        uu, rng = rng.uniform()
        uu = uu * n_seg
        seg = jnp.minimum(jnp.floor(uu).astype(jnp.int32), n_seg - 1)
        frac = uu - jnp.floor(uu)
        v0 = jnp.take(track, seg, axis=0)
        v1 = jnp.take(track, seg + 1, axis=0)
        pos = v0[..., :3] * (1.0 - frac[..., None]) + v1[..., :3] * frac[..., None]
        time = v0[..., 3] * (1.0 - frac) + v1[..., 3] * frac

        cos_theta = 1.0 / constants.n
        sin_theta = jnp.sqrt(jnp.maximum(1.0 - cos_theta * cos_theta, 0.0))
        phi, rng = rng.uniform()
        phi = jnp.float32(2.0 * np.pi) * phi
        local = vec3(
            sin_theta * jnp.cos(phi), sin_theta * jnp.sin(phi), cos_theta
        )
        seg_vec = v1[..., :3] - v0[..., :3]
        seg_len = jnp.sqrt(jnp.maximum(dot(seg_vec, seg_vec), 1e-30))
        particle_dir = seg_vec / seg_len[..., None]
        ray_dir = _rotate_to(particle_dir, local)

        ft = self._ft_factor(constants.n, wavelength)
        contrib = jnp.float32(2.0 * np.pi) * n_seg * seg_len * ft
        pol_ref = normalize(jnp.cross(ray_dir, particle_dir))
        stokes = jnp.zeros((*time.shape, 4), jnp.float32)
        stokes = stokes.at[..., 0].set(1.0).at[..., 1].set(1.0)
        return SourceRay(pos, ray_dir, time, contrib, stokes, pol_ref), rng

    def sample_backward(self, params, observer, normal, wavelength, constants, rng):
        """Backward sample toward an observer: each straight segment has (at
        most) one point whose Cherenkov cone passes through the observer
        (the simple-source construction applied per segment); the total
        backward contribution is the sum over segments, estimated by picking
        one candidate with probability proportional to its contribution and
        carrying the sum. The reference leaves this unimplemented
        (lightsource.cherenkov.track.glsl:78-79 TODO) — the weighted
        selection it sketches is one vectorized cumsum here."""
        track = params["track"]  # (L, 4)
        v0 = track[:-1]  # (S, 4)
        v1 = track[1:]
        seg_vec = v1[:, :3] - v0[:, :3]  # (S, 3)
        seg_len = jnp.sqrt(jnp.maximum((seg_vec**2).sum(-1), 1e-30))  # (S,)
        seg_dir = seg_vec / seg_len[:, None]

        cos_theta = 1.0 / constants.n  # (N,)
        sin_theta = jnp.sqrt(jnp.maximum(1.0 - cos_theta * cos_theta, 0.0))

        # per (lane, segment) emission point: observer (N,1,3) vs segs (S,3)
        rel = observer[..., None, :] - v0[None, :, :3]  # (N, S, 3)
        mu = (rel * seg_dir[None]).sum(-1)  # (N, S)
        c_point = v0[None, :, :3] + mu[..., None] * seg_dir[None]
        d_perp = jnp.sqrt(
            jnp.maximum(((observer[..., None, :] - c_point) ** 2).sum(-1), 1e-30)
        )
        mu = mu - (cos_theta / jnp.maximum(sin_theta, 1e-7))[..., None] * d_perp
        position = v0[None, :, :3] + mu[..., None] * seg_dir[None]  # (N, S, 3)
        ray_dir = normalize(observer[..., None, :] - position)  # (N, S, 3)
        frac = mu / seg_len[None]
        time = v0[None, :, 3] * (1.0 - frac) + v1[None, :, 3] * frac  # (N, S)

        ft = self._ft_factor(constants.n, wavelength)  # (N,)
        is_zero = dot(normal, normal) == 0.0
        cos_nrm = jnp.where(
            is_zero[..., None], 1.0, (ray_dir * normal[..., None, :]).sum(-1)
        )
        cos_nrm = jnp.maximum(cos_nrm, 0.0)
        on_seg = (mu >= 0.0) & (mu <= seg_len[None])
        contrib_s = ft[..., None] * cos_nrm / d_perp * on_seg.astype(jnp.float32)

        # pick one candidate ~ contribution; the lane carries the sum
        total = contrib_s.sum(-1)  # (N,)
        uu, rng = rng.uniform()
        cum = jnp.cumsum(contrib_s, axis=-1)
        k = jnp.sum(cum < (uu * total)[..., None], axis=-1)
        k = lax.stop_gradient(jnp.minimum(k, contrib_s.shape[-1] - 1))

        take = lambda a: jnp.take_along_axis(
            a, k[..., None, None] if a.ndim == 3 else k[..., None], axis=1
        ).squeeze(1)
        pos_k = take(position)
        dir_k = take(ray_dir)
        time_k = take(time)
        pol_ref = normalize(jnp.cross(dir_k, jnp.take(seg_dir, k, axis=0)))
        stokes = jnp.zeros((*total.shape, 4), jnp.float32)
        stokes = stokes.at[..., 0].set(1.0).at[..., 1].set(1.0)
        return SourceRay(pos_k, dir_k, time_k, total, stokes, pol_ref), rng

    def _ft_factor(self, n, lam):
        return (
            _frank_tamm_photons(n, lam) / jnp.float32(2.0 * np.pi)
            if self.usePhotonCount
            else _frank_tamm_energy(n, lam)
        )


def _sample_emission_angle(n, a, b, uu):
    """Sample the angular emission profile around the Cherenkov angle
    (reference: shader/lightsource.particles.common.glsl:72-100)."""
    cos_chev = 1.0 / n
    int_lower = 1.0 - jnp.exp(-b * jnp.power(1.0 - cos_chev, a))
    int_upper = 1.0 - jnp.exp(-b * jnp.power(1.0 + cos_chev, a))
    uu = uu * (int_upper + int_lower) - int_lower
    x = jnp.power(-jnp.log1p(-jnp.abs(uu)) / b, 1.0 / a)
    return cos_chev - jnp.sign(uu) * x


def _eval_emission_angle(n, a, b, cos_theta):
    """Evaluate the angular emission pdf
    (reference: shader/lightsource.particles.common.glsl:143-158)."""
    cos_chev = 1.0 / n
    norm = a * b
    norm = norm / (
        2.0
        - jnp.exp(-b * jnp.power(1.0 - cos_chev, a))
        - jnp.exp(-b * jnp.power(1.0 + cos_chev, a))
    )
    x = jnp.abs(cos_theta - cos_chev)
    x = jnp.maximum(x, 1e-7)
    return jnp.exp(-b * jnp.power(x, a)) * jnp.power(x, a - 1.0) * norm


class MuonTrackLightSource(LightSource):
    """Cherenkov light from a muon track plus its secondaries (<500 MeV)
    after Raedel's parameterization (reference: src/theia/light.py:1413-1520,
    shader/lightsource.particles.muon.glsl). Forward sampling only."""

    name = "Muon Track Light Source"
    supportForward = True
    supportBackward = True
    nRNGForward = 3
    nRNGBackward = 1
    _param_names = (
        "startPosition",
        "startTime",
        "endPosition",
        "endTime",
        "_energyScale",
        "_a_angular",
        "_b_angular",
    )
    _extra_names = ("muonEnergy", "applyFrankTamm")

    def __init__(
        self,
        startPosition=(0.0, 0.0, 0.0),
        startTime: float = 0.0,
        endPosition=(0.0, 0.0, 0.0),
        endTime: float = 0.0,
        muonEnergy: float = 1.0 * u.GeV,
        applyFrankTamm: bool = True,
    ) -> None:
        self.startPosition = startPosition
        self.startTime = startTime
        self.endPosition = endPosition
        self.endTime = endTime
        self.applyFrankTamm = applyFrankTamm
        self.muonEnergy = muonEnergy

    @property
    def muonEnergy(self) -> float:
        return self._muonEnergy

    @muonEnergy.setter
    def muonEnergy(self, value: float) -> None:
        self._muonEnergy = value
        # secondary-particle light yield + angular fit
        # (reference: src/theia/light.py:1506-1516,
        #  notebooks/track_angular_dist_fit.ipynb)
        self._energyScale = 1.1880 + 0.0206 * np.log(value)
        self._a_angular = 0.86634 - 7.5624e-3 * np.log10(value)
        self._b_angular = 2.5030 + 3.0533e-2 * np.log10(value)

    def sample_forward(self, params, wavelength, constants, rng: RNGState):
        shape = rng.stream.shape
        start = jnp.broadcast_to(params["startPosition"], (*shape, 3))
        end = jnp.broadcast_to(params["endPosition"], (*shape, 3))
        uu, rng = rng.uniform()
        position = start * (1.0 - uu[..., None]) + end * uu[..., None]
        t0, t1 = params["startTime"], params["endTime"]
        start_time = t0 * (1.0 - uu) + t1 * uu
        d = end - start
        track_dist = jnp.sqrt(jnp.maximum(dot(d, d), 1e-30))
        contrib = track_dist * params["_energyScale"]

        (v1, v2), rng = rng.uniform2d()
        phi = jnp.float32(2.0 * np.pi) * v1
        cos_theta = _sample_emission_angle(
            constants.n, params["_a_angular"], params["_b_angular"], v2
        )
        track_dir = d / track_dist[..., None]
        local = spherical_to_cartesian(phi, cos_theta)
        ray_dir = _rotate_to(track_dir, local)
        if self.applyFrankTamm:
            contrib = contrib * _frank_tamm_photons(constants.n, wavelength)
        return SourceRay(position, ray_dir, start_time, contrib), rng

    def sample_backward(
        self, params, observer, normal, wavelength, constants, rng: RNGState
    ):
        """Importance sample the track point seen from ``observer``.

        Mirrors the reference's proxy-pdf scheme
        (shader/lightsource.particles.muon.glsl sampleLight backward):
        the attenuation exp(-mu_t t) along the track has no closed-form
        integral, so the point is drawn from 1/(d^2 + (a x)^2) around the
        closest point C on the track line (x = signed distance from C,
        d = dist(observer, line)), whose inverse CDF is a tangent; the
        heuristic shape a^2 = 2.2/(b(b+2)), b = ln2/(mu_t d) matches the
        proxy to the attenuation scale."""
        start = jnp.broadcast_to(params["startPosition"], observer.shape)
        end = jnp.broadcast_to(params["endPosition"], observer.shape)
        seg = end - start
        track_dist = jnp.sqrt(jnp.maximum(dot(seg, seg), 1e-30))
        track_dir = seg / track_dist[..., None]

        to_obs = observer - start
        start_dist = jnp.sqrt(jnp.maximum(dot(to_obs, to_obs), 1e-30))
        cos_start = dot(to_obs / start_dist[..., None], track_dir)
        # signed distances along the track relative to the closest point C
        dist_start2c = -cos_start * start_dist
        dist_end2c = track_dist + dist_start2c
        d = jnp.sqrt(jnp.maximum(1.0 - cos_start * cos_start, 0.0)) * start_dist
        d = jnp.maximum(d, 1e-4)  # observer on the track line

        b = jnp.float32(np.log(2.0)) / (d * jnp.maximum(constants.mu_e, 1e-6))
        a2 = 2.2 / (b * (b + 2.0))
        a = jnp.sqrt(a2)
        # proxy CDF normalization; the 1/(a d) factor cancels in the
        # inverse CDF and is reintroduced in the contribution below
        int_lo = jnp.arctan(a * dist_start2c / d)
        int_hi = jnp.arctan(a * dist_end2c / d)
        norm = int_hi - int_lo
        uu, rng = rng.uniform()
        uu = uu * norm + int_lo
        x = d / a * jnp.tan(uu)
        contrib = norm / (a * d) * (d * d + a2 * x * x)

        x = x - dist_start2c  # x=0 -> ray starts at startPosition
        ray_pos = start + x[..., None] * track_dir
        ray_dir = normalize(observer - ray_pos)
        # Emission time interpolates startTime..endTime by track fraction,
        # consistent with sample_forward. (The reference instead assumes
        # speed-of-light travel here — glsl `startTime + x/c`,
        # lightsource.particles.muon.glsl:111 — which disagrees with its own
        # forward branch whenever endTime != startTime + L/c; both agree in
        # the physical muon case.)
        frac = x / track_dist
        time = params["startTime"] * (1.0 - frac) + params["endTime"] * frac
        contrib = contrib * dw_dA(ray_pos, observer, normal)

        cos_obs = dot(track_dir, ray_dir)
        contrib = contrib * _eval_emission_angle(
            constants.n, params["_a_angular"], params["_b_angular"], cos_obs
        )
        contrib = contrib * params["_energyScale"]
        if self.applyFrankTamm:
            contrib = contrib * _frank_tamm_photons(constants.n, wavelength)
        # 1/2pi: the Frank-Tamm formula above misses the d/d(phi) factor
        contrib = contrib / jnp.float32(2.0 * np.pi)
        return SourceRay(ray_pos, ray_dir, time, contrib), rng


class ParticleCascadeLightSource(LightSource):
    """Cherenkov light from EM/hadronic showers (Raedel parameterization):
    gamma-distributed longitudinal profile + angular emission fit
    (reference: src/theia/light.py:1522-1664,
    shader/lightsource.particles.cascade.glsl)."""

    name = "Particle Cascade Light Source"
    supportForward = True
    supportBackward = True
    nRNGForward = 12  # gamma rejection: draw count is a loose upper bound
    nRNGBackward = 10
    _param_names = (
        "startPosition",
        "startTime",
        "direction",
        "effectiveLength",
        "a_angular",
        "b_angular",
        "a_long",
        "b_long",
    )
    _extra_names = ("applyFrankTamm",)

    def __init__(
        self,
        startPosition=(0.0, 0.0, 0.0),
        startTime: float = 0.0,
        direction=(0.0, 0.0, 1.0),
        effectiveLength: float = 1.0,
        a_angular: float = 0.0,
        b_angular: float = 0.0,
        a_long: float = 0.0,
        b_long: float = 0.0,
        applyFrankTamm: bool = True,
    ) -> None:
        self.startPosition = startPosition
        self.startTime = startTime
        self.direction = direction
        self.effectiveLength = effectiveLength
        self.a_angular = a_angular
        self.b_angular = b_angular
        self.a_long = a_long
        self.b_long = b_long
        self.applyFrankTamm = applyFrankTamm

    def _sample_z(self, params, rng):
        from .ops.gamma import sample_gamma

        z, rng = sample_gamma(params["a_long"], rng)
        return jax.lax.stop_gradient(z) * params["b_long"], rng

    def sample_forward(self, params, wavelength, constants, rng: RNGState):
        shape = rng.stream.shape
        z, rng = self._sample_z(params, rng)
        axis = normalize(jnp.broadcast_to(params["direction"], (*shape, 3)))
        pos = (
            jnp.broadcast_to(params["startPosition"], (*shape, 3))
            + z[..., None] * axis
        )
        time = params["startTime"] + z / jnp.float32(u.c)

        (u1, u2), rng = rng.uniform2d()
        phi = jnp.float32(2.0 * np.pi) * u1
        cos_theta = _sample_emission_angle(
            constants.n, params["a_angular"], params["b_angular"], u2
        )
        ray_dir = _rotate_to(axis, spherical_to_cartesian(phi, cos_theta))
        contrib = jnp.broadcast_to(params["effectiveLength"], time.shape)
        if self.applyFrankTamm:
            contrib = contrib * _frank_tamm_photons(constants.n, wavelength)
        return SourceRay(pos, ray_dir, time, contrib), rng

    def sample_backward(self, params, observer, normal, wavelength, constants, rng):
        shape = observer.shape[:-1]
        z, rng = self._sample_z(params, rng)
        axis = normalize(jnp.broadcast_to(params["direction"], (*shape, 3)))
        pos = (
            jnp.broadcast_to(params["startPosition"], (*shape, 3))
            + z[..., None] * axis
        )
        time = params["startTime"] + z / jnp.float32(u.c)
        ray_dir = normalize(observer - pos)
        cos_theta = dot(axis, ray_dir)
        contrib = _eval_emission_angle(
            constants.n, params["a_angular"], params["b_angular"], cos_theta
        )
        contrib = contrib * jnp.float32(1.0 / (2.0 * np.pi))
        contrib = contrib * dw_dA(pos, observer, normal)
        contrib = contrib * params["effectiveLength"]
        if self.applyFrankTamm:
            contrib = contrib * _frank_tamm_photons(constants.n, wavelength)
        return SourceRay(pos, ray_dir, time, contrib), rng


class FunctionWavelengthSource(WavelengthSource):
    """Importance sample a user distribution over wavelength via a
    numerically inverted CDF table (reference: src/theia/light.py:351-414,
    shader/wavelengthsource.function.glsl)."""

    name = "Function Wavelength Source"
    nRNGSamples = 1
    _param_names = ("_table", "_contrib")

    def __init__(self, fn, *, lambdaRange=(300.0, 700.0), numSamples: int = 1024):
        from scipy.integrate import quad
        from scipy.stats.sampling import NumericalInversePolynomial

        contrib, _ = quad(fn, *lambdaRange)

        class Dist:
            def pdf(self, x):
                return fn(x)

        inv_cdf = NumericalInversePolynomial(Dist(), domain=lambdaRange)
        uu = np.linspace(0.0, 1.0, numSamples)
        self._table = inv_cdf.ppf(uu).astype(np.float32)
        self._contrib = float(contrib)

    def sample(self, params, rng: RNGState):
        from .lookup import lookup

        uu, rng = rng.uniform()
        lam = lookup(params["_table"], uu)
        contrib = jnp.broadcast_to(params["_contrib"], lam.shape)
        return (lam, contrib), rng


# ---------------------------------------------------------------------------
# light-source targets (focus existing sources; reference:
# src/theia/target.py:738-1106, shader/lightsource.target.*.glsl,
# shader/lightsource.guided.glsl)
# ---------------------------------------------------------------------------


class LightSourceTarget(Component):
    """Samples target points used to focus a light source
    (``sampleLightTarget`` interface)."""

    name = "Light Source Target"
    nRNGSamples: int = 0

    def sample(self, params, wavelength, rng: RNGState):
        """Returns ((position, normal, contrib), rng)."""
        raise NotImplementedError


class PointLightSourceTarget(LightSourceTarget):
    """Single point, volume normal (reference:
    shader/lightsource.target.point.glsl)."""

    name = "Point Light Source Target"
    nRNGSamples = 0
    _param_names = ("position",)

    def __init__(self, *, position=(0.0, 0.0, 0.0)) -> None:
        self.position = position

    def sample(self, params, wavelength, rng: RNGState):
        shape = rng.stream.shape
        pos = jnp.broadcast_to(params["position"], (*shape, 3))
        nrm = jnp.zeros_like(pos)
        return (pos, nrm, jnp.ones(shape, jnp.float32)), rng


class _PlanarLightSourceTarget(LightSourceTarget):
    nRNGSamples = 2

    def _frame(self, params, shape):
        o2w = jnp.broadcast_to(params["_objToWorld"], (*shape, 3, 3))
        pos = jnp.broadcast_to(params["position"], (*shape, 3))
        nrm = jnp.broadcast_to(params["_normal"], (*shape, 3))
        return o2w, pos, nrm

    def sample(self, params, wavelength, rng: RNGState):
        shape = rng.stream.shape
        o2w, offset, nrm = self._frame(params, shape)
        local, rng = self._sample_local(params, rng)
        pos = matvec(o2w, local) + offset
        contrib = jnp.broadcast_to(params["_area"], shape)
        return (pos, nrm, contrib), rng


class DiskLightSourceTarget(_PlanarLightSourceTarget):
    """Disk target (reference: src/theia/target.py:770-868)."""

    name = "Disk Light Source Target"
    _param_names = ("radius", "position", "_normal", "_area", "_objToWorld")
    _extra_names = ("normal", "up")

    def __init__(
        self, *, position=(0.0, 0.0, 0.0), radius=1.0, normal=(0.0, 0.0, 1.0),
        up=(0.0, 1.0, 0.0),
    ) -> None:
        self.position = position
        self.radius = radius
        self.normal = normal
        self.up = up
        self.update()

    def update(self) -> None:
        from .target import _orient_frame

        m = _orient_frame(self.normal, self.up)
        self._objToWorld = m
        self._normal = m[:, 2]
        self._area = np.pi * self.radius**2

    def params(self):
        self.update()
        return super().params()

    def _sample_local(self, params, rng):
        from .ops.sampling import sample_unit_disk

        (u1, u2), rng = rng.uniform2d()
        return params["radius"] * sample_unit_disk(u1, u2), rng


class FlatLightSourceTarget(_PlanarLightSourceTarget):
    """Rectangular target (reference: src/theia/target.py:869-1004)."""

    name = "Flat Light Source Target"
    _param_names = ("width", "height", "position", "_normal", "_area", "_objToWorld")
    _extra_names = ("normal", "up")

    def __init__(
        self, *, width=1.0, height=1.0, position=(0.0, 0.0, 0.0),
        normal=(0.0, 0.0, 1.0), up=(0.0, 1.0, 0.0),
    ) -> None:
        self.width = width
        self.height = height
        self.position = position
        self.normal = normal
        self.up = up
        self.update()

    def update(self) -> None:
        from .target import _orient_frame

        m = _orient_frame(self.normal, self.up)
        self._objToWorld = m
        self._normal = m[:, 2]
        self._area = self.width * self.height

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


class TargetLightSource(LightSource):
    """Focus a backward-capable light source onto a target: sample a target
    point, then the principal source toward it
    (reference: src/theia/target.py:1006-1106, shader/lightsource.guided.glsl)."""

    name = "Target Light Source"
    supportForward = True
    supportBackward = False

    def __init__(self, source: LightSource, target: LightSourceTarget) -> None:
        if not source.supportBackward:
            raise ValueError("principal source must support backward mode")
        self.source = source
        self.target = target
        self.nRNGForward = target.nRNGSamples + source.nRNGBackward

    def params(self):
        return {
            "principal": self.source.params(),
            "target": self.target.params(),
        }

    def sample_forward(self, params, wavelength, constants, rng: RNGState):
        (pos, nrm, contrib), rng = self.target.sample(
            params["target"], wavelength, rng
        )
        ray, rng = self.source.sample_backward(
            params["principal"], pos, nrm, wavelength, constants, rng
        )
        return (
            SourceRay(
                position=ray.position,
                direction=ray.direction,
                start_time=ray.start_time,
                contrib=ray.contrib * contrib,
                stokes=ray.stokes,
                pol_ref=ray.pol_ref,
            ),
            rng,
        )


class StreamingHostWavelengthSource(HostWavelengthSource):
    """Walks a large host array batch by batch; call :meth:`update` (or let
    the pipeline do it) to advance (reference: src/theia/light.py:180-257)."""

    name = "Streaming Host Wavelength Source"

    def __init__(self, wavelength, contrib=None, *, batchSize: int) -> None:
        self._all_wavelength = np.asarray(wavelength, np.float32)
        self._all_contrib = (
            np.ones_like(self._all_wavelength)
            if contrib is None
            else np.asarray(contrib, np.float32)
        )
        self.batchSize = batchSize
        self.offset = 0
        self._slice()

    def _slice(self) -> None:
        n = len(self._all_wavelength)
        idx = (self.offset + np.arange(self.batchSize)) % n
        self.wavelength = self._all_wavelength[idx]
        self.contrib = self._all_contrib[idx]

    def update(self) -> None:
        self._slice()
        self.offset = (self.offset + self.batchSize) % len(self._all_wavelength)

    def params(self):
        self.update()
        return super().params()


class StreamingHostLightSource(HostLightSource):
    """Streams source rays from large host arrays batch by batch
    (reference: src/theia/light.py:789-881)."""

    name = "Streaming Host Light Source"

    def __init__(self, position, direction, startTime, contrib, *, batchSize: int):
        self._all = dict(
            position=np.asarray(position, np.float32),
            direction=np.asarray(direction, np.float32),
            startTime=np.asarray(startTime, np.float32),
            contrib=np.asarray(contrib, np.float32),
        )
        self.batchSize = batchSize
        self.offset = 0
        self._slice()

    def _slice(self) -> None:
        n = len(self._all["startTime"])
        idx = (self.offset + np.arange(self.batchSize)) % n
        self.position = self._all["position"][idx]
        self.direction = self._all["direction"][idx]
        self.startTime = self._all["startTime"][idx]
        self.contrib = self._all["contrib"][idx]

    def update(self) -> None:
        self._slice()
        self.offset = (self.offset + self.batchSize) % len(self._all["startTime"])

    def params(self):
        self.update()
        return super().params()


from .items import (  # noqa: E402
    LightSampleItem,
    PolarizedLightSampleItem,
    WavelengthSampleItem,
)


def __getattr__(name):
    # the sampler lives in theia_jax.testing (which imports this module);
    # resolve lazily to mirror the reference's light.LightSampler
    if name == "LightSampler":
        from .testing import LightSampler

        return LightSampler
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
