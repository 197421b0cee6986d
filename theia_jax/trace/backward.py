"""Backward (camera-origin) volume tracing and direct-light connection.

``VolumeBackwardTracer``: camera rays scatter through the medium; at every
scatter vertex the light source is sampled backward and connected with a
shadow ray (reference: src/theia/trace.py:773-1045,
shader/tracer.volume.backward.glsl, shader/ray.combine.glsl).

``sample_direct``: the zero-scatter connection camera-point <-> backward
light sample shared with ``DirectLightTracer``
(reference: shader/tracer.direct.common.glsl).
"""

from __future__ import annotations

from dataclasses import replace
from typing import TYPE_CHECKING

import jax
import jax.numpy as jnp
from jax import lax

from ..compile_cache import jit
from .. import units as u
from ..callback import EmptyEventCallback, TraceEventCallback
from ..camera import Camera, CameraRay
from ..component import Component, TraceConfig
from ..light import LightSource, SourceRay, WavelengthSource
from ..material import Medium, medium_constants
from ..ops.math3d import distance, dot, local_frame, matmul, matvec, normalize
from ..polarization import (
    apply_rotation,
    phase_matrix_elements,
    phase_mueller,
    rotate_pol_ref,
    rotation_coeffs,
    rotation_mueller,
    unpolarized_stokes,
)
from ..random import PhiloxRNG, RNGState
from ..target import Target
from .core import (
    TracerBase,
    active_lanes,
    EventResultCode,
    HitItem,
    PropagateParams,
    RayState,
    propagate_ray,
    reattach_geometry,
    sample_scatter_dir_medium,
    sample_scatter_length,
    scatter_prob,
    scatter_ray,
    update_ray,
    update_ray_is,
)
from ..lookup import lookup
from ..ops.sampling import scatter_dir

if TYPE_CHECKING:
    from ..response import HitResponse

__all__ = ["VolumeBackwardTracer"]


def _light_pol(light, lam_shape):
    """Stokes + reference frame of a backward light sample; unpolarized
    default (reference: lightsource.common.glsl createSourceRay)."""
    stokes = light.stokes if light.stokes is not None else unpolarized_stokes(lam_shape)
    pol_ref = (
        light.pol_ref
        if light.pol_ref is not None
        else local_frame(light.direction)[0]
    )
    return stokes, pol_ref


def _mueller_scatter(medium, direction, new_dir, mueller, pol_ref):
    """Backward scatter: mueller <- mueller @ rotate^T @ phase
    (reference: ray.scatter.glsl _scatterPolRay_impl backward)."""
    cos_theta = dot(direction, new_dir)
    m12, m22, m33, m34 = phase_matrix_elements(medium, cos_theta)
    new_ref, c, s = rotate_pol_ref(direction, pol_ref, new_dir)
    rot_t = jnp.swapaxes(rotation_mueller(c, s), -1, -2)
    new_mueller = matmul(matmul(mueller, rot_t), phase_mueller(m12, m22, m33, m34))
    return new_mueller, new_ref


def _connect_stokes(mueller, pol_ref, light):
    """Transport the light's Stokes vector through the accumulated Mueller
    chain; returns (stokes_normalized, S0)
    (reference: ray.combine.glsl combineRaysAligned polarized)."""
    l_stokes, l_ref = _light_pol(light, light.contrib.shape)
    c, s = rotation_coeffs(light.direction, l_ref, pol_ref)
    stokes = matvec(mueller, apply_rotation(l_stokes, c, s))
    s0 = stokes[..., 0]
    safe = jnp.where(jnp.abs(s0) > 1e-30, s0, 1.0)
    return stokes / safe[..., None], s0


def _merge_dim(after: RNGState, before: RNGState, take_after) -> RNGState:
    return replace(before, dim=jnp.where(take_after, after.dim, before.dim))


def combine_rays_aligned(
    ray: RayState, end_pos, end_contrib, end_time_offset, prop: PropagateParams
):
    """Attenuate the ray over the connection distance and combine
    contributions (reference: shader/ray.combine.glsl:109-143).

    Returns (contrib, time, ok_mask)."""
    dist = distance(ray.position, end_pos)
    ray, code = update_ray(ray, dist, prop)
    # the connection distance is deterministic geometry (not a sampled
    # quantity): reattach its gradient (see core.reattach_geometry)
    ray = reattach_geometry(ray, dist)
    contrib = end_contrib * ray.contrib
    time = end_time_offset + ray.time
    ok = (code >= 0) & (time <= prop.max_time) & (contrib > 0.0)
    return contrib, time, ok


def sample_direct(
    tracer, p, prop, medium, resp_state, cb_state, rng: RNGState, occluder=None
):
    """Zero-scatter direct connection (reference:
    shader/tracer.direct.common.glsl:55-90). ``occluder(a, b) -> visible``
    optionally tests scene occlusion. Returns updated states + rng."""
    streams = rng.stream
    (lam, lam_c), rng = tracer.wavelengthSource.sample(p["photons"], rng)
    cam_pt, rng = tracer.camera.sample_point(p["camera"], lam, rng)
    constants = medium_constants(medium, lam)
    light, rng = tracer.source.sample_backward(
        p["lightSource"], cam_pt.position, cam_pt.normal, lam, constants, rng
    )
    ray = RayState(
        position=light.position,
        direction=light.direction,
        wavelength=lam,
        time=light.start_time,
        lin_contrib=light.contrib * lam_c,
        log_contrib=jnp.zeros_like(lam),
        constants=constants,
    )
    lane = active_lanes(streams, p)
    cb_state = tracer.callback.on_event(
        p["callback"],
        cb_state,
        ray,
        jnp.full_like(streams, int(EventResultCode.RAY_CREATED), jnp.int32),
        lane,
        0,
    )
    # light must come from the front side and be visible
    ok = lane & (dot(cam_pt.normal, light.direction) < 0.0)
    if occluder is not None:
        ok &= occluder(cam_pt.position, light.position)
    cam_ray = tracer.camera.ray_from_point(
        p["camera"], cam_pt, light.direction, lam
    )
    contrib, time, c_ok = combine_rays_aligned(
        ray, cam_ray.position, cam_ray.contrib, cam_ray.time_delta, prop
    )
    ok &= c_ok
    stokes = hit_pol_ref = None
    if tracer.polarized:
        if cam_ray.mueller is None:
            raise ValueError(
                f"camera {type(tracer.camera).__name__} does not provide "
                "polarization frames"
            )
        stokes, s0 = _connect_stokes(cam_ray.mueller, cam_ray.pol_ref, light)
        contrib = contrib * s0
        ok &= contrib > 0.0
        hit_pol_ref = cam_ray.hit_pol_ref
    item = HitItem(
        position=cam_ray.hit_position,
        direction=cam_ray.hit_direction,
        normal=cam_ray.hit_normal,
        wavelength=lam,
        time=time,
        contrib=contrib,
        object_id=cam_ray.object_id,
        stokes=stokes,
        pol_ref=hit_pol_ref,
    )
    rng_b = rng
    resp_state, rng = tracer.response.record(p["response"], resp_state, item, ok, rng)
    rng = _merge_dim(rng, rng_b, ok)
    code = jnp.where(
        ok,
        jnp.int32(EventResultCode.RAY_DETECTED),
        jnp.int32(EventResultCode.RAY_MISSED),
    )
    cb_state = tracer.callback.on_event(
        p["callback"], cb_state, ray, code, lane, 1
    )
    return resp_state, cb_state, rng


class VolumeBackwardTracer(TracerBase):
    """Camera-origin volume path tracing with per-vertex light connections
    (reference: src/theia/trace.py:773-1045)."""

    name = "Volume Backward Tracer"
    _param_names = ("scatterCoefficient", "maxTime")

    def __init__(
        self,
        batchSize: int,
        source: LightSource,
        camera: Camera,
        wavelengthSource: WavelengthSource,
        response: "HitResponse",
        rng: PhiloxRNG,
        *,
        medium: Medium | None,
        capacity: int | None = None,
        callback: TraceEventCallback | None = None,
        nScattering: int = 6,
        target: Target | None = None,
        scatterCoefficient: float = float("nan"),
        traceBBox: tuple = ((-1.0 * u.km,) * 3, (1.0 * u.km,) * 3),
        maxTime: float = 1000.0 * u.ns,
        polarized: bool = False,
        disableDirectLighting: bool = False,
    ) -> None:
        if not source.supportBackward:
            raise ValueError("Light source does not support backward mode!")
        if not disableDirectLighting and not camera.supportDirect:
            raise ValueError("Camera does not support direct mode!")
        self._init_batch(batchSize, capacity)
        self.source = source
        self.camera = camera
        self.wavelengthSource = wavelengthSource
        self.response = response
        self.rng = rng
        self.medium = medium
        self.callback = EmptyEventCallback() if callback is None else callback
        self.nScattering = nScattering
        self.target = target
        self.scatterCoefficient = scatterCoefficient
        self.traceBBox = traceBBox
        self.maxTime = maxTime
        self.polarized = polarized
        self.disableDirectLighting = disableDirectLighting

        # reference accounting (src/theia/trace.py:895-910)
        self.maxHitsPerThread = nScattering + (0 if disableDirectLighting else 1)
        rngStride = 3 + source.nRNGBackward
        rngPre = wavelengthSource.nRNGSamples + camera.nRNGSamples
        if not disableDirectLighting:
            rngPre += (
                wavelengthSource.nRNGSamples
                + camera.nRNGDirect
                + source.nRNGBackward
            )
        self.nRNGSamples = (
            rngPre
            + rngStride * nScattering
            + self.maxHitsPerThread * response.nRNGSamples
        )
        rng.configure(self.nRNGSamples, self.capacity)
        response.prepare(
            TraceConfig(
                batch_size=batchSize,
                capacity=self.capacity,
                max_hits_per_thread=self.maxHitsPerThread,
                normalization=self.normalization,
                polarized=polarized,
            )
        )
        self._jit_trace = jit(self._trace_batch)

    def collectStages(self):
        stages = [
            ("photons", self.wavelengthSource),
            ("lightSource", self.source),
            ("camera", self.camera),
        ]
        if self.target is not None:
            stages.append(("target", self.target))
        stages += [
            ("tracer", self),
            ("callback", self.callback),
            ("response", self.response),
        ]
        return stages

    def params(self):
        p = {
            "tracer": {
                "batchSize": jnp.asarray(self.batchSize, jnp.uint32),
                "scatterCoefficient": jnp.asarray(
                    self.scatterCoefficient, jnp.float32
                ),
                "maxTime": jnp.asarray(self.maxTime, jnp.float32),
                "lowerBBox": jnp.asarray(self.traceBBox[0], jnp.float32),
                "upperBBox": jnp.asarray(self.traceBBox[1], jnp.float32),
            },
            "medium": self.medium,
            "photons": self.wavelengthSource.params(),
            "lightSource": self.source.params(),
            "camera": self.camera.params(),
            "response": self.response.params(),
            "callback": self.callback.params(),
        }
        if self.target is not None:
            p["target"] = self.target.params()
        return p

    def _propagation(self, p) -> PropagateParams:
        lo = p["tracer"]["lowerBBox"]
        hi = p["tracer"]["upperBBox"]
        return PropagateParams(
            scatter_coefficient=p["tracer"]["scatterCoefficient"],
            lower_bbox=lo,
            upper_bbox=hi,
            max_time=p["tracer"]["maxTime"],
            max_dist=jnp.linalg.norm(hi - lo),
        )

    def _visible(self, p, observer, target_pos):
        """Self-shadowing test against the optional target
        (reference: tracer.volume.backward.glsl:45-60)."""
        if self.target is None:
            return jnp.ones(observer.shape[:-1], bool)
        d = target_pos - observer
        dist = jnp.sqrt(jnp.maximum(dot(d, d), 1e-30))
        direction = d / dist[..., None]
        hit = self.target.intersect(p["target"], observer, direction)
        return ~hit.valid | (hit.dist >= dist)

    def _trace_batch(self, p, counter, streams):
        medium = p["medium"]
        prop = self._propagation(p)
        rng = self.rng.state_for(counter, streams)
        resp_state = self.response.init()
        cb_state = self.callback.init(streams.shape[0], self.nScattering + 4)

        i_path = 0
        if not self.disableDirectLighting:
            resp_state, cb_state, rng = sample_direct(
                self, p, prop, medium, resp_state, cb_state, rng
            )
            i_path = 2

        # sample the camera ray
        (lam, lam_c), rng = self.wavelengthSource.sample(p["photons"], rng)
        cam, rng = self.camera.sample_ray(p["camera"], lam, rng)
        if self.polarized:
            if cam.mueller is None:
                raise ValueError(
                    f"camera {type(self.camera).__name__} does not provide "
                    "polarization frames"
                )
            pol = (cam.mueller, cam.pol_ref)
        else:
            pol = None
        constants = medium_constants(medium, lam)
        ray = RayState(
            position=cam.position,
            direction=cam.direction,
            wavelength=lam,
            time=cam.time_delta,
            lin_contrib=cam.contrib * lam_c,
            log_contrib=jnp.zeros_like(lam),
            constants=constants,
        )
        alive = active_lanes(streams, p) & ~ray.is_bad()
        cb_state = self.callback.on_event(
            p["callback"],
            cb_state,
            ray,
            jnp.full_like(streams, int(EventResultCode.RAY_CREATED), jnp.int32),
            alive,
            i_path,
        )
        i_path += 1

        def body(i, carry):
            ray, alive, pol, rng, resp_state, cb_state = carry
            pre_alive = alive

            # trace (tracer.volume.backward.glsl:86-115)
            uu, rng = rng.uniform()
            dist = sample_scatter_length(ray, prop, uu)
            if self.target is not None:
                hit = self.target.intersect(
                    p["target"], ray.position, ray.direction
                )
                shadowed = hit.valid & (hit.dist <= dist)
                dist = jnp.where(shadowed, hit.dist, dist)
            else:
                shadowed = jnp.zeros_like(alive)
            ray, code = propagate_ray(ray, dist, prop)
            ray = update_ray_is(ray, dist, prop, shadowed)
            code = jnp.where(
                shadowed, jnp.int32(EventResultCode.RAY_ABSORBED), code
            )
            step_ok = pre_alive & ~shadowed & (code >= 0)

            # shadow ray: connect scatter vertex to the light
            rng_b = rng
            light, rng = self.source.sample_backward(
                p["lightSource"],
                ray.position,
                jnp.zeros_like(ray.position),
                ray.wavelength,
                ray.constants,
                rng,
            )
            visible = self._visible(p, light.position, ray.position)
            conn = scatter_ray(ray, medium, -light.direction)
            contrib, time, ok = combine_rays_aligned(
                conn, light.position, light.contrib, light.start_time, prop
            )
            ok &= step_ok & visible
            stokes = hit_pol_ref = None
            if pol is not None:
                # extend the mueller chain by the connection scatter, then
                # transport the light's stokes vector through it
                conn_mueller, conn_ref = _mueller_scatter(
                    medium, ray.direction, -light.direction, pol[0], pol[1]
                )
                stokes, s0 = _connect_stokes(conn_mueller, conn_ref, light)
                contrib = contrib * s0
                ok &= contrib > 0.0
                hit_pol_ref = cam.hit_pol_ref
            item = HitItem(
                position=cam.hit_position,
                direction=cam.hit_direction,
                normal=cam.hit_normal,
                wavelength=ray.wavelength,
                time=time,
                contrib=contrib,
                object_id=cam.object_id,
                stokes=stokes,
                pol_ref=hit_pol_ref,
            )
            resp_state, rng = self.response.record(
                p["response"], resp_state, item, ok, rng
            )
            rng = _merge_dim(rng, rng_b, step_ok)

            code = jnp.where(
                step_ok, jnp.int32(EventResultCode.RAY_SCATTERED), code
            )
            alive = pre_alive & step_ok
            cb_state = self.callback.on_event(
                p["callback"], cb_state, ray, code, pre_alive, i_path + i
            )

            # scatter for the next segment (skipped on the last iteration)
            rng_b = rng
            (u1, u2), rng = rng.uniform2d()
            cos_theta, phi, _ = sample_scatter_dir_medium(
                medium, ray.direction, ray.wavelength, u1, u2
            )
            new_dir = scatter_dir(
                ray.direction, lax.stop_gradient(cos_theta), phi
            )
            scattered = replace(
                ray,
                direction=new_dir,
                lin_contrib=ray.lin_contrib * ray.constants.mu_s,
            )
            if medium is not None and medium.log_phase_function is not None:
                log_p = lookup(
                    medium.log_phase_function,
                    0.5 * (lax.stop_gradient(cos_theta) + 1.0),
                )
                scattered = replace(
                    scattered,
                    log_contrib=scattered.log_contrib
                    + log_p
                    - lax.stop_gradient(log_p),
                )
            do_scatter = alive & (i < self.nScattering - 2)
            if pol is not None:
                new_mueller, new_ref = _mueller_scatter(
                    medium, ray.direction, new_dir, pol[0], pol[1]
                )
                m4 = do_scatter[..., None, None]
                m3 = do_scatter[..., None]
                pol = (
                    jnp.where(m4, new_mueller, pol[0]),
                    jnp.where(m3, new_ref, pol[1]),
                )
            ray = jax.tree.map(
                lambda new, old: jnp.where(
                    do_scatter.reshape(
                        do_scatter.shape + (1,) * (new.ndim - do_scatter.ndim)
                    ),
                    new,
                    old,
                ),
                scattered,
                ray,
            )
            rng = _merge_dim(rng, rng_b, do_scatter)
            return ray, alive, pol, rng, resp_state, cb_state

        carry = (ray, alive, pol, rng, resp_state, cb_state)
        # the reference loop runs PATH_LENGTH-1 iterations: shadow rays
        # already extend every path by one segment
        ray, alive, pol, rng, resp_state, cb_state = lax.fori_loop(
            0, self.nScattering - 1, body, carry
        )
        cb_state = self.callback.on_event(
            p["callback"],
            cb_state,
            ray,
            jnp.full_like(streams, int(EventResultCode.MAX_ITER), jnp.int32),
            alive,
            i_path + self.nScattering - 1,
        )
        return resp_state, cb_state

