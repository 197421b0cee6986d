"""Camera-origin scene tracers.

``SceneBackwardTargetTracer``: camera rays traced through the scene; hits
on geometry flagged LIGHT_SOURCE produce responses — simulating an
in-scene detector without an explicit light model (reference:
src/theia/trace.py:1605-1880, shader/tracer.scene.backward.target.glsl;
reuses the generic traverse with SCENE_TRAVERSE_BACKWARD).

``SceneBackwardTracer``: camera rays scatter through the scene; every
volume vertex is connected to the light with a scene-occlusion-tested
shadow ray (reference: src/theia/trace.py:1339-1602,
shader/tracer.scene.backward.glsl, shader/scene.traverse.backward.glsl).
"""

from __future__ import annotations

from dataclasses import replace
from typing import TYPE_CHECKING

import jax
import jax.numpy as jnp
from jax import lax

from ..compile_cache import jit
from .. import units as u
from ..accel import intersect_scene, is_visible
from ..callback import EmptyEventCallback, TraceEventCallback
from ..camera import Camera
from ..component import Component, TraceConfig
from ..light import LightSource, WavelengthSource
from ..material import MaterialFlags, packed_medium_constants
from ..ops.math3d import dot, matmul, matvec
from ..ops.sampling import scatter_dir
from ..polarization import (
    apply_rotation,
    polarizer_coeffs,
    polarizer_mueller,
    rotate_pol_ref,
    rotation_coeffs,
    rotation_mueller,
    unpolarized_stokes,
)
from ..random import PhiloxRNG, RNGState
from ..scene import Scene
from ..target import TargetGuide
from .backward import combine_rays_aligned, sample_direct
from .core import (
    TracerBase,
    active_lanes,
    EventResultCode,
    HitItem,
    PropagateParams,
    RayState,
    propagate_ray,
    reattach_geometry,
    sample_scatter_length,
    update_ray_is,
)
from .scene import SceneForwardTracer, _merge_dim

if TYPE_CHECKING:
    from ..response import HitResponse

__all__ = ["SceneBackwardTargetTracer", "SceneBackwardTracer"]


class SceneBackwardTargetTracer(SceneForwardTracer):
    """Camera-origin tracing detecting LIGHT_SOURCE-flagged geometry."""

    name = "Scene Backward Target Tracer"
    _target_bit = int(MaterialFlags.LIGHT_SOURCE)
    _no_r_bit = int(MaterialFlags.NO_REFLECT_BWD)
    _no_t_bit = int(MaterialFlags.NO_TRANSMIT_BWD)
    _transmit_eta2 = True

    def __init__(
        self,
        batchSize: int,
        camera: Camera,
        wavelengthSource: WavelengthSource,
        response: "HitResponse",
        rng: PhiloxRNG,
        scene: Scene,
        *,
        medium: str | None = None,
        maxPathLength: int = 6,
        targetId: int = -1,
        targetGuide: TargetGuide | None = None,
        **kwargs,
    ) -> None:
        self.camera = camera
        kwargs.pop("disableDirectLighting", None)
        if kwargs.get("polarized"):
            raise NotImplementedError(
                "polarized backward scene tracing (Mueller transport) is not "
                "yet supported"
            )
        # reference accounting (trace.py:1729-1738)
        super().__init__(
            batchSize,
            _CameraAsSource(camera),
            wavelengthSource,
            response,
            rng,
            scene,
            maxPathLength=maxPathLength,
            targetId=targetId,
            targetGuide=targetGuide,
            sourceMedium=medium,
            # there is no direct-light prologue in this mode; the flag only
            # gates the initial allow_response which must be True
            disableDirectLighting=False,
            **kwargs,
        )

    def _sample_initial(self, p, pack, streams, rng):
        (lam, lam_contrib), rng = self.wavelengthSource.sample(p["photons"], rng)
        cam, rng = self.camera.sample_ray(p["camera"], lam, rng)
        medium = jnp.full(
            streams.shape, pack.media.handle(self.sourceMedium), jnp.int32
        )
        constants = packed_medium_constants(pack.media, medium, lam)
        ray = RayState(
            position=cam.position,
            direction=cam.direction,
            wavelength=lam,
            time=cam.time_delta,
            lin_contrib=cam.contrib * lam_contrib,
            log_contrib=jnp.zeros_like(lam),
            constants=constants,
        )
        # polarized backward rays would carry a Mueller matrix instead of a
        # Stokes vector (reference: ray.glsl PolarizedBackwardRay); not yet
        # supported here — guarded in __init__.
        return ray, medium, None, rng

    def params(self):
        p = super().params()
        p["camera"] = self.camera.params()
        return p

    def collectStages(self):
        stages = [("photons", self.wavelengthSource), ("camera", self.camera)]
        if self.targetGuide is not None:
            stages.append(("guide", self.targetGuide))
        stages += [
            ("tracer", self),
            ("callback", self.callback),
            ("response", self.response),
        ]
        return stages


class _CameraAsSource:
    """Adapter so SceneForwardTracer's constructor checks pass; actual
    sampling is overridden in _sample_initial."""

    supportForward = True
    nRNGForward = 0

    def __init__(self, camera: Camera) -> None:
        self.nRNGForward = camera.nRNGSamples

    def params(self):
        return {}


class SceneBackwardTracer(TracerBase):
    """Camera-origin scene tracing with per-vertex light connections."""

    name = "Scene Backward Tracer"
    _param_names = ("scatterCoefficient", "maxTime")

    def __init__(
        self,
        batchSize: int,
        source: LightSource,
        camera: Camera,
        wavelengthSource: WavelengthSource,
        response: "HitResponse",
        rng: PhiloxRNG,
        scene: Scene,
        *,
        capacity: int | None = None,
        callback: TraceEventCallback | None = None,
        medium: str | None = None,
        maxPathLength: int = 6,
        scatterCoefficient: float = float("nan"),
        maxTime: float = 1000.0 * u.ns,
        polarized: bool = False,
        disableDirectLighting: bool = False,
        disableTransmission: bool = False,
        disableVolumeBorder: bool = False,
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
        self.scene = scene
        self.callback = EmptyEventCallback() if callback is None else callback
        self.camMedium = medium if medium is not None else scene.medium
        self.maxPathLength = maxPathLength
        self.scatterCoefficient = scatterCoefficient
        self.maxTime = maxTime
        self.polarized = polarized
        self.disableDirectLighting = disableDirectLighting
        self.disableTransmission = disableTransmission
        self.disableVolumeBorder = disableVolumeBorder

        # reference accounting (trace.py:1459-1471)
        maxHits = maxPathLength + (0 if disableDirectLighting else 1)
        self.maxHitsPerThread = maxHits
        rngStride = 3 + source.nRNGBackward
        rngPre = wavelengthSource.nRNGSamples + camera.nRNGSamples
        if not disableDirectLighting:
            rngPre += (
                wavelengthSource.nRNGSamples
                + camera.nRNGDirect
                + source.nRNGBackward
            )
        self.nRNGSamples = (
            rngPre + rngStride * maxPathLength + maxHits * response.nRNGSamples
        )
        rng.configure(self.nRNGSamples, self.capacity)
        response.prepare(
            TraceConfig(
                batch_size=batchSize,
                capacity=self.capacity,
                max_hits_per_thread=maxHits,
                normalization=self.normalization,
                polarized=polarized,
            )
        )
        self._jit_trace = jit(self._trace_batch)

    def collectStages(self):
        return [
            ("photons", self.wavelengthSource),
            ("lightSource", self.source),
            ("camera", self.camera),
            ("tracer", self),
            ("callback", self.callback),
            ("response", self.response),
        ]

    def params(self):
        return {
            "tracer": {
                "batchSize": jnp.asarray(self.batchSize, jnp.uint32),
                "scatterCoefficient": jnp.asarray(
                    self.scatterCoefficient, jnp.float32
                ),
                "maxTime": jnp.asarray(self.maxTime, jnp.float32),
            },
            "scene": self.scene.pack,
            "photons": self.wavelengthSource.params(),
            "lightSource": self.source.params(),
            "camera": self.camera.params(),
            "response": self.response.params(),
            "callback": self.callback.params(),
            # extracted on host: table slicing must not happen under trace
            "camMedium": (
                self.scene.materials.media.medium(self.camMedium)
                if self.camMedium
                else None
            ),
        }

    def _trace_batch(self, p, counter, streams):
        pack = p["scene"]
        prop = PropagateParams(
            scatter_coefficient=p["tracer"]["scatterCoefficient"],
            lower_bbox=pack.lower_bbox,
            upper_bbox=pack.upper_bbox,
            max_time=p["tracer"]["maxTime"],
            max_dist=jnp.linalg.norm(pack.upper_bbox - pack.lower_bbox),
        )
        rng = self.rng.state_for(counter, streams)
        resp_state = self.response.init()
        cb_state = self.callback.init(streams.shape[0], self.maxPathLength + 4)
        cam_medium_name = self.camMedium
        medium_pytree = p["camMedium"]

        i_path = 0
        if not self.disableDirectLighting:
            resp_state, cb_state, rng = sample_direct(
                self,
                p,
                prop,
                medium_pytree,
                resp_state,
                cb_state,
                rng,
                occluder=lambda a, b: is_visible(pack, a, b),
            )
            i_path = 2

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
        medium = jnp.full(
            streams.shape, pack.media.handle(cam_medium_name), jnp.int32
        )
        constants = packed_medium_constants(pack.media, medium, lam)
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

        surf_tracer = make_surface_interactor(
            disable_transmission=self.disableTransmission,
            disable_volume_border=self.disableVolumeBorder,
        )

        def body(i, carry):
            ray, medium, alive, pol, rng, resp_state, cb_state = carry
            pre_alive = alive
            bad = ray.is_bad()
            alive = alive & ~bad
            pre_alive = alive

            uu, rng = rng.uniform()
            dist = sample_scatter_length(ray, prop, uu)
            hit = intersect_scene(pack, medium, ray.position, ray.direction, dist)
            travel = jnp.where(hit.valid, hit.t, dist)
            ray, code = propagate_ray(ray, travel, prop)
            # hit.t is geometric (differentiable in intersect_scene) —
            # reattach so camera-side bounce segments carry d/d(geometry)
            # like the forward tracer (core.reattach_geometry)
            ray = reattach_geometry(ray, travel, valid=hit.valid)
            ray = update_ray_is(ray, travel, prop, hit.valid)
            code = jnp.where(hit.valid & (hit.error != 0), hit.error, code)
            in_bounds = code >= 0
            surf = pre_alive & in_bounds & hit.valid

            ray = replace(
                ray,
                position=jnp.where(surf[..., None], hit.world_pos, ray.position),
            )
            # surface interaction (backward flags, eta^2 on transmission)
            # capture the incident direction for the Mueller alignment
            ray, medium, code2, absorbed_surf, rng, pol = surf_tracer(
                p, prop, pack, ray, medium, hit, surf, rng, pol
            )

            miss = pre_alive & in_bounds & ~hit.valid
            # shadow ray at volume vertices
            rng_b = rng
            light, rng = self.source.sample_backward(
                p["lightSource"],
                ray.position,
                jnp.zeros_like(ray.position),
                ray.wavelength,
                ray.constants,
                rng,
            )
            visible = is_visible(pack, light.position, ray.position)
            # scatter the connection ray toward the light (phase factor)
            from ..material import lookup_packed
            import numpy as np

            cos_theta = dot(ray.direction, -light.direction)
            log_p = lookup_packed(
                pack.media.tables["log_phase_function"],
                pack.media.sizes["log_phase_function"],
                medium,
                0.5 * (cos_theta + 1.0),
                jnp.log(jnp.float32(1.0 / (4.0 * np.pi))),
            )
            conn = replace(
                ray,
                direction=-light.direction,
                lin_contrib=ray.lin_contrib * ray.constants.mu_s,
                log_contrib=ray.log_contrib + log_p,
            )
            contrib, time, ok = combine_rays_aligned(
                conn, light.position, light.contrib, light.start_time, prop
            )
            ok &= miss & visible
            stokes = hit_pol_ref = None
            if pol is not None:
                conn_mueller, conn_ref = _mueller_scatter_packed(
                    pack.media, medium, ray.direction, -light.direction,
                    pol[0], pol[1],
                )
                stokes, s0 = _connect_stokes_bwd(conn_mueller, conn_ref, light)
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
            rng = _merge_dim(rng, rng_b, miss)

            # scatter the real ray at volume vertices
            rng_b = rng
            (s1, s2), rng = rng.uniform2d()
            new_dir, _, scat_log_p = _sample_phase(pack, medium, ray.direction, s1, s2)
            if pol is not None:
                new_mueller, new_ref = _mueller_scatter_packed(
                    pack.media, medium, ray.direction, new_dir, pol[0], pol[1]
                )
                pol = (
                    jnp.where(miss[..., None, None], new_mueller, pol[0]),
                    jnp.where(miss[..., None], new_ref, pol[1]),
                )
            ray = replace(
                ray,
                direction=jnp.where(miss[..., None], new_dir, ray.direction),
                lin_contrib=jnp.where(
                    miss, ray.lin_contrib * ray.constants.mu_s, ray.lin_contrib
                ),
                log_contrib=jnp.where(
                    miss,
                    ray.log_contrib + scat_log_p - lax.stop_gradient(scat_log_p),
                    ray.log_contrib,
                ),
            )
            rng = _merge_dim(rng, rng_b, miss)

            code = jnp.where(surf, code2, code)
            code = jnp.where(miss, jnp.int32(EventResultCode.RAY_SCATTERED), code)
            alive = pre_alive & (code >= 0) & ~absorbed_surf
            cb_state = self.callback.on_event(
                p["callback"], cb_state, ray, code, pre_alive, i_path + i
            )
            return ray, medium, alive, pol, rng, resp_state, cb_state

        carry = (ray, medium, alive, pol, rng, resp_state, cb_state)
        # PATH_LENGTH - 1 iterations: shadow rays extend every path by one
        ray, medium, alive, pol, rng, resp_state, cb_state = lax.fori_loop(
            0, self.maxPathLength - 1, body, carry
        )
        cb_state = self.callback.on_event(
            p["callback"],
            cb_state,
            ray,
            jnp.full_like(streams, int(EventResultCode.MAX_ITER), jnp.int32),
            alive,
            i_path + self.maxPathLength - 1,
        )
        return resp_state, cb_state



def _sample_phase(pack, medium, direction, u1, u2):
    """Packed-table phase sampling shared with the forward scene tracer."""
    import numpy as np

    from ..material import lookup_packed

    phi = jnp.float32(2.0 * np.pi) * u1
    tbl = pack.media.tables["phase_sampling"]
    sizes = pack.media.sizes["phase_sampling"]
    cos_tab = lookup_packed(tbl, sizes, medium, u2, 0.0)
    has_tab = jnp.take(sizes, medium) > 0
    cos_theta = jnp.where(has_tab, jnp.clip(cos_tab, -1.0, 1.0), 2.0 * u2 - 1.0)
    cos_theta = lax.stop_gradient(cos_theta)
    direction_new = scatter_dir(direction, cos_theta, phi)
    log_p = lookup_packed(
        pack.media.tables["log_phase_function"],
        pack.media.sizes["log_phase_function"],
        medium,
        0.5 * (cos_theta + 1.0),
        jnp.log(jnp.float32(1.0 / (4.0 * np.pi))),
    )
    return direction_new, jnp.exp(log_p), log_p


def _mueller_scatter_packed(store, handle, direction, new_dir, mueller, pol_ref):
    """Backward volume scatter on the accumulated Mueller chain using the
    packed per-medium phase matrices: mueller <- mueller @ rotate^T @ phase
    (reference: ray.scatter.glsl _scatterPolRay_impl backward)."""
    from ..polarization import phase_mueller
    from .scene import _phase_matrix_packed

    cos_theta = dot(direction, new_dir)
    m12, m22, m33, m34 = _phase_matrix_packed(store, handle, cos_theta)
    new_ref, c, s = rotate_pol_ref(direction, pol_ref, new_dir)
    rot_t = jnp.swapaxes(rotation_mueller(c, s), -1, -2)
    return matmul(matmul(mueller, rot_t), phase_mueller(m12, m22, m33, m34)), new_ref


def _connect_stokes_bwd(mueller, pol_ref, light):
    """Transport the light's Stokes through the Mueller chain
    (reference: ray.combine.glsl combineRaysAligned polarized)."""
    from ..ops.math3d import local_frame

    l_stokes = (
        light.stokes
        if light.stokes is not None
        else unpolarized_stokes(light.contrib.shape)
    )
    l_ref = (
        light.pol_ref
        if light.pol_ref is not None
        else local_frame(light.direction)[0]
    )
    c, s = rotation_coeffs(light.direction, l_ref, pol_ref)
    stokes = matvec(mueller, apply_rotation(l_stokes, c, s)
    )
    s0 = stokes[..., 0]
    safe = jnp.where(jnp.abs(s0) > 1e-30, s0, 1.0)
    return stokes / safe[..., None], s0


def make_surface_interactor(
    *,
    no_r_bit: int = int(MaterialFlags.NO_REFLECT_BWD),
    no_t_bit: int = int(MaterialFlags.NO_TRANSMIT_BWD),
    eta2: bool = True,
    disable_transmission: bool = False,
    disable_volume_border: bool = False,
    pol_mode: str = "mueller",
):
    """Surface interaction (Fresnel reflect/transmit IS) parameterized by
    transport direction (reference: scene.traverse.backward.glsl:19-89 /
    scene.traverse.glsl:73-154)."""
    from ..accel import offset_ray
    from ..material import lookup_packed
    from .scene import _reflect, _refract

    _BLACK = int(MaterialFlags.BLACK_BODY)
    _VOL = int(MaterialFlags.VOLUME_BORDER)
    _NO_R = no_r_bit
    _NO_T = no_t_bit

    def interact(p, prop, pack, ray, medium, hit, surf, rng, pol=None):
        flags = hit.flags
        is_abs = (flags & jnp.uint32(_BLACK)) != 0
        vol_border = ((flags & jnp.uint32(_VOL)) != 0) & (
            not disable_volume_border
        )
        can_reflect = (flags & jnp.uint32(_NO_R)) == 0
        can_transmit = ((flags & jnp.uint32(_NO_T)) == 0) & (
            not disable_transmission
        )

        # Fresnel
        cos_i = jnp.clip(dot(ray.direction, hit.ray_nrm), -1.0, 1.0)
        sin_i = jnp.sqrt(jnp.maximum(1.0 - cos_i * cos_i, 0.0))
        n_i = ray.constants.n
        lmin = jnp.take(pack.media.lambda_min, hit.medium_tr)
        lmax = jnp.take(pack.media.lambda_max, hit.medium_tr)
        t = jnp.clip((ray.wavelength - lmin) / (lmax - lmin), 0.0, 1.0)
        n_t = lookup_packed(
            pack.media.tables["refractive_index"],
            pack.media.sizes["refractive_index"],
            hit.medium_tr,
            t,
            1.0,
        )
        sin_t = sin_i * n_i / n_t
        # double-where keeps the IOR gradient NaN-free on TIR lanes
        s2 = 1.0 - sin_t * sin_t
        tir = s2 <= 0.0
        cos_t = jnp.where(tir, 0.0, jnp.sqrt(jnp.where(tir, 1.0, s2)))
        cos_ia = jnp.abs(cos_i)
        r_s = (n_i * cos_ia - n_t * cos_t) / (n_i * cos_ia + n_t * cos_t)
        r_p = (n_t * cos_ia - n_i * cos_t) / (n_t * cos_ia + n_i * cos_t)
        r_coef = 0.5 * (r_s * r_s + r_p * r_p)

        u_surf, rng_a = rng.uniform()
        both = surf & ~is_abs & ~vol_border & can_reflect & can_transmit
        rng = _merge_dim(rng_a, rng, both)
        do_reflect = jnp.where(both, u_surf < lax.stop_gradient(r_coef), can_reflect)
        absorbed = surf & (is_abs | (~can_reflect & ~can_transmit & ~vol_border))

        eta = n_i / n_t
        refl_dir = _reflect(ray.direction, hit.ray_nrm)
        refl_pos = offset_ray(hit.world_pos, hit.ray_nrm)
        # refracted direction is sampler state -> detached (IOR gradient
        # flows through the contribution factors, not the geometry)
        trans_dir = _refract(ray.direction, hit.ray_nrm, lax.stop_gradient(eta))
        trans_pos = offset_ray(hit.world_pos, -hit.ray_nrm)
        refl_factor = jnp.where(both, 1.0, r_coef)
        trans_factor = jnp.where(both, 1.0, 1.0 - r_coef)
        if eta2:
            trans_factor = trans_factor * eta * eta

        sel_r = surf & ~is_abs & ~vol_border & do_reflect & can_reflect
        sel_t = surf & ~is_abs & ~vol_border & ~do_reflect & can_transmit
        if pol is not None and pol_mode == "mueller":
            # align the chain to the plane of incidence, then extend by the
            # Fresnel polarizer of the taken branch (reference:
            # ray.propagate.glsl alignRayToHit backward + ray.surface.glsl)
            mueller, pref = pol
            a_ref, ac, as_ = rotate_pol_ref(ray.direction, pref, hit.ray_nrm)
            rot_t = jnp.swapaxes(rotation_mueller(ac, as_), -1, -2)
            m4 = surf[..., None, None]
            mueller = jnp.where(m4, matmul(mueller, rot_t), mueller)
            pref = jnp.where(surf[..., None], a_ref, pref)
            _, m12_r, m33_r = polarizer_coeffs(r_p, r_s)
            t_s = r_s + 1.0
            t_p = (r_p + 1.0) * eta
            _, m12_t, m33_t = polarizer_coeffs(t_p, t_s)
            mueller = jnp.where(
                sel_r[..., None, None],
                matmul(mueller, polarizer_mueller(m12_r, m33_r)),
                jnp.where(
                    sel_t[..., None, None],
                    matmul(mueller, polarizer_mueller(m12_t, m33_t)),
                    mueller,
                ),
            )
            pol = (mueller, pref)
        elif pol is not None:
            # forward (Stokes) variant: rotate then apply the polarizer
            # (reference: ray.surface.glsl reflectRay/transmitRay forward)
            from ..polarization import apply_polarizer, apply_rotation

            stokes, pref = pol
            a_ref, ac, as_ = rotate_pol_ref(ray.direction, pref, hit.ray_nrm)
            a_stokes = apply_rotation(stokes, ac, as_)
            stokes = jnp.where(surf[..., None], a_stokes, stokes)
            pref = jnp.where(surf[..., None], a_ref, pref)
            _, m12_r, m33_r = polarizer_coeffs(r_p, r_s)
            t_s = r_s + 1.0
            t_p = (r_p + 1.0) * eta
            _, m12_t, m33_t = polarizer_coeffs(t_p, t_s)
            stokes = jnp.where(
                sel_r[..., None],
                apply_polarizer(stokes, m12_r, m33_r),
                jnp.where(
                    sel_t[..., None],
                    apply_polarizer(stokes, m12_t, m33_t),
                    stokes,
                ),
            )
            pol = (stokes, pref)
        new_medium = jnp.where(
            surf & (vol_border | sel_t), hit.medium_tr, medium
        )
        crossed = new_medium != medium
        new_dir = jnp.where(
            sel_r[..., None],
            refl_dir,
            jnp.where(sel_t[..., None], trans_dir, ray.direction),
        )
        new_pos = jnp.where(
            sel_r[..., None],
            refl_pos,
            jnp.where(
                (sel_t | (surf & vol_border))[..., None],
                jnp.where(sel_t[..., None], trans_pos, offset_ray(hit.world_pos, -hit.ray_nrm)),
                ray.position,
            ),
        )
        new_lin = jnp.where(
            sel_r,
            ray.lin_contrib * refl_factor,
            jnp.where(sel_t, ray.lin_contrib * trans_factor, ray.lin_contrib),
        )
        constants = packed_medium_constants(pack.media, new_medium, ray.wavelength)
        ray = RayState(
            position=new_pos,
            direction=new_dir,
            wavelength=ray.wavelength,
            time=ray.time,
            lin_contrib=new_lin,
            log_contrib=ray.log_contrib,
            constants=jax.tree.map(
                lambda new, old: jnp.where(crossed, new, old),
                constants,
                ray.constants,
            ),
        )
        code = jnp.where(
            surf & vol_border,
            jnp.int32(EventResultCode.VOLUME_HIT),
            jnp.int32(EventResultCode.RAY_HIT),
        )
        code = jnp.where(absorbed, jnp.int32(EventResultCode.RAY_ABSORBED), code)
        return ray, new_medium, code, absorbed, rng, pol

    return interact
