"""Bidirectional path tracer.

Traces a light subpath (volume vertices stored per lane), then a camera
subpath; every camera vertex is connected to every stored light vertex in
the same medium with a visibility-tested connection weighted by
1/n(pathLength) (reference: src/theia/trace.py:2098-2367,
shader/tracer.bidirectional.glsl). By construction it misses direct and
single-scatter light — pair with a DirectLightTracer
(reference: trace.py:2174-2179).

Wavefront design: the per-thread vertex registers become (L, N, ...) arrays in
the loop carry; the camera loop connects to all L vertices vectorized.
"""

from __future__ import annotations

from dataclasses import replace
from typing import TYPE_CHECKING

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ..compile_cache import jit
from .. import units as u
from ..accel import intersect_scene, is_visible
from ..callback import EmptyEventCallback, TraceEventCallback
from ..camera import Camera
from ..component import Component, TraceConfig
from ..light import LightSource, WavelengthSource
from ..material import MaterialFlags, lookup_packed, packed_medium_constants
from ..ops.math3d import distance, dot, local_frame, matmul, matvec, normalize
from ..polarization import (
    apply_phase_matrix,
    apply_rotation,
    rotate_pol_ref,
    rotation_coeffs,
    rotation_mueller,
    phase_mueller,
    unpolarized_stokes,
)
from ..random import PhiloxRNG, RNGState
from ..scene import Scene
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
    update_ray,
    update_ray_is,
)
from .scene import _merge_dim, _phase_matrix_packed, _pol_scatter_packed
from .scene_backward import (
    _mueller_scatter_packed,
    _sample_phase,
    make_surface_interactor,
)

if TYPE_CHECKING:
    from ..response import HitResponse

__all__ = ["BidirectionalPathTracer"]


class BidirectionalPathTracer(TracerBase):
    """Bidirectional volume path tracing against a scene."""

    name = "Bidirectional Path Tracer"
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
        callbackScope: str = "both",
        cameraMedium: str | None = None,
        lightPathLength: int = 6,
        cameraPathLength: int = 6,
        scatterCoefficient: float = float("nan"),
        maxTime: float = 1000.0 * u.ns,
        polarized: bool = False,
        disableTransmission: bool = False,
        disableVolumeBorder: bool = False,
    ) -> None:
        if not source.supportForward:
            raise ValueError("light source does not support forward mode")
        self._init_batch(batchSize, capacity)
        self.source = source
        self.camera = camera
        self.wavelengthSource = wavelengthSource
        self.response = response
        self.rng = rng
        self.scene = scene
        self.callback = EmptyEventCallback() if callback is None else callback
        self.callbackScope = callbackScope
        self.cameraMedium = (
            cameraMedium if cameraMedium is not None else scene.medium
        )
        self.lightPathLength = lightPathLength
        self.cameraPathLength = cameraPathLength
        self.scatterCoefficient = scatterCoefficient
        self.maxTime = maxTime
        self.polarized = polarized
        self.disableTransmission = disableTransmission
        self.disableVolumeBorder = disableVolumeBorder

        # reference accounting (trace.py:2204-2214): 4 draws per segment on
        # both subpaths plus the initial samples
        self.maxHitsPerThread = lightPathLength * cameraPathLength
        self.nRNGSamples = (
            wavelengthSource.nRNGSamples
            + source.nRNGForward
            + camera.nRNGSamples
            + 4 * (lightPathLength + cameraPathLength)
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
        }

    def _normalize_path(self, path_length):
        """1/n(len): number of estimators covering this path length
        (reference: tracer.bidirectional.glsl:57-66)."""
        l = path_length.astype(jnp.int32)
        n = l - 2
        n = n - jnp.maximum(l - 2 - self.cameraPathLength, 0)
        n = n - jnp.maximum(l - 2 - self.lightPathLength, 0)
        n = jnp.maximum(n, 1)
        return 1.0 / n.astype(jnp.float32)

    def _trace_batch(self, p, counter, streams):
        pack = p["scene"]
        N = streams.shape[0]
        L = self.lightPathLength
        prop = PropagateParams(
            scatter_coefficient=p["tracer"]["scatterCoefficient"],
            lower_bbox=pack.lower_bbox,
            upper_bbox=pack.upper_bbox,
            max_time=p["tracer"]["maxTime"],
            max_dist=jnp.linalg.norm(pack.upper_bbox - pack.lower_bbox),
        )
        rng = self.rng.state_for(counter, streams)
        resp_state = self.response.init()
        cb_state = self.callback.init(
            N, self.lightPathLength + self.cameraPathLength + 4
        )
        fwd_surface = make_surface_interactor(
            no_r_bit=int(MaterialFlags.NO_REFLECT_FWD),
            no_t_bit=int(MaterialFlags.NO_TRANSMIT_FWD),
            eta2=False,
            disable_transmission=self.disableTransmission,
            disable_volume_border=self.disableVolumeBorder,
            pol_mode="stokes",
        )
        bwd_surface = make_surface_interactor(
            disable_transmission=self.disableTransmission,
            disable_volume_border=self.disableVolumeBorder,
        )

        # ---- light subpath -------------------------------------------------
        (lam, lam_c), rng = self.wavelengthSource.sample(p["photons"], rng)
        scene_medium = jnp.full(
            N, pack.media.handle(self.scene.medium), jnp.int32
        )
        constants = packed_medium_constants(pack.media, scene_medium, lam)
        src, rng = self.source.sample_forward(p["lightSource"], lam, constants, rng)
        ray = RayState(
            position=src.position,
            direction=src.direction,
            wavelength=lam,
            time=src.start_time,
            lin_contrib=src.contrib * lam_c,
            log_contrib=jnp.zeros_like(lam),
            constants=constants,
        )
        medium = scene_medium
        alive = active_lanes(streams, p) & ~ray.is_bad()
        if self.polarized:
            stokes = (
                src.stokes if src.stokes is not None else unpolarized_stokes(lam.shape)
            )
            s_ref = (
                src.pol_ref
                if src.pol_ref is not None
                else local_frame(src.direction)[0]
            )
            pol_l = (stokes, s_ref)
        else:
            pol_l = None

        # vertex storage (L, N, ...)
        v_pos = jnp.zeros((L, N, 3), jnp.float32)
        v_dir = jnp.zeros((L, N, 3), jnp.float32)
        v_time = jnp.zeros((L, N), jnp.float32)
        v_contrib = jnp.zeros((L, N), jnp.float32)
        v_medium = jnp.full((L, N), -1, jnp.int32)  # -1 = not connectable
        if self.polarized:
            v_stokes = jnp.zeros((L, N, 4), jnp.float32)
            v_ref = jnp.zeros((L, N, 3), jnp.float32)
        else:
            v_stokes = v_ref = jnp.zeros((0,), jnp.float32)

        def light_body(i, carry):
            ray, medium, alive, rng, pol_l, store = carry
            v_pos, v_dir, v_time, v_contrib, v_medium, v_stokes, v_ref = store
            pre_alive = alive
            last = i == L - 1

            uu, rng = rng.uniform()
            dist = sample_scatter_length(ray, prop, uu)
            hit = intersect_scene(pack, medium, ray.position, ray.direction, dist)
            travel = jnp.where(hit.valid, hit.t, dist)
            ray, code = propagate_ray(ray, travel, prop)
            # geometric hit distance carries d/d(geometry) (core.reattach_geometry)
            ray = reattach_geometry(ray, travel, valid=hit.valid)
            ray = update_ray_is(ray, travel, prop, hit.valid)
            code = jnp.where(hit.valid & (hit.error != 0), hit.error, code)
            in_bounds = code >= 0

            # store vertex: connectable only at volume-scatter vertices
            connectable = pre_alive & in_bounds & ~hit.valid
            v_pos = v_pos.at[i].set(ray.position)
            v_dir = v_dir.at[i].set(ray.direction)
            v_time = v_time.at[i].set(ray.time)
            v_contrib = v_contrib.at[i].set(ray.contrib)
            v_medium = v_medium.at[i].set(jnp.where(connectable, medium, -1))
            if pol_l is not None:
                v_stokes = v_stokes.at[i].set(pol_l[0])
                v_ref = v_ref.at[i].set(pol_l[1])

            surf = pre_alive & in_bounds & hit.valid
            ray = replace(
                ray,
                position=jnp.where(surf[..., None], hit.world_pos, ray.position),
            )
            ray, medium, code2, absorbed, rng, pol_l = fwd_surface(
                p, prop, pack, ray, medium, hit, surf, rng, pol_l
            )
            miss = pre_alive & in_bounds & ~hit.valid & ~last
            rng_b = rng
            (s1, s2), rng = rng.uniform2d()
            new_dir, _, log_p = _sample_phase(pack, medium, ray.direction, s1, s2)
            if pol_l is not None:
                n_stokes, n_ref = _pol_scatter_packed(
                    pack.media, medium, ray.direction, new_dir, pol_l
                )
                pol_l = (
                    jnp.where(miss[..., None], n_stokes, pol_l[0]),
                    jnp.where(miss[..., None], n_ref, pol_l[1]),
                )
            ray = replace(
                ray,
                direction=jnp.where(miss[..., None], new_dir, ray.direction),
                lin_contrib=jnp.where(
                    miss, ray.lin_contrib * ray.constants.mu_s, ray.lin_contrib
                ),
                log_contrib=jnp.where(
                    miss,
                    ray.log_contrib + log_p - lax.stop_gradient(log_p),
                    ray.log_contrib,
                ),
            )
            rng = _merge_dim(rng, rng_b, miss)
            code = jnp.where(surf, code2, code)
            code = jnp.where(
                pre_alive & in_bounds & ~hit.valid,
                jnp.int32(EventResultCode.RAY_SCATTERED),
                code,
            )
            alive = pre_alive & (code >= 0) & ~absorbed
            return ray, medium, alive, rng, pol_l, (
                v_pos, v_dir, v_time, v_contrib, v_medium, v_stokes, v_ref
            )

        carry = (
            ray, medium, alive, rng, pol_l,
            (v_pos, v_dir, v_time, v_contrib, v_medium, v_stokes, v_ref),
        )
        ray, medium, alive, rng, pol_l, store = lax.fori_loop(
            0, L, light_body, carry
        )
        v_pos, v_dir, v_time, v_contrib, v_medium, v_stokes, v_ref = store

        # ---- camera subpath ------------------------------------------------
        cam, rng = self.camera.sample_ray(p["camera"], lam, rng)
        cam_medium = jnp.full(N, pack.media.handle(self.cameraMedium), jnp.int32)
        constants = packed_medium_constants(pack.media, cam_medium, lam)
        cray = RayState(
            position=cam.position,
            direction=cam.direction,
            wavelength=lam,
            time=cam.time_delta,
            lin_contrib=cam.contrib,
            log_contrib=jnp.zeros_like(lam),
            constants=constants,
        )
        cmedium = cam_medium
        calive = active_lanes(streams, p) & ~cray.is_bad()
        if self.polarized:
            if cam.mueller is None:
                raise ValueError(
                    f"camera {type(self.camera).__name__} does not provide "
                    "polarization frames"
                )
            pol_c = (cam.mueller, cam.pol_ref)
        else:
            pol_c = None

        def connect_all(cray, cmedium, cam_i, pol_c, resp_state, rng):
            """Connect the current camera vertex to every light vertex."""
            # light vertex data: (L, N, ...) vs camera (N, ...)
            same_medium = v_medium == cmedium[None, :]
            visible = jax.vmap(
                lambda lp: is_visible(pack, cray.position, lp)
            )(v_pos)
            conn_dir = normalize(cray.position[None] - v_pos)  # light -> cam
            d = distance(cray.position[None], v_pos)
            # scatter light vertex toward the camera vertex: mu_s * phase
            cos_l = dot(v_dir, conn_dir)
            log_p_l = lookup_packed(
                pack.media.tables["log_phase_function"],
                pack.media.sizes["log_phase_function"],
                jnp.maximum(v_medium, 0),
                0.5 * (cos_l + 1.0),
                jnp.log(jnp.float32(1.0 / (4.0 * np.pi))),
            )
            mu_s = cray.constants.mu_s[None]
            light_contrib = v_contrib * mu_s * jnp.exp(log_p_l)
            # scatter camera ray toward the light vertex: mu_s * phase
            cos_c = dot(cray.direction[None], -conn_dir)
            log_p_c = lookup_packed(
                pack.media.tables["log_phase_function"],
                pack.media.sizes["log_phase_function"],
                jnp.broadcast_to(cmedium[None], cos_c.shape),
                0.5 * (cos_c + 1.0),
                jnp.log(jnp.float32(1.0 / (4.0 * np.pi))),
            )
            cam_factor = cray.lin_contrib[None] * jnp.exp(
                cray.log_contrib[None]
            ) * mu_s * jnp.exp(log_p_c)
            # attenuation over the connection + G term
            mu_e = cray.constants.mu_e[None]
            att = jnp.exp(-mu_e * d)
            vg = cray.constants.vg[None]
            time = v_time + cray.time[None] + d / vg
            path_len = cam_i + jax.lax.broadcasted_iota(jnp.int32, (L, N), 0) + 3
            weight = self._normalize_path(path_len)
            contrib = (
                light_contrib * cam_factor * att * weight / jnp.maximum(d * d, 1e-12)
            )
            ok = (
                same_medium
                & visible
                & calive[None]
                & (contrib > 0.0)
                & (time <= prop.max_time)
            )
            stokes_f = ref_f = None
            if pol_c is not None:
                handles = jnp.maximum(v_medium, 0)
                # scatter the light vertex stokes toward the camera vertex
                # (reference: lightsource.scatter.glsl scatterSourceRay)
                m12, m22, m33, m34 = _phase_matrix_packed(
                    pack.media, handles, cos_l
                )
                l_ref, lc, ls = rotate_pol_ref(v_dir, v_ref, conn_dir)
                l_stokes = apply_phase_matrix(
                    apply_rotation(v_stokes, lc, ls), m12, m22, m33, m34
                )
                # extend the camera mueller chain by its connection scatter
                cm12, cm22, cm33, cm34 = _phase_matrix_packed(
                    pack.media,
                    jnp.broadcast_to(cmedium[None], cos_c.shape),
                    cos_c,
                )
                c_dir = jnp.broadcast_to(cray.direction[None], (L, N, 3))
                c_ref0 = jnp.broadcast_to(pol_c[1][None], (L, N, 3))
                c_ref, cc, cs = rotate_pol_ref(c_dir, c_ref0, -conn_dir)
                rot_t = jnp.swapaxes(rotation_mueller(cc, cs), -1, -2)
                conn_mueller = matmul(
                    matmul(jnp.broadcast_to(pol_c[0][None], (L, N, 4, 4)), rot_t),
                    phase_mueller(cm12, cm22, cm33, cm34),
                )
                # align the light frame to the camera connection frame and
                # transport (reference: ray.combine.glsl combineRaysAligned)
                ac, as_ = rotation_coeffs(conn_dir, l_ref, c_ref)
                stokes_f = matvec(conn_mueller,
                    apply_rotation(l_stokes, ac, as_),
                )
                s0 = stokes_f[..., 0]
                contrib = contrib * s0
                safe = jnp.where(jnp.abs(s0) > 1e-30, s0, 1.0)
                stokes_f = (stokes_f / safe[..., None]).reshape(-1, 4)
                ref_f = jnp.broadcast_to(
                    cam.hit_pol_ref[None], (L, N, 3)
                ).reshape(-1, 3)
                ok = ok & (contrib > 0.0)
            item = HitItem(
                position=jnp.broadcast_to(cam.hit_position[None], (L, N, 3)).reshape(-1, 3),
                direction=jnp.broadcast_to(cam.hit_direction[None], (L, N, 3)).reshape(-1, 3),
                normal=jnp.broadcast_to(cam.hit_normal[None], (L, N, 3)).reshape(-1, 3),
                wavelength=jnp.broadcast_to(lam[None], (L, N)).reshape(-1),
                time=time.reshape(-1),
                contrib=contrib.reshape(-1),
                object_id=jnp.broadcast_to(cam.object_id[None], (L, N)).reshape(-1),
                stokes=stokes_f,
                pol_ref=ref_f,
            )
            resp_state, rng = self.response.record(
                p["response"], resp_state, item, ok.reshape(-1), rng
            )
            return resp_state, rng

        def cam_body(i, carry):
            cray, cmedium, calive, pol_c, rng, resp_state = carry
            pre_alive = calive
            uu, rng = rng.uniform()
            dist = sample_scatter_length(cray, prop, uu)
            hit = intersect_scene(pack, cmedium, cray.position, cray.direction, dist)
            travel = jnp.where(hit.valid, hit.t, dist)
            cray, code = propagate_ray(cray, travel, prop)
            # geometric hit distance carries d/d(geometry) (core.reattach_geometry)
            cray = reattach_geometry(cray, travel, valid=hit.valid)
            cray = update_ray_is(cray, travel, prop, hit.valid)
            code = jnp.where(hit.valid & (hit.error != 0), hit.error, code)
            in_bounds = code >= 0
            miss = pre_alive & in_bounds & ~hit.valid

            # connect this camera vertex to the light path (the reference
            # connects at both volume and surface vertices,
            # tracer.bidirectional.glsl:225-233)
            conn_ok = pre_alive & in_bounds
            conn_ray = replace(
                cray,
                lin_contrib=jnp.where(conn_ok, cray.lin_contrib, 0.0),
            )
            resp_state, rng = connect_all(
                conn_ray, cmedium, i, pol_c, resp_state, rng
            )

            surf = pre_alive & in_bounds & hit.valid
            cray = replace(
                cray,
                position=jnp.where(surf[..., None], hit.world_pos, cray.position),
            )
            cray, cmedium, code2, absorbed, rng, pol_c = bwd_surface(
                p, prop, pack, cray, cmedium, hit, surf, rng, pol_c
            )
            rng_b = rng
            (s1, s2), rng = rng.uniform2d()
            new_dir, _, log_p = _sample_phase(pack, cmedium, cray.direction, s1, s2)
            if pol_c is not None:
                n_mueller, n_ref = _mueller_scatter_packed(
                    pack.media, cmedium, cray.direction, new_dir, pol_c[0], pol_c[1]
                )
                pol_c = (
                    jnp.where(miss[..., None, None], n_mueller, pol_c[0]),
                    jnp.where(miss[..., None], n_ref, pol_c[1]),
                )
            cray = replace(
                cray,
                direction=jnp.where(miss[..., None], new_dir, cray.direction),
                lin_contrib=jnp.where(
                    miss, cray.lin_contrib * cray.constants.mu_s, cray.lin_contrib
                ),
                log_contrib=jnp.where(
                    miss,
                    cray.log_contrib + log_p - lax.stop_gradient(log_p),
                    cray.log_contrib,
                ),
            )
            rng = _merge_dim(rng, rng_b, miss)
            code = jnp.where(surf, code2, code)
            code = jnp.where(miss, jnp.int32(EventResultCode.RAY_SCATTERED), code)
            calive = pre_alive & (code >= 0) & ~absorbed
            return cray, cmedium, calive, pol_c, rng, resp_state

        carry = (cray, cmedium, calive, pol_c, rng, resp_state)
        cray, cmedium, calive, pol_c, rng, resp_state = lax.fori_loop(
            0, self.cameraPathLength, cam_body, carry
        )
        return resp_state, cb_state

