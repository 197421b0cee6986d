"""Scene tracers: full geometry with Fresnel media boundaries.

``SceneForwardTracer`` reproduces the reference's scene path tracer —
per segment: exponential distance sampling, (optional) target-guide
free-shadow-ray extension, scene intersection with media-mismatch checks,
surface interaction (Fresnel reflect/transmit/volume-border/black-body by
material flags) or volume scatter with guide MIS — as one jitted wavefront
program (reference: src/theia/trace.py:1048-1336,
shader/tracer.scene.forward.glsl, shader/scene.traverse.glsl).

AD discipline matches the volume tracer: geometry frozen, physical factors
(transmittance, mu_s, phase values, Fresnel coefficients) traced, sampling
pdfs and MIS weights frozen.
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
from ..accel import SurfaceHit, intersect_scene, intersect_target, offset_ray
from ..callback import EmptyEventCallback, TraceEventCallback
from ..component import Component, TraceConfig
from ..light import LightSource, WavelengthSource
from ..material import MaterialFlags, packed_medium_constants, lookup_packed
from ..ops.math3d import dot, local_frame, normalize
from ..ops.sampling import scatter_dir
from ..polarization import (
    apply_phase_matrix,
    apply_polarizer,
    apply_rotation,
    polarizer_coeffs,
    rotate_pol_ref,
    unpolarized_stokes,
)
from ..random import PhiloxRNG, RNGState
from ..scene import Scene, ScenePack
from ..target import TargetGuide
from .core import (
    TracerBase,
    active_lanes,
    EventResultCode,
    HitItem,
    PropagateParams,
    RayState,
    create_hit,
    propagate_ray,
    reattach_geometry,
    sample_scatter_length,
    update_ray,
    update_ray_is,
)

if TYPE_CHECKING:  # avoid circular import
    from ..response import HitResponse

__all__ = ["SceneForwardTracer"]

import os

#: diagnostic knob for A/B perf measurement: "0"
#: disables the response-chain fusions (free-extension shadow
#: response fused into the main record + the 2N batched MIS shadow
#: chain). The estimator terms are identical either way; fusing merges
#: record calls, so histogram bins can differ in f32 accumulation order
#: (measured <= 3e-8 relative)
_FUSE_RESPONSES = os.environ.get("THEIA_FUSE_RESPONSES", "1") != "0"

_BLACK = int(MaterialFlags.BLACK_BODY)
_DETECTOR = int(MaterialFlags.DETECTOR)
_NO_R_FWD = int(MaterialFlags.NO_REFLECT_FWD)
_NO_T_FWD = int(MaterialFlags.NO_TRANSMIT_FWD)
_VOLUME = int(MaterialFlags.VOLUME_BORDER)


def _phase_matrix_packed(store, handle, cos_theta):
    """(m12, m22, m33, m34) from the packed per-medium tables
    (reference: polarization.glsl:88-107)."""
    t = 0.5 * (cos_theta + 1.0)

    def g(kind):
        return lookup_packed(store.tables[kind], store.sizes[kind], handle, t, 0.0)

    return g("phase_m12"), g("phase_m22"), g("phase_m33"), g("phase_m34")


def _pol_scatter_packed(store, handle, direction, new_dir, pol):
    """Rotate to the scattering plane and apply the phase matrix
    (reference: ray.scatter.glsl:46-69)."""
    stokes, pol_ref = pol
    cos_theta = dot(direction, new_dir)
    m12, m22, m33, m34 = _phase_matrix_packed(store, handle, cos_theta)
    new_ref, c, s = rotate_pol_ref(direction, pol_ref, new_dir)
    stokes = apply_phase_matrix(
        apply_rotation(stokes, c, s), m12, m22, m33, m34
    )
    return stokes, new_ref


def _pol_align(direction, pol, hit_normal):
    """Rotate the frame perpendicular to the plane of incidence
    (reference: ray.propagate.glsl:187-201 alignRayToHit)."""
    stokes, pol_ref = pol
    new_ref, c, s = rotate_pol_ref(direction, pol_ref, hit_normal)
    return apply_rotation(stokes, c, s), new_ref


def _merge_dim(after: RNGState, before: RNGState, take_after) -> RNGState:
    return replace(before, dim=jnp.where(take_after, after.dim, before.dim))


def _reflect(i, n):
    return i - 2.0 * dot(n, i)[..., None] * n


def _refract(i, n, eta):
    """GLSL refract(); returns the (unit) inverted normal on total internal
    reflection so callers may ``normalize`` without dividing by zero — TIR
    lanes are always masked out by the selection logic.  The double-where
    keeps sqrt off k<=0 where its infinite slope would poison IOR
    gradients (jnp.where does not block NaN cotangents)."""
    cos_i = dot(n, i)
    k = 1.0 - eta * eta * (1.0 - cos_i * cos_i)
    tir = k <= 0.0
    k_safe = jnp.where(tir, 1.0, k)
    out = eta[..., None] * i - (eta * cos_i + jnp.sqrt(k_safe))[..., None] * n
    return jnp.where(tir[..., None], -n, out)


class SceneForwardTracer(TracerBase):
    """Forward path tracing against a scene (reference:
    src/theia/trace.py:1048-1336)."""

    name = "Scene Forward Tracer"
    _param_names = ("targetId", "scatterCoefficient", "maxTime")
    # direction hooks (SceneBackwardTargetTracer flips these)
    _target_bit = _DETECTOR
    _no_r_bit = _NO_R_FWD
    _no_t_bit = _NO_T_FWD
    _transmit_eta2 = False  # backward radiance transport takes eta^2

    def __init__(
        self,
        batchSize: int,
        source: LightSource,
        wavelengthSource: WavelengthSource,
        response: "HitResponse",
        rng: PhiloxRNG,
        scene: Scene,
        *,
        capacity: int | None = None,
        callback: TraceEventCallback | None = None,
        maxPathLength: int = 6,
        targetId: int = -1,
        targetGuide: TargetGuide | None = None,
        scatterCoefficient: float = float("nan"),
        sourceMedium: str | None = None,
        maxTime: float = 1000.0 * u.ns,
        polarized: bool = False,
        disableDirectLighting: bool = False,
        disableTransmission: bool = False,
        disableVolumeBorder: bool = False,
        useRefractedHitDir: bool = False,
        refCompatRNG: bool = False,
    ) -> None:
        if not source.supportForward:
            raise ValueError("light source does not support forward mode")
        self._init_batch(batchSize, capacity)
        self.source = source
        self.wavelengthSource = wavelengthSource
        self.response = response
        self.rng = rng
        self.scene = scene
        self.callback = EmptyEventCallback() if callback is None else callback
        self.maxPathLength = maxPathLength
        self.targetId = targetId
        self.targetGuide = targetGuide
        self.scatterCoefficient = scatterCoefficient
        self.sourceMedium = sourceMedium if sourceMedium is not None else scene.medium
        self.maxTime = maxTime
        self.polarized = polarized
        self.disableDirectLighting = disableDirectLighting
        self.disableTransmission = disableTransmission
        self.disableVolumeBorder = disableVolumeBorder
        self.useRefractedHitDir = useRefractedHitDir
        # ScenePhotonTracer sets this before calling super().__init__
        self._photon_mode = getattr(self, "_photon_mode", False)

        # reference accounting (src/theia/trace.py:1185-1196), with one
        # deliberate fix: with a target guide the reference's stride
        # (4 + guide) undercounts its own per-segment consumption — a miss
        # segment draws dist(1) + phase(2) + guide(N) + scatter(2) = 5 + N
        # (scene.traverse.glsl:294, 253-255, 391) — which silently overlaps
        # Philox streams between batches. We advance by the true worst case;
        # tests/test_rng_schedule.py pins the schedule.
        #
        # ``refCompatRNG=True`` reproduces the reference's own offset
        # stride verbatim instead, so multi-batch runs land on bit-identical
        # Philox streams for conformance comparisons on guided configs —
        # inheriting the reference's stream-overlap bug between batches
        # (harmless for single-batch goldens; see PARITY.md "RNG-stream
        # identity").
        self.refCompatRNG = refCompatRNG
        maxHits = maxPathLength - 1
        rngStride = 4
        if targetGuide is not None:
            maxHits *= 2
            rngStride = (4 if refCompatRNG else 5) + targetGuide.nRNGSamples
        if not disableDirectLighting:
            maxHits += 1
        self.maxHitsPerThread = maxHits
        self.nRNGSamples = (
            source.nRNGForward
            + wavelengthSource.nRNGSamples
            + rngStride * maxPathLength
            + maxHits * response.nRNGSamples
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

    # -- params ----------------------------------------------------------

    def collectStages(self):
        stages = [
            ("photons", self.wavelengthSource),
            ("lightSource", self.source),
        ]
        if self.targetGuide is not None:
            stages.append(("guide", self.targetGuide))
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
                "targetId": jnp.asarray(self.targetId, jnp.int32),
                "scatterCoefficient": jnp.asarray(
                    self.scatterCoefficient, jnp.float32
                ),
                "maxTime": jnp.asarray(self.maxTime, jnp.float32),
            },
            "scene": self.scene.pack,
            "photons": self.wavelengthSource.params(),
            "lightSource": self.source.params(),
            "response": self.response.params(),
            "callback": self.callback.params(),
        }
        if self.targetGuide is not None:
            p["guide"] = self.targetGuide.params()
        return p

    def _propagation(self, p) -> PropagateParams:
        pack: ScenePack = p["scene"]
        return PropagateParams(
            scatter_coefficient=p["tracer"]["scatterCoefficient"],
            lower_bbox=pack.lower_bbox,
            upper_bbox=pack.upper_bbox,
            max_time=p["tracer"]["maxTime"],
            max_dist=jnp.linalg.norm(pack.upper_bbox - pack.lower_bbox),
        )

    # -- physics helpers -------------------------------------------------

    def _fresnel(self, pack: ScenePack, ray: RayState, hit: SurfaceHit):
        """(n_in, n_tr, r_s, r_p) per lane
        (reference: shader/scatter.surface.glsl:21-51)."""
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
        # double-where: sqrt at a clamped 0 has infinite slope and would
        # turn the IOR gradient into NaN on TIR lanes
        s2 = 1.0 - sin_t * sin_t
        tir = s2 <= 0.0
        cos_t = jnp.where(tir, 0.0, jnp.sqrt(jnp.where(tir, 1.0, s2)))
        cos_i = jnp.abs(cos_i)
        r_s = (n_i * cos_i - n_t * cos_t) / (n_i * cos_i + n_t * cos_t)
        r_p = (n_t * cos_i - n_i * cos_t) / (n_t * cos_i + n_i * cos_t)
        return n_i, n_t, r_s, r_p

    def _scatter_prob_packed(self, pack: ScenePack, medium, in_dir, out_dir):
        """Phase function value via the packed log-phase tables."""
        cos_theta = dot(in_dir, out_dir)
        log_p = lookup_packed(
            pack.media.tables["log_phase_function"],
            pack.media.sizes["log_phase_function"],
            medium,
            0.5 * (cos_theta + 1.0),
            jnp.log(jnp.float32(1.0 / (4.0 * np.pi))),
        )
        return jnp.exp(log_p), log_p

    def _sample_phase_packed(self, pack: ScenePack, medium, in_dir, u1, u2):
        """Importance sample the phase function from packed tables.
        Returns (direction, pdf, log_p) — uniform-sphere fallback where the
        medium has no sampling table."""
        phi = jnp.float32(2.0 * np.pi) * u1
        tbl = pack.media.tables["phase_sampling"]
        sizes = pack.media.sizes["phase_sampling"]
        cos_tab = lookup_packed(tbl, sizes, medium, u2, 0.0)
        has_tab = jnp.take(sizes, medium) > 0
        cos_theta = jnp.where(
            has_tab, jnp.clip(cos_tab, -1.0, 1.0), 2.0 * u2 - 1.0
        )
        cos_theta = lax.stop_gradient(cos_theta)
        direction = scatter_dir(in_dir, cos_theta, phi)
        p, log_p = self._scatter_prob_packed(
            pack, medium, in_dir, direction
        )
        inv4pi = jnp.float32(1.0 / (4.0 * np.pi))
        pdf = jnp.where(has_tab, p, inv4pi)
        return direction, pdf, log_p

    def _create_response_item(
        self, p, ray: RayState, hit: SurfaceHit, r_s, r_p, n_i, n_t, absorb,
        pol=None,
    ) -> tuple[HitItem, jax.Array]:
        """Build the detector HitItem, emulating transmission where the
        surface is not absorbing (reference: scene.traverse.glsl:31-69).
        Returns (item, contrib>0 mask)."""
        transmittance = 1.0 - 0.5 * (r_s * r_s + r_p * r_p)
        lin = jnp.where(absorb, ray.lin_contrib, ray.lin_contrib * transmittance)
        ray = replace(ray, lin_contrib=lin)
        if pol is not None:
            # align perpendicular to the plane of incidence, then apply the
            # transmission polarizer for non-absorbing detectors
            # (reference: ray.surface.glsl transmitRay polarized)
            stokes, pol_ref = _pol_align(ray.direction, pol, hit.ray_nrm)
            t_s = r_s + 1.0
            t_p = (r_p + 1.0) * (n_i / n_t)
            _, m12, m33 = polarizer_coeffs(t_p, t_s)
            stokes = jnp.where(
                absorb[..., None], stokes, apply_polarizer(stokes, m12, m33)
            )
            pol = (stokes, pol_ref)
        if self.useRefractedHitDir:
            # direction is sampler state -> detached from the IOR gradient
            eta = lax.stop_gradient(n_i / n_t)
            refr = normalize(_refract(ray.direction, hit.ray_nrm, eta))
            direction = jnp.where(absorb[..., None], ray.direction, refr)
            ray = replace(ray, direction=direction)
        item = create_hit(
            ray, hit.obj_pos, hit.obj_nrm, hit.custom_id, hit.world_to_obj,
            pol=pol,
        )
        return item, item.contrib > 0.0


    def _propagate_to_hit(self, ray: RayState, hit: SurfaceHit, prop):
        dist = jnp.sqrt(
            jnp.maximum(dot(hit.world_pos - ray.position, hit.world_pos - ray.position), 1e-30)
        )
        moved = replace(ray, position=hit.world_pos)
        new, code = update_ray(moved, dist, prop)
        # deterministic connection distance: reattach its gradient to the
        # arrival time / transmittance (see the segment-loop comment)
        return reattach_geometry(new, dist), code

    def _shadow_item(self, p, ray: RayState, hit: SurfaceHit, mask, prop,
                     pol=None):
        """processShadowRay's item half: the detector HitItem + validity
        for a (possibly batched) shadow wavefront
        (reference: scene.traverse.glsl:160-183)."""
        pack: ScenePack = p["scene"]
        target_id = p["tracer"]["targetId"]
        is_target = (hit.flags & jnp.uint32(self._target_bit)) != 0
        correct = (target_id < 0) | (hit.custom_id == target_id)
        ok = mask & hit.valid & is_target & correct & (hit.error == 0)
        moved, code = self._propagate_to_hit(ray, hit, prop)
        ok &= code >= 0
        n_i, n_t, r_s, r_p = self._fresnel(pack, moved, hit)
        absorb = (hit.flags & jnp.uint32(_BLACK)) != 0
        item, pos_mask = self._create_response_item(
            p, moved, hit, r_s, r_p, n_i, n_t, absorb, pol=pol
        )
        return item, ok & pos_mask

    def _shadow_response(
        self, p, resp_state, ray: RayState, hit: SurfaceHit, mask, rng, prop,
        pol=None,
    ):
        """processShadowRay: response if the shadow ray reached the target
        (reference: scene.traverse.glsl:160-183)."""
        item, ok = self._shadow_item(p, ray, hit, mask, prop, pol=pol)
        rng_after = rng
        resp_state, rng_after = self.response.record(
            p["response"], resp_state, item, ok, rng_after
        )
        return resp_state, _merge_dim(rng_after, rng, ok)

    def _sample_initial(self, p, pack, streams, rng):
        """Sample the initial rays (forward: wavelength + light source)."""
        (lam, lam_contrib), rng = self.wavelengthSource.sample(p["photons"], rng)
        src_medium = jnp.full(
            streams.shape,
            pack.media.handle(self.sourceMedium),
            jnp.int32,
        )
        constants = packed_medium_constants(pack.media, src_medium, lam)
        src, rng = self.source.sample_forward(p["lightSource"], lam, constants, rng)
        init_lin = (
            jnp.ones_like(lam) if self._photon_mode else src.contrib * lam_contrib
        )
        ray = RayState(
            position=src.position,
            direction=src.direction,
            wavelength=lam,
            time=src.start_time,
            lin_contrib=init_lin,
            log_contrib=jnp.zeros_like(lam),
            constants=constants,
        )
        if self.polarized:
            # unpolarized sources get a frame from the local basis
            # (reference: lightsource.common.glsl createSourceRay)
            stokes = (
                src.stokes if src.stokes is not None else unpolarized_stokes(lam.shape)
            )
            pol_ref = (
                src.pol_ref
                if src.pol_ref is not None
                else local_frame(src.direction)[0]
            )
            pol = (stokes, pol_ref)
        else:
            pol = None
        return ray, src_medium, pol, rng

    # -- the traced program ---------------------------------------------

    def _segment_body(self, p, pack, prop, mis, streams, static_last=False):
        """Build the per-segment loop body (shared by the monolithic
        batch loop and ScenePhotonTracer's compacted per-run launches).
        ``i`` is the traced global segment index.

        ``static_last=True`` builds the peeled final-segment body: on
        segment ``maxPathLength - 1`` every lane has ``miss == False``, so
        the MIS shadow block and the volume-scatter block are fully masked
        dead work (their responses add exact zeros and their RNG dims are
        merged back). Peeling the iteration out of the ``fori_loop`` with a
        static flag lets XLA drop both blocks — one full MIS shadow query
        (the most expensive part of a segment) per batch — with bit-identical
        results (reference semantics: the loop's last iteration never
        scatters, tracer.scene.forward.glsl loop bound)."""
        def body(i, carry):
            ray, medium, alive, allow_response, pol, rng, resp_state, cb_state = (
                carry
            )
            pre_alive = alive
            last = i == self.maxPathLength - 1  # traced bool

            # health check (reference: scene.traverse.glsl:288-290)
            bad = ray.is_bad()
            alive = alive & ~bad
            pre_alive = alive

            # ---- trace() (scene.traverse.glsl:286-352) ----
            uu, rng = rng.uniform()
            dist = sample_scatter_length(ray, prop, uu)
            sampled_dist = dist
            if mis:
                guide_eval = self.targetGuide.eval(
                    p["guide"], ray.position, ray.direction
                )
                mis_ext = allow_response & (guide_eval.prob > 0.0)
                mis_ext &= guide_eval.dist > dist
                dist = jnp.where(mis_ext, jnp.maximum(guide_eval.dist, dist), dist)

            hit = intersect_scene(pack, medium, ray.position, ray.direction, dist)
            travel = jnp.where(hit.valid, hit.t, dist)

            # the free-extension shadow response and the main surface
            # response are per-lane mutually exclusive and share the same
            # hit rows, so for RNG-free unpolarized responses they fuse
            # into ONE Fresnel + item + record at the main response site
            # (the extension lanes substitute their propagated-to-hit ray
            # state; Fresnel itself reads only direction/constants/hit —
            # identical between the two states)
            fuse_ext = (
                mis
                and _FUSE_RESPONSES
                and self.response.nRNGSamples == 0
                and pol is None
            )
            ext_ray = ext_ok = None
            if mis:
                # hit beyond the sampled distance == free shadow ray
                ext_mask = (
                    pre_alive
                    & mis_ext
                    & hit.valid
                    & (travel > sampled_dist)
                    & (hit.error == 0)
                )
                if fuse_ext:
                    ext_ray, ext_code = self._propagate_to_hit(ray, hit, prop)
                    ext_ok = ext_mask & (ext_code >= 0)
                else:
                    resp_state, rng = self._shadow_response(
                        p, resp_state, ray, hit, ext_mask, rng, prop, pol=pol
                    )
                hit = replace(hit, valid=hit.valid & ~ext_mask)
                travel = jnp.where(ext_mask, sampled_dist, travel)

            ray, code = propagate_ray(ray, travel, prop)
            # Reattach the deterministic hit-distance gradient: sampled
            # scatter distances stay frozen, but hit.t is recomputed
            # differentiably in intersect_scene (see
            # core.reattach_geometry for the full rationale)
            ray = reattach_geometry(ray, travel, valid=hit.valid)
            ray = update_ray_is(ray, travel, prop, hit.valid)
            # media mismatch error dominates
            code = jnp.where(hit.valid & (hit.error != 0), hit.error, code)
            in_bounds = code >= 0

            # ---- processInteraction: surface hit ----
            surf = pre_alive & in_bounds & hit.valid
            # set polarization-free position to exact hit point
            ray = replace(
                ray,
                position=jnp.where(
                    surf[..., None], hit.world_pos, ray.position
                ),
            )
            n_i, n_t, r_s, r_p = self._fresnel(pack, ray, hit)
            flags = hit.flags
            is_abs = (flags & jnp.uint32(_BLACK)) != 0
            is_target = (flags & jnp.uint32(self._target_bit)) != 0
            vol_border = ((flags & jnp.uint32(_VOLUME)) != 0) & (
                not self.disableVolumeBorder
            )
            can_reflect = (flags & jnp.uint32(self._no_r_bit)) == 0
            can_transmit = ((flags & jnp.uint32(self._no_t_bit)) == 0) & (
                not self.disableTransmission
            )

            target_id = p["tracer"]["targetId"]
            respond = (
                surf
                & allow_response
                & is_target
                & ((target_id < 0) | (hit.custom_id == target_id))
            )
            # align the polarization frame perpendicular to the plane of
            # incidence on surface lanes (alignRayToHit); uses the incident
            # direction — must happen before the new direction is chosen
            if pol is not None:
                a_stokes, a_ref = _pol_align(ray.direction, pol, hit.ray_nrm)
                pol = (
                    jnp.where(surf[..., None], a_stokes, pol[0]),
                    jnp.where(surf[..., None], a_ref, pol[1]),
                )
            if fuse_ext:
                # extension lanes respond with their propagated-to-hit
                # state; everyone else with the main (post-propagation)
                # state. The two masks are disjoint (ext lanes were
                # invalidated out of ``surf``). Only position/time/
                # contribs differ between the states (direction, medium
                # constants and wavelength are untouched by propagation).
                resp_ray = replace(
                    ray,
                    position=jnp.where(
                        ext_ok[..., None], ext_ray.position, ray.position
                    ),
                    time=jnp.where(ext_ok, ext_ray.time, ray.time),
                    lin_contrib=jnp.where(
                        ext_ok, ext_ray.lin_contrib, ray.lin_contrib
                    ),
                    log_contrib=jnp.where(
                        ext_ok, ext_ray.log_contrib, ray.log_contrib
                    ),
                )
                ext_respond = (
                    ext_ok
                    & is_target
                    & ((target_id < 0) | (hit.custom_id == target_id))
                )
            else:
                resp_ray = ray
                ext_respond = None
            item, pos_ok = self._create_response_item(
                p, resp_ray, hit, r_s, r_p, n_i, n_t, is_abs, pol=pol
            )
            rec_mask = respond & pos_ok
            if fuse_ext:
                rec_mask = rec_mask | (ext_respond & pos_ok)
            rng_b = rng
            resp_state, rng_a = self.response.record(
                p["response"], resp_state, item, rec_mask, rng
            )
            rng = _merge_dim(rng_a, rng_b, rec_mask)

            # surface interaction outcome
            r_coef = 0.5 * (r_s * r_s + r_p * r_p)
            u_surf, rng_a = rng.uniform()
            both = surf & ~is_abs & ~vol_border & can_reflect & can_transmit
            rng = _merge_dim(rng_a, rng, both)
            do_reflect = jnp.where(
                both,
                u_surf < lax.stop_gradient(r_coef),
                can_reflect,
            )
            absorbed_surf = surf & (
                is_abs | (~can_reflect & ~can_transmit & ~vol_border)
            )

            # compute all three outcomes and select per lane
            # 1) reflect
            refl_dir = normalize(_reflect(ray.direction, hit.ray_nrm))
            refl_pos = offset_ray(hit.world_pos, hit.ray_nrm)
            # IS: no factor when both paths possible; explicit factor else
            refl_factor = jnp.where(both, 1.0, r_coef)
            # grad: IS decision frozen, but r is physical (Fresnel from n) ->
            # reintroduce via ratio for the IS case
            sg = lax.stop_gradient
            refl_log = jnp.where(
                both, jnp.log(jnp.maximum(r_coef, 1e-30)), 0.0
            )
            refl_corr = refl_log - sg(refl_log)
            # 2) transmit
            eta = n_i / n_t
            eta_sq = eta * eta
            # frozen-sampler estimator: the refracted *direction* is part of
            # the path sampler (detached, like phase cos_theta); the IOR
            # gradient lives in the contribution factors below
            trans_dir = normalize(
                _refract(ray.direction, hit.ray_nrm, sg(eta))
            )
            trans_pos = offset_ray(hit.world_pos, -hit.ray_nrm)
            trans_factor = jnp.where(both, 1.0, 1.0 - r_coef)
            if self._transmit_eta2:
                # backward rays transport radiance -> eta^2 on transmission
                # (reference: ray.surface.glsl transmitRayIS backward)
                trans_factor = trans_factor * eta_sq

            trans_log = jnp.where(
                both, jnp.log(jnp.maximum(1.0 - r_coef, 1e-30)), 0.0
            )
            trans_corr = trans_log - sg(trans_log)
            # 3) volume border: straight through, medium change
            border_pos = offset_ray(hit.world_pos, -hit.ray_nrm)

            new_medium = jnp.where(
                surf & (vol_border | (~do_reflect & can_transmit & ~is_abs)),
                hit.medium_tr,
                medium,
            )
            crossed = new_medium != medium

            sel_reflect = surf & ~is_abs & ~vol_border & do_reflect & can_reflect
            sel_transmit = (
                surf & ~is_abs & ~vol_border & ~do_reflect & can_transmit
            )

            new_dir = jnp.where(
                sel_reflect[..., None],
                refl_dir,
                jnp.where(sel_transmit[..., None], trans_dir, ray.direction),
            )
            new_pos = jnp.where(
                sel_reflect[..., None],
                refl_pos,
                jnp.where(
                    (sel_transmit | (surf & vol_border))[..., None],
                    jnp.where(sel_transmit[..., None], trans_pos, border_pos),
                    ray.position,
                ),
            )
            new_lin = jnp.where(
                sel_reflect,
                ray.lin_contrib * refl_factor,
                jnp.where(
                    sel_transmit, ray.lin_contrib * trans_factor, ray.lin_contrib
                ),
            )
            new_log = jnp.where(
                sel_reflect,
                ray.log_contrib + refl_corr,
                jnp.where(
                    sel_transmit, ray.log_contrib + trans_corr, ray.log_contrib
                ),
            )
            if pol is not None:
                # Fresnel polarizers in the (already aligned) incidence frame;
                # the reference frame itself is preserved by both outcomes
                # (reference: ray.surface.glsl reflectRay/transmitRay)
                stokes, pol_ref = pol
                _, m12_r, m33_r = polarizer_coeffs(r_p, r_s)
                t_s = r_s + 1.0
                t_p = (r_p + 1.0) * eta
                _, m12_t, m33_t = polarizer_coeffs(t_p, t_s)
                stokes = jnp.where(
                    sel_reflect[..., None],
                    apply_polarizer(stokes, m12_r, m33_r),
                    jnp.where(
                        sel_transmit[..., None],
                        apply_polarizer(stokes, m12_t, m33_t),
                        stokes,
                    ),
                )
                pol = (stokes, pol_ref)
            medium = new_medium
            new_constants = packed_medium_constants(
                pack.media, medium, ray.wavelength
            )
            ray = RayState(
                position=new_pos,
                direction=new_dir,
                wavelength=ray.wavelength,
                time=ray.time,
                lin_contrib=new_lin,
                log_contrib=new_log,
                constants=jax.tree.map(
                    lambda new, old: jnp.where(crossed, new, old),
                    new_constants,
                    ray.constants,
                ),
            )

            # ---- processInteraction: volume scatter (miss) ----
            miss = pre_alive & in_bounds & ~hit.valid & ~last
            if static_last:
                # all-False by construction; the guarded blocks below are
                # skipped entirely (see docstring)
                miss = jnp.zeros_like(pre_alive)

            if mis and not static_last:
                rng_b = rng
                (u1, u2), rng = rng.uniform2d()
                dir_phase, p_pp, log_p_pp = self._sample_phase_packed(
                    pack, medium, ray.direction, u1, u2
                )
                guide_sample, rng = self.targetGuide.sample(
                    p["guide"], ray.position, rng
                )
                phase_eval = self.targetGuide.eval(
                    p["guide"], ray.position, dir_phase
                )
                p_tt = guide_sample.prob
                p_tp = phase_eval.prob
                p_pt, log_p_pt = self._scatter_prob_packed(
                    pack, medium, ray.direction, guide_sample.direction
                )
                w_target = sg(p_tt) * sg(p_pt) / (sg(p_tt) ** 2 + sg(p_pt) ** 2)
                w_phase = sg(p_pp) ** 2 / (sg(p_pp) ** 2 + sg(p_tp) ** 2)
                w_target = jnp.nan_to_num(w_target, nan=0.0, posinf=0.0, neginf=0.0)
                w_phase = jnp.nan_to_num(w_phase, nan=0.0, posinf=0.0, neginf=0.0)

                # fused shadow pair: both MIS shadow rays share the origin
                # and medium, so one 2N intersection streams the triangle
                # tables once for both; the responses
                # stay sequential to preserve the RNG draw order. Shadow
                # rays only respond on detector instances, so the query is
                # the target-nearest + any-hit-occlusion split
                # (accel.intersect_target; culled + compacted on brute
                # packs). Splitting the pair into two N-lane queries so
                # the phase half's detector groups compact doubles the
                # segment's query HLO and with it the compile time.
                n_lane = streams.shape[0]
                hit2 = intersect_target(
                    pack,
                    jnp.concatenate([medium, medium]),
                    jnp.concatenate([ray.position, ray.position]),
                    jnp.concatenate([dir_phase, guide_sample.direction]),
                    jnp.concatenate([phase_eval.dist, guide_sample.dist]),
                    # only miss lanes consume shadow hits; culled backends
                    # drop the rest (RNG-neutral: every downstream mask
                    # already includes ``miss``)
                    active=jnp.concatenate([miss, miss]),
                )
                s_hits = (
                    jax.tree.map(lambda a: a[:n_lane], hit2),
                    jax.tree.map(lambda a: a[n_lane:], hit2),
                )
                if _FUSE_RESPONSES and self.response.nRNGSamples == 0 and pol is None:
                    # RNG-free unpolarized responses: process the whole
                    # 2N shadow pair through ONE propagate/Fresnel/item/
                    # record chain instead of two sequential N-lane ones
                    # (the sequential order only exists to preserve the
                    # response's RNG draw order)
                    tile = lambda a: jnp.concatenate([a, a])
                    shadow2 = RayState(
                        position=jnp.concatenate(
                            [ray.position, ray.position]
                        ),
                        direction=jnp.concatenate(
                            [dir_phase, guide_sample.direction]
                        ),
                        wavelength=tile(ray.wavelength),
                        time=tile(ray.time),
                        lin_contrib=jnp.concatenate(
                            [
                                ray.lin_contrib
                                * ray.constants.mu_s
                                * sg(w_phase),
                                ray.lin_contrib
                                * ray.constants.mu_s
                                * sg(w_target),
                            ]
                        ),
                        log_contrib=jnp.concatenate(
                            [
                                ray.log_contrib + log_p_pp - sg(log_p_pp),
                                ray.log_contrib + log_p_pt - sg(log_p_pt),
                            ]
                        ),
                        constants=jax.tree.map(tile, ray.constants),
                    )
                    item2, ok2 = self._shadow_item(
                        p, shadow2, hit2, jnp.concatenate([miss, miss]), prop
                    )
                    resp_state, _ = self.response.record(
                        p["response"], resp_state, item2, ok2, rng
                    )
                else:
                    for s_hit, (s_dir, w, corr) in zip(
                        s_hits,
                        (
                            (dir_phase, w_phase, log_p_pp),
                            (guide_sample.direction, w_target, log_p_pt),
                        ),
                    ):
                        shadow = replace(
                            ray,
                            direction=s_dir,
                            lin_contrib=ray.lin_contrib
                            * ray.constants.mu_s
                            * sg(w),
                            log_contrib=ray.log_contrib + corr - sg(corr),
                        )
                        shadow_pol = (
                            _pol_scatter_packed(
                                pack.media, medium, ray.direction, s_dir, pol
                            )
                            if pol is not None
                            else None
                        )
                        resp_state, rng = self._shadow_response(
                            p, resp_state, shadow, s_hit, miss, rng, prop,
                            pol=shadow_pol,
                        )
                rng = _merge_dim(rng, rng_b, miss)

            # scatter the real ray
            if not static_last:
                rng_b = rng
                (su1, su2), rng = rng.uniform2d()
                scat_dir, _, scat_log_p = self._sample_phase_packed(
                    pack, medium, ray.direction, su1, su2
                )
                scat_corr = scat_log_p - sg(scat_log_p)
                if pol is not None:
                    s_stokes, s_ref = _pol_scatter_packed(
                        pack.media, medium, ray.direction, scat_dir, pol
                    )
                    pol = (
                        jnp.where(miss[..., None], s_stokes, pol[0]),
                        jnp.where(miss[..., None], s_ref, pol[1]),
                    )
                ray = replace(
                    ray,
                    direction=jnp.where(miss[..., None], scat_dir, ray.direction),
                    lin_contrib=jnp.where(
                        miss, ray.lin_contrib * ray.constants.mu_s, ray.lin_contrib
                    ),
                    log_contrib=jnp.where(
                        miss, ray.log_contrib + scat_corr, ray.log_contrib
                    ),
                )
                rng = _merge_dim(rng, rng_b, miss)

            # ---- result codes + events ----
            code = jnp.where(
                surf & respond,
                jnp.int32(EventResultCode.RAY_DETECTED),
                jnp.where(
                    surf & vol_border,
                    jnp.int32(EventResultCode.VOLUME_HIT),
                    jnp.where(
                        surf,
                        jnp.int32(EventResultCode.RAY_HIT),
                        jnp.where(
                            pre_alive & in_bounds,
                            jnp.int32(EventResultCode.RAY_SCATTERED),
                            code,
                        ),
                    ),
                ),
            )
            code = jnp.where(
                absorbed_surf, jnp.int32(EventResultCode.RAY_ABSORBED), code
            )
            alive = pre_alive & (code >= 0) & ~absorbed_surf
            if self._photon_mode:
                # Russian-roulette absorption per segment; run-boundary RNG
                # resync happens implicitly (no MIS -> fixed draws/segment)
                u_abs, rng_a = rng.uniform()
                survive = ray.contrib > u_abs
                rng = _merge_dim(rng_a, rng, alive)
                ray = replace(
                    ray,
                    lin_contrib=jnp.where(alive & survive, 1.0, ray.lin_contrib),
                    log_contrib=jnp.where(alive & survive, 0.0, ray.log_contrib),
                )
                code = jnp.where(
                    alive & ~survive,
                    jnp.int32(EventResultCode.RAY_ABSORBED),
                    code,
                )
                alive = alive & survive
            cb_state = self.callback.on_event(
                p["callback"], cb_state, ray, code, pre_alive, i + 1
            , pol=pol)

            if mis:
                allow_response = code != jnp.int32(EventResultCode.RAY_SCATTERED)
            else:
                allow_response = jnp.ones_like(allow_response)

            return (
                ray, medium, alive, allow_response, pol, rng, resp_state, cb_state
            )

        return body

    def _trace_batch(self, p, counter, streams):
        # guide-less traces issue only primary nearest queries, where the
        # instanced compaction ladder does not pay — select the
        # profile for the whole traced program (bit-identical either way;
        # ops/instanced.py QUERY_PROFILE)
        from ..ops.instanced import query_profile

        with query_profile(
            "mis" if self.targetGuide is not None else "primary"
        ):
            return self._trace_batch_profiled(p, counter, streams)

    def _trace_batch_profiled(self, p, counter, streams):
        pack: ScenePack = p["scene"]
        prop = self._propagation(p)
        mis = self.targetGuide is not None
        rng = self.rng.state_for(counter, streams)

        ray, medium, pol, rng = self._sample_initial(p, pack, streams, rng)

        resp_state = self.response.init()
        cb_state = self.callback.init(streams.shape[0], self.maxPathLength + 2)
        cb_state = self.callback.on_event(
            p["callback"],
            cb_state,
            ray,
            jnp.full_like(streams, int(EventResultCode.RAY_CREATED), jnp.int32),
            active_lanes(streams, p),
            0,
         pol=pol,)
        alive = active_lanes(streams, p) & ~ray.is_bad()
        allow_response = jnp.full(
            streams.shape, not self.disableDirectLighting, dtype=bool
        )

        body = self._segment_body(p, pack, prop, mis, streams)

        carry = (ray, medium, alive, allow_response, pol, rng, resp_state, cb_state)
        # peel the final segment: its MIS shadow + scatter blocks are fully
        # masked dead work inside the fori_loop (see _segment_body docstring)
        if self.maxPathLength > 1:
            carry = lax.fori_loop(0, self.maxPathLength - 1, body, carry)
        body_last = self._segment_body(
            p, pack, prop, mis, streams, static_last=True
        )
        ray, medium, alive, allow_response, pol, rng, resp_state, cb_state = (
            body_last(jnp.int32(self.maxPathLength - 1), carry)
        )
        cb_state = self.callback.on_event(
            p["callback"],
            cb_state,
            ray,
            jnp.full_like(streams, int(EventResultCode.MAX_ITER), jnp.int32),
            alive,
            self.maxPathLength + 1,
         pol=pol,)
        if getattr(self, "_debug_rng", False):
            # conformance hook: expose each lane's final dim counter
            return resp_state, cb_state, rng.dim
        return resp_state, cb_state

    # -- host API --------------------------------------------------------

