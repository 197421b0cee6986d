"""Volume tracers: analytic targets, single (possibly scattering) medium.

``VolumeForwardTracer`` reproduces the reference's forward volume path
tracer — exponential distance sampling, MIS between phase-function and
target sampling, time-resolved responses — as ONE jitted, differentiable
function over a photon wavefront (reference:
src/theia/trace.py:499-770, shader/tracer.volume.forward.glsl).

Where the reference launches one GPU thread per path with divergent control
flow, the design here keeps an (N,)-wavefront with per-lane alive masks and
a ``lax.fori_loop`` over path segments; responses accumulate via masked
scatter-adds. Per-lane RNG dimension counters reproduce the reference's
draw schedule exactly, enabling stream-identical verification.

Gradient semantics (beyond the reference, SURVEY.md §5.9): path geometry
is detached, physical factors (transmittance, mu_s, phase values) stay
traced, sampling pdfs and MIS weights are frozen — an unbiased
"differentiate the integrand" estimator for d(light curve)/d(medium).
"""

from __future__ import annotations

from typing import TYPE_CHECKING

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ..compile_cache import jit
from .. import units as u
from ..callback import EmptyEventCallback, TraceEventCallback
from ..component import Component, TraceConfig
from ..light import LightSource, WavelengthSource
from ..material import Medium, medium_constants
from ..lookup import lookup
from ..ops.math3d import dot, normalize
from ..ops.sampling import scatter_dir
from ..ops.math3d import local_frame
from ..polarization import (
    apply_phase_matrix,
    apply_rotation,
    phase_matrix_elements,
    rotate_pol_ref,
    unpolarized_stokes,
)
from ..random import PhiloxRNG, RNGState
from ..target import Target, TargetSample

if TYPE_CHECKING:  # avoid circular import (response imports trace.core)
    from ..response import HitResponse
from .core import (
    TracerBase,
    active_lanes,
    EventResultCode,
    HitItem,
    PropagateParams,
    RayState,
    create_hit,
    propagate_ray,
    propagate_ray_to_hit,
    reattach_geometry,
    sample_scatter_dir_medium,
    sample_scatter_length,
    scatter_prob,
    scatter_ray_is,
    update_ray_is,
)

__all__ = ["VolumeForwardTracer"]


def _jacobian_dA_dW(obs, pos, nrm):
    """Area -> solid-angle probability conversion; 0 marks invalid
    (reference: tracer.volume.forward.glsl:107-118)."""
    d = pos - obs
    d2 = dot(d, d)
    dn = normalize(d)
    denom = jnp.abs(dot(dn, nrm))
    factor = d2 / denom
    return jnp.where(jnp.isinf(factor) | jnp.isnan(factor), 0.0, factor)


def _merge_dim(after: RNGState, before: RNGState, take_after) -> RNGState:
    """Advance the per-lane dim counter only where the reference's control
    flow would have drawn."""
    return replace(before, dim=jnp.where(take_after, after.dim, before.dim))


def _log_phase(medium: Medium | None, cos_theta):
    if medium is None or medium.log_phase_function is None:
        return None
    return lookup(medium.log_phase_function, 0.5 * (cos_theta + 1.0))


def _pol_scatter(medium, direction, new_dir, pol):
    """Polarized scatter: rotate the frame into the scattering plane and
    apply the Mueller phase matrix (reference: ray.scatter.glsl:50-62)."""
    stokes, pol_ref = pol
    cos_theta = dot(direction, new_dir)
    m12, m22, m33, m34 = phase_matrix_elements(medium, cos_theta)
    new_ref, c, s = rotate_pol_ref(direction, pol_ref, new_dir)
    stokes = apply_phase_matrix(
        apply_rotation(stokes, c, s), m12, m22, m33, m34
    )
    return stokes, new_ref


def _pol_align(direction, pol, hit_normal):
    """Rotate the frame into the plane of incidence
    (reference: ray.propagate.glsl alignRayToHit)."""
    stokes, pol_ref = pol
    new_ref, c, s = rotate_pol_ref(direction, pol_ref, hit_normal)
    return apply_rotation(stokes, c, s), new_ref


class VolumeForwardTracer(TracerBase):
    """Forward path tracing in a single homogeneous medium against an
    analytic target (reference: src/theia/trace.py:499-770).

    Parameters mirror the reference; ``medium`` is a :class:`Medium` pytree
    (or None = vacuum) and is differentiable.
    """

    name = "Volume Forward Tracer"
    _param_names = ("scatterCoefficient", "objectId", "maxTime")
    _extra_names = ("medium", "traceBBox")

    def __init__(
        self,
        batchSize: int,
        source: LightSource,
        target: Target,
        wavelengthSource: WavelengthSource,
        response: HitResponse,
        rng: PhiloxRNG,
        *,
        medium: Medium | None,
        objectId: int = 0,
        capacity: int | None = None,
        callback: TraceEventCallback | None = None,
        nScattering: int = 6,
        scatterCoefficient: float = float("nan"),
        traceBBox: tuple = ((-1.0 * u.km,) * 3, (1.0 * u.km,) * 3),
        maxTime: float = 1000.0 * u.ns,
        polarized: bool = False,
        disableDirectLighting: bool = False,
        disableTargetSampling: bool = False,
        refCompatRNG: bool = False,
    ) -> None:
        if not source.supportForward:
            raise ValueError("light source does not support forward mode")
        self._init_batch(batchSize, capacity)
        self.source = source
        self.target = target
        self.wavelengthSource = wavelengthSource
        self.response = response
        self.rng = rng
        self.medium = medium
        self.objectId = objectId
        self.callback = EmptyEventCallback() if callback is None else callback
        self.nScattering = nScattering
        self.scatterCoefficient = scatterCoefficient
        self.traceBBox = traceBBox
        self.maxTime = maxTime
        self.polarized = polarized
        self.disableDirectLighting = disableDirectLighting
        self.disableTargetSampling = disableTargetSampling

        # reference accounting (src/theia/trace.py:624-637), fixed: the
        # reference's stride * pathLength omits the pre-loop first trace
        # step (dist 1, plus phase 2 + target draws under MIS), so its
        # nRNGSamples undercounts the true per-path consumption and can
        # overlap Philox streams between batches. We advance by the worst
        # case; the schedule is pinned by tests/test_rng_schedule.py.
        #
        # ``refCompatRNG=True`` instead advances the offset exactly as the
        # reference does (rngStride = 3 or 7, no first-step term,
        # src/theia/trace.py:631-634) so multi-batch conformance runs see
        # bit-identical Philox streams — including the reference's own
        # between-batch stream overlap (see PARITY.md "RNG-stream
        # identity").
        self.refCompatRNG = refCompatRNG
        self.maxHitsPerThread = nScattering
        if not disableTargetSampling:
            self.maxHitsPerThread *= 2
        if not disableDirectLighting:
            self.maxHitsPerThread += 1
        self.pathLength = nScattering if disableTargetSampling else nScattering - 1
        if refCompatRNG:
            firstStep = 0
            rngStride = 3 if disableTargetSampling else 7
        elif disableTargetSampling:
            firstStep = 1
            rngStride = 3
        else:
            firstStep = 3 + target.nRNGSamples
            rngStride = 5 + target.nRNGSamples
        self.nRNGSamples = (
            source.nRNGForward
            + wavelengthSource.nRNGSamples
            + firstStep
            + rngStride * self.pathLength
            + self.maxHitsPerThread * response.nRNGSamples
        )
        rng.configure(self.nRNGSamples, self.capacity)

        response.prepare(self._config())

        self._jit_trace = jit(self._trace_batch)

    # -- config ---------------------------------------------------------

    def _config(self) -> TraceConfig:
        return TraceConfig(
            batch_size=self.batchSize,
            capacity=self.capacity,
            max_hits_per_thread=self.maxHitsPerThread,
            normalization=self.normalization,
            polarized=self.polarized,
        )

    def collectStages(self) -> list[tuple[str, Component]]:
        return [
            ("photons", self.wavelengthSource),
            ("lightSource", self.source),
            ("target", self.target),
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
                "lowerBBox": jnp.asarray(self.traceBBox[0], jnp.float32),
                "upperBBox": jnp.asarray(self.traceBBox[1], jnp.float32),
                "objectId": jnp.asarray(self.objectId, jnp.int32),
            },
            "medium": self.medium,
            "photons": self.wavelengthSource.params(),
            "lightSource": self.source.params(),
            "target": self.target.params(),
            "response": self.response.params(),
            "callback": self.callback.params(),
        }

    # -- the traced program ---------------------------------------------

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

    def _create_response(
        self,
        p,
        resp_state,
        ray: RayState,
        hit: TargetSample,
        direction,
        w_frozen,
        w_traced,
        scattered: bool,
        mask,
        rng: RNGState,
        prop: PropagateParams,
        medium=None,
        pol=None,
    ):
        """Propagate a (copy of the) ray to a target sample and record the
        response (reference: tracer.volume.forward.glsl:50-80). Returns
        (resp_state, rng, accepted_mask)."""
        valid = mask & hit.valid
        if pol is not None and scattered:
            pol = _pol_scatter(medium, ray.direction, direction, pol)
        if scattered:
            ray = scatter_ray_is(ray, direction)
        if pol is not None:
            pol = _pol_align(direction if scattered else ray.direction, pol, hit.normal)
        ray, code = propagate_ray_to_hit(ray, hit.position, prop)
        valid &= code >= 0
        ray = replace(
            ray,
            lin_contrib=ray.lin_contrib * lax.stop_gradient(w_frozen),
        )
        if w_traced is not None:
            ray = replace(
                ray,
                log_contrib=ray.log_contrib
                + w_traced
                - lax.stop_gradient(w_traced),
            )
        item = create_hit(
            ray,
            hit.obj_position,
            hit.obj_normal,
            p["tracer"]["objectId"],
            hit.world_to_obj,
            pol=pol,
        )
        valid &= item.contrib > 0.0
        rng_after = rng
        resp_state, rng_after = self.response.record(
            p["response"], resp_state, item, valid, rng_after
        )
        rng = _merge_dim(rng_after, rng, valid)
        return resp_state, rng

    def _trace_step(
        self, p, prop, medium, ray, alive, rng, resp_state, allow_response: bool,
        pol=None,
    ):
        """One path segment (reference: tracer.volume.forward.glsl:152-211).
        Returns (ray, alive, rng, resp_state, code)."""
        uu, rng = rng.uniform()
        dist = sample_scatter_length(ray, prop, uu)

        hit = self.target.intersect(p["target"], ray.position, ray.direction)
        hit_valid = hit.valid & (hit.dist <= dist)
        dist = jnp.minimum(hit.dist, dist)

        ray, code = propagate_ray(ray, dist, prop)
        # geometric target distance carries d/d(geometry) (core.reattach_geometry)
        ray = reattach_geometry(ray, dist, valid=hit_valid)
        ray = update_ray_is(ray, dist, prop, hit_valid)
        in_bounds = code >= 0

        # lanes hitting the target are done: DETECTED with response when
        # allowed, silently ABSORBED otherwise
        code = jnp.where(
            in_bounds & hit_valid,
            jnp.int32(
                EventResultCode.RAY_DETECTED
                if allow_response
                else EventResultCode.RAY_ABSORBED
            ),
            code,
        )
        hit_item = None
        if allow_response:
            hit_ray = ray
            hit_pol = (
                _pol_align(ray.direction, pol, hit.normal)
                if pol is not None
                else None
            )
            item = create_hit(
                hit_ray,
                hit.obj_position,
                hit.obj_normal,
                p["tracer"]["objectId"],
                hit.world_to_obj,
                pol=hit_pol,
            )
            hit_mask = alive & in_bounds & hit_valid & (item.contrib > 0.0)
            hit_item = (item, hit_mask)

        mis_mask = alive & in_bounds & ~hit_valid
        if not self.disableTargetSampling:
            # MIS: sample both the phase function and the target
            # (reference: tracer.volume.forward.glsl:120-150)
            rng_before = rng
            (u1, u2), rng = rng.uniform2d()
            cos_theta, phi, p_pp = sample_scatter_dir_medium(
                medium, ray.direction, ray.wavelength, u1, u2
            )
            dir_phase = scatter_dir(
                ray.direction, lax.stop_gradient(cos_theta), phi
            )
            phase_hit = self.target.intersect(p["target"], ray.position, dir_phase)

            target_hit, rng = self.target.sample(p["target"], ray.position, rng)
            dir_target = normalize(target_hit.position - ray.position)
            p_tt = target_hit.prob * _jacobian_dA_dW(
                ray.position, target_hit.position, target_hit.normal
            )
            p_pt = scatter_prob(medium, ray.direction, dir_target)
            p_tp = phase_hit.prob * _jacobian_dA_dW(
                ray.position, phase_hit.position, phase_hit.normal
            )
            # frozen MIS weights; traced physical factors reintroduced via
            # the log-ratio trick (primal-identical to the reference)
            sg = lax.stop_gradient
            w_target = sg(p_tt) * sg(p_pt) / (sg(p_tt) ** 2 + sg(p_pt) ** 2)
            w_phase = sg(p_pp) ** 2 / (sg(p_pp) ** 2 + sg(p_tp) ** 2)
            # grazing lanes sitting ~on the target overflow p_tt -> inf and
            # make the weight inf/inf = NaN; the reference drops such
            # contributions via its `contrib > 0` check — sanitize so the
            # NaN cannot poison the backward pass through masked lanes
            w_target = jnp.nan_to_num(w_target, nan=0.0, posinf=0.0, neginf=0.0)
            w_phase = jnp.nan_to_num(w_phase, nan=0.0, posinf=0.0, neginf=0.0)
            log_p_pt = _log_phase(medium, dot(ray.direction, dir_target))
            # detach the sampled angle: only the phase *value* carries grad
            log_p_pp = _log_phase(medium, lax.stop_gradient(cos_theta))

            # with MIS active the reference never records plain target hits
            # (ALLOW_RESPONSE is false for every trace call), so the two MIS
            # candidates are the only responses here
            assert hit_item is None
            resp_state, rng = self._create_response(
                p,
                resp_state,
                ray,
                phase_hit,
                dir_phase,
                w_phase,
                log_p_pp,
                True,
                mis_mask,
                rng,
                prop,
                medium=medium,
                pol=pol,
            )
            # record B: the target-sampled candidate
            resp_state, rng = self._create_response(
                p,
                resp_state,
                ray,
                target_hit,
                dir_target,
                w_target,
                log_p_pt,
                True,
                mis_mask,
                rng,
                prop,
                medium=medium,
                pol=pol,
            )
            # lanes that hit (or died) did not consume the MIS draws
            rng = _merge_dim(rng, rng_before, mis_mask)
        elif hit_item is not None:
            item, mask = hit_item
            rng_after = rng
            resp_state, rng_after = self.response.record(
                p["response"], resp_state, item, mask, rng_after
            )
            rng = _merge_dim(rng_after, rng, mask)

        code = jnp.where(
            mis_mask, jnp.int32(EventResultCode.RAY_SCATTERED), code
        )
        alive = alive & (code >= 0) & ~(in_bounds & hit_valid)
        return ray, alive, rng, resp_state, code, pol

    def _trace_batch(self, p, counter, streams):
        """The full jitted batch: sample -> first segment -> scan segments.

        Call-stack analogue of the reference's traceMain
        (tracer.volume.forward.glsl:231-276)."""
        medium = p["medium"]
        prop = self._propagation(p)
        rng = self.rng.state_for(counter, streams)

        # sampleRay (tracer.volume.forward.glsl:222-228)
        (lam, lam_contrib), rng = self.wavelengthSource.sample(p["photons"], rng)
        constants = medium_constants(medium, lam)
        src, rng = self.source.sample_forward(
            p["lightSource"], lam, constants, rng
        )
        ray = RayState(
            position=src.position,
            direction=src.direction,
            wavelength=lam,
            time=src.start_time,
            lin_contrib=src.contrib * lam_contrib,
            log_contrib=jnp.zeros_like(lam),
            constants=constants,
        )
        if self.polarized:
            # unpolarized sources get a frame from the local basis
            # (reference: lightsource.common.glsl createSourceRay)
            stokes = (
                src.stokes
                if src.stokes is not None
                else unpolarized_stokes(lam.shape)
            )
            pol_ref = (
                src.pol_ref
                if src.pol_ref is not None
                else local_frame(src.direction)[0]
            )
            pol = (stokes, pol_ref)
        else:
            pol = None

        resp_state = self.response.init()
        cb_state = self.callback.init(streams.shape[0], self.pathLength + 3)
        all_lanes = active_lanes(streams, p)
        cb_state = self.callback.on_event(
            p["callback"],
            cb_state,
            ray,
            jnp.full_like(streams, int(EventResultCode.RAY_CREATED), jnp.int32),
            all_lanes,
            0,
         pol=pol,)
        occluded = self.target.occluded(p["target"], ray.position)
        cb_state = self.callback.on_event(
            p["callback"],
            cb_state,
            ray,
            jnp.full_like(streams, int(EventResultCode.ERROR_TRACE_ABORT), jnp.int32),
            occluded & all_lanes,
            0,
         pol=pol,)
        alive = all_lanes & ~occluded & ~ray.is_bad()

        mis = not self.disableTargetSampling
        direct = not self.disableDirectLighting
        if direct and mis:
            # extend first ray to the target (tracer.volume.forward.glsl:250-253)
            direct_hit = self.target.intersect(
                p["target"], ray.position, ray.direction
            )
            resp_state, rng = self._create_response(
                p,
                resp_state,
                ray,
                direct_hit,
                ray.direction,
                jnp.ones_like(lam),
                None,
                False,
                alive,
                rng,
                prop,
                medium=medium,
                pol=pol,
            )

        # first trace: may respond directly only if there is no MIS
        # (the reference's DIRECT_LIGHTING macro: with MIS enabled the
        # unscattered segment was already handled by the extension above)
        first_allow = (not mis) and direct
        pre_alive = alive
        ray, alive, rng, resp_state, code, pol = self._trace_step(
            p, prop, medium, ray, alive, rng, resp_state, first_allow, pol
        )
        cb_state = self.callback.on_event(
            p["callback"], cb_state, ray, code, pre_alive, 1
        , pol=pol)

        allow_in_loop = not mis

        def body(i, carry):
            if self.polarized:
                ray, alive, rng, resp_state, cb_state, pol = carry
            else:
                ray, alive, rng, resp_state, cb_state = carry
                pol = None
            pre_alive = alive
            # scatter (2 draws), then trace
            rng_b = rng
            (u1, u2), rng = rng.uniform2d()
            cos_theta, phi, _ = sample_scatter_dir_medium(
                medium, ray.direction, ray.wavelength, u1, u2
            )
            new_dir = scatter_dir(
                ray.direction, lax.stop_gradient(cos_theta), phi
            )
            if pol is not None:
                new_stokes, new_ref = _pol_scatter(
                    medium, ray.direction, new_dir, pol
                )
                pol = (
                    jnp.where(alive[..., None], new_stokes, pol[0]),
                    jnp.where(alive[..., None], new_ref, pol[1]),
                )
            scattered = scatter_ray_is(ray, new_dir)
            log_p = _log_phase(medium, lax.stop_gradient(cos_theta))
            if log_p is not None:
                scattered = replace(
                    scattered,
                    log_contrib=scattered.log_contrib
                    + log_p
                    - lax.stop_gradient(log_p),
                )
            ray = jax.tree.map(
                lambda new, old: jnp.where(
                    alive.reshape(alive.shape + (1,) * (new.ndim - alive.ndim)),
                    new,
                    old,
                ),
                scattered,
                ray,
            )
            rng = _merge_dim(rng, rng_b, alive)

            ray, alive, rng, resp_state, code, pol = self._trace_step(
                p, prop, medium, ray, alive, rng, resp_state, allow_in_loop, pol
            )
            cb_state = self.callback.on_event(
                p["callback"], cb_state, ray, code, pre_alive, i + 2
            , pol=pol)
            if self.polarized:
                return ray, alive, rng, resp_state, cb_state, pol
            return ray, alive, rng, resp_state, cb_state

        if self.polarized:
            carry = (ray, alive, rng, resp_state, cb_state, pol)
            out = lax.fori_loop(0, self.pathLength, body, carry)
            ray, alive, rng, resp_state, cb_state, pol = out
        else:
            ray, alive, rng, resp_state, cb_state = lax.fori_loop(
                0,
                self.pathLength,
                body,
                (ray, alive, rng, resp_state, cb_state),
            )
        cb_state = self.callback.on_event(
            p["callback"],
            cb_state,
            ray,
            jnp.full_like(streams, int(EventResultCode.MAX_ITER), jnp.int32),
            alive,
            self.pathLength + 2,
         pol=pol,)
        if getattr(self, "_debug_rng", False):
            # conformance hook: expose each lane's final dim counter
            return resp_state, cb_state, rng.dim
        return resp_state, cb_state

