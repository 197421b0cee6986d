"""Shared ray-state machinery for all tracers.

The wavefront of N photons is a pytree of (N,)-shaped arrays; every function
here is a pure, differentiable jnp transform on it. Semantics mirror the
reference's device library (reference: src/theia/shader/ray.glsl:22-143,
ray.propagate.glsl:32-166, ray.scatter.glsl:13-44,
scatter.volume.glsl:7-77, result.glsl:10-29) with one deliberate extension:
all sampling-probability factors are wrapped in ``stop_gradient`` while the
physical factors stay traced, making every tracer an unbiased
"differentiate the integrand, freeze the sampler" gradient estimator —
machinery the reference does not have (SURVEY.md §5.9).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from enum import IntEnum

import jax
import jax.numpy as jnp
from jax import lax

from ..compile_cache import jit
from ..component import Component
from ..material import Medium, MediumConstants, medium_constants, normalize_lambda
from ..lookup import lookup
from ..ops.math3d import dot, matvec, normalize, vec3
from ..ops.sampling import INV_4PI, TWO_PI, scatter_dir

__all__ = [
    "EventResultCode",
    "TracerBase",
    "active_lanes",
    "PropagateParams",
    "RayState",
    "sample_scatter_length",
    "update_ray",
    "update_ray_is",
    "propagate_ray",
    "propagate_ray_to_hit",
    "reattach_geometry",
    "sample_scatter_dir_medium",
    "scatter_prob",
    "scatter_ray",
    "scatter_ray_is",
    "create_hit",
    "HitItem",
]


class EventResultCode(IntEnum):
    """Result codes emitted after each trace step
    (reference: src/theia/shader/result.glsl:10-29, trace.py:308-343)."""

    SUCCESS = 0
    RAY_CREATED = 1
    RAY_SCATTERED = 2
    RAY_HIT = 3
    RAY_DETECTED = 4
    VOLUME_HIT = 5
    RAY_LOST = -1
    RAY_DECAYED = -2
    RAY_ABSORBED = -3
    RAY_MISSED = -4
    MAX_ITER = -5
    ERROR_CODE_MAX_VALUE = -10
    ERROR_UNKNOWN = -10
    ERROR_MEDIA_MISMATCH = -11
    ERROR_TRACE_ABORT = -12
    ERROR_RAY_BAD = -13


def active_lanes(streams: jax.Array, p) -> jax.Array:
    """Mask of lanes that belong to the current (runtime) batch.

    The analogue of the reference's indirect dispatch (src/theia/trace.py:
    354-408): the traced program always runs ``capacity`` lanes; lanes with
    ``stream >= batchSize`` are masked dead from creation, so ``batchSize``
    can change per batch without retracing."""
    tracer = p.get("tracer", {}) if isinstance(p, dict) else {}
    bs = tracer.get("batchSize") if isinstance(tracer, dict) else None
    if bs is None:
        return jnp.ones(streams.shape, dtype=bool)
    return streams < bs


class TracerBase(Component):
    """Host-side batch API shared by every tracer.

    Lanes are allocated once at ``capacity`` and the trace function is
    jitted once; ``batchSize`` is a *runtime* parameter: lanes beyond it
    are masked dead (see :func:`active_lanes`) and the ``1/batchSize``
    normalization follows the runtime value, so
    ``setParams(batchSize=...)`` — or the pipeline's
    ``tracer__batchSize`` — switches batch sizes between tasks with no
    recompilation (reference semantics: indirect dispatch,
    src/theia/trace.py:354-408, 478-481)."""

    @property
    def _debug_rng(self) -> bool:
        """Conformance hook: when set, ``_trace_batch`` additionally returns
        each lane's final RNG dim counter (see tests/test_rng_schedule.py).

        The flag is read at *trace* time, so it must invalidate the jit
        cache on change — jax.jit keys on argument avals only and would
        otherwise keep serving the stale non-debug computation."""
        return self.__dict__.get("_debug_rng_flag", False)

    @_debug_rng.setter
    def _debug_rng(self, value: bool) -> None:
        if bool(value) != self.__dict__.get("_debug_rng_flag", False):
            self.__dict__["_debug_rng_flag"] = bool(value)
            if "_jit_trace" in self.__dict__:
                self._jit_trace = jit(self._trace_batch)

    def _init_batch(self, batchSize: int, capacity: int | None) -> None:
        capacity = batchSize if capacity is None else capacity
        if not 0 < batchSize <= capacity:
            raise ValueError(
                f"batchSize must be in (0, capacity={capacity}], got {batchSize}"
            )
        self.batchSize = batchSize
        self.capacity = capacity
        self.normalization = 1.0 / batchSize

    def setParams(self, **kwargs) -> None:
        if "batchSize" in kwargs:
            bs = int(kwargs.pop("batchSize"))
            if not 0 < bs <= self.capacity:
                raise ValueError(
                    f"batchSize must be in (0, capacity={self.capacity}], got {bs}"
                )
            self.batchSize = bs
            self.normalization = 1.0 / bs
            response = getattr(self, "response", None)
            if response is not None:
                response.renormalize(self.normalization)
        super().setParams(**kwargs)

    def getParam(self, name: str):
        if name == "batchSize":
            return self.batchSize
        return super().getParam(name)

    def streams(self) -> jax.Array:
        """Lane ids for one batch — always ``capacity`` wide."""
        return jnp.arange(self.capacity, dtype=jnp.uint32)

    # -- host API shared by all tracers ---------------------------------

    def run(self, params=None, *, advance: bool = True):
        """Trace one batch; returns (response result, callback result).

        Advances the RNG offset by nRNGSamples afterwards (the reference's
        autoAdvance, src/theia/random.py:278-282)."""
        p = self.params() if params is None else params
        counter = self.rng.counter_words
        resp_state, cb_state = self._jit_trace(p, counter, self.streams())
        if advance:
            self.rng.advance()
        return (
            self.response.result(p["response"], resp_state),
            self.callback.result(p["callback"], cb_state),
        )

    def trace_fn(self):
        """Return (fn, example_args) with fn(params, counter, streams) ->
        (response_state, callback_state) — the raw jittable step for
        composition with jax.grad / shard_map."""
        return self._trace_batch, (
            self.params(),
            self.rng.counter_words,
            self.streams(),
        )


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class PropagateParams:
    """Propagation bounds and the distance-sampling coefficient
    (reference: src/theia/shader/ray.propagate.glsl:20-28).

    ``scatter_coefficient``: negative/NaN -> importance sample with the
    medium's mu_s; zero disables volume scattering."""

    scatter_coefficient: jax.Array
    lower_bbox: jax.Array  # f32[3]
    upper_bbox: jax.Array  # f32[3]
    max_time: jax.Array
    max_dist: jax.Array


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class RayState:
    """Per-lane ray state; contribution = lin_contrib * exp(log_contrib)."""

    position: jax.Array  # f32[N,3]
    direction: jax.Array  # f32[N,3]
    wavelength: jax.Array  # f32[N]
    time: jax.Array  # f32[N]
    lin_contrib: jax.Array  # f32[N]
    log_contrib: jax.Array  # f32[N]
    constants: MediumConstants  # per-lane

    @property
    def contrib(self) -> jax.Array:
        """lin * exp(log), computed in log space with clamping.

        The naive product overflows on extreme importance-sampling-tail
        lanes (exp alone can overflow while the product is moderate) and
        its VJP then evaluates 0*inf = NaN on *masked* lanes, poisoning
        medium-parameter gradients. Clamping the combined exponent keeps
        every lane finite with zero gradient outside the clamp."""
        mag = jnp.abs(self.lin_contrib)
        mag_safe = jnp.where(mag > 0, mag, 1.0)
        log_total = jnp.clip(jnp.log(mag_safe) + self.log_contrib, -87.0, 87.0)
        value = jnp.sign(self.lin_contrib) * jnp.exp(log_total)
        return jnp.where(mag > 0, value, 0.0)

    def is_bad(self) -> jax.Array:
        """NaN/inf guard (reference: ray.glsl:136-143)."""
        bad_pos = jnp.any(~jnp.isfinite(self.position), axis=-1)
        bad_dir = jnp.any(~jnp.isfinite(self.direction), axis=-1)
        zero_dir = dot(self.direction, self.direction) <= 0.0
        return bad_pos | bad_dir | zero_dir


def _effective_sample_coef(
    params: PropagateParams, constants: MediumConstants
) -> jax.Array:
    """Negative/NaN scatter_coefficient selects the medium's mu_s."""
    coef = params.scatter_coefficient
    use_medium = ~(coef >= 0.0)  # catches negatives AND NaN
    return jnp.where(use_medium, constants.mu_s, coef)


def sample_scatter_length(
    ray: RayState, params: PropagateParams, u: jax.Array
) -> jax.Array:
    """Exponential distance sampling; non-scattering media travel max_dist
    (reference: ray.propagate.glsl:32-49)."""
    coef = _effective_sample_coef(params, ray.constants)
    coef = lax.stop_gradient(coef)  # sampling density is frozen for AD
    can_scatter = ray.constants.mu_s > 0.0
    sample = (coef != 0.0) & can_scatter
    safe = jnp.where(sample, coef, 1.0)
    dist = -jnp.log1p(-u) / safe
    return jnp.where(sample, dist, params.max_dist)


def update_ray(
    ray: RayState, dist: jax.Array, params: PropagateParams
) -> tuple[RayState, jax.Array]:
    """Attenuate and advance time as if traveled ``dist`` (position
    unchanged); returns (ray, result_code) with DECAYED past max_time
    (reference: ray.propagate.glsl:70-80).

    ``dist`` is frozen for AD (path geometry is detached); mu_e stays
    traced so transmittance gradients flow. ``vg`` is traced too: arrival
    times then carry d(time)/d(group_velocity), which reaches the light
    curve through time-smooth responses (KernelHistogramHitResponse);
    hard-binned histograms freeze time at the binning instead."""
    d = lax.stop_gradient(dist)
    new = replace(
        ray,
        log_contrib=ray.log_contrib - ray.constants.mu_e * d,
        time=ray.time + d / ray.constants.vg,
    )
    code = jnp.where(
        new.time <= params.max_time,
        jnp.int32(EventResultCode.SUCCESS),
        jnp.int32(EventResultCode.RAY_DECAYED),
    )
    return new, code


def update_ray_is(
    ray: RayState, dist: jax.Array, params: PropagateParams, hit: jax.Array
) -> RayState:
    """Apply the 1/pdf factor of exponential distance sampling: on a hit the
    exp(+coef*d) survival factor alone; on a miss additionally 1/coef
    (reference: ray.propagate.glsl:101-130). Pure sampling probability ->
    fully stop-gradiented."""
    coef = lax.stop_gradient(_effective_sample_coef(params, ray.constants))
    d = lax.stop_gradient(dist)
    can_scatter = ray.constants.mu_s > 0.0
    log_is = jnp.where(can_scatter, coef * d, 0.0)
    # 1/coef on miss; coef==0 gives inf, discarded later as RAY_LOST —
    # guarded to keep NaNs out of the masked lanes
    inv = 1.0 / jnp.where(coef > 0.0, coef, 1.0)
    lin_is = jnp.where(can_scatter & ~hit, inv, 1.0)
    return replace(
        ray,
        log_contrib=ray.log_contrib + log_is,
        lin_contrib=ray.lin_contrib * lin_is,
    )


def propagate_ray(
    ray: RayState, dist: jax.Array, params: PropagateParams
) -> tuple[RayState, jax.Array]:
    """Move the ray; RAY_LOST outside the trace bbox
    (reference: ray.propagate.glsl:153-166)."""
    d = lax.stop_gradient(dist)
    pos = ray.position + d[..., None] * ray.direction
    outside = jnp.any(
        (pos < params.lower_bbox) | (pos > params.upper_bbox), axis=-1
    )
    new, code = update_ray(replace(ray, position=pos), dist, params)
    code = jnp.where(outside, jnp.int32(EventResultCode.RAY_LOST), code)
    return new, code


def reattach_geometry(
    ray: RayState, dist: jax.Array, valid: jax.Array | None = None
) -> RayState:
    """Re-attach a *deterministic* distance's gradient to arrival time and
    transmittance via the zero-valued ``dist - stop_gradient(dist)``.

    ``update_ray``/``propagate_ray`` freeze ``dist`` by design (the
    frozen-sampler AD discipline): sampled scatter lengths must not be
    differentiated. But a surface-hit ``t`` or a shadow/connection distance
    is pure geometry — recomputed differentiably by ``intersect_scene`` /
    the analytic targets — so adding this correction makes arrival times
    and exp(-mu_e d) carry d/d(geometry) (e.g. source-position
    reconstruction from light curves) without changing any primal value or
    the vg/mu gradient paths. Call it ONLY for geometric distances, never
    for sampled ones."""
    dt = dist - lax.stop_gradient(dist)
    if valid is not None:
        dt = jnp.where(valid, dt, 0.0)
    return replace(
        ray,
        time=ray.time + dt / ray.constants.vg,
        log_contrib=ray.log_contrib - ray.constants.mu_e * dt,
    )


def propagate_ray_to_hit(
    ray: RayState, hit_pos: jax.Array, params: PropagateParams
) -> tuple[RayState, jax.Array]:
    """Propagate to a known hit position (reference: ray.propagate.glsl:245-258).

    The distance to a known hit is geometric, so its gradient is
    re-attached (see ``reattach_geometry``)."""
    dist = jnp.linalg.norm(hit_pos - ray.position, axis=-1)
    new, code = update_ray(replace(ray, position=hit_pos), dist, params)
    return reattach_geometry(new, dist), code


# ------------------------------ volume scattering ---------------------------


def sample_scatter_dir_medium(
    medium: Medium | None, in_dir: jax.Array, wavelength, u1, u2
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Importance sample the phase function.

    Returns (cos_theta, phi, pdf). With no sampling table: uniform sphere
    (reference: scatter.volume.glsl:30-47)."""
    phi = jnp.float32(TWO_PI) * u1
    if medium is not None and medium.phase_sampling is not None:
        cos_theta = jnp.clip(lookup(medium.phase_sampling, u2), -1.0, 1.0)
        pdf = jnp.exp(lookup(medium.log_phase_function, 0.5 * (cos_theta + 1.0)))
    else:
        cos_theta = 2.0 * u2 - 1.0
        pdf = jnp.full_like(cos_theta, INV_4PI)
    return cos_theta, phi, pdf


def scatter_prob(
    medium: Medium | None, in_dir: jax.Array, out_dir: jax.Array
) -> jax.Array:
    """Phase-function value for the given direction pair
    (reference: scatter.volume.glsl:56-68)."""
    if medium is None or medium.log_phase_function is None:
        return jnp.full(in_dir.shape[:-1], INV_4PI, jnp.float32)
    cos_theta = dot(in_dir, out_dir)
    return jnp.exp(lookup(medium.log_phase_function, 0.5 * (cos_theta + 1.0)))


def scatter_ray_is(ray: RayState, new_dir: jax.Array) -> RayState:
    """Scatter into an importance-sampled direction: only the scattering
    coefficient is applied — the phase function cancelled against its pdf
    (reference: ray.scatter.glsl:13-18)."""
    return replace(
        ray,
        direction=new_dir,
        lin_contrib=ray.lin_contrib * ray.constants.mu_s,
    )


def scatter_ray(
    ray: RayState, medium: Medium | None, new_dir: jax.Array
) -> RayState:
    """Scatter into an arbitrary direction: apply phase function and mu_s
    (reference: ray.scatter.glsl:24-30)."""
    phase = scatter_prob(medium, ray.direction, new_dir)
    return replace(
        ray,
        direction=new_dir,
        lin_contrib=ray.lin_contrib * ray.constants.mu_s * phase,
    )


def scatter_ray_sampled(
    ray: RayState, medium: Medium | None, u1, u2
) -> RayState:
    """Importance-sampled scatter (reference: ray.scatter.glsl:36-44).

    The phase/pdf ratio is 1 in the primal but carries the gradient of the
    phase function w.r.t. medium parameters (detached-sampler AD; not in
    the reference)."""
    cos_theta, phi, _ = sample_scatter_dir_medium(
        medium, ray.direction, ray.wavelength, u1, u2
    )
    cos_theta = lax.stop_gradient(cos_theta)
    new_dir = scatter_dir(ray.direction, cos_theta, phi)
    ray = scatter_ray_is(ray, lax.stop_gradient(new_dir))
    if medium is not None and medium.log_phase_function is not None:
        log_p = lookup(medium.log_phase_function, 0.5 * (cos_theta + 1.0))
        ray = replace(
            ray,
            log_contrib=ray.log_contrib + log_p - lax.stop_gradient(log_p),
        )
    return ray


# ------------------------------ hits ----------------------------------------


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class HitItem:
    """Detector hit in object space
    (reference: src/theia/shader/response.common.glsl:4-20).
    ``stokes``/``pol_ref`` present only in polarized mode."""

    position: jax.Array  # f32[N,3] object space
    direction: jax.Array  # f32[N,3] object space
    normal: jax.Array  # f32[N,3] object space
    wavelength: jax.Array  # f32[N]
    time: jax.Array  # f32[N]
    contrib: jax.Array  # f32[N]
    object_id: jax.Array  # i32[N]
    stokes: jax.Array | None = None  # f32[N,4] normalized
    pol_ref: jax.Array | None = None  # f32[N,3] object space


def create_hit(
    ray: RayState,
    obj_pos: jax.Array,
    obj_normal: jax.Array,
    object_id,
    world_to_obj: jax.Array | None = None,
    pol: tuple[jax.Array, jax.Array] | None = None,
) -> HitItem:
    """Build a HitItem from the ray's current state
    (reference: src/theia/shader/ray.response.glsl:18-92).

    ``pol=(stokes, pol_ref)`` in world space enables the polarized variant:
    the reference frame is transformed to object space, aligned to the
    plane of incidence, and S0 is folded into the contribution."""
    if world_to_obj is None:
        obj_dir = ray.direction
    else:
        obj_dir = normalize(
            matvec(world_to_obj, ray.direction)
        )
    object_id = jnp.broadcast_to(
        jnp.asarray(object_id, jnp.int32), ray.wavelength.shape
    )
    contrib = ray.contrib
    stokes = pol_ref = None
    if pol is not None:
        from ..ops.math3d import perpendicular_to2
        from ..polarization import apply_rotation, rotation_coeffs

        w_stokes, w_ref = pol
        hit_pol_ref = perpendicular_to2(obj_dir, obj_normal)
        if world_to_obj is None:
            obj_pol_ref = w_ref
        else:
            obj_pol_ref = normalize(
                matvec(world_to_obj, w_ref)
            )
        c, s = rotation_coeffs(obj_dir, obj_pol_ref, hit_pol_ref)
        stokes = apply_rotation(w_stokes, c, s)
        s0 = stokes[..., 0]
        contrib = contrib * s0
        safe = jnp.where(s0 != 0.0, s0, 1.0)
        stokes = stokes / safe[..., None]
        pol_ref = hit_pol_ref
    return HitItem(
        position=obj_pos,
        direction=obj_dir,
        normal=obj_normal,
        wavelength=ray.wavelength,
        time=ray.time,
        contrib=contrib,
        object_id=object_id,
        stokes=stokes,
        pol_ref=pol_ref,
    )
