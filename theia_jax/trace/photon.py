"""Photon-resolved tracers: Russian-roulette absorption sampling.

The reference's wavefront photon mode traces PATH_LENGTH segments per
"run", compacts survivors into a queue and relaunches with an indirect
dispatch (reference: src/theia/trace.py:2370-2959,
shader/tracer.{volume,scene}.photon.*.glsl, SURVEY.md §3.3). Here the
default path collapses the runs into ``nRuns x nScatteringPerRun`` masked
loop segments inside one jitted program; when RR absorption empties the
wavefront quickly, :meth:`VolumePhotonTracer.run_compacted` restores the
queue economy as a host-driven static-shape ladder.
The reference's *RNG schedule* is kept: every run starts at a fixed
per-run dimension base (its relaunch pushes a uniform dim offset), so
streams stay comparable.

Per segment the photon's accumulated contribution is its survival
probability: survival is sampled (contrib <= u -> absorbed), then the
contribution resets to 1. Detection reports the survival chance as
contribution — pair with ``StoreTimeHitResponse`` to sample the final
detection (reference: trace.py:2735-2741 note).
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
from ..component import Component, TraceConfig
from ..light import LightSource, WavelengthSource
from ..material import Medium, medium_constants
from ..lookup import lookup
from ..ops.sampling import scatter_dir
from ..random import PhiloxRNG, RNGState
from ..target import Target
from .core import (
    TracerBase,
    active_lanes,
    EventResultCode,
    PropagateParams,
    RayState,
    create_hit,
    propagate_ray,
    reattach_geometry,
    sample_scatter_dir_medium,
    sample_scatter_length,
    scatter_ray_is,
    update_ray_is,
)
from .scene import SceneForwardTracer

if TYPE_CHECKING:
    from ..response import HitResponse

__all__ = ["VolumePhotonTracer", "ScenePhotonTracer"]


def _merge_dim(after: RNGState, before: RNGState, take_after) -> RNGState:
    return replace(before, dim=jnp.where(take_after, after.dim, before.dim))


def _sample_absorption(ray: RayState, alive, rng: RNGState):
    """Russian roulette on the accumulated contribution; survivors reset
    to contribution 1 (reference: tracer.volume.photon.common.glsl:88-104)."""
    uu, rng_after = rng.uniform()
    survive = ray.contrib > uu
    rng = _merge_dim(rng_after, rng, alive)
    new = replace(
        ray,
        lin_contrib=jnp.where(alive & survive, 1.0, ray.lin_contrib),
        log_contrib=jnp.where(alive & survive, 0.0, ray.log_contrib),
    )
    return new, alive & survive, rng


class _CompactionLadderMixin:
    """Host-driven shrink-ladder execution for the photon tracers.

    The reference's photon mode compacts survivors into a queue and
    relaunches with an indirect dispatch (reference:
    src/theia/trace.py:2627-2668, wavefront queue economy). A single
    fixed-shape ``fori_loop`` cannot shrink, so :meth:`run_compacted`
    launches each *run* as its own jitted step and, whenever occupancy
    drops below ``min_fill``, gathers survivors to the front (stable
    argsort) and halves the lane count — a static-shape ladder with one
    cached compile per size. Survivors keep their original Philox stream
    ids (and, where applicable, their per-lane dim counters), so the
    draws — and the histogram — match :meth:`run` up to float32
    accumulation order.

    Subclass hooks: ``_ladder_init(p, counter, streams) -> state`` (a
    dict of per-lane arrays that must include ``"alive"`` and
    ``"streams"``) and ``_ladder_chunk(p, counter, run, state,
    resp_state) -> (state, resp_state)`` tracing one run.
    """

    def run_compacted(
        self,
        *,
        min_fill: float = 0.5,
        min_lanes: int = 1024,
        advance: bool = True,
        replan: bool | None = None,
        streams=None,
    ):
        """Trace one batch run-by-run, compacting survivors between runs.

        Requires an additive response (histogram family) and no event
        callback: per-run launches accumulate one response state but
        cannot stitch per-step callback tensors across ladder sizes.

        The first batch adapts: it synchronizes on the survivor count
        after every run to pick ladder sizes (with 1/min_fill headroom)
        and records the schedule. Subsequent batches *replay* the plan
        with zero host syncs — launches chain asynchronously on-device,
        which matters wherever dispatch round-trips are expensive.
        Replayed gathers count survivors that exceeded the planned size
        into :attr:`compaction_overflow` (dropped; re-run with
        ``replan=True`` if nonzero — survival statistics shifted). If
        the adaptive batch finds no shrinkage, replays auto-delegate to
        the monolithic loop.

        Wins when absorption kills lanes quickly. Returns the response
        result (like :meth:`run`).

        ``streams``: optional replacement for the default lane-id array —
        pass one placed with a multi-device ``NamedSharding`` to execute
        every ladder launch (and its compaction gathers) as an SPMD
        program over the mesh; jit propagates the sharding through the
        per-lane state and XLA inserts the collectives."""
        from ..response import HistogramHitResponse

        if not isinstance(self.response, HistogramHitResponse):
            raise ValueError(
                "run_compacted needs an additive response (histogram "
                f"family), got {type(self.response).__name__}"
            )
        if not isinstance(self.callback, EmptyEventCallback):
            raise ValueError("run_compacted does not support event callbacks")

        p = self.params()
        counter = self.rng.counter_words
        if streams is None:
            streams = self.streams()
        state = self._jit_ladder_init(p, counter, streams)
        resp_state = self.response.init()

        plan = self.__dict__.get("_compact_plan")
        adapt = replan or plan is None
        if not adapt and all(s == self.capacity for s in plan):
            # auto heuristic: the adaptive batch found no shrinkage (high
            # survival) — per-run launches would only add dispatch
            # overhead, so delegate to the monolithic loop
            return self.run(p, advance=advance)[0]
        size = self.capacity
        sizes: list[int] = []
        overflow = jnp.zeros((), jnp.int32)
        for run in range(self.nRuns):
            state, resp_state = self._jit_ladder_chunk(size)(
                p, counter, jnp.uint32(run), state, resp_state
            )
            if run == self.nRuns - 1:
                break
            if adapt:
                n_alive = int(jnp.sum(state["alive"]))  # host sync (1st batch)
                new_size = size
                while (
                    new_size // 2 >= max(min_lanes, 1)
                    and n_alive <= new_size // 2 * min_fill
                ):
                    new_size //= 2
            else:
                new_size = min(size, plan[run])
            sizes.append(new_size)
            if new_size != size:
                state, dropped = self._jit_ladder_gather(new_size)(state)
                overflow = overflow + dropped
                size = new_size
        if adapt:
            self._compact_plan = sizes
        # device scalar, fetched lazily by the property — converting here
        # would block the async launch chain before the caller pipelines it
        self._overflow_dev = overflow
        if advance:
            self.rng.advance()
        return self.response.result(p["response"], resp_state)

    @property
    def compaction_overflow(self) -> int:
        """Live photons dropped by the last replayed ladder (0 on adaptive
        batches by construction); nonzero means re-run with replan=True."""
        dev = self.__dict__.get("_overflow_dev")
        return 0 if dev is None else int(dev)

    @property
    def _jit_ladder_init(self):
        fn = self.__dict__.get("_ladder_init_fn")
        if fn is None:
            fn = self.__dict__["_ladder_init_fn"] = jit(self._ladder_init)
        return fn

    def _jit_ladder_chunk(self, size: int):
        cache = self.__dict__.setdefault("_ladder_chunk_fns", {})
        fn = cache.get(size)
        if fn is None:
            fn = cache[size] = jit(self._ladder_chunk)
        return fn

    def _jit_ladder_gather(self, new_size: int):
        cache = self.__dict__.setdefault("_ladder_gather_fns", {})
        fn = cache.get(new_size)
        if fn is None:

            def gather(state):
                # stable survivors-first permutation, truncated to the
                # ladder size; on adaptive batches dropped lanes are dead
                # by construction, on replays any live excess is counted
                alive = state["alive"]
                order = jnp.argsort(~alive)[:new_size]
                take = lambda a: jnp.take(a, order, axis=0)
                dropped = jnp.sum(alive.astype(jnp.int32)) - jnp.sum(
                    take(alive).astype(jnp.int32)
                )
                return jax.tree.map(take, state), dropped

            fn = cache[new_size] = jit(gather)
        return fn


class VolumePhotonTracer(_CompactionLadderMixin, TracerBase):
    """Photon-resolved volume tracing against an analytic target
    (reference: src/theia/trace.py:2671-2959)."""

    name = "Volume Photon Tracer"
    _param_names = ("objectId", "maxTime")

    def __init__(
        self,
        batchSize: int,
        source: LightSource,
        target: Target,
        wavelengthSource: WavelengthSource,
        response: "HitResponse",
        rng: PhiloxRNG,
        *,
        medium: Medium | None,
        objectId: int = 0,
        capacity: int | None = None,
        callback: TraceEventCallback | None = None,
        traceBBox: tuple = ((-1.0 * u.km,) * 3, (1.0 * u.km,) * 3),
        maxTime: float = 1000.0 * u.ns,
        nScatteringPerRun: int = 10,
        nRuns: int = 10,
        polarized: bool = False,
    ) -> None:
        self._init_batch(batchSize, capacity)
        self.source = source
        self.target = target
        self.wavelengthSource = wavelengthSource
        self.response = response
        self.rng = rng
        self.medium = medium
        self.objectId = objectId
        self.callback = EmptyEventCallback() if callback is None else callback
        self.traceBBox = traceBBox
        self.maxTime = maxTime
        self.nScatteringPerRun = nScatteringPerRun
        self.nRuns = nRuns
        self.polarized = polarized
        self.maxHitsPerThread = 1

        # reference accounting (trace.py:2782-2785)
        self._pre_dims = source.nRNGForward + wavelengthSource.nRNGSamples
        self._per_run = 4 * nScatteringPerRun + response.nRNGSamples
        self.nRNGSamples = (
            self._pre_dims
            + 4 * nRuns * nScatteringPerRun
            + response.nRNGSamples
        )
        rng.configure(self.nRNGSamples, self.capacity)
        response.prepare(
            TraceConfig(
                batch_size=batchSize,
                capacity=self.capacity,
                max_hits_per_thread=nRuns,  # one response record per run
                normalization=self.normalization,
                polarized=polarized,
            )
        )
        self._jit_trace = jit(self._trace_batch)

    def collectStages(self):
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

    def _propagation(self, p) -> PropagateParams:
        lo = p["tracer"]["lowerBBox"]
        hi = p["tracer"]["upperBBox"]
        return PropagateParams(
            scatter_coefficient=jnp.float32(float("nan")),
            lower_bbox=lo,
            upper_bbox=hi,
            max_time=p["tracer"]["maxTime"],
            max_dist=jnp.linalg.norm(hi - lo),
        )

    def _init_photons(self, p, rng: RNGState, streams):
        """Sample the initial photon wavefront (wavelength + source)."""
        medium = p["medium"]
        (lam, _), rng = self.wavelengthSource.sample(p["photons"], rng)
        constants = medium_constants(medium, lam)
        src, rng = self.source.sample_forward(p["lightSource"], lam, constants, rng)
        # photon mode: contribution tracks survival probability only
        ray = RayState(
            position=src.position,
            direction=src.direction,
            wavelength=lam,
            time=src.start_time,
            lin_contrib=jnp.ones_like(lam),
            log_contrib=jnp.zeros_like(lam),
            constants=constants,
        )
        occluded = self.target.occluded(p["target"], ray.position)
        alive = active_lanes(streams, p) & ~occluded & ~ray.is_bad()
        return ray, alive, occluded, rng

    def _trace_batch(self, p, counter, streams):
        medium = p["medium"]
        prop = self._propagation(p)
        rng = self.rng.state_for(counter, streams)
        ray, alive, occluded, rng = self._init_photons(p, rng, streams)

        resp_state = self.response.init()
        n_steps = self.nRuns * self.nScatteringPerRun
        cb_state = self.callback.init(streams.shape[0], n_steps + 2)
        all_lanes = active_lanes(streams, p)
        cb_state = self.callback.on_event(
            p["callback"],
            cb_state,
            ray,
            jnp.full_like(streams, int(EventResultCode.RAY_CREATED), jnp.int32),
            all_lanes,
            0,
        )
        cb_state = self.callback.on_event(
            p["callback"],
            cb_state,
            ray,
            jnp.full_like(
                streams, int(EventResultCode.ERROR_TRACE_ABORT), jnp.int32
            ),
            occluded & all_lanes,
            0,
        )

        body = lambda i, carry: self._photon_step(p, prop, medium, i, carry)

        carry = (ray, alive, rng, resp_state, cb_state)
        ray, alive, rng, resp_state, cb_state = lax.fori_loop(
            0, n_steps, body, carry
        )
        cb_state = self.callback.on_event(
            p["callback"],
            cb_state,
            ray,
            jnp.full_like(streams, int(EventResultCode.MAX_ITER), jnp.int32),
            alive,
            n_steps + 1,
        )
        if getattr(self, "_debug_rng", False):
            # conformance hook: expose each lane's final dim counter
            return resp_state, cb_state, rng.dim
        return resp_state, cb_state

    def _photon_step(self, p, prop, medium, i, carry):
        """One trace segment (shared by the monolithic batch loop and the
        compacted per-run launches); ``i`` is the traced global step."""
        ray, alive, rng, resp_state, cb_state = carry
        if True:  # keep the original body's indentation level
            pre_alive = alive
            # run-boundary dim resync (the reference's relaunch push.dim)
            run = i // self.nScatteringPerRun
            at_boundary = (i % self.nScatteringPerRun) == 0
            base = self._pre_dims + run * self._per_run
            rng = replace(
                rng,
                dim=jnp.where(
                    at_boundary,
                    jnp.uint32(base),
                    rng.dim,
                ),
            )

            # trace (tracer.volume.photon.common.glsl:37-79)
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

            item = create_hit(
                ray,
                hit.obj_position,
                hit.obj_normal,
                p["tracer"]["objectId"],
                hit.world_to_obj,
            )
            detect = pre_alive & in_bounds & hit_valid & (item.contrib > 0.0)
            rng_b = rng
            resp_state, rng = self.response.record(
                p["response"], resp_state, item, detect, rng
            )
            rng = _merge_dim(rng, rng_b, detect)
            # a detected photon is absorbed (no double counting)
            code = jnp.where(
                in_bounds & hit_valid,
                jnp.int32(EventResultCode.RAY_ABSORBED),
                jnp.where(
                    in_bounds, jnp.int32(EventResultCode.RAY_SCATTERED), code
                ),
            )
            step_ok = pre_alive & in_bounds & ~hit_valid

            # scatter (unconditional draw like the reference)
            (u1, u2), rng = rng.uniform2d()
            cos_theta, phi, _ = sample_scatter_dir_medium(
                medium, ray.direction, ray.wavelength, u1, u2
            )
            new_dir = scatter_dir(
                ray.direction, lax.stop_gradient(cos_theta), phi
            )
            scattered = scatter_ray_is(ray, new_dir)
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
            ray = jax.tree.map(
                lambda new, old: jnp.where(
                    step_ok.reshape(
                        step_ok.shape + (1,) * (new.ndim - step_ok.ndim)
                    ),
                    new,
                    old,
                ),
                scattered,
                ray,
            )

            # Russian-roulette absorption
            ray, survive, rng = _sample_absorption(ray, step_ok, rng)
            code = jnp.where(
                step_ok & ~survive,
                jnp.int32(EventResultCode.RAY_ABSORBED),
                code,
            )
            alive = step_ok & survive
            cb_state = self.callback.on_event(
                p["callback"], cb_state, ray, code, pre_alive, i + 1
            )
            return ray, alive, rng, resp_state, cb_state

    # -- compacted execution hooks (see _CompactionLadderMixin) ----------

    def _ladder_init(self, p, counter, streams):
        rng = self.rng.state_for(counter, streams)
        ray, alive, _, _ = self._init_photons(p, rng, streams)
        # dim is NOT carried: every run resyncs to its fixed base inside
        # _photon_step (the reference's relaunch push.dim)
        return {"ray": ray, "alive": alive, "streams": streams}

    def _ladder_chunk(self, p, counter, run, state, resp_state):
        medium = p["medium"]
        prop = self._propagation(p)
        rng = self.rng.state_for(counter, state["streams"])

        def body(j, carry):
            i = (run * jnp.uint32(self.nScatteringPerRun)).astype(jnp.int32) + j
            r, a, g, rs = carry
            r, a, g, rs, _ = self._photon_step(
                p, prop, medium, i, (r, a, g, rs, None)
            )
            return r, a, g, rs

        ray, alive, rng, resp_state = lax.fori_loop(
            0,
            self.nScatteringPerRun,
            body,
            (state["ray"], state["alive"], rng, resp_state),
        )
        return {**state, "ray": ray, "alive": alive}, resp_state


class ScenePhotonTracer(_CompactionLadderMixin, SceneForwardTracer):
    """Photon-resolved scene tracing: SceneForwardTracer's surface physics
    with Russian-roulette absorption, no MIS, responses always allowed
    (reference: src/theia/trace.py:2370-2668,
    shader/tracer.scene.photon.loop.glsl)."""

    name = "Scene Photon Tracer"

    def __init__(
        self,
        batchSize: int,
        source: LightSource,
        wavelengthSource: WavelengthSource,
        response: "HitResponse",
        rng: PhiloxRNG,
        scene,
        *,
        nScatteringPerRun: int = 10,
        nRuns: int = 10,
        **kwargs,
    ) -> None:
        kwargs.pop("targetGuide", None)
        kwargs.pop("maxPathLength", None)
        self.nScatteringPerRun = nScatteringPerRun
        self.nRuns = nRuns
        self._photon_mode = True
        super().__init__(
            batchSize,
            source,
            wavelengthSource,
            response,
            rng,
            scene,
            maxPathLength=nRuns * nScatteringPerRun,
            targetGuide=None,
            disableDirectLighting=False,
            **kwargs,
        )

    # photon mode hooks consumed by SceneForwardTracer._trace_batch
    def _photon_init_contrib(self, lam):
        return jnp.ones_like(lam)

    def _photon_absorb(self, ray, alive, rng):
        return _sample_absorption(ray, alive, rng)

    # -- compacted execution hooks (see _CompactionLadderMixin) ----------

    def _ladder_init(self, p, counter, streams):
        from .core import active_lanes

        pack = p["scene"]
        rng = self.rng.state_for(counter, streams)
        ray, medium, pol, rng = self._sample_initial(p, pack, streams, rng)
        alive = active_lanes(streams, p) & ~ray.is_bad()
        allow = jnp.full(streams.shape, True)
        state = {
            "ray": ray,
            "medium": medium,
            "alive": alive,
            "allow": allow,
            # the scene schedule has no per-run resync: carry each lane's
            # dim counter across runs (and through compaction gathers)
            "dim": rng.dim,
            "streams": streams,
        }
        if pol is not None:
            state["pol"] = pol
        return state

    def _ladder_chunk(self, p, counter, run, state, resp_state):
        # photon mode is always guide-less -> pure-primary queries: skip
        # the instanced compaction ladder for this separately-jitted
        # chunk too (SceneForwardTracer._trace_batch selects the profile
        # for the monolithic run; see ops/instanced.py QUERY_PROFILE)
        from ..ops.instanced import query_profile

        with query_profile("primary"):
            return self._ladder_chunk_profiled(
                p, counter, run, state, resp_state
            )

    def _ladder_chunk_profiled(self, p, counter, run, state, resp_state):
        pack = p["scene"]
        prop = self._propagation(p)
        streams = state["streams"]
        body = self._segment_body(
            p, pack, prop, self.targetGuide is not None, streams
        )
        rng = replace(self.rng.state_for(counter, streams), dim=state["dim"])
        pol = state.get("pol")

        def body_j(j, carry):
            i = (run * jnp.uint32(self.nScatteringPerRun)).astype(jnp.int32) + j
            return body(i, carry)

        carry = (
            state["ray"],
            state["medium"],
            state["alive"],
            state["allow"],
            pol,
            rng,
            resp_state,
            None,
        )
        ray, medium, alive, allow, pol, rng, resp_state, _ = lax.fori_loop(
            0, self.nScatteringPerRun, body_j, carry
        )
        new_state = {
            **state,
            "ray": ray,
            "medium": medium,
            "alive": alive,
            "allow": allow,
            "dim": rng.dim,
        }
        if pol is not None:
            new_state["pol"] = pol
        return new_state, resp_state
