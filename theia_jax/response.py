"""Hit responses: turn detector hits into recorded results.

Functional design: a response owns a *state* pytree threaded through the
jitted trace step; ``record`` folds a masked wavefront of hits into it and
``result`` finalizes (applying the 1/batchSize normalization the reference
applies in its reducer kernel, estimator.reduce.glsl:17-35). Histogram
accumulation uses XLA scatter-add over bins instead of shared-memory float
atomics (reference: src/theia/response.py, shader/response.histogram.glsl).
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from .component import Component, TraceConfig
from .random import RNGState
from .trace.core import HitItem

__all__ = [
    "ValueResponse",
    "UniformValueResponse",
    "CustomValueResponse",
    "HitResponse",
    "HistogramHitResponse",
    "KernelHistogramHitResponse",
    "HitRecorder",
    "StoreTimeHitResponse",
    "StoreValueHitResponse",
    "SampleValueResponse",
    "Estimator",
    "HistogramEstimator",
    "HistogramReducer",
    "HostEstimator",
    "createHitTimeQueue",
    "createValueQueue",
    "replay_hits",
    "sample_camera_hits",
    # reference per-record layouts (theia_jax.items)
    "PolarizedHitItem",
    "HitTimeItem",
    "HitTimeAndIdItem",
    "ValueItem",
    "CameraHitResponseItem",
    "PolarizedCameraHitResponseItem",
]

from .items import (  # noqa: E402  (re-export at reference locations)
    CameraHitResponseItem,
    HitTimeAndIdItem,
    HitTimeItem,
    PolarizedCameraHitResponseItem,
    PolarizedHitItem,
    ValueItem,
)


class ValueResponse(Component):
    """Maps a HitItem to a scalar detector response value
    (reference: src/theia/response.py:444-483)."""

    name = "Value Response"
    nRNGSamples: int = 0

    def value(
        self, params, item: HitItem, rng: RNGState
    ) -> tuple[jax.Array, RNGState]:
        raise NotImplementedError

    def prepare(self, config: TraceConfig) -> None:
        pass


class UniformValueResponse(ValueResponse):
    """Perfect isotropic, uniform response: value = contribution
    (reference: shader/response.uniform.glsl)."""

    name = "Uniform Value Response"

    def value(self, params, item: HitItem, rng: RNGState):
        return item.contrib, rng


class CustomValueResponse(ValueResponse):
    """User-provided value function ``fn(params, item, rng) -> (value, rng)``
    (reference: src/theia/response.py:498-530)."""

    name = "Custom Value Response"

    def __init__(self, fn, *, nRNGSamples: int = 0, params=None) -> None:
        self._fn = fn
        self.nRNGSamples = nRNGSamples
        self._custom_params = params or {}

    def params(self):
        return dict(self._custom_params)

    def value(self, params, item: HitItem, rng: RNGState):
        return self._fn(params, item, rng)


class HitResponse(Component):
    """Base class for hit responses (reference: src/theia/response.py:125-188)."""

    name = "Hit Response"
    nRNGSamples: int = 0

    def prepare(self, config: TraceConfig) -> None:
        """Called by the tracer during construction."""
        self._config = config

    def renormalize(self, normalization: float) -> None:
        """Hook for runtime batchSize changes: the tracer pushes the new
        ``1/batchSize`` here. Responses that derived their normalization
        from the trace config follow it; user-set values stay fixed."""

    def init(self):
        """Fresh accumulator state for one batch."""
        raise NotImplementedError

    def record(
        self, params, state, item: HitItem, mask: jax.Array, rng: RNGState
    ) -> tuple[object, RNGState]:
        """Fold a masked wavefront of hits into the state."""
        raise NotImplementedError

    def result(self, params, state):
        """Finalize the batch (applies normalization)."""
        return state


class EmptyResponse(HitResponse):
    """Ignores all hits (reference: src/theia/response.py EmptyResponse)."""

    name = "Empty Response"

    def init(self):
        return ()

    def record(self, params, state, item, mask, rng):
        return state, rng

    def result(self, params, state):
        return None


class HistogramHitResponse(HitResponse):
    """Time-binned histogram of response values — the light curve
    (reference: src/theia/response.py:1200-1421,
    shader/response.histogram.glsl:16-68).

    ``nDetectors``: when set, hits are additionally binned by their
    detector/object id into an (nDetectors, nBins) array — one transient
    per module from a single trace (hits with ids outside [0, nDetectors)
    are dropped). The reference filters one detectorId per tracer pass
    instead; the detector axis only widens the flat bin index."""

    name = "Histogram Hit Response"
    _param_names = ("t0", "binSize")

    def __init__(
        self,
        value_response: ValueResponse | None = None,
        *,
        nBins: int = 100,
        t0: float = 0.0,
        binSize: float = 1.0,
        normalization: float | None = None,
        nDetectors: int | None = None,
    ) -> None:
        self.value_response = (
            UniformValueResponse() if value_response is None else value_response
        )
        if nBins < 1:
            raise ValueError("nBins must be >= 1")
        if nDetectors is not None and nDetectors < 1:
            raise ValueError("nDetectors must be >= 1 (or None for no detector axis)")
        self.nBins = nBins
        self.t0 = t0
        self.binSize = binSize
        self.nDetectors = nDetectors
        self._normalization = normalization
        self.nRNGSamples = self.value_response.nRNGSamples

    def _size(self) -> int:
        return self.nBins * (self.nDetectors or 1)

    def _flat_bins(self, item: HitItem, bins, oob):
        """Flatten (detector, time-bin) to a scatter index; out-of-range
        lanes map to the drop slot ``_size()``."""
        if self.nDetectors is not None:
            det = jax.lax.stop_gradient(item.object_id).astype(jnp.int32)
            oob = oob | (det < 0) | (det >= self.nDetectors)
            bins = jnp.clip(bins, 0, self.nBins - 1) + det * self.nBins
        return jnp.where(oob, self._size(), bins)

    def params(self):
        p = super().params()
        p["value"] = self.value_response.params()
        return p

    def prepare(self, config: TraceConfig) -> None:
        super().prepare(config)
        self.value_response.prepare(config)
        if self._normalization is None:
            self._normalization = config.normalization
            self._auto_norm = True

    def renormalize(self, normalization: float) -> None:
        if getattr(self, "_auto_norm", False):
            self._normalization = normalization

    def init(self):
        return jnp.zeros(self._size(), jnp.float32)

    def record(self, params, state, item: HitItem, mask, rng: RNGState):
        value, rng = self.value_response.value(params.get("value", {}), item, rng)
        # time gradient is meaningless through floor(); bin on the detached time
        t = jax.lax.stop_gradient(item.time)
        bin_f = jnp.floor((t - params["t0"]) / params["binSize"])
        bins = bin_f.astype(jnp.int32)
        oob = (bin_f < 0) | (bin_f >= self.nBins) | ~mask
        bins = self._flat_bins(item, bins, oob)  # drop slot on oob
        # float32 adds into the bins; the drop slot falls off the end
        state = state.at[bins].add(value, mode="drop")
        return state, rng

    def result(self, params, state):
        out = state * jnp.float32(self._normalization)
        if self.nDetectors is not None:
            out = out.reshape(self.nDetectors, self.nBins)
        return out


class KernelHistogramHitResponse(HistogramHitResponse):
    """Histogram with Gaussian kernel smearing (binned KDE) — also gives a
    smooth, differentiable dependence on arrival time
    (reference: src/theia/response.py:1424-1673,
    shader/response.histogram.kernel.glsl)."""

    name = "Kernel Histogram Hit Response"
    _param_names = ("t0", "binSize", "bandwidth")

    def __init__(
        self,
        value_response: ValueResponse | None = None,
        *,
        nBins: int = 100,
        t0: float = 0.0,
        binSize: float = 1.0,
        bandwidth: float = 1.0,
        support: int = 4,
        normalization: float | None = None,
        nDetectors: int | None = None,
    ) -> None:
        super().__init__(
            value_response,
            nBins=nBins,
            t0=t0,
            binSize=binSize,
            normalization=normalization,
            nDetectors=nDetectors,
        )
        self.bandwidth = bandwidth
        self.support = support  # kernel support in +-bins (static)

    def record(self, params, state, item: HitItem, mask, rng: RNGState):
        value, rng = self.value_response.value(params.get("value", {}), item, rng)
        t = item.time  # differentiable: kernel weights are smooth in time
        h = params["bandwidth"]
        center_f = (t - params["t0"]) / params["binSize"]
        base = jnp.floor(jax.lax.stop_gradient(center_f)).astype(jnp.int32)
        norm = params["binSize"] / (h * jnp.sqrt(2.0 * jnp.pi))
        for off in range(-self.support, self.support + 1):
            bins = base + off
            # kernel evaluated at bin centers, scaled to integrate to ~1
            bc = (bins.astype(jnp.float32) + 0.5) * params["binSize"] + params["t0"]
            w = jnp.exp(-0.5 * jnp.square((bc - t) / h)) * norm
            oob = (bins < 0) | (bins >= self.nBins) | ~mask
            b = self._flat_bins(item, bins, oob)
            v = jnp.where(b >= self._size(), 0.0, value * w)
            state = state.at[b].add(v, mode="drop")
        return state, rng


class HitRecorder(HitResponse):
    """Stores raw hits for host retrieval; slots are deterministic
    (record-call-major) rather than an atomic-counter queue
    (reference: src/theia/response.py:191-275).

    The result is a dict of arrays of shape (maxHits, ...) plus a ``valid``
    mask."""

    name = "Hit Recorder"

    def __init__(self, *, polarized: bool = False) -> None:
        self.polarized = polarized

    def prepare(self, config: TraceConfig) -> None:
        super().prepare(config)
        self._capacity = config.capacity * config.max_hits_per_thread

    def init(self):
        n = self._capacity
        state = dict(
            cursor=jnp.int32(0),  # traced: record() runs inside lax loops
            overflow=jnp.int32(0),  # hits dropped past capacity
            position=jnp.zeros((n, 3), jnp.float32),
            direction=jnp.zeros((n, 3), jnp.float32),
            normal=jnp.zeros((n, 3), jnp.float32),
            wavelength=jnp.zeros(n, jnp.float32),
            time=jnp.zeros(n, jnp.float32),
            contrib=jnp.zeros(n, jnp.float32),
            objectId=jnp.zeros(n, jnp.int32),
            valid=jnp.zeros(n, bool),
        )
        if self._config.polarized:
            state["stokes"] = jnp.zeros((n, 4), jnp.float32)
            state["polRef"] = jnp.zeros((n, 3), jnp.float32)
        return state

    def record(self, params, state, item: HitItem, mask, rng: RNGState):
        # compact accepted lanes to the cursor (the atomic-counter queue
        # analogue, reference: hephaistos.queue); overflow drops hits
        c = state["cursor"]
        slot = c + jnp.cumsum(mask.astype(jnp.int32)) - 1
        slot = jnp.where(mask, slot, self._capacity)  # dropped by mode="drop"

        def upd(buf, val):
            return buf.at[slot].set(val, mode="drop")

        total = c + jnp.sum(mask.astype(jnp.int32))
        new_state = dict(
            cursor=jnp.minimum(total, self._capacity),
            # queue-saturation accounting (the reference surfaces this via
            # maxHits bookkeeping, src/theia/response.py:225-241)
            overflow=state["overflow"]
            + jnp.maximum(total - self._capacity, 0),
            position=upd(state["position"], item.position),
            direction=upd(state["direction"], item.direction),
            normal=upd(state["normal"], item.normal),
            wavelength=upd(state["wavelength"], item.wavelength),
            time=upd(state["time"], item.time),
            contrib=upd(state["contrib"], item.contrib),
            objectId=upd(state["objectId"], item.object_id),
            valid=upd(state["valid"], mask),
        )
        if "stokes" in state:
            new_state["stokes"] = upd(state["stokes"], item.stokes)
            new_state["polRef"] = upd(state["polRef"], item.pol_ref)
        return new_state, rng

    def result(self, params, state):
        dropped = int(state["overflow"])
        if dropped > 0:
            warnings.warn(
                f"HitRecorder overflow: {dropped} hits dropped past the "
                f"capacity of {self._capacity}; raise maxHitsPerThread"
            )
        return state


class StoreTimeHitResponse(HitResponse):
    """Photon-mode sampler: accept each hit with probability equal to its
    response value and store the arrival time — converting radiance
    contributions into discrete photon detections
    (reference: src/theia/response.py:656-797, shader/response.time.store.glsl)."""

    name = "Store Time Hit Response"

    def __init__(self, value_response: ValueResponse | None = None) -> None:
        self.value_response = (
            UniformValueResponse() if value_response is None else value_response
        )
        self.nRNGSamples = self.value_response.nRNGSamples + 1

    def params(self):
        return {"value": self.value_response.params()}

    def prepare(self, config: TraceConfig) -> None:
        super().prepare(config)
        self.value_response.prepare(config)
        self._capacity = config.capacity * config.max_hits_per_thread

    def init(self):
        n = self._capacity
        return dict(
            cursor=jnp.int32(0),
            overflow=jnp.int32(0),
            time=jnp.zeros(n, jnp.float32),
            objectId=jnp.zeros(n, jnp.int32),
            valid=jnp.zeros(n, bool),
        )

    def record(self, params, state, item: HitItem, mask, rng: RNGState):
        value, rng = self.value_response.value(params.get("value", {}), item, rng)
        uu, rng = rng.uniform()
        accept = mask & (uu < value)
        c = state["cursor"]
        slot = c + jnp.cumsum(accept.astype(jnp.int32)) - 1
        slot = jnp.where(accept, slot, self._capacity)

        def upd(buf, val):
            return buf.at[slot].set(val, mode="drop")

        total = c + jnp.sum(accept.astype(jnp.int32))
        state = dict(
            cursor=jnp.minimum(total, self._capacity),
            overflow=state["overflow"]
            + jnp.maximum(total - self._capacity, 0),
            time=upd(state["time"], item.time),
            objectId=upd(state["objectId"], item.object_id),
            valid=upd(state["valid"], accept),
        )
        return state, rng

    def result(self, params, state):
        dropped = int(state["overflow"])
        if dropped > 0:
            warnings.warn(
                f"StoreTimeHitResponse overflow: {dropped} detections "
                f"dropped past the capacity of {self._capacity}; raise "
                f"maxHitsPerThread"
            )
        return state


class SampleValueResponse(HitResponse):
    """Per-lane value output for testing detector models: stores the
    response value of the first recorded hit per record call
    (reference: src/theia/response.py:800-881)."""

    name = "Sample Value Response"

    def __init__(self, value_response: ValueResponse | None = None) -> None:
        self.value_response = (
            UniformValueResponse() if value_response is None else value_response
        )
        self.nRNGSamples = self.value_response.nRNGSamples

    def params(self):
        return {"value": self.value_response.params()}

    def prepare(self, config: TraceConfig) -> None:
        super().prepare(config)
        self.value_response.prepare(config)

    def init(self):
        n = self._config.capacity
        return jnp.full(n, jnp.nan, jnp.float32)

    def record(self, params, state, item: HitItem, mask, rng: RNGState):
        value, rng = self.value_response.value(params.get("value", {}), item, rng)
        lane = jnp.arange(state.shape[0])
        take = mask & jnp.isnan(jnp.take(state, lane))
        state = jnp.where(take, value, state)
        return state, rng


class StoreValueHitResponse(HitResponse):
    """Stores (value, time) per hit into a queue — feed the result to
    :class:`HistogramEstimator` / :class:`HostEstimator`
    (reference: src/theia/response.py:532-623)."""

    name = "Store Value Hit Response"

    def __init__(self, value_response: ValueResponse | None = None) -> None:
        self.value_response = (
            UniformValueResponse() if value_response is None else value_response
        )
        self.nRNGSamples = self.value_response.nRNGSamples

    def params(self):
        return {"value": self.value_response.params()}

    def prepare(self, config: TraceConfig) -> None:
        super().prepare(config)
        self.value_response.prepare(config)
        self._capacity = config.capacity * config.max_hits_per_thread

    def init(self):
        n = self._capacity
        return dict(
            cursor=jnp.int32(0),
            value=jnp.zeros(n, jnp.float32),
            time=jnp.zeros(n, jnp.float32),
            valid=jnp.zeros(n, bool),
        )

    def record(self, params, state, item: HitItem, mask, rng: RNGState):
        value, rng = self.value_response.value(params.get("value", {}), item, rng)
        c = state["cursor"]
        slot = c + jnp.cumsum(mask.astype(jnp.int32)) - 1
        slot = jnp.where(mask, slot, self._capacity)

        def upd(buf, val):
            return buf.at[slot].set(val, mode="drop")

        state = dict(
            cursor=jnp.minimum(c + jnp.sum(mask.astype(jnp.int32)), self._capacity),
            value=upd(state["value"], value),
            time=upd(state["time"], item.time),
            valid=upd(state["valid"], mask),
        )
        return state, rng


class Estimator:
    """Base class for estimators consuming a (value, time) queue into a
    final output (reference: src/theia/response.py:1676-1718)."""

    def __call__(self, queue):  # pragma: no cover - interface
        raise NotImplementedError


class HistogramReducer:
    """Reduces a stack of partial histograms into one
    (reference: src/theia/response.py:1065-1180, estimator.reduce.glsl —
    there a workgroup reduction over subgroup partials; here a single
    fused sum, differentiable and jit-safe)."""

    def __init__(self, *, nBins: int = 100, normalization: float = 1.0):
        self.nBins = nBins
        self.normalization = normalization

    def __call__(self, hists):
        hists = jnp.asarray(hists).reshape(-1, self.nBins)
        return jnp.sum(hists, axis=0) * self.normalization


def createHitTimeQueue(capacity: int, *, objectId: bool = True) -> dict:
    """Empty SoA queue with the layout StoreTimeHitResponse fills
    (reference: src/theia/response.py:638-652; items.HitTimeAndIdItem /
    items.HitTimeItem describe the per-record view)."""
    q = dict(
        cursor=jnp.int32(0),
        overflow=jnp.int32(0),
        time=jnp.zeros(capacity, jnp.float32),
        valid=jnp.zeros(capacity, bool),
    )
    if objectId:
        q["objectId"] = jnp.zeros(capacity, jnp.int32)
    return q


def createValueQueue(capacity: int) -> dict:
    """Empty SoA queue with the layout StoreValueHitResponse fills and
    estimators consume (reference: src/theia/response.py:434-441;
    items.ValueItem describes the per-record view)."""
    return dict(
        cursor=jnp.int32(0),
        value=jnp.zeros(capacity, jnp.float32),
        time=jnp.zeros(capacity, jnp.float32),
        valid=jnp.zeros(capacity, bool),
    )


class HistogramEstimator(Estimator):
    """Consumes a (value, time) queue into a time histogram
    (reference: src/theia/response.py:1721-1850, shader/estimator.hist.glsl)."""

    def __init__(
        self,
        *,
        nBins: int = 100,
        t0: float = 0.0,
        binSize: float = 1.0,
        normalization: float = 1.0,
    ) -> None:
        self.nBins = nBins
        self.t0 = t0
        self.binSize = binSize
        self.normalization = normalization

    def __call__(self, queue) -> np.ndarray:
        valid = np.asarray(queue["valid"])
        value = np.asarray(queue["value"])[valid]
        time = np.asarray(queue["time"])[valid]
        hist, _ = np.histogram(
            time,
            bins=self.nBins,
            range=(self.t0, self.t0 + self.nBins * self.binSize),
            weights=value.astype(np.float64),
        )
        return hist * self.normalization


class HostEstimator:
    """Copies the (value, time) queue to host arrays
    (reference: src/theia/response.py:1853-1905)."""

    def __call__(self, queue):
        valid = np.asarray(queue["valid"])
        return {
            "value": np.asarray(queue["value"])[valid],
            "time": np.asarray(queue["time"])[valid],
        }


def replay_hits(hits: dict, response: HitResponse, params=None, *, rng=None):
    """Feed stored hits (a HitRecorder result) back through any response
    (reference: src/theia/response.py:278-422 HitReplay)."""
    from .random import PhiloxRNG
    from .component import TraceConfig

    valid = jnp.asarray(hits["valid"])
    n = valid.shape[0]
    item = HitItem(
        position=jnp.asarray(hits["position"]),
        direction=jnp.asarray(hits["direction"]),
        normal=jnp.asarray(hits["normal"]),
        wavelength=jnp.asarray(hits["wavelength"]),
        time=jnp.asarray(hits["time"]),
        contrib=jnp.asarray(hits["contrib"]),
        object_id=jnp.asarray(hits["objectId"]),
        stokes=jnp.asarray(hits["stokes"]) if "stokes" in hits else None,
        pol_ref=jnp.asarray(hits["polRef"]) if "polRef" in hits else None,
    )
    response.prepare(
        TraceConfig(
            batch_size=n,
            capacity=n,
            max_hits_per_thread=1,
            normalization=1.0,
            polarized=item.stokes is not None,
        )
    )
    params = response.params() if params is None else params
    rng = rng if rng is not None else PhiloxRNG(key=0xC0FFEE)
    state = response.init()
    state, _ = response.record(
        params, state, item, valid, rng.state(jnp.arange(n, dtype=jnp.uint32))
    )
    return response.result(params, state)


def sample_camera_hits(
    camera, response: HitResponse, n: int, *, wavelength=450.0, rng=None
):
    """Drive a response with camera-sampled hits (testing detector models;
    reference: src/theia/response.py:908-1062 CameraHitResponseSampler)."""
    from .random import PhiloxRNG

    rng = rng if rng is not None else PhiloxRNG(key=0xC0FFEE)
    state = rng.state(jnp.arange(n, dtype=jnp.uint32))
    lam = jnp.full(n, wavelength, jnp.float32)
    ray, state = camera.sample_ray(camera.params(), lam, state)
    item = HitItem(
        position=ray.hit_position,
        direction=ray.hit_direction,
        normal=ray.hit_normal,
        wavelength=lam,
        time=ray.time_delta,
        contrib=ray.contrib,
        object_id=ray.object_id,
    )
    response.prepare(
        TraceConfig(
            batch_size=n,
            capacity=n,
            max_hits_per_thread=1,
            normalization=1.0,
            polarized=False,
        )
    )
    params = response.params()
    rstate = response.init()
    rstate, _ = response.record(
        params, rstate, item, jnp.ones(n, bool), state
    )
    return response.result(params, rstate)


# reference-name aliases (src/theia/response.py API)
HitReplay = replay_hits
CameraHitResponseSampler = sample_camera_hits
