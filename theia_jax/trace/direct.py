"""Direct light tracer: zero-scatter camera <-> light connections
(reference: src/theia/trace.py:1883-2095, shader/tracer.direct.glsl).

Optionally tests occlusion against a scene; otherwise self-shadowing is
approximated via the detector normal check."""

from __future__ import annotations

from typing import TYPE_CHECKING

import jax
import jax.numpy as jnp

from ..compile_cache import jit
from .. import units as u
from ..accel import is_visible
from ..callback import EmptyEventCallback, TraceEventCallback
from ..camera import Camera
from ..component import Component, TraceConfig
from ..light import LightSource, WavelengthSource
from ..material import Medium
from ..random import PhiloxRNG, RNGState
from ..scene import Scene
from .backward import sample_direct
from .core import PropagateParams, TracerBase

if TYPE_CHECKING:
    from ..response import HitResponse

__all__ = ["DirectLightTracer"]


class DirectLightTracer(TracerBase):
    """Zero-scatter connection estimator."""

    name = "Direct Light Tracer"
    _param_names = ("maxTime",)

    def __init__(
        self,
        batchSize: int,
        source: LightSource,
        camera: Camera,
        wavelengthSource: WavelengthSource,
        response: "HitResponse",
        rng: PhiloxRNG,
        scene: Scene | None = None,
        *,
        capacity: int | None = None,
        callback: TraceEventCallback | None = None,
        medium: Medium | None = None,
        maxTime: float = 1000.0 * u.ns,
        polarized: bool = False,
    ) -> None:
        if not source.supportBackward:
            raise ValueError("Light source does not support backward mode")
        if not camera.supportDirect:
            raise ValueError("Camera does not support direct lighting")
        if scene is None and medium is None:
            # vacuum is a valid medium; mirror the reference check loosely
            pass
        self._init_batch(batchSize, capacity)
        self.source = source
        self.camera = camera
        self.wavelengthSource = wavelengthSource
        self.response = response
        self.rng = rng
        self.scene = scene
        self.medium = medium
        self.callback = EmptyEventCallback() if callback is None else callback
        self.maxTime = maxTime
        self.polarized = polarized
        self.maxHitsPerThread = 1
        self.nRNGSamples = (
            source.nRNGBackward
            + camera.nRNGDirect
            + wavelengthSource.nRNGSamples
            + response.nRNGSamples
        )
        rng.configure(self.nRNGSamples, self.capacity)
        response.prepare(
            TraceConfig(
                batch_size=batchSize,
                capacity=self.capacity,
                max_hits_per_thread=1,
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
        p = {
            "tracer": {
                "batchSize": jnp.asarray(self.batchSize, jnp.uint32),
                "maxTime": jnp.asarray(self.maxTime, jnp.float32),
            },
            "photons": self.wavelengthSource.params(),
            "lightSource": self.source.params(),
            "camera": self.camera.params(),
            "response": self.response.params(),
            "callback": self.callback.params(),
        }
        if self.scene is not None:
            p["scene"] = self.scene.pack
            name = self.scene.medium
            p["medium"] = (
                self.scene.materials.media.medium(name) if name else None
            )
        else:
            p["medium"] = self.medium
        return p

    def _trace_batch(self, p, counter, streams):
        medium = p["medium"]
        if self.scene is not None:
            pack = p["scene"]
            lo, hi = pack.lower_bbox, pack.upper_bbox
            occluder = lambda a, b: is_visible(pack, a, b)
        else:
            lo = jnp.asarray((-1.0 * u.km,) * 3, jnp.float32)
            hi = jnp.asarray((1.0 * u.km,) * 3, jnp.float32)
            occluder = None
        prop = PropagateParams(
            scatter_coefficient=jnp.float32(float("nan")),
            lower_bbox=lo,
            upper_bbox=hi,
            max_time=p["tracer"]["maxTime"],
            max_dist=jnp.linalg.norm(hi - lo),
        )
        rng = self.rng.state_for(counter, streams)
        resp_state = self.response.init()
        cb_state = self.callback.init(streams.shape[0], 2)
        resp_state, cb_state, rng = sample_direct(
            self, p, prop, medium, resp_state, cb_state, rng, occluder=occluder
        )
        return resp_state, cb_state

