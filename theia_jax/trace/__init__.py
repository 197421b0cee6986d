"""Tracers: Monte Carlo estimators producing detector hits from light."""

from .core import (
    EventResultCode,
    HitItem,
    PropagateParams,
    RayState,
    TracerBase,
    create_hit,
)

#: reference name for the tracer base class (ref trace.py `Tracer`)
Tracer = TracerBase

_LAZY = {
    "VolumeForwardTracer": ".volume",
    "VolumeBackwardTracer": ".backward",
    "SceneForwardTracer": ".scene",
    "SceneBackwardTracer": ".scene_backward",
    "SceneBackwardTargetTracer": ".scene_backward",
    "DirectLightTracer": ".direct",
    "VolumePhotonTracer": ".photon",
    "ScenePhotonTracer": ".photon",
    "BidirectionalPathTracer": ".bidirectional",
    # event callbacks live in theia_jax.callback; the reference exports
    # them from its trace module (ref trace.py __all__), mirror that
    "TraceEventCallback": "..callback",
    "EmptyEventCallback": "..callback",
    "EventStatisticCallback": "..callback",
    "TrackRecordCallback": "..callback",
}


def __getattr__(name: str):
    # tracer modules import components (callback, response, ...) which in
    # turn import trace.core — load them lazily to avoid import cycles
    if name in _LAZY:
        import importlib

        module = importlib.import_module(_LAZY[name], __name__)
        return getattr(module, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
