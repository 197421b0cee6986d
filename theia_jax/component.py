"""Component/stage base classes.

The reference composes GLSL snippets into megakernels; here every component
is a Python object holding *static* configuration plus a pytree of runtime
parameters, and contributes pure jnp sampling/response functions that
tracers close over at trace time (SURVEY.md §1 "key architectural idea").

Runtime parameters flow through the jitted trace function as arguments, so
they can change per batch without recompilation — the double-buffered UBO
analogue. Uniform ``stage__param`` addressing for pipelines lives in
:mod:`theia_jax.pipeline`.
"""

from __future__ import annotations

from typing import Any

import jax.numpy as jnp
import numpy as np

__all__ = ["Component", "TraceConfig"]


def _to_jax(value):
    if isinstance(value, (tuple, list, np.ndarray, float, int)):
        return jnp.asarray(value, jnp.float32)
    return value


class Component:
    """Base for pipeline components (reference: hephaistos PipelineStage,
    docs/pipeline/pipeline.md:24-64).

    Subclasses declare ``_param_names``; :meth:`params` snapshots them as a
    pytree of jnp arrays for the jitted step, while get/setParams provide
    the reference's uniform stage-parameter API.
    """

    name: str = "Component"
    _param_names: tuple[str, ...] = ()
    _extra_names: tuple[str, ...] = ()

    def params(self) -> dict[str, Any]:
        """Snapshot runtime parameters as a pytree."""
        out = {}
        for name in self._param_names:
            out[name] = _to_jax(getattr(self, name))
        return out

    def setParams(self, **kwargs) -> None:
        allowed = set(self._param_names) | set(self._extra_names)
        for key, value in kwargs.items():
            if key not in allowed:
                raise ValueError(f"{type(self).__name__} has no parameter {key!r}")
            setattr(self, key, value)

    def getParam(self, name: str):
        if name not in set(self._param_names) | set(self._extra_names):
            raise ValueError(f"{type(self).__name__} has no parameter {name!r}")
        return getattr(self, name)

    def update(self) -> None:
        """Hook called once per batch before parameters are snapshot
        (the reference's ``_finishParams``)."""


class TraceConfig:
    """Static configuration a tracer hands to its response
    (reference: src/theia/response.py:95-178)."""

    def __init__(
        self,
        batch_size: int,
        capacity: int,
        max_hits_per_thread: int,
        normalization: float,
        polarized: bool,
    ) -> None:
        self.batch_size = batch_size
        self.capacity = capacity
        self.max_hits_per_thread = max_hits_per_thread
        self.normalization = normalization
        self.polarized = polarized
