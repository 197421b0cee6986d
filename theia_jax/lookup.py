"""Differentiable lookup tables.

Tables hold values at equidistant sample points over the normalized
coordinate range [0, 1] and are interpolated linearly (1D) or bilinearly
(2D) on device. This reproduces the device-side semantics of the reference
(reference: src/theia/shader/lookup.glsl:4-113, src/theia/lookup.py:30-277)
with two changes:

* tables are plain ``jax.Array``\\ s inside parameter pytrees — no device
  pointers; a "null table" is represented statically by ``None``
* interpolation is differentiable by construction: gradients flow to the
  table *values* (the ``lookUpDx`` finite-difference helper of the reference
  becomes ordinary JAX AD, but is also provided for parity)
"""

from __future__ import annotations

import warnings
from typing import Literal

import jax
import jax.numpy as jnp
import numpy as np
from scipy.interpolate import (
    CloughTocher2DInterpolator,
    CubicSpline,
    LinearNDInterpolator,
)

__all__ = [
    "lookup",
    "lookup_dx",
    "lookup2d",
    "sample_table1d",
    "sample_table2d",
    "eval_table",
    "Table",
    "getTableSize",
    "uploadTables",
]


def lookup(table: jax.Array | None, u, null_value=0.0) -> jax.Array:
    """Linearly interpolate ``table`` at normalized coordinate ``u``.

    ``u`` is clamped to [0, 1]; ``table`` is a float array of shape
    (..., n) sampled at ``n`` equidistant points. ``None`` returns
    ``null_value`` (the reference's null-pointer convention).
    """
    if table is None:
        return jnp.asarray(null_value, jnp.float32) * jnp.ones_like(
            jnp.asarray(u, jnp.float32)
        )
    table = jnp.asarray(table)
    n = table.shape[-1]
    u = jnp.clip(jnp.asarray(u, jnp.float32), 0.0, 1.0) * jnp.float32(n - 1)
    lo = jnp.floor(u).astype(jnp.int32)
    hi = jnp.ceil(u).astype(jnp.int32)
    l = u - jnp.floor(u)
    v_lo = jnp.take(table, lo, axis=-1)
    v_hi = jnp.take(table, hi, axis=-1)
    # explicit lerp (not jnp.where-free mix) to match the reference's
    # inf-safe formulation
    return v_lo * (1.0 - l) + v_hi * l


def lookup_dx(
    table: jax.Array | None, u, null_value=(0.0, 0.0)
) -> tuple[jax.Array, jax.Array]:
    """Interpolated value and finite-difference derivative d/du.

    Mirrors the reference's central-difference scheme with one-sided
    differences at the borders (reference: src/theia/shader/lookup.glsl:34-73).
    """
    if table is None:
        zero = jnp.zeros_like(jnp.asarray(u, jnp.float32))
        return (
            zero + jnp.float32(null_value[0]),
            zero + jnp.float32(null_value[1]),
        )
    table = jnp.asarray(table)
    n = table.shape[-1]
    u = jnp.clip(jnp.asarray(u, jnp.float32), 0.0, 1.0) * jnp.float32(n - 1)
    lo = jnp.maximum(jnp.floor(u).astype(jnp.int32), 0)
    hi = jnp.minimum(lo + 1, n - 1)
    l = u - jnp.floor(u)
    lolo = jnp.maximum(lo - 1, 0)
    hihi = jnp.minimum(hi + 1, n - 1)
    v_lolo = jnp.take(table, lolo, axis=-1)
    v_lo = jnp.take(table, lo, axis=-1)
    v_hi = jnp.take(table, hi, axis=-1)
    v_hihi = jnp.take(table, hihi, axis=-1)
    dx_lo = (v_hi - v_lolo) / jnp.maximum(hi - lolo, 1).astype(jnp.float32)
    dx_hi = (v_hihi - v_lo) / jnp.maximum(hihi - lo, 1).astype(jnp.float32)
    value = v_lo * (1.0 - l) + v_hi * l
    dx = (dx_lo * (1.0 - l) + dx_hi * l) * jnp.float32(n - 1)
    return value, dx


def lookup2d(table: jax.Array | None, u, v, null_value=0.0) -> jax.Array:
    """Bilinearly interpolate a 2D table of shape (nu, nv) at (u, v) in [0,1]^2.

    Row-major layout: axis 0 is u, axis 1 is v (numpy convention, matching
    the reference).
    """
    if table is None:
        return jnp.asarray(null_value, jnp.float32) * jnp.ones_like(
            jnp.asarray(u, jnp.float32)
        )
    table = jnp.asarray(table)
    nu, nv = table.shape[-2], table.shape[-1]
    u = jnp.clip(jnp.asarray(u, jnp.float32), 0.0, 1.0) * jnp.float32(nu - 1)
    v = jnp.clip(jnp.asarray(v, jnp.float32), 0.0, 1.0) * jnp.float32(nv - 1)
    u_lo = jnp.floor(u).astype(jnp.int32)
    u_hi = jnp.ceil(u).astype(jnp.int32)
    ul = u - jnp.floor(u)
    v_lo = jnp.floor(v).astype(jnp.int32)
    v_hi = jnp.ceil(v).astype(jnp.int32)
    vl = v - jnp.floor(v)
    flat = table.reshape(*table.shape[:-2], nu * nv)
    q11 = jnp.take(flat, u_lo * nv + v_lo, axis=-1)
    q12 = jnp.take(flat, u_hi * nv + v_lo, axis=-1)
    q21 = jnp.take(flat, u_lo * nv + v_hi, axis=-1)
    q22 = jnp.take(flat, u_hi * nv + v_hi, axis=-1)
    lo = q11 * (1.0 - ul) + q12 * ul
    hi = q21 * (1.0 - ul) + q22 * ul
    return lo * (1.0 - vl) + hi * vl


# ---------------------------------------------------------------------------
# host-side table builders (numpy/scipy; reference: src/theia/lookup.py:147-277)
# ---------------------------------------------------------------------------


def _parse_boundary(data: np.ndarray, boundary, n: int) -> np.ndarray:
    if boundary is None:
        return np.linspace(data.min(), data.max(), n)
    if isinstance(boundary, tuple) and len(boundary) == 2:
        return np.linspace(boundary[0], boundary[1], n)
    raise ValueError("Can't parse given boundaries!")


def sample_table1d(
    data,
    nx: int = 1024,
    *,
    boundary=None,
    mode: Literal["linear", "cubic"] = "linear",
) -> np.ndarray:
    """Resample scattered (x, f(x)) data of shape (N, 2) onto ``nx``
    equidistant points; returns the float32 table values."""
    data = np.asarray(data)
    x = _parse_boundary(data[:, 0], boundary, nx)
    if mode == "linear":
        return np.interp(x, data[:, 0], data[:, 1]).astype(np.float32)
    elif mode == "cubic":
        return CubicSpline(data[:, 0], data[:, 1])(x).astype(np.float32)
    raise ValueError("Unknown interpolation mode!")


def sample_table2d(
    data,
    nx: int = 1024,
    ny: int = 1024,
    *,
    boundaries=None,
    mode: Literal["linear", "cubic"] = "linear",
) -> np.ndarray:
    """Resample scattered (x, y, f(x,y)) data of shape (N, 3) onto a regular
    grid; returns float32 values of shape (ny, nx) — axis 0 is the SECOND
    input column (reference meshgrid-'xy' convention, pinned by the
    reference's tests), so ``lookup2d(table, u, v)`` reads u = normalized
    y and v = normalized x. Grid points outside the data's convex hull
    are filled by nearest neighbor (with a warning)."""
    data = np.asarray(data)
    if boundaries is None:
        x = _parse_boundary(data[:, 0], None, nx)
        y = _parse_boundary(data[:, 1], None, ny)
    elif isinstance(boundaries, tuple) and len(boundaries) == 2:
        x = _parse_boundary(data[:, 0], boundaries[0], nx)
        y = _parse_boundary(data[:, 1], boundaries[1], ny)
    else:
        raise ValueError("Can't parse given boundaries!")
    # NOTE axis order: like the reference (meshgrid 'xy' indexing,
    # pinned by its own test suite) the result is values[i_y, i_x] —
    # shape (ny, nx), so lookup2d reads it with u = y-coord, v = x-coord.
    xg, yg = np.meshgrid(x, y)
    if mode == "linear":
        model = LinearNDInterpolator
    elif mode == "cubic":
        model = CloughTocher2DInterpolator
    else:
        raise ValueError("Unknown interpolation mode!")
    interp = model(data[:, :2], data[:, 2])
    values = interp(xg, yg).astype(np.float32)
    # scipy's simplex interpolators return NaN outside the convex hull of
    # the scattered inputs (the grid's corners usually are outside it);
    # baking NaN into a device table would poison every lookup touching
    # it, so fill those cells by nearest-neighbor extrapolation
    bad = ~np.isfinite(values)
    if bad.any():
        from scipy.interpolate import NearestNDInterpolator

        warnings.warn(
            f"sample_table2d: {int(bad.sum())} grid points outside the "
            "convex hull of the data; filled by nearest neighbor"
        )
        nearest = NearestNDInterpolator(data[:, :2], data[:, 2])
        values[bad] = nearest(xg[bad], yg[bad]).astype(np.float32)
    return values


def eval_table(f, *axes_spec) -> np.ndarray:
    """Sample ``f`` on a regular grid; each axis spec is either ``n`` (grid
    over [0,1]) or ``(min, max, n)``. Returns float32 values with axis k
    matching spec k ('ij' indexing — intentionally unlike
    :func:`sample_table2d`'s reference-parity 'xy' order; the reference's
    own ``evalTable`` is unusable as published, it calls a nonexistent
    ``list.push``)."""

    def make_axis(spec):
        if isinstance(spec, int):
            return np.linspace(0.0, 1.0, spec)
        if isinstance(spec, tuple) and len(spec) == 3:
            return np.linspace(*spec)
        raise ValueError(f"Cannot parse dimension: {spec}")

    axes = [make_axis(a) for a in axes_spec]
    grid = np.meshgrid(*axes, indexing="ij")
    return np.asarray(f(*grid), dtype=np.float32)


# reference-name aliases (src/theia/lookup.py API)
sampleTable1D = sample_table1d
sampleTable2D = sample_table2d
evalTable = eval_table


# ---------------------------------------------------------------------------
# reference-style table handles
# ---------------------------------------------------------------------------


class Table:
    """Host-side equidistant lookup table (reference: src/theia/lookup.py:
    30-81). Wraps the sampled values; :meth:`upload` returns the device
    array consumed by :func:`lookup` / :func:`lookup2d`. ``nbytes``
    mirrors the reference's GPU layout (int32 shape header + f32 data)."""

    ALIGNMENT = 4

    def __init__(self, data) -> None:
        self._data = np.ascontiguousarray(data, dtype=np.float32)

    @property
    def data(self) -> np.ndarray:
        return self._data

    @property
    def shape(self) -> tuple:
        return self._data.shape

    @property
    def nbytes(self) -> int:
        return self._data.nbytes + 4 * self._data.ndim

    def upload(self) -> jax.Array:
        """Device copy of the table."""
        return jnp.asarray(self._data)


def getTableSize(a) -> int:
    """Bytes needed to store a table of the given shape (array, shape
    tuple, or None -> 0); int32 header + f32 data like the reference
    (src/theia/lookup.py:84-97 — which sums the dims instead of taking
    their product, agreeing only for 1D tables; this version is exact
    for any rank)."""
    if a is None:
        return 0
    shape = a if isinstance(a, tuple) else np.shape(a)
    if len(shape) == 0:
        raise RuntimeError("table cannot have zero shape!")
    return 4 * (len(shape) + int(np.prod(shape)))


def uploadTables(data: list) -> tuple[tuple[jax.Array, jax.Array], list[int]]:
    """Pack 1D tables into one device allocation and return per-table
    handles (reference: src/theia/lookup.py:99-133 returns device
    *addresses*; the analogue here is the (values, sizes) packed pair of
    :func:`theia_jax.material.lookup_packed` plus integer handles)."""
    arrs = [np.ascontiguousarray(d, np.float32).reshape(-1) for d in data]
    lmax = max((len(a) for a in arrs), default=1)
    values = np.zeros((len(arrs), lmax), np.float32)
    sizes = np.zeros(len(arrs), np.int32)
    for i, a in enumerate(arrs):
        values[i, : len(a)] = a
        sizes[i] = len(a)
    return (jnp.asarray(values), jnp.asarray(sizes)), list(range(len(arrs)))
